"""Sharding rules and the FSDP weight gather (port of
``repro.dist.sharding``).

One rule table drives three consumers, as there:

* :func:`param_specs` — a spec tree that mirrors a config's parameter tree
  exactly (the checkpoint and the FSDP state init read it);
* :meth:`Sharder.materialize` — the ZeRO/FSDP weight gather of one layer's
  params right before use;
* the activation hooks (``hidden`` / ``heads`` / ``kv_cache`` /
  ``ffn_hidden`` / ``logits`` / ``act``) that the model code calls.

A spec is a :class:`PartitionSpec`: a tuple of one entry a tensor dim —
``None``, an axis name, or a tuple of names — equal entry for entry to the
reference's ``jax.sharding.PartitionSpec``. Every axis assignment is
divisibility-guarded, so the same rules hold on any mesh: a
:class:`~repro_torch.core.collectives.RankMesh`, ``None``, or a duck-typed
object with ``axis_names`` and a ``shape`` dict. ``model`` is the
tensor-parallel axis; every other axis is data-parallel.

The reference leaves the gathers to XLA. Here a data-only mesh is the
default group's ranks: each rank keeps its contiguous ``1/N`` slice of
every leaf the table shards over data (:meth:`Sharder.shard_params`),
``materialize`` all-gathers a layer's slices where the layer runs (an
autograd function whose backward reduce-scatters the gradient back to the
rank's slice), and the activation hooks are identities, since each rank
already holds only its own batch rows. Every gather and reduce-scatter goes
over the data group's fallback VCI, the WORLD group: one communicator,
chosen by the framework, carries all the gradient traffic. That is the
conservative baseline the paper measures its VCIs against; ``comm="vci"``
(:mod:`repro_torch.core.bucketing`) spreads the buckets over many.
Training on a ``model`` axis above 1 is ROADMAP.md Queue 1 item 14.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core.collectives import _all_gather, _reduce_scatter
from repro_torch.tree import tree_flatten_with_paths, tree_map_with_paths

AxisLike = Union[None, str, Tuple[str, ...]]

# model goes on the LAST dim (column-parallel) for these weight names, on
# dim -2 (row-parallel) for the _TP_ROW names; biases follow their matmul.
_TP_COL = frozenset({"wq", "wk", "wv", "w_gate", "w_up", "in_proj"})
_TP_ROW = frozenset({"wo", "w_down", "out_proj"})
_TP_BIAS = frozenset({"bq", "bk", "bv", "b_up"})


class PartitionSpec(tuple):
    """One leaf's spec: an entry a dim (``None``, an axis name or a tuple
    of names). A tuple, so it equals the reference's spec entry for entry;
    a class of its own, so spec trees can tell it from their containers."""

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def P(*entries: AxisLike) -> PartitionSpec:
    return PartitionSpec(entries)


def is_spec(x: Any) -> bool:
    return isinstance(x, PartitionSpec)


# ---------------------------------------------------------------------------
# mesh introspection (RankMesh, duck-typed fakes, and None)
# ---------------------------------------------------------------------------

def _axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "axis_names", None)
    return tuple(names) if names is not None else tuple(dict(mesh.shape))


def batch_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel mesh axes, in mesh order (everything but model)."""
    if mesh is None:
        return ("data",)
    return tuple(a for a in _axis_names(mesh) if a != "model")


def data_axes(mesh, cfg: Optional[ModelConfig] = None) -> Tuple[str, ...]:
    """Axes the batch dimension shards over (cfg hook, as there)."""
    return batch_axes(mesh)


def dp_entry(dp: Tuple[str, ...]) -> AxisLike:
    """A spec entry sharding one dim over ALL the data axes: the bare axis
    name for a 1-axis mesh, the tuple for data x pod meshes."""
    return dp[0] if len(dp) == 1 else tuple(dp)


def _axis_size(mesh, ax: AxisLike) -> int:
    if mesh is None or ax is None:
        return 1
    axes = ax if isinstance(ax, tuple) else (ax,)
    n = 1
    for a in axes:
        n *= dict(mesh.shape).get(a, 1)
    return n


def zero1_opt_specs(mesh, opt_state):
    """The spec tree of a ZeRO-1 optimizer state (flat bucket space):
    every 1-D leaf (a bucket's m / v / f32 master) over the data axes,
    scalars (the step count) replicated. Takes states and meta states."""
    dpe = dp_entry(batch_axes(mesh))
    return tree_map_with_paths(
        lambda _, l: P(dpe) if getattr(l, "ndim", 0) == 1 else P(), opt_state)


# ---------------------------------------------------------------------------
# the parameter rule table
# ---------------------------------------------------------------------------

def _leaf_spec(mesh, keys: Sequence[str], shape: Tuple[int, ...], *,
               stacked: bool, fsdp: bool = True) -> PartitionSpec:
    """The spec of one parameter leaf, selected by its tree path.

    ``stacked`` marks a leading layer-stack dim (always unsharded).
    ``fsdp=False`` drops the data-axis weight sharding (the TP-only spec).
    Expert-parallel dims on MoE expert tables are kept either way."""
    nd = len(shape)
    spec: list = [None] * nd
    if nd == 0:
        return P()
    lead = 1 if stacked else 0
    dp = batch_axes(mesh)
    dpn = _axis_size(mesh, tuple(dp))
    tp = _axis_size(mesh, "model")
    name = keys[-1]
    parent = keys[-2] if len(keys) >= 2 else ""

    def model_ok(dim: int) -> bool:
        return tp > 1 and dim >= lead and shape[dim] % tp == 0

    def dp_ok(dim: int) -> bool:
        return fsdp and dpn > 1 and dim >= lead and shape[dim] % dpn == 0

    if parent == "moe" and name in ("w_gate", "w_up", "w_down"):
        # (..., E, a, b) expert tables: expert-parallel over the data axes
        # when E divides, else the FSDP fallback lands on d_model below
        e_dim = lead
        if dpn > 1 and shape[e_dim] % dpn == 0:
            spec[e_dim] = dp_entry(dp)
        ff_dim = nd - 1 if name in ("w_gate", "w_up") else nd - 2
        if model_ok(ff_dim):
            spec[ff_dim] = "model"
        elif spec[e_dim] is None:
            d_dim = nd - 2 if name in ("w_gate", "w_up") else nd - 1
            if dp_ok(d_dim):
                spec[d_dim] = dp_entry(dp)
    elif name == "router":
        pass  # tiny, replicated
    elif parent == "embed" and nd >= 2:           # (V, d) or (K, V, d)
        if model_ok(nd - 2):
            spec[nd - 2] = "model"                # vocab column-parallel
        if dp_ok(nd - 1):
            spec[nd - 1] = dp_entry(dp)
    elif parent in ("lm_head", "img_proj") and nd >= 2:
        if model_ok(nd - 1):
            spec[nd - 1] = "model"
        if dp_ok(nd - 2):
            spec[nd - 2] = dp_entry(dp)
    elif name in _TP_COL and nd >= 2:
        if model_ok(nd - 1):
            spec[nd - 1] = "model"
        if dp_ok(nd - 2):
            spec[nd - 2] = dp_entry(dp)
    elif name in _TP_ROW and nd >= 2:
        if model_ok(nd - 2):
            spec[nd - 2] = "model"
        if dp_ok(nd - 1):
            spec[nd - 1] = dp_entry(dp)
    elif name in _TP_BIAS:
        if model_ok(nd - 1):
            spec[nd - 1] = "model"
    # everything else (norm scales, conv_w, A_log, D, dt_bias, ...) replicates
    return P(*spec)


def param_shapes(cfg: ModelConfig):
    """``init_params(cfg)``'s tree on the meta device: every leaf's shape
    and dtype, no memory (a full-width arch costs nothing)."""
    from repro_torch.models.transformer import init_params  # import cycle
    return init_params(cfg, 0, device="meta")


def param_specs(cfg: ModelConfig, mesh):
    """A spec tree with the exact structure of ``init_params(cfg)``."""
    def assign(path, leaf):
        stacked = bool(path) and path[0] == "layers"
        return _leaf_spec(mesh, path, tuple(leaf.shape), stacked=stacked)

    return tree_map_with_paths(assign, param_shapes(cfg))


# ---------------------------------------------------------------------------
# the FSDP gather and its reduce-scatter backward
# ---------------------------------------------------------------------------

class _Gather(torch.autograd.Function):
    """All-gather a leaf's data slices along ``dim``; the backward
    reduce-scatters (sums) the gradient back to this rank's slice."""

    @staticmethod
    def forward(ctx, x, dim: int, shard: "Sharder"):
        ctx.dim, ctx.shard = dim, shard
        return shard._gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.shard._scatter(g, ctx.dim), None, None


class _DataSum(torch.autograd.Function):
    """Sum over the data ranks; the backward sums the gradient the same
    way (every rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x, shard: "Sharder"):
        ctx.shard = shard
        return shard._all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.shard._all_reduce(g.clone()), None


class Sharder:
    """The rule table bound to one (mesh, config) pair, and the collectives
    of a data-only mesh on the default group.

    With ``mesh=None`` (or one data rank) every method is the identity, so
    the same model code runs unsharded. Over more ranks the mesh is the
    default group's, which must have them; ``rank`` instead names a rank
    for cutting its slices alone (no collective can run then). ``tally`` counts the collectives
    issued (``all_gather``, ``reduce_scatter``, ``all_reduce``) and the
    bytes each kind received or sent."""

    def __init__(self, mesh, cfg: ModelConfig, rank: Optional[int] = None):
        if _axis_size(mesh, "model") > 1:
            raise NotImplementedError(
                "training on a model axis above 1 (GSPMD tensor parallelism, "
                "with expert-parallel MoE) is ROADMAP.md Queue 1 item 14; the "
                "ported Sharder takes a data-only mesh")
        self.mesh = mesh
        self.cfg = cfg
        self.dp: Tuple[str, ...] = batch_axes(mesh)
        self.n = _axis_size(mesh, tuple(self.dp))
        self.rank = 0 if rank is None else rank
        if self.n > 1 and rank is None:
            if not dist.is_initialized() or \
                    dist.get_world_size() != self.n:
                raise ValueError(
                    f"a data mesh of {self.n} needs torch.distributed's "
                    f"default group of {self.n} ranks")
            self.rank = dist.get_rank()
        shapes = dict(tree_flatten_with_paths(param_shapes(cfg)))
        self.specs = param_specs(cfg, mesh)
        # each leaf's path -> (its data-sharded dim or None, global shape)
        self._dims: Dict[Tuple[str, ...],
                         Tuple[Optional[int], Tuple[int, ...]]] = {}
        dpe = dp_entry(self.dp)
        for path, spec in tree_flatten_with_paths(self.specs,
                                                  is_leaf=is_spec):
            dim = next((i for i, e in enumerate(spec) if e == dpe), None)
            self._dims[path] = (dim, tuple(shapes[path].shape))
        self.tally: Dict[str, int] = {}
        self.reset_tally()

    def reset_tally(self) -> None:
        self.tally.update(all_gather=0, reduce_scatter=0, all_reduce=0,
                          gather_bytes=0, scatter_bytes=0)

    # -- mesh arithmetic -------------------------------------------------
    def _axsize(self, ax: AxisLike) -> int:
        return _axis_size(self.mesh, ax)

    def div(self, n: int, ax: AxisLike) -> bool:
        """True when ``n`` can shard over ``ax`` (present, >1, divides)."""
        sz = self._axsize(ax)
        return sz > 1 and n % sz == 0

    def sharded_dim(self, path: Sequence[str], ndim: Optional[int] = None
                    ) -> Optional[int]:
        """The dim of the leaf at ``path`` that is split over the data
        ranks (``None``: replicated). ``ndim`` — the leaf's rank, one less
        than the stored leaf's for a layer's slice of a stacked leaf."""
        dim, shape = self._dims[tuple(path)]
        if dim is None or self.n == 1:
            return None
        return dim - (len(shape) - (len(shape) if ndim is None else ndim))

    def global_shape(self, path: Sequence[str]) -> Tuple[int, ...]:
        """The whole leaf's shape at ``path`` (a stored leaf)."""
        return self._dims[tuple(path)][1]

    def local_shape(self, path: Sequence[str]) -> Tuple[int, ...]:
        """The shape of this rank's slice of the stored leaf at ``path``."""
        shape = list(self.global_shape(path))
        dim = self.sharded_dim(path)
        if dim is not None:
            shape[dim] //= self.n
        return tuple(shape)

    # -- the rank's slices -----------------------------------------------
    def shard_leaf(self, path: Sequence[str], t: torch.Tensor
                   ) -> torch.Tensor:
        """This rank's contiguous ``1/N`` of ``t`` along its sharded dim (a
        copy), or ``t`` itself where it is replicated."""
        dim = self.sharded_dim(path, t.dim())
        if dim is None:
            return t
        size = t.shape[dim] // self.n
        return t.narrow(dim, self.rank * size, size).clone()

    def shard_params(self, params):
        """A full param tree -> this rank's FSDP tree."""
        return tree_map_with_paths(self.shard_leaf, params)

    @torch.no_grad()
    def gather_leaf(self, path: Sequence[str], t: torch.Tensor
                    ) -> torch.Tensor:
        """The whole leaf from every rank's slice (no autograd; collective:
        every rank calls it)."""
        dim = self.sharded_dim(path, t.dim())
        return t if dim is None else self._gather(t, dim)

    def gather_params(self, params):
        return tree_map_with_paths(self.gather_leaf, params)

    # -- weights ----------------------------------------------------------
    def materialize(self, p, at: Sequence[str] = ()):
        """ZeRO/FSDP weight gather: every data-sharded leaf of ``p`` (the
        subtree at path ``at`` of the param tree, e.g. ``("layers",)`` for
        a layer's slice) all-gathered along the table's dim, right before
        use. Its backward reduce-scatters the gradient to this rank's
        slice; under remat the recompute gathers again."""
        if self.n == 1:
            return p
        at = tuple(at)

        def gather(path, leaf):
            dim = self.sharded_dim(at + path, leaf.dim())
            return leaf if dim is None else _Gather.apply(leaf, dim, self)

        return tree_map_with_paths(gather, p)

    # -- named activation sites (identities on a data-only mesh) ----------
    def act(self, x, *axes: AxisLike):
        return x

    def hidden(self, x):
        """(B, S, d) residual-stream activations: batch over data axes."""
        return x

    def heads(self, q):
        """(B, S, H, hd): attention/SSM heads over model."""
        return q

    def kv_cache(self, k):
        return k

    def ffn_hidden(self, h):
        return h

    def logits(self, logits):
        return logits

    # -- sums over the data ranks -------------------------------------------
    def data_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the data ranks, differentiably (the global
        batch's token sums of the MoE load balance)."""
        return x if self.n == 1 else _DataSum.apply(x, self)

    @torch.no_grad()
    def data_sum_(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the data ranks in place (no autograd)."""
        return x if self.n == 1 else self._all_reduce(x)

    # -- the collectives (the WORLD group: the fallback VCI) --------------
    def _gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        xm = x.movedim(dim, 0).contiguous()
        out = torch.empty((self.n * xm.shape[0],) + tuple(xm.shape[1:]),
                          dtype=xm.dtype, device=xm.device)
        _all_gather(out.view(-1), xm.view(-1))
        self.tally["all_gather"] += 1
        self.tally["gather_bytes"] += out.numel() * out.element_size()
        # laid out as the whole leaf is: a matmul then reads it as it reads
        # the unsharded weight (the same kernel, so the same rounding)
        return out.movedim(0, dim).contiguous()

    def _scatter(self, g: torch.Tensor, dim: int) -> torch.Tensor:
        gm = g.movedim(dim, 0).contiguous()
        out = torch.empty((gm.shape[0] // self.n,) + tuple(gm.shape[1:]),
                          dtype=gm.dtype, device=gm.device)
        _reduce_scatter(out.view(-1), gm.view(-1))
        self.tally["reduce_scatter"] += 1
        self.tally["scatter_bytes"] += gm.numel() * gm.element_size()
        return out.movedim(0, dim)

    def _all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(x)
        self.tally["all_reduce"] += 1
        return x
