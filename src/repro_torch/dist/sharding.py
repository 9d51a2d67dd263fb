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

The reference leaves the gathers to XLA. Here a mesh is the default
group's ranks as a row-major ``(data, model)`` grid: each rank keeps its
slice of every leaf along both of the table's dims
(:meth:`Sharder.shard_params`), ``materialize`` all-gathers a layer's
data slices where the layer runs (an autograd function whose backward
reduce-scatters the gradient back to the rank's slice) and leaves the
model slices sliced, and the model code computes tensor parallelism on
them through the model line's collectives (:mod:`repro_torch.dist.tp`).
An expert table whose E dim lies over data is never gathered: the MoE
moves its dispatch buffer to the experts' owners instead
(:meth:`Sharder.all_to_all`). The activation hooks are identities, since
each rank already holds only its own batch rows. Every FSDP gather,
reduce-scatter and exchange goes over the rank's data line's fallback VCI
(the WORLD group on a data-only mesh), every TP collective over its model
line's: one communicator a line, chosen by the framework, carries all the
traffic. That is the conservative baseline the paper measures its VCIs
against; ``comm="vci"`` (:mod:`repro_torch.core.bucketing`) spreads the
buckets over many, and the serve path's :class:`repro_torch.serve.comm.
ServeCommPlan` gives each purpose its own.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core.collectives import RankMesh, vci_group
from repro_torch.dist.tp import LineComm, line_gather, line_scatter
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


def ssm_divides(cfg: ModelConfig, tp: int) -> bool:
    """Whether a Mamba2 block splits over ``tp`` model ranks: its heads
    and its conv channels divide ``tp``, and a rank's heads read whole
    B/C groups or share one (every config has one group)."""
    c = cfg.ssm
    if c is None or tp <= 1:
        return False
    h = c.num_heads(cfg.d_model)
    ch = c.d_inner(cfg.d_model) + 2 * c.ngroups * c.d_state
    if h % tp or ch % tp:
        return False
    local, rep = h // tp, h // c.ngroups
    return local % rep == 0 or rep % local == 0


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
# the FSDP gather, the expert exchange and the data-line sums (autograd)
# ---------------------------------------------------------------------------

class _Gather(torch.autograd.Function):
    """All-gather a leaf's data slices along ``dim`` on the data line; the
    backward reduce-scatters (sums) the gradient back to this rank's
    slice."""

    @staticmethod
    def forward(ctx, x, dim: int, shard: "Sharder"):
        ctx.dim, ctx.shard = dim, shard
        return shard._gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.shard._scatter(g, ctx.dim), None, None


class _DataSum(torch.autograd.Function):
    """Sum over the data line; the backward sums the gradient the same
    way (every rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x, shard: "Sharder"):
        ctx.shard = shard
        return shard._all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.shard._all_reduce(g.clone()), None


class _AllToAll(torch.autograd.Function):
    """The MoE buffer's exchange over the data line (the GShard
    all_to_all): ``to_experts`` sends each rank's rows of every expert to
    the expert's owner; the reverse sends them back. The backward is the
    other direction."""

    @staticmethod
    def forward(ctx, x, to_experts: bool, shard: "Sharder"):
        ctx.to_experts, ctx.shard = to_experts, shard
        return shard._all_to_all(x, to_experts)

    @staticmethod
    def backward(ctx, g):
        return ctx.shard._all_to_all(g, not ctx.to_experts), None, None


class Sharder:
    """The rule table bound to one (mesh, config) pair, and the
    collectives of a ``(data, model)`` mesh of this process's ranks.

    With ``mesh=None`` (or one rank) every method is the identity, so the
    same model code runs unsharded. Over more ranks the mesh is the
    default group's, which must have ``data x model`` of them, placed as
    :meth:`RankMesh.coords` says (row-major); ``rank`` instead names a
    rank for cutting its slices alone (no collective can run then).

    Each rank stores its slice of every leaf along both of the table's
    dims: its data index's ``1/data`` of the dim over the data axes, its
    model index's ``1/model`` of the dim over ``model``. The FSDP traffic
    (:meth:`materialize`, :meth:`data_sum`, the MoE's :meth:`all_to_all`)
    runs on this rank's data line, the tensor-parallel traffic
    (:attr:`tp`, a :class:`~repro_torch.dist.tp.LineComm`) on its model
    line, each on the line's fallback VCI; on a data-only mesh the data
    line is the default group. ``tally`` counts the collectives issued:
    ``all_gather``, ``reduce_scatter``, ``all_reduce``, ``all_to_all`` on
    the data line (and the bytes the gathers received and the scatters
    sent), ``model_all_reduce``, ``model_all_gather`` and
    ``model_reduce_scatter`` on the model line, ``world_all_gather`` over
    every rank (:attr:`world`: a decode cache whose sequence is split over
    the whole mesh)."""

    def __init__(self, mesh, cfg: ModelConfig, rank: Optional[int] = None):
        self.mesh = mesh
        self.cfg = cfg
        self.dp: Tuple[str, ...] = batch_axes(mesh)
        self.n = _axis_size(mesh, tuple(self.dp))
        self.tp_size = _axis_size(mesh, "model")
        self.size = self.n * self.tp_size
        self.rank = 0 if rank is None else rank
        live = self.size > 1 and rank is None
        if live:
            if not dist.is_initialized() or \
                    dist.get_world_size() != self.size:
                raise ValueError(
                    f"a mesh of {self.size} ranks needs torch.distributed's "
                    f"default group of {self.size} ranks")
            self.rank = dist.get_rank()
        # this rank's place on the grid, (data index, model index)
        self.data_rank, self.model_rank = divmod(self.rank, self.tp_size)
        shapes = dict(tree_flatten_with_paths(param_shapes(cfg)))
        self.specs = param_specs(cfg, mesh)
        # each leaf's path -> (its dim over data, its dim over model, whether
        # the data dim is an expert table's E dim, its global shape)
        self._dims: Dict[Tuple[str, ...], Tuple[Optional[int], Optional[int],
                                                bool, Tuple[int, ...]]] = {}
        dpe = dp_entry(self.dp)
        for path, spec in tree_flatten_with_paths(self.specs,
                                                  is_leaf=is_spec):
            dim = next((i for i, e in enumerate(spec) if e == dpe), None)
            mdim = next((i for i, e in enumerate(spec) if e == "model"),
                        None)
            expert = (len(path) >= 2 and path[-2] == "moe"
                      and path[-1] in ("w_gate", "w_up", "w_down")
                      and dim == (1 if path[0] == "layers" else 0))
            self._dims[path] = (dim, mdim, expert,
                                tuple(shapes[path].shape))
        self.tally: Dict[str, int] = {}
        self.reset_tally()
        # the lines' fallback VCIs: the default group on a data-only mesh
        self._data_group = None
        model_group = None
        if live and self.tp_size > 1:
            if not isinstance(mesh, RankMesh):
                raise ValueError(f"a model axis over ranks needs a RankMesh, "
                                 f"got {mesh!r}")
            self._data_group = vci_group(0, 1, axis="data", mesh=mesh)
            model_group = vci_group(0, 1, axis="model", mesh=mesh)
        self.tp: Optional[LineComm] = (
            LineComm(model_group, self.tp_size, self.model_rank, self.tally)
            if self.tp_size > 1 else None)
        # every rank of the mesh (the default group), as one line
        self.world: Optional[LineComm] = (
            LineComm(None, self.size, self.rank, self.tally, line="world")
            if self.size > 1 else None)
        heads, kv = cfg.num_heads, cfg.num_kv_heads
        # attention is tensor-parallel where the heads divide the axis;
        # elsewhere its model-sliced leaves are used whole
        self.attn_tp = self.tp is not None and heads > 0 and \
            heads % self.tp_size == 0 and kv % self.tp_size == 0
        # so is a Mamba2 block where its heads and its conv channels do
        self.ssm_tp = self.tp is not None and ssm_divides(cfg, self.tp_size)

    def reset_tally(self) -> None:
        self.tally.update(all_gather=0, reduce_scatter=0, all_reduce=0,
                          all_to_all=0, gather_bytes=0, scatter_bytes=0,
                          model_all_reduce=0, model_all_gather=0,
                          model_reduce_scatter=0, world_all_gather=0)

    # -- mesh arithmetic -------------------------------------------------
    def _axsize(self, ax: AxisLike) -> int:
        return _axis_size(self.mesh, ax)

    def div(self, n: int, ax: AxisLike) -> bool:
        """True when ``n`` can shard over ``ax`` (present, >1, divides)."""
        sz = self._axsize(ax)
        return sz > 1 and n % sz == 0

    def _rel(self, path, which: int, ndim: Optional[int]) -> Optional[int]:
        entry = self._dims[tuple(path)]
        dim, shape = entry[which], entry[3]
        if dim is None:
            return None
        return dim - (len(shape) - (len(shape) if ndim is None else ndim))

    def sharded_dim(self, path: Sequence[str], ndim: Optional[int] = None
                    ) -> Optional[int]:
        """The dim of the leaf at ``path`` that is split over the data
        ranks (``None``: whole over data). ``ndim`` — the leaf's rank, one
        less than the stored leaf's for a layer's slice of a stacked
        leaf."""
        return None if self.n == 1 else self._rel(path, 0, ndim)

    def model_dim(self, path: Sequence[str], ndim: Optional[int] = None
                  ) -> Optional[int]:
        """The dim of the leaf at ``path`` split over ``model`` (``None``:
        whole over model)."""
        return None if self.tp_size == 1 else self._rel(path, 1, ndim)

    def expert_parallel(self, path: Sequence[str]) -> bool:
        """Whether the leaf at ``path`` is an expert table whose E dim is
        split over the data ranks (the reference keeps it so under
        ``materialize``: the experts run where they live)."""
        return self.n > 1 and self._dims[tuple(path)][2]

    def global_shape(self, path: Sequence[str]) -> Tuple[int, ...]:
        """The whole leaf's shape at ``path`` (a stored leaf)."""
        return self._dims[tuple(path)][3]

    def local_shape(self, path: Sequence[str]) -> Tuple[int, ...]:
        """The shape of this rank's slice of the stored leaf at ``path``."""
        shape = list(self.global_shape(path))
        for dim, parts in ((self.sharded_dim(path), self.n),
                           (self.model_dim(path), self.tp_size)):
            if dim is not None:
                shape[dim] //= parts
        return tuple(shape)

    def leaf_index(self, path: Sequence[str], ndim: int) -> tuple:
        """This rank's slice of the whole leaf at ``path``, as an index
        (a slice a dim)."""
        index = [slice(None)] * ndim
        shape = self.global_shape(path)[len(self.global_shape(path)) - ndim:]
        for dim, parts, at in ((self.sharded_dim(path, ndim), self.n,
                                self.data_rank),
                               (self.model_dim(path, ndim), self.tp_size,
                                self.model_rank)):
            if dim is not None:
                size = shape[dim] // parts
                index[dim] = slice(at * size, (at + 1) * size)
        return tuple(index)

    # -- the rank's slices -----------------------------------------------
    def shard_leaf(self, path: Sequence[str], t: torch.Tensor
                   ) -> torch.Tensor:
        """This rank's slice of ``t`` along its dims over data and over
        model (a copy), or ``t`` itself where it is replicated."""
        if self.sharded_dim(path, t.dim()) is None and \
                self.model_dim(path, t.dim()) is None:
            return t
        return t[self.leaf_index(path, t.dim())].clone()

    def shard_params(self, params):
        """A full param tree -> this rank's tree."""
        return tree_map_with_paths(self.shard_leaf, params)

    @torch.no_grad()
    def gather_leaf(self, path: Sequence[str], t: torch.Tensor
                    ) -> torch.Tensor:
        """The whole leaf from every rank's slice (no autograd; collective:
        every rank calls it)."""
        dim = self.sharded_dim(path, t.dim())
        if dim is not None:
            t = self._gather(t, dim)
        mdim = self.model_dim(path, t.dim())
        if mdim is not None:
            t = self.tp._gather(t, mdim)
        return t

    def gather_params(self, params):
        return tree_map_with_paths(self.gather_leaf, params)

    # -- weights ----------------------------------------------------------
    def materialize(self, p, at: Sequence[str] = ()):
        """ZeRO/FSDP weight gather, the reference's ``fsdp=False`` view:
        every leaf of ``p`` (the subtree at path ``at`` of the param tree,
        e.g. ``("layers",)`` for a layer's slice) all-gathered over the
        data line along its dim over data, right before use; slices over
        ``model`` stay sliced (the model code computes tensor parallelism
        on them), and so does an expert table's E dim over data (the
        experts run where they live: :meth:`all_to_all`). The backward
        reduce-scatters the gradient to this rank's slice; under remat the
        recompute gathers again."""
        if self.n == 1:
            return p
        at = tuple(at)

        def gather(path, leaf):
            full = at + path
            dim = self.sharded_dim(full, leaf.dim())
            if dim is None or self.expert_parallel(full):
                return leaf
            return _Gather.apply(leaf, dim, self)

        return tree_map_with_paths(gather, p)

    def gather_experts(self, t: torch.Tensor) -> torch.Tensor:
        """A layer's expert table (``(E/N, a, b)``, E over the data line)
        gathered whole along E, with the reduce-scatter backward."""
        return _Gather.apply(t, 0, self)

    def model_whole(self, p, at: Sequence[str] = (), summed: bool = False):
        """Every leaf of ``p`` (at path ``at``) that is sliced over
        ``model`` gathered whole over the model line, for a site that
        computes on it replicated over ``model``: every model rank then
        computes the whole gradient and keeps its slice (``summed``: each
        computes a part of it, and the backward reduce-scatters)."""
        if self.tp is None:
            return p
        at = tuple(at)

        def gather(path, leaf):
            dim = self.model_dim(at + path, leaf.dim())
            if dim is None:
                return leaf
            if summed:
                return self.tp.gather_sum(leaf, dim)
            return self.tp.all_gather(leaf, gather_axis=dim)

        return tree_map_with_paths(gather, p)

    def ssm_site(self, p, at: Sequence[str] = ()):
        """A Mamba2 layer's params (``ssm``, ``norm1``; data dims gathered)
        and its block's comm: :attr:`tp` where the block is
        tensor-parallel (:attr:`ssm_tp`), ``None`` where it computes
        replicated over ``model`` (its model-sliced leaves gathered
        whole). On the tensor-parallel block a model rank computes its own
        heads and conv channels (:mod:`repro_torch.models.ssm`), so it
        reads every ``ssm`` leaf but ``out_proj`` in part: a leaf sliced
        over ``model`` (``in_proj``) is gathered whole with a
        reduce-scatter backward, a replicated one goes through ``copy``
        (its backward sums the ranks' partial gradients over the line),
        and ``out_proj``'s row slice stays this rank's. ``(p, comm)``."""
        if not self.ssm_tp:
            return self.model_whole(p, at), None
        at = tuple(at) + ("ssm",)
        s = {}
        for name, leaf in p["ssm"].items():
            dim = self.model_dim(at + (name,), leaf.dim())
            if dim is None:
                s[name] = self.tp.copy(leaf)
            elif name == "out_proj":
                s[name] = leaf
            else:
                s[name] = self.tp.gather_sum(leaf, dim)
        return {**p, "ssm": s}, self.tp

    def tp_sites(self, p, at: Sequence[str] = ()):
        """A block's params (``attn``, ``ffn``; data dims gathered) and the
        comm of each site: its :attr:`tp` where the site is
        tensor-parallel, ``None`` where it computes replicated over
        ``model`` (attention whose heads do not divide the axis: its
        model-sliced leaves are gathered whole; an FFN whose d_ff does not
        divide it is not sliced). ``(p, attn comm, ffn comm)``."""
        if self.tp is None:
            return p, None, None
        at = tuple(at)
        p = dict(p)
        attn_c = ffn_c = None
        if "attn" in p:
            if self.attn_tp:
                attn_c = self.tp
            else:
                p["attn"] = self.model_whole(p["attn"], at + ("attn",))
        if "ffn" in p and self.model_dim(at + ("ffn", "w_gate")) is not None:
            ffn_c = self.tp
        return p, attn_c, ffn_c

    # -- named activation sites (identities: each rank holds its rows) ----
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

    # -- the MoE exchange and the sums over the data line ----------------
    def all_to_all(self, x: torch.Tensor, to_experts: bool) -> torch.Tensor:
        """An expert-major MoE buffer moved over the data line, with its
        backward: ``to_experts`` takes ``(E, R, d)`` (this rank's ``R``
        rows of every expert) to ``(E/N, N*R, d)`` (every rank's rows of
        this rank's experts, in rank order); the reverse takes them back."""
        return _AllToAll.apply(x, to_experts, self)

    def data_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the data line, differentiably (the global
        batch's token sums of the MoE load balance)."""
        return x if self.n == 1 else _DataSum.apply(x, self)

    @torch.no_grad()
    def data_sum_(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the data line in place (no autograd)."""
        return x if self.n == 1 else self._all_reduce(x)

    def split_key(self, path: Sequence[str]) -> Optional[str]:
        """Over which ranks this rank's stored leaf at ``path`` is a
        slice: ``"both"``, ``"data"``, ``"model"``, or ``None`` (whole on
        every rank)."""
        d = self.sharded_dim(path) is not None
        m = self.model_dim(path) is not None
        return {(True, True): "both", (True, False): "data",
                (False, True): "model"}.get((d, m))

    @torch.no_grad()
    def norm_sum_(self, parts: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The sum of squares of the sliced leaves over the ranks, each
        element once (:func:`repro_torch.optim.adamw.global_norm`'s
        ``psum``; keys of :meth:`split_key`): ``"both"`` over every rank,
        ``"data"`` over the data line (its model ranks hold the same
        values), ``"model"`` over the model line. One all-reduce a line."""
        zero = next(iter(parts.values())).new_zeros(()) if parts else \
            torch.zeros(())
        both, data, model = (parts.get(k, zero) for k in
                             ("both", "data", "model"))
        if self.tp is None:
            return self.data_sum_(both + data)
        sums = self.data_sum_(torch.stack([both, data]))
        return self.model_sum_(sums[0] + model) + sums[1]

    @torch.no_grad()
    def model_sum_(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the model line in place (no autograd)."""
        if self.tp is None:
            return x
        dist.all_reduce(x, group=self.tp.group)
        self.tally["model_all_reduce"] += 1
        return x

    # -- the data line's collectives (its fallback VCI) --------------------
    def _gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        # laid out as the whole leaf is: a matmul then reads it as it reads
        # the unsharded weight (the same kernel, so the same rounding)
        out = line_gather(x, dim, self.n, self._data_group)
        self.tally["all_gather"] += 1
        self.tally["gather_bytes"] += out.numel() * out.element_size()
        return out

    def _scatter(self, g: torch.Tensor, dim: int) -> torch.Tensor:
        self.tally["reduce_scatter"] += 1
        self.tally["scatter_bytes"] += g.numel() * g.element_size()
        return line_scatter(g, dim, self.n, self._data_group)

    def _all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(x, group=self._data_group)
        self.tally["all_reduce"] += 1
        return x

    def _all_to_all(self, x: torch.Tensor, to_experts: bool) -> torch.Tensor:
        n = self.n
        if to_experts:               # (E, R, d): block j to rank j
            send = x.contiguous()
        else:                        # (E/n, n*R, d): rows of rank j to j
            e, rows = x.shape[0], x.shape[1] // n
            send = x.reshape((e, n, rows) + tuple(x.shape[2:])).transpose(
                0, 1).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self._data_group)
        self.tally["all_to_all"] += 1
        if not to_experts:           # (n, E/n, R, d) from each owner
            return recv.reshape((-1,) + tuple(recv.shape[2:]))
        e, rows = x.shape[0] // n, x.shape[1]
        return recv.view((n, e, rows) + tuple(x.shape[2:])).transpose(
            0, 1).reshape((e, n * rows) + tuple(x.shape[2:]))
