"""Serve-path communication streams — VCIs for decode/prefill collectives.

Port of ``repro.serve.comm``. The gradient path (``core/bucketing.py``)
maps each gradient bucket onto a CommContext/VCI; the serve path has the
same shape of user-exposed parallelism with different *purposes*: every
decode step issues TP partial-sum all-reduces (attention ``wo`` and FFN
``w_down`` row-parallel matmuls), the MoE expert-output gather, and the
vocab-parallel embedding sum and logits gather. :class:`ServeCommPlan`
holds ONE ``CommWorld`` plus per-lane/per-purpose ``CommContext``s and
mints a fresh ``CommRuntime`` per call (the reference mints one per
trace).

Purposes (one context — hence one VCI stream — per purpose, per lane):

* ``tp_attn``  — attention output-projection partial sums (row-parallel wo);
* ``tp_mlp``   — FFN down-projection partial sums (row-parallel w_down);
* ``moe``      — the MoE expert-parallel gather of expert outputs, or the
                 ff-TP partial-sum all-reduce when experts don't divide the
                 axis;
* ``sample``   — vocab-parallel embedding/logits collectives feeding the
                 sampler.

With ``num_vcis`` below the live context count the pool falls back exactly
as the paper's §4.2 describes: contexts collide on VCI 0 and share its
process group, so their operations serialise.

Each rank runs the model on its own shard: the parameters are cut by
:func:`serve_param_specs` (:func:`shard_params`, or ``init_params(...,
shard=)`` leaf by leaf), where the reference's ``shard_map`` slices global
arrays by the same specs. The process groups of a context's VCI span one
line of the :class:`~repro_torch.core.collectives.RankMesh` along the
``model`` axis.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core.collectives import CommRuntime, RankMesh, vci_group
from repro_torch.core.comm import CommContext, CommWorld

PURPOSES = ("tp_attn", "tp_mlp", "moe", "sample")

TP_AXIS = "model"


@dataclass
class CommTally:
    """What a plan's collectives cost: the number issued by purpose (the
    data-axis token gather under ``"tokens"``) and the host seconds spent
    in them. With ``timed`` the device is synchronised before each clock
    starts, so the seconds hold the collectives alone."""

    counts: Dict[str, int] = field(default_factory=dict)
    seconds: float = 0.0
    timed: bool = False

    def reset(self) -> None:
        self.counts, self.seconds = {}, 0.0

    def run(self, purpose: str, x: torch.Tensor, op: Callable[[], Any]):
        if self.timed and x.is_cuda:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        out = op()
        self.seconds += time.perf_counter() - t0
        self.counts[purpose] = self.counts.get(purpose, 0) + 1
        return out


@dataclass
class ServeComm:
    """One lane's view threaded through the model's decode/prefill code:
    its contexts on a (possibly shared) :class:`CommRuntime`. Every
    collective here is waited on before it returns: the eager model reads
    its result next."""

    rt: CommRuntime
    contexts: Dict[str, CommContext]
    axis: str = TP_AXIS
    tally: CommTally = field(default_factory=CommTally)

    @property
    def size(self) -> int:
        return self.rt.axis_size(self.axis)

    def rank(self) -> int:
        """This rank's index along the axis."""
        d, m = self.rt.mesh.coords(dist.get_rank())
        return m if self.axis == "model" else d

    def psum(self, x: torch.Tensor, purpose: str) -> torch.Tensor:
        """Partial-sum all-reduce on the purpose's VCI stream, in place on
        ``x`` when it is contiguous (the model's partial sums are fresh
        matmul outputs, read nowhere else)."""
        x = x.contiguous()
        return self.tally.run(purpose, x, lambda: self.rt.wait(
            self.rt.all_reduce(x, self.contexts[purpose], axis=self.axis)))

    def all_gather(self, x: torch.Tensor, purpose: str,
                   gather_axis: int) -> torch.Tensor:
        """Tiled all-gather along ``gather_axis`` (rank order)."""
        n, g = self.size, gather_axis % x.dim()
        flat = self.tally.run(purpose, x, lambda: self.rt.wait(
            self.rt.all_gather(x.contiguous(), self.contexts[purpose],
                               axis=self.axis)))
        parts = flat.view((n,) + tuple(x.shape)).movedim(0, g)
        shape = list(x.shape)
        shape[g] *= n
        return parts.reshape(shape)

    def all_to_all(self, x: torch.Tensor, purpose: str, *, split_axis: int,
                   concat_axis: int) -> torch.Tensor:
        return self.tally.run(purpose, x, lambda: self.rt.wait(
            self.rt.all_to_all(x, self.contexts[purpose],
                               split_axis=split_axis,
                               concat_axis=concat_axis, axis=self.axis)))

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """A column-parallel site's entry: the identity (serving takes no
        gradient; the training path's :class:`repro_torch.dist.tp.
        LineComm` sums it over the line in the backward)."""
        return x

    def drain(self, x):
        """Order ``x`` after every stream (step-end global progress)."""
        self.rt.barrier()
        return x


class ServeCommPlan:
    """Host-persistent serve comm plan (the serve mirror of ``CommPlan``).

    Built once per engine; every call mints a fresh runtime via
    :meth:`runtime` while the world, the VCI pool and the contexts persist
    — so pool statistics accumulate and the VCI mapping is decided exactly
    once, at creation time, like ``MPI_Comm_create``. ``tally`` counts the
    collectives of every lane.
    """

    def __init__(self, *, num_vcis: int = 8, vci_policy: str = "fcfs",
                 lanes: int = 1, progress: str = "hybrid",
                 join_every: int = 8, token_impl: str = "barrier"):
        if lanes < 1:
            raise ValueError(f"need at least one lane, got {lanes}")
        self.lanes = lanes
        self.progress = progress
        self.join_every = join_every
        self.token_impl = token_impl
        self.tally = CommTally()
        self.world = CommWorld(num_vcis=num_vcis, policy=vci_policy)
        self.contexts: Dict[Tuple[int, str], CommContext] = {}
        for lane in range(lanes):
            for purpose in PURPOSES:
                hint = "dedicated" if vci_policy == "hinted" else None
                self.contexts[(lane, purpose)] = self.world.create(
                    f"lane{lane}.{purpose}", kind="p2p", hint=hint)

    def runtime(self, mesh: Optional[RankMesh] = None) -> CommRuntime:
        """A fresh per-call runtime bound to the persistent world."""
        return CommRuntime(self.world, progress=self.progress,
                           join_every=self.join_every,
                           token_impl=self.token_impl, mesh=mesh)

    def comm(self, lane: int = 0, *, rt: Optional[CommRuntime] = None,
             axis: str = TP_AXIS, mesh: Optional[RankMesh] = None
             ) -> ServeComm:
        """The lane's comm view. Pass one shared ``rt`` to run several
        lanes on one runtime (collision semantics)."""
        if not 0 <= lane < self.lanes:
            raise ValueError(f"lane {lane} outside [0, {self.lanes})")
        ctxs = {p: self.contexts[(lane, p)] for p in PURPOSES}
        return ServeComm(rt or self.runtime(mesh), ctxs, axis=axis,
                         tally=self.tally)

    def create_groups(self, mesh: RankMesh) -> None:
        """Create the process groups of every VCI the contexts use, along
        ``model`` (VCI 0's along ``data`` too, for the token gather), in
        one order on every rank: ``new_group`` is collective."""
        vci_group(max(self.vci_map().values()), self.world.pool.num_vcis,
                  TP_AXIS, mesh)
        if mesh.data_size > 1:
            vci_group(0, self.world.pool.num_vcis, "data", mesh)

    def gather_tokens(self, x: torch.Tensor, mesh: RankMesh) -> torch.Tensor:
        """Every data rank's sampled rows (``x``: ``(b, ...)``), in data
        order: ``(data * b, ...)``, on COMM_WORLD's fallback VCI along
        ``data``, counted apart as ``"tokens"``."""
        rt = self.runtime(mesh)
        flat = self.tally.run("tokens", x, lambda: rt.wait(rt.all_gather(
            x.contiguous(), self.world.world, axis="data")))
        return flat.view((mesh.data_size * x.shape[0],) + tuple(x.shape[1:]))

    @property
    def stats(self):
        return self.world.stats

    def vci_map(self) -> Dict[str, int]:
        """{context name: vci index} — the realized mapping, for reporting."""
        return {c.name: c.vci.index for c in self.contexts.values()}


# ---------------------------------------------------------------------------
# manual-TP parameter/cache specs
# ---------------------------------------------------------------------------

def serve_tp_validate(cfg: ModelConfig, tp: int) -> None:
    """The divisibility contract of the manual-TP serve path."""
    if tp <= 1:
        return
    problems = []
    if cfg.family not in ("dense", "moe"):
        problems.append(f"family {cfg.family!r} (attention archs only)")
    if cfg.modality != "text":
        problems.append(f"modality {cfg.modality!r}")
    if cfg.num_heads % tp:
        problems.append(f"num_heads {cfg.num_heads} % tp")
    if cfg.num_kv_heads % tp:
        problems.append(f"num_kv_heads {cfg.num_kv_heads} % tp")
    if cfg.d_ff % tp:
        problems.append(f"d_ff {cfg.d_ff} % tp")
    if cfg.vocab_size % tp:
        problems.append(f"vocab_size {cfg.vocab_size} % tp")
    if cfg.decode_kv_expand != 1:
        problems.append("decode_kv_expand != 1")
    if cfg.moe is not None and (cfg.moe.num_experts % tp
                                and cfg.d_ff % tp):
        problems.append(f"num_experts {cfg.moe.num_experts} % tp")
    if problems:
        raise ValueError(
            f"arch {cfg.name!r} cannot run the manual-TP serve path at "
            f"tp={tp}: " + "; ".join(problems))


_COL = frozenset({"wq", "wk", "wv", "w_gate", "w_up"})
_ROW = frozenset({"wo", "w_down"})
_COL_BIAS = frozenset({"bq", "bk", "bv", "b_up"})


def leaf_spec(cfg: ModelConfig, path: Tuple[str, ...], ndim: int,
              tp: int) -> Optional[int]:
    """The dim of the leaf at ``path`` that shards over the TP axis, or
    ``None`` (replicated), by the Megatron rules of
    :func:`serve_param_specs`."""
    name, parent = path[-1], (path[-2] if len(path) >= 2 else "")
    if tp == 1 or ndim == 0:
        return None
    if parent == "embed" and ndim >= 2:
        return ndim - 2                    # (V, d): vocab-parallel rows
    if parent == "lm_head":
        return ndim - 1                    # (d, V): vocab-parallel columns
    if parent == "moe" and name in ("w_gate", "w_up", "w_down"):
        if cfg.moe.num_experts % tp == 0:
            return ndim - 3                # (E, a, b): expert-parallel
        return ndim - 1 if name in ("w_gate", "w_up") else ndim - 2
    if name == "router":
        return None
    if name in _COL and ndim >= 2:
        return ndim - 1
    if name in _ROW and ndim >= 2:
        return ndim - 2
    if name in _COL_BIAS:
        return ndim - 1
    return None


def _walk(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def serve_param_specs(cfg: ModelConfig, params, tp: int):
    """Each leaf's dim sharded over the TP axis, or ``None``: the tree of
    the reference's ``PartitionSpec``s, each reduced to where it names the
    axis.

    Megatron layout: wq/wk/wv/w_gate/w_up column-parallel, wo/w_down
    row-parallel, biases follow their matmul (b_down/bo replicated — added
    AFTER the partial-sum all-reduce). Embedding and lm_head are
    vocab-parallel, feeding the ``sample`` stream's psum/all-gather. MoE
    expert tables are expert-parallel over the TP axis when the expert
    count divides, else ff-TP within every expert. Norm scales and the
    router replicate.
    """
    return _walk(params, lambda path, leaf: leaf_spec(cfg, path, leaf.dim(),
                                                      tp))


def cut_leaf(t: torch.Tensor, dim: Optional[int], tp: int, index: int
             ) -> torch.Tensor:
    """Shard ``index`` of ``tp`` of ``t`` along ``dim`` (a copy), or ``t``
    itself when ``dim`` is ``None``."""
    if dim is None:
        return t
    n = t.shape[dim]
    if n % tp:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"over tp={tp}")
    return t.narrow(dim, index * (n // tp), n // tp).contiguous()


def param_sharder(cfg: ModelConfig, tp: int, index: int):
    """``init_params(..., shard=)``'s callback: each leaf cut to rank
    ``index``'s shard as soon as it is made."""
    return lambda path, leaf: cut_leaf(
        leaf, leaf_spec(cfg, path, leaf.dim(), tp), tp, index)


def shard_params(cfg: ModelConfig, params, tp: int, index: int):
    """Rank ``index``'s shard (along the TP axis) of a full param tree."""
    return _walk(params, param_sharder(cfg, tp, index))


def serve_cache_specs(paged: bool, batch: int, kv_heads: int, tp: int,
                      batch_shards: int) -> Dict[str, Tuple]:
    """Axis names of each dim of a stacked decode cache's K/V (``"kv"``)
    and, paged, its page table (``"table"``): KV heads over the TP axis,
    a contiguous cache's batch over ``data``.

    A paged pool is a SHARED resource — any slot may hold any page — so it
    cannot shard over the batch: pools replicate over data and shard only
    their KV heads; the page table and cursor replicate."""
    kv_ax = TP_AXIS if (tp > 1 and kv_heads % tp == 0) else None
    if paged:                                 # (L, NP, PS, KV, hd)
        return {"kv": (None, None, None, kv_ax, None), "table": (None, None)}
    b_ax = "data" if (batch_shards > 1 and batch % batch_shards == 0) \
        else None                             # (L, B, S, KV, hd)
    return {"kv": (None, b_ax, None, kv_ax, None)}


def local_size(n: int, axis: Optional[str], mesh: RankMesh) -> int:
    """A dim of ``n`` on one rank when sharded over ``axis`` (``"data"``:
    the data line, ``pod x data``)."""
    if axis is None:
        return n
    return n // (mesh.data_size if axis == "data" else mesh.shape[axis])
