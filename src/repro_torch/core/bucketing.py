"""Gradient bucketing onto VCI streams — the training-loop integration.

Port of ``repro.core.bucketing`` (the post-schedule, replicated-optimizer
half). A gradient tree is partitioned into B buckets; each bucket gets a
CommContext (communicator analogue), is packed into one flat buffer and
reduced over the data group on its VCI's process group, B reductions in
flight at once, then unpacked back into the tree.

Knobs of :func:`reduce_gradients`, as in the reference:

* ``staging="per_vci"`` — each bucket's reduction is issued as soon as that
  bucket is packed; ``"shared"`` packs every bucket into one staging buffer
  first and issues the reductions after (the reference's lock on a shared
  request pool: no reduction starts before every pack is done).
* ``pack="xla"`` — each bucket packed by concatenating its leaves
  (``torch.cat``) and unpacked by slicing. ``pack="pallas"`` — every leaf
  laid into one tile-aligned arena, each bucket packed by the tile-gather
  kernel (:func:`repro_torch.kernels.bucket_pack.bucket_pack`, one launch a
  bucket, written straight into its slice of one buffer that holds all
  buckets back to back) and, after the reductions, the whole buffer
  unpacked into arena layout by one :func:`~repro_torch.kernels.
  bucket_pack.bucket_unpack` launch. On CPU tensors those wrappers run
  their plain versions.
* ``reduction="all_reduce"`` — one in-place all-reduce a bucket;
  ``"reduce_scatter"`` — reduce_scatter, mean, all_gather on the same VCI
  (all_reduce for a bucket whose size does not divide the group).

A :class:`CommPlan` caches the plan, the CommWorld with one context per
bucket and the pack tables per (treedef, shapes, knobs); the ordering state
(:class:`~repro_torch.core.collectives.CommRuntime`) is per step.

ZeRO-1: ``reduce_gradients(output="shards")`` stops after each bucket's
reduce_scatter (at the wire dtype ``reduce_dtype``) and returns this
rank's f32 shard of every bucket with the :class:`ShardLayout`;
:func:`all_gather_shards` gathers updated shards back on the same
contexts and unpacks each bucket by slicing.

Bucket-ready overlap: :func:`overlap_boundaries` registers a gradient
hook on every param leaf; the hook that delivers a bucket's last leaf
gradient packs that bucket (per-slot copies, never the tile-gather
kernel, as the reference's boundary) and issues its reduce (or, with
``taps``, its reduce_scatter) on the bucket's VCI inside the backward,
from a fresh runtime a bucket, in :attr:`CommPlan.ready_order`.

On a ``(data, model)`` mesh (a :class:`CommPlan` given ``mesh`` with a
model axis) the buckets reduce over the data ranks only: each context's
VCI group spans this rank's data line (``vci_group(i, K, axis="data",
mesh=...)``), and the model ranks of a line are replicas. On a data-only
mesh nothing changes: the groups span the default group.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.collectives import (CommRuntime, RankMesh, Request,
                                          vci_group)
from repro_torch.core.comm import CommContext, CommWorld
from repro_torch.kernels.bucket_pack import TILE
from repro_torch.tree import tree_flatten, tree_unflatten


@dataclass(frozen=True)
class LeafSlot:
    index: int            # position in the flattened tree (JAX leaf order)
    shape: Tuple[int, ...]
    dtype: Any
    offset: int           # offset inside the bucket's flat buffer

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


@dataclass(frozen=True)
class Bucket:
    bid: int
    slots: Tuple[LeafSlot, ...]
    padded_size: int


@dataclass(frozen=True)
class BucketPlan:
    treedef: Any
    buckets: Tuple[Bucket, ...]
    align: int
    slot_align: Optional[int] = None  # per-slot alignment (pallas layout)

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)

    @property
    def total_padded(self) -> int:
        return sum(b.padded_size for b in self.buckets)

    @property
    def num_leaves(self) -> int:
        return sum(len(b.slots) for b in self.buckets)


def _round_up(n: int, align: int) -> int:
    return ((n + align - 1) // align) * align


@dataclass(frozen=True)
class ShardLayout:
    """Per-rank ownership of every bucket's flat buffer (the ZeRO-1 map):
    ``reduce_scatter`` over ``axis_size`` ranks gives rank ``r`` elements
    ``[r*S_b, (r+1)*S_b)`` of bucket ``b``, ``S_b = padded_size /
    axis_size``. Pure host arithmetic, the reference's verbatim."""

    plan: BucketPlan
    axis_size: int

    def __post_init__(self):
        if self.axis_size < 1:
            raise ValueError(f"axis_size must be >= 1, got {self.axis_size}")
        for b in self.plan.buckets:
            if b.padded_size % self.axis_size:
                raise ValueError(
                    f"bucket {b.bid} padded_size {b.padded_size} not "
                    f"divisible by axis_size {self.axis_size}; plan with "
                    f"align a multiple of the axis size (TILE covers any "
                    f"2^k mesh up to 1024)")

    @property
    def num_buckets(self) -> int:
        return self.plan.num_buckets

    @property
    def shard_sizes(self) -> Tuple[int, ...]:
        """Per-bucket local shard length (``padded_size / axis_size``)."""
        return tuple(b.padded_size // self.axis_size
                     for b in self.plan.buckets)

    def shard_bounds(self, bid: int) -> Tuple[Tuple[int, int], ...]:
        """[start, stop) of every rank's shard of bucket ``bid``."""
        s = self.plan.buckets[bid].padded_size // self.axis_size
        return tuple((r * s, (r + 1) * s) for r in range(self.axis_size))

    def owner_of(self, bid: int, offset: int) -> int:
        """The unique rank owning flat ``offset`` of bucket ``bid``."""
        b = self.plan.buckets[bid]
        if not 0 <= offset < b.padded_size:
            raise IndexError(f"offset {offset} outside bucket {bid} "
                             f"[0, {b.padded_size})")
        return offset // (b.padded_size // self.axis_size)

    def slot_owners(self, bid: int, slot: LeafSlot
                    ) -> Tuple[Tuple[int, int, int], ...]:
        """Partition of a slot's range into (rank, start, stop) pieces."""
        s = self.plan.buckets[bid].padded_size // self.axis_size
        out, cur = [], slot.offset
        end = slot.offset + slot.size
        while cur < end:
            r = cur // s
            stop = min(end, (r + 1) * s)
            out.append((r, cur, stop))
            cur = stop
        return tuple(out)

    @property
    def total_shard_elems(self) -> int:
        """Per-rank optimizer-state footprint in elements (the 1/N claim)."""
        return sum(self.shard_sizes)


def plan_buckets(tree, num_buckets: int, *, align: int = TILE,
                 slot_align: Optional[int] = None,
                 partition: str = "size") -> BucketPlan:
    """Partition a tree's leaves into buckets, as the reference does.

    ``partition="size"`` is the greedy size-balanced assignment (largest
    leaf first, ties by leaf index, into the least-loaded bucket);
    ``"contig"`` keeps leaves contiguous in leaf order with size-balanced
    split points. ``slot_align`` places every leaf at an aligned offset
    inside its bucket (the tile-gather kernel's layout contract).
    """
    if slot_align is not None and align % slot_align:
        raise ValueError(f"align {align} must be a multiple of slot_align "
                         f"{slot_align}")
    if partition not in ("size", "contig"):
        raise ValueError(f"unknown partition {partition!r}")
    leaves, treedef = tree_flatten(tree)
    sizes = [int(np.prod(tuple(l.shape))) if l.dim() else 1 for l in leaves]
    num_buckets = max(1, min(num_buckets, len(leaves)))
    members: List[List[int]] = [[] for _ in range(num_buckets)]
    if partition == "size":
        order = sorted(range(len(leaves)), key=lambda i: -sizes[i])
        loads = [0] * num_buckets
        for i in order:
            b = loads.index(min(loads))
            members[b].append(i)
            loads[b] += sizes[i]
    else:  # contig: balanced prefix splits of the leaf sequence
        total = sum(sizes)
        b, load = 0, 0
        for i in range(len(leaves)):
            left = len(leaves) - i
            if (b < num_buckets - 1 and members[b]
                    and (load >= total * (b + 1) / num_buckets
                         or left <= num_buckets - 1 - b)):
                b += 1
            members[b].append(i)
            load += sizes[i]
    buckets = []
    for bid, idxs in enumerate(members):
        slots, off = [], 0
        for i in sorted(idxs):
            if slot_align is not None:
                off = _round_up(off, slot_align)
            slots.append(LeafSlot(i, tuple(leaves[i].shape), leaves[i].dtype,
                                  off))
            off += sizes[i]
        buckets.append(Bucket(bid, tuple(slots), _round_up(max(off, 1),
                                                           align)))
    return BucketPlan(treedef, tuple(buckets), align, slot_align)


def bucket_ready_order(plan: BucketPlan,
                       leaf_use_order: Optional[Sequence[int]] = None
                       ) -> Tuple[int, ...]:
    """Buckets sorted by backward readiness: the bucket whose earliest-used
    leaf is used last in the forward is ready first (``leaf_use_order``
    lists leaf indices in forward use order; default: leaf order)."""
    if leaf_use_order is None:
        use = list(range(plan.num_leaves))
    else:
        if sorted(leaf_use_order) != list(range(plan.num_leaves)):
            raise ValueError("leaf_use_order must be a permutation of "
                             f"range({plan.num_leaves})")
        use = [0] * plan.num_leaves
        for pos, idx in enumerate(leaf_use_order):
            use[idx] = pos

    def earliest_use(b: Bucket) -> int:
        return min(use[s.index] for s in b.slots)
    return tuple(sorted(range(plan.num_buckets),
                        key=lambda bid: (-earliest_use(plan.buckets[bid]),
                                         bid)))


# ---------------------------------------------------------------------------
# pack / unpack — the concatenate / slice path (pack="xla")
# ---------------------------------------------------------------------------

def pack_bucket(leaves: Sequence[torch.Tensor], bucket: Bucket,
                dtype=torch.float32) -> torch.Tensor:
    """Pack a bucket's leaves into one flat, aligned buffer (``torch.cat``
    of the leaves and the zero gaps)."""
    parts = []
    cursor = 0
    dev = leaves[bucket.slots[0].index].device
    for s in bucket.slots:
        if s.offset < cursor:
            raise ValueError("slots must be non-overlapping, in order")
        if s.offset > cursor:  # slot-aligned layout: zero-fill the gap
            parts.append(torch.zeros((s.offset - cursor,), dtype=dtype,
                                     device=dev))
            cursor = s.offset
        parts.append(leaves[s.index].to(dtype).reshape(-1))
        cursor += s.size
    pad = bucket.padded_size - cursor
    if pad:
        parts.append(torch.zeros((pad,), dtype=dtype, device=dev))
    return torch.cat(parts)


def unpack_bucket(flat: torch.Tensor, bucket: Bucket
                  ) -> List[Tuple[int, torch.Tensor]]:
    """Inverse of pack: (leaf_index, value) pairs, each in its slot's
    shape and dtype (a view of ``flat`` where the dtype already agrees)."""
    return [(s.index, flat[s.offset:s.offset + s.size].reshape(s.shape)
             .to(s.dtype)) for s in bucket.slots]


def _pack_bucket_dma(leaves, bucket: Bucket, dtype) -> torch.Tensor:
    """The pallas layout written slot by slot: a zeroed buffer and one copy
    per slot at its aligned offset (the reference's per-slot
    dynamic_update_slice lowering). Equal to :func:`pack_bucket`."""
    buf = torch.zeros((bucket.padded_size,), dtype=dtype,
                      device=leaves[bucket.slots[0].index].device)
    for s in bucket.slots:
        buf[s.offset:s.offset + s.size].copy_(leaves[s.index].reshape(-1))
    return buf


# ---------------------------------------------------------------------------
# persistent comm plans
# ---------------------------------------------------------------------------

class CommPlan:
    """Everything hoistable out of the step, built once and reused: the
    ``BucketPlan``, the ``CommWorld`` with one CommContext per bucket (the
    VCI mapping) and, for the pallas pack, the host tile tables and their
    device copies. :meth:`runtime` returns a FRESH ``CommRuntime`` (the
    ordering state) for each step."""

    def __init__(self, plan: BucketPlan, *, num_vcis: int = 8,
                 vci_policy: str = "fcfs", progress: str = "hybrid",
                 join_every: int = 8, token_impl: str = "barrier",
                 schedule: str = "post", mesh: Optional[RankMesh] = None):
        if schedule not in ("post", "overlap"):
            raise ValueError(f"unknown schedule {schedule!r}")
        self.plan = plan
        self.world = CommWorld(num_vcis=num_vcis, policy=vci_policy)
        self.contexts: Tuple[CommContext, ...] = tuple(
            self.world.create(f"bucket{b.bid}", kind="p2p")
            for b in plan.buckets)
        self.progress = progress
        self.join_every = join_every
        self.token_impl = token_impl
        self.schedule = schedule
        # the buckets' groups span the data lines of a mesh with a model
        # axis, the default group otherwise
        self.mesh = mesh if mesh is not None and mesh.model > 1 else None
        self._tables = None
        self._device_tables: Dict[torch.device, tuple] = {}
        self._ready_order: Optional[Tuple[int, ...]] = None

    @property
    def ready_order(self) -> Tuple[int, ...]:
        """Bucket issue order for overlap scheduling (backward readiness,
        :func:`bucket_ready_order` of the plan)."""
        if self._ready_order is None:
            self._ready_order = bucket_ready_order(self.plan)
        return self._ready_order

    def runtime(self) -> CommRuntime:
        """A fresh per-step runtime bound to the cached world/contexts."""
        return CommRuntime(self.world, progress=self.progress,
                           join_every=self.join_every,
                           token_impl=self.token_impl, mesh=self.mesh,
                           data_axis=None if self.mesh is None else "data")

    @property
    def data_size(self) -> int:
        """Ranks the buckets reduce over (this rank's data line)."""
        return self.mesh.data_size if self.mesh is not None else \
            dist.get_world_size()

    def make_groups(self) -> None:
        """Create every VCI group the contexts can use, now (collective:
        every rank calls it at the same point)."""
        k = self.world.pool.num_vcis
        if self.mesh is None:
            vci_group(0, k)
        else:
            vci_group(k - 1, k, axis="data", mesh=self.mesh)

    @property
    def tables(self):
        """(tile, arena_offsets, arena_size, pack_tables, unpack_table),
        numpy, equal to the reference's. ``pack_tables[b]`` maps bucket
        ``b``'s tiles to arena tiles; ``unpack_table`` maps arena tiles
        into the concatenation of all reduced buckets."""
        if self._tables is None:
            from repro_torch.kernels.bucket_pack import (arena_layout,
                                                         build_tile_tables)
            plan = self.plan
            tile = plan.slot_align
            if tile is None:
                raise ValueError("the pallas pack path needs a slot-aligned "
                                 "plan (plan_buckets(..., slot_align=TILE))")
            sizes = [0] * plan.num_leaves
            for b in plan.buckets:
                for s in b.slots:
                    sizes[s.index] = s.size
            arena_offs, arena_size = arena_layout(sizes, tile)
            pack_tables = tuple(build_tile_tables(
                [arena_offs[s.index] for s in b.slots],
                [s.offset for s in b.slots],
                [s.size for s in b.slots], b.padded_size, tile)
                for b in plan.buckets)
            bases = np.cumsum([0] + [b.padded_size for b in plan.buckets])
            src, dst, szs = [], [], []
            for bi, b in enumerate(plan.buckets):
                for s in b.slots:
                    src.append(int(bases[bi]) + s.offset)
                    dst.append(int(arena_offs[s.index]))
                    szs.append(s.size)
            unpack_table = build_tile_tables(src, dst, szs, arena_size, tile)
            self._tables = (tile, arena_offs, arena_size, pack_tables,
                            unpack_table)
        return self._tables

    def device_tables(self, device: torch.device):
        """(pack_tables, unpack_table) as int32 tensors on ``device``,
        copied once per device."""
        device = torch.device(device)
        if device not in self._device_tables:
            _, _, _, pack_tables, unpack_table = self.tables

            def dev(pair):
                return tuple(torch.from_numpy(a).to(device) for a in pair)
            self._device_tables[device] = (
                tuple(dev(t) for t in pack_tables), dev(unpack_table))
        return self._device_tables[device]


_PLAN_CACHE: Dict[Any, CommPlan] = {}
_PLAN_CACHE_STATS = {"hits": 0, "misses": 0, "builds": 0}


def comm_plan_key(grads, *, num_streams: int, align: int,
                  slot_align: Optional[int], num_vcis: int, vci_policy: str,
                  progress: str, join_every: int, token_impl: str,
                  schedule: str = "post", mesh: Optional[RankMesh] = None):
    """Hashable cache key: tree structure + leaf shapes/dtypes + knobs."""
    leaves, treedef = tree_flatten(grads)
    shapes = tuple((tuple(l.shape), str(l.dtype)) for l in leaves)
    return (treedef, shapes, num_streams, align, slot_align, num_vcis,
            vci_policy, progress, join_every, token_impl, schedule, mesh)


def get_comm_plan(grads, *, num_streams: int = 8, align: int = TILE,
                  pack: str = "xla", num_vcis: int = 8,
                  vci_policy: str = "fcfs", progress: str = "hybrid",
                  join_every: int = 8, token_impl: str = "barrier",
                  schedule: str = "post",
                  persistent: bool = True,
                  mesh: Optional[RankMesh] = None) -> CommPlan:
    """Build (or fetch) the CommPlan for a gradient tree.
    ``persistent=True`` caches on (treedef, shapes, knobs);
    ``persistent=False`` rebuilds every call (the reference's ablation).
    ``schedule="overlap"`` plans use-order-contiguous buckets. ``mesh``
    with a model axis puts the buckets' groups on the data lines."""
    if mesh is not None and mesh.model == 1:
        mesh = None
    slot_align = align if pack == "pallas" else None
    key = comm_plan_key(grads, num_streams=num_streams, align=align,
                        slot_align=slot_align, num_vcis=num_vcis,
                        vci_policy=vci_policy, progress=progress,
                        join_every=join_every, token_impl=token_impl,
                        schedule=schedule, mesh=mesh)
    if persistent:
        cached = _PLAN_CACHE.get(key)
        if cached is not None:
            _PLAN_CACHE_STATS["hits"] += 1
            return cached
        _PLAN_CACHE_STATS["misses"] += 1
    partition = "contig" if schedule == "overlap" else "size"
    plan = plan_buckets(grads, num_streams, align=align,
                        slot_align=slot_align, partition=partition)
    cp = CommPlan(plan, num_vcis=num_vcis, vci_policy=vci_policy,
                  progress=progress, join_every=join_every,
                  token_impl=token_impl, schedule=schedule, mesh=mesh)
    _PLAN_CACHE_STATS["builds"] += 1
    if persistent:
        _PLAN_CACHE[key] = cp
    return cp


def plan_cache_stats() -> Dict[str, int]:
    return dict(_PLAN_CACHE_STATS, size=len(_PLAN_CACHE))


def plan_cache_clear() -> None:
    _PLAN_CACHE.clear()
    for k in _PLAN_CACHE_STATS:
        _PLAN_CACHE_STATS[k] = 0


# ---------------------------------------------------------------------------
# the bucketed reduction itself
# ---------------------------------------------------------------------------

def _issue_reduce(rt: CommRuntime, ctx, flat: torch.Tensor, *, n: int,
                  reduction: str, padded: int) -> Tuple[Request, bool]:
    """Issue the first collective of one bucket buffer's reduction: its
    reduce_scatter when ``reduction="reduce_scatter"`` and the bucket
    divides the group (returns True), else an in-place all_reduce."""
    if reduction == "reduce_scatter" and padded % n == 0:
        return rt.reduce_scatter(flat, ctx), True
    return rt.all_reduce(flat, ctx), False


def _gather_mean(rt: CommRuntime, ctx, req: Request, flat: torch.Tensor, *,
                 n: int, mean: bool) -> Request:
    """The second half after a reduce_scatter: wait for the shard, take
    the mean, all_gather it back into ``flat`` on the same context."""
    shard = rt.wait(req)
    if mean:
        shard.div_(n)
    return rt.all_gather(shard, ctx, out=flat)


def _reduce_flat(rt: CommRuntime, ctx, flat: torch.Tensor, *, n: int,
                 mean: bool, reduction: str, padded: int
                 ) -> Tuple[Request, bool]:
    """Issue one bucket buffer's reduction, whose result lands back in
    ``flat``: reduce_scatter, mean, all_gather when the bucket divides the
    group, else an in-place all_reduce. Returns the request and whether
    the mean's ``/ n`` is still to be applied after the wait (the
    all_reduce case: the sum is divided after it, as the reference does).
    The overlap boundaries issue the same ops in the same order."""
    req, scattered = _issue_reduce(rt, ctx, flat, n=n, reduction=reduction,
                                   padded=padded)
    if scattered:
        return _gather_mean(rt, ctx, req, flat, n=n, mean=mean), False
    return req, mean


def _shard_f32(rt: CommRuntime, req: Request, *, n: int, mean: bool
               ) -> torch.Tensor:
    """A bucket's reduce_scatter result as the f32 shard ZeRO-1 owns,
    divided by ``n`` in place when ``mean`` (the result is the request's
    own buffer, or its f32 copy)."""
    shard = rt.wait(req).float()
    return shard.div_(n) if mean else shard


def reduce_gradients(
    rt: CommRuntime,
    grads,
    plan: Union[BucketPlan, CommPlan],
    *,
    mean: bool = True,
    staging: str = "per_vci",
    reduce_dtype=torch.float32,
    pack: str = "xla",
    reduction: str = "all_reduce",
    output: str = "tree",
):
    """All-reduce a gradient tree over the data group on VCI streams and
    return the reduced tree (leaves in their own dtypes; ``reduce_dtype`` is
    the wire and staging dtype). See the module docstring for the knobs.
    One CommContext per bucket: the CommPlan's, or created here on the
    runtime's world for a bare ``BucketPlan``.

    ``output="shards"`` (with ``reduction="reduce_scatter"``) returns
    ``(shards, layout)`` instead: ``shards[b]`` is this rank's f32 slice of
    reduced bucket ``b`` (divided by N when ``mean``), ``layout`` the
    :class:`ShardLayout`, which raises when a bucket does not divide the
    group (no all_reduce fallback: ZeRO-1 owns exactly 1/N of each)."""
    if pack not in ("xla", "pallas"):
        raise ValueError(f"unknown pack impl {pack!r}")
    if reduction not in ("all_reduce", "reduce_scatter"):
        raise ValueError(f"unknown reduction {reduction!r}")
    if staging not in ("per_vci", "shared"):
        raise ValueError(f"unknown staging {staging!r}")
    if output not in ("tree", "shards"):
        raise ValueError(f"unknown output {output!r}")
    if output == "shards" and reduction != "reduce_scatter":
        raise ValueError("output='shards' requires reduction='reduce_scatter'")

    comm_plan = plan if isinstance(plan, CommPlan) else None
    bplan: BucketPlan = comm_plan.plan if comm_plan is not None else plan
    leaves, treedef = tree_flatten(grads)
    contexts = (comm_plan.contexts if comm_plan is not None else
                [rt.world.create(kind="p2p") for _ in bplan.buckets])
    n = rt.size
    dev = leaves[0].device
    bases = np.cumsum([0] + [b.padded_size for b in bplan.buckets]).tolist()
    layout = ShardLayout(bplan, n) if output == "shards" else None

    pending: List[Tuple[Request, bool]] = []

    def issue(bid: int, buf: torch.Tensor) -> None:
        if layout is not None:
            pending.append((rt.reduce_scatter(buf, contexts[bid]), False))
            return
        b = bplan.buckets[bid]
        pending.append(_reduce_flat(rt, contexts[bid], buf, n=n, mean=mean,
                                    reduction=reduction,
                                    padded=b.padded_size))

    # ---- pack (per_vci: each bucket's reduction issued right after it) ----
    if pack == "pallas":
        from repro_torch.kernels.bucket_pack import (arena_from_leaves,
                                                     bucket_pack,
                                                     bucket_unpack)
        cp = comm_plan if comm_plan is not None else CommPlan(bplan,
                                                              num_vcis=1)
        tile, arena_offs, arena_size, _, _ = cp.tables
        pack_tables, unpack_table = cp.device_tables(dev)
        arena, _ = arena_from_leaves(leaves, tile=tile, dtype=reduce_dtype)
        # every bucket packs into its slice of ONE buffer, so the unpack
        # reads the reduced buckets back to back without a concatenate
        staged = torch.empty((bplan.total_padded,), dtype=reduce_dtype,
                             device=dev)
        packed = []
        for bid, (b, (blk, val)) in enumerate(zip(bplan.buckets,
                                                  pack_tables)):
            buf = bucket_pack(arena, blk, val, b.padded_size, tile=tile,
                              out=staged[bases[bid]:bases[bid + 1]])
            if staging == "per_vci":
                issue(bid, buf)
            packed.append(buf)
        del arena
    else:
        packed = []
        for bid, b in enumerate(bplan.buckets):
            buf = pack_bucket(leaves, b, dtype=reduce_dtype)
            if staging == "per_vci":
                issue(bid, buf)
            packed.append(buf)
        if staging == "shared":
            staged = torch.cat(packed)
            packed = [staged[bases[i]:bases[i + 1]]
                      for i in range(len(packed))]
    if staging == "shared":
        for bid, buf in enumerate(packed):
            issue(bid, buf)

    if layout is not None:
        del packed
        return [_shard_f32(rt, req, n=n, mean=mean)
                for req, _ in pending], layout

    # ---- wait: every bucket's reduction is complete before any unpack ----
    for req, divide in pending:
        val = rt.wait(req)
        if divide:
            val.div_(n)

    # ---- unpack ----------------------------------------------------------
    out_leaves: List[Optional[torch.Tensor]] = [None] * len(leaves)
    if pack == "pallas":
        del packed
        out_arena = bucket_unpack(staged, *unpack_table, arena_size,
                                  tile=tile)
        del staged
        for i, leaf in enumerate(leaves):
            off = int(arena_offs[i])
            # a copy even where the dtypes match (f32 norm scales): a view
            # would keep the whole f32 arena alive through the update
            out_leaves[i] = out_arena[off:off + leaf.numel()].reshape(
                leaf.shape).to(leaf.dtype, copy=True)
    else:
        for flat, b in zip(packed, bplan.buckets):
            for idx, val in unpack_bucket(flat, b):
                out_leaves[idx] = val
    return tree_unflatten(treedef, out_leaves)


def all_gather_shards(rt: CommRuntime, shards: Sequence[torch.Tensor],
                      plan: Union[BucketPlan, CommPlan], *, wire_dtype=None,
                      order: Optional[Sequence[int]] = None):
    """Rebuild the full tree from this rank's bucket shards (ZeRO-1 step
    3): each bucket's shard, cast to ``wire_dtype`` when given, is
    all-gathered on the same context its reduce_scatter used (the
    CommPlan's), every gather issued before any is waited, in ``order``
    (default bucket id); each gathered bucket is unpacked by slicing, the
    leaves cast to their slots' dtypes."""
    comm_plan = plan if isinstance(plan, CommPlan) else None
    bplan: BucketPlan = comm_plan.plan if comm_plan is not None else plan
    contexts = (comm_plan.contexts if comm_plan is not None else
                [rt.world.create(kind="p2p") for _ in bplan.buckets])
    if order is None:
        order = range(bplan.num_buckets)
    reqs = []
    for bid in order:
        shard = shards[bid]
        if wire_dtype is not None:
            shard = shard.to(wire_dtype)
        reqs.append((bid, rt.all_gather(shard, contexts[bid])))
    out_leaves: List[Optional[torch.Tensor]] = [None] * bplan.num_leaves
    for bid, req in reqs:
        for idx, val in unpack_bucket(rt.wait(req), bplan.buckets[bid]):
            out_leaves[idx] = val
    return tree_unflatten(bplan.treedef, out_leaves)


class OverlapBoundaries:
    """The hooked params of one backward (see :func:`overlap_boundaries`).

    ``params`` is the tree to run the loss on and ``leaves`` its leaves,
    the tensors to differentiate; ``issued`` lists the bucket ids in the
    order their reduces were issued, and ``hooks_seen[b]`` how many leaf
    gradients had arrived when bucket ``b`` was issued. :meth:`wait` (after
    the backward) waits on every bucket and returns the reduced gradient
    tree, or, with taps, the taps holding the shards."""

    def __init__(self, cp: CommPlan, leaves, treedef, *, taps, carry,
                 accum_steps: int, mean: bool, pack: str, reduction: str,
                 reduce_dtype):
        self.cp = cp
        self.leaves = leaves
        self.params = tree_unflatten(treedef, leaves)
        self.taps = taps
        self._carry = carry
        self._accum = accum_steps
        self._kw = dict(mean=mean, pack=pack, reduction=reduction,
                        reduce_dtype=reduce_dtype)
        plan = cp.plan
        self._bucket_of = {s.index: b.bid for b in plan.buckets
                           for s in b.slots}
        self._grads: Dict[int, torch.Tensor] = {}
        self._missing = [len(b.slots) for b in plan.buckets]
        self._next = 0                      # position in cp.ready_order
        self._seen = 0                      # leaf gradients arrived
        self._pending: Dict[int, tuple] = {}
        self._n = cp.data_size
        self.issued: List[int] = []
        self.hooks_seen: Dict[int, int] = {}
        # the hooks hold this object and it holds the leaves: wait()
        # removes them, so that the cycle does not keep the taps and the
        # carry alive until the garbage collector runs
        self._handles = [leaf.register_hook(self._hook(i))
                         for i, leaf in enumerate(leaves)]

    def _hook(self, index: int):
        def hook(grad: torch.Tensor) -> None:
            self._grads[index] = grad
            self._seen += 1
            self._missing[self._bucket_of[index]] -= 1
            order = self.cp.ready_order
            # issue in ready order: every rank issues the buckets that
            # share a VCI in one order, whatever order the hooks run in
            while self._next < len(order) and \
                    self._missing[order[self._next]] == 0:
                self._issue(order[self._next])
                self._next += 1
        return hook

    def _issue(self, bid: int) -> None:
        b = self.cp.plan.buckets[bid]
        vals: Dict[int, torch.Tensor] = {}
        for s in b.slots:
            ct = self._grads.pop(s.index)
            if self._carry is not None:
                ct = (self._carry[s.index] + ct.float() / self._accum
                      ).to(s.dtype)
            vals[s.index] = ct
        dtype = self._kw["reduce_dtype"]
        flat = (_pack_bucket_dma(vals, b, dtype) if self._kw["pack"] ==
                "pallas" else pack_bucket(vals, b, dtype=dtype))
        rt = self.cp.runtime()       # per-stream ordering only
        ctx = self.cp.contexts[bid]
        if self.taps is not None:
            # an f32 wire scatters straight into the tap
            tap = self.taps[bid]
            req = rt.reduce_scatter(flat, ctx, out=tap if tap.dtype ==
                                    flat.dtype else None)
            scattered = True
        else:
            req, scattered = _issue_reduce(
                rt, ctx, flat, n=self._n, reduction=self._kw["reduction"],
                padded=b.padded_size)
        self._pending[bid] = (rt, req, scattered, flat)
        self.hooks_seen[bid] = self._seen
        self.issued.append(bid)

    def wait(self):
        """Wait on every bucket's reduction (in issue order); the reduced
        mean-gradient tree, or the taps filled with the f32 shards."""
        plan = self.cp.plan
        if len(self.issued) != plan.num_buckets:
            raise RuntimeError(
                f"{len(self.issued)} of {plan.num_buckets} buckets were "
                f"issued: a param leaf got no gradient in the backward")
        for h in self._handles:
            h.remove()
        self._handles, self._carry = [], None
        n, mean = self._n, self._kw["mean"]
        if self.taps is not None:
            for bid in self.issued:
                rt, req, _, _ = self._pending.pop(bid)
                shard = _shard_f32(rt, req, n=n, mean=mean)
                if shard is not self.taps[bid]:
                    self.taps[bid].copy_(shard)
            return self.taps
        out: List[Optional[torch.Tensor]] = [None] * plan.num_leaves
        for bid in self.issued:
            rt, req, scattered, flat = self._pending.pop(bid)
            ctx = self.cp.contexts[bid]
            if scattered:
                req = _gather_mean(rt, ctx, req, flat, n=n, mean=mean)
            val = rt.wait(req)
            if mean and not scattered:
                val.div_(n)
            for idx, leaf in unpack_bucket(val, plan.buckets[bid]):
                out[idx] = leaf
        return tree_unflatten(plan.treedef, out)


def overlap_boundaries(cp: CommPlan, params, *,
                       taps: Optional[Sequence[torch.Tensor]] = None,
                       carry=None, accum_steps: int = 1, mean: bool = True,
                       pack: str = "xla", reduction: str = "all_reduce",
                       reduce_dtype=torch.float32) -> OverlapBoundaries:
    """Hook ``params`` so that every bucket's gradient reduce is issued
    INSIDE the backward, on the bucket's VCI, as soon as the bucket's last
    leaf gradient exists (bucket-ready hooks, PyTorch-DDP style).

    Returns an :class:`OverlapBoundaries`: run the loss on its ``params``,
    differentiate with respect to its ``leaves`` (only ``Tensor`` hooks
    fire under ``torch.autograd.grad``), then call its ``wait()`` for the
    mean-reduced gradients; the gradients autograd returns are this rank's
    own, not reduced. The reduces are not waited on inside the hooks.
    With ``taps`` (ZeRO-1: one f32 tensor of shard size a bucket, see
    :class:`ShardLayout`) each hook issues the bucket's reduce_scatter at
    the wire dtype ``reduce_dtype`` instead, and ``wait()`` fills each tap
    with this rank's mean-reduced f32 shard, as ``reduce_gradients(...,
    output="shards")`` returns it.

    ``carry`` (microbatch accumulation): the f32 sum of the earlier
    microbatches' gradients, each divided by ``accum_steps`` (a tree like
    ``params``); each hook folds it in as ``carry + ct.float() /
    accum_steps`` cast to the leaf dtype, the post schedule's arithmetic,
    so only the last microbatch's backward carries hooks. Every VCI group
    is created here, before the backward: ``new_group`` is collective, and
    on the card the hooks run on the autograd engine's device thread."""
    leaves, treedef = tree_flatten(params)
    if treedef != cp.plan.treedef:
        raise ValueError("params tree does not match the CommPlan's tree")
    if pack not in ("xla", "pallas"):
        raise ValueError(f"unknown pack impl {pack!r}")
    if reduction not in ("all_reduce", "reduce_scatter"):
        raise ValueError(f"unknown reduction {reduction!r}")
    if taps is not None:
        layout = ShardLayout(cp.plan, cp.data_size)
        if [tuple(t.shape) for t in taps] != \
                [(s,) for s in layout.shard_sizes]:
            raise ValueError(f"need one f32 tap of shard size a bucket "
                             f"{layout.shard_sizes}")
    carry_leaves = None
    if carry is not None:
        carry_leaves, carry_def = tree_flatten(carry)
        if carry_def != treedef:
            raise ValueError("carry tree does not match the params tree")
    cp.make_groups()                        # every VCI group, made now
    leaves = [p.detach().requires_grad_() for p in leaves]
    return OverlapBoundaries(cp, leaves, treedef, taps=taps,
                             carry=carry_leaves, accum_steps=accum_steps,
                             mean=mean, pack=pack, reduction=reduction,
                             reduce_dtype=reduce_dtype)
