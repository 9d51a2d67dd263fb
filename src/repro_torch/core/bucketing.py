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

``output="shards"``, :func:`all_gather_shards` (ZeRO-1, ROADMAP.md Queue 1
item 7) and :func:`overlap_boundaries` (bucket-ready overlap, item 8) are
later slices and raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.collectives import CommRuntime, Request
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
                 schedule: str = "post"):
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
        self._tables = None
        self._device_tables: Dict[torch.device, tuple] = {}

    def runtime(self) -> CommRuntime:
        """A fresh per-step runtime bound to the cached world/contexts."""
        return CommRuntime(self.world, progress=self.progress,
                           join_every=self.join_every,
                           token_impl=self.token_impl)

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
                  schedule: str = "post"):
    """Hashable cache key: tree structure + leaf shapes/dtypes + knobs."""
    leaves, treedef = tree_flatten(grads)
    shapes = tuple((tuple(l.shape), str(l.dtype)) for l in leaves)
    return (treedef, shapes, num_streams, align, slot_align, num_vcis,
            vci_policy, progress, join_every, token_impl, schedule)


def get_comm_plan(grads, *, num_streams: int = 8, align: int = TILE,
                  pack: str = "xla", num_vcis: int = 8,
                  vci_policy: str = "fcfs", progress: str = "hybrid",
                  join_every: int = 8, token_impl: str = "barrier",
                  schedule: str = "post",
                  persistent: bool = True) -> CommPlan:
    """Build (or fetch) the CommPlan for a gradient tree.
    ``persistent=True`` caches on (treedef, shapes, knobs);
    ``persistent=False`` rebuilds every call (the reference's ablation).
    ``schedule="overlap"`` plans use-order-contiguous buckets."""
    slot_align = align if pack == "pallas" else None
    key = comm_plan_key(grads, num_streams=num_streams, align=align,
                        slot_align=slot_align, num_vcis=num_vcis,
                        vci_policy=vci_policy, progress=progress,
                        join_every=join_every, token_impl=token_impl,
                        schedule=schedule)
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
                  token_impl=token_impl, schedule=schedule)
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

def _reduce_flat(rt: CommRuntime, ctx, flat: torch.Tensor, *, n: int,
                 mean: bool, reduction: str, padded: int
                 ) -> Tuple[Request, bool]:
    """Issue one bucket buffer's reduction, whose result lands back in
    ``flat``: reduce_scatter, mean, all_gather when the bucket divides the
    group, else an in-place all_reduce. Returns the request and whether
    the mean's ``/ n`` is still to be applied after the wait (the
    all_reduce case: the sum is divided after it, as the reference does)."""
    if reduction == "reduce_scatter" and padded % n == 0:
        shard = rt.wait(rt.reduce_scatter(flat, ctx))
        if mean:
            shard.div_(n)
        return rt.all_gather(shard, ctx, out=flat), False
    return rt.all_reduce(flat, ctx), mean


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
    runtime's world for a bare ``BucketPlan``."""
    if pack not in ("xla", "pallas"):
        raise ValueError(f"unknown pack impl {pack!r}")
    if reduction not in ("all_reduce", "reduce_scatter"):
        raise ValueError(f"unknown reduction {reduction!r}")
    if staging not in ("per_vci", "shared"):
        raise ValueError(f"unknown staging {staging!r}")
    if output == "shards":
        raise NotImplementedError(
            "reduce_gradients(output='shards') is ZeRO-1, ROADMAP.md Queue 1 "
            "item 7 (not ported yet)")
    if output != "tree":
        raise ValueError(f"unknown output {output!r}")

    comm_plan = plan if isinstance(plan, CommPlan) else None
    bplan: BucketPlan = comm_plan.plan if comm_plan is not None else plan
    leaves, treedef = tree_flatten(grads)
    contexts = (comm_plan.contexts if comm_plan is not None else
                [rt.world.create(kind="p2p") for _ in bplan.buckets])
    n = rt.size
    dev = leaves[0].device
    bases = np.cumsum([0] + [b.padded_size for b in bplan.buckets]).tolist()

    pending: List[Tuple[Request, bool]] = []

    def issue(bid: int, buf: torch.Tensor) -> None:
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
            out_leaves[i] = out_arena[off:off + leaf.numel()].reshape(
                leaf.shape).to(leaf.dtype)
    else:
        for flat, b in zip(packed, bplan.buckets):
            for idx, val in unpack_bucket(flat, b):
                out_leaves[idx] = val
    return tree_unflatten(treedef, out_leaves)


def overlap_boundaries(*a, **kw):
    raise NotImplementedError(
        "overlap_boundaries (schedule='overlap', bucket-ready overlap) is "
        "ROADMAP.md Queue 1 item 8 (not ported yet)")


def all_gather_shards(*a, **kw):
    raise NotImplementedError(
        "all_gather_shards (ZeRO-1 param gather) is ROADMAP.md Queue 1 "
        "item 7 (not ported yet)")
