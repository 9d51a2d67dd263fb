"""AdamW with dtype-configurable moments and global-norm clipping (port of
``repro.optim.adamw``): the replicated update and the ZeRO-1 sharded one.

The math is the reference's: float32 arithmetic, b2 = 0.95, decoupled
weight decay on matrices only (``ndim >= 2``), each result cast back to
its tensor's dtype. Unlike the reference's pure functions, the updates
are done IN PLACE on the params (the f32 master shards) and the moments
(the returned trees hold the same tensors), so a full-width step does not
hold a second copy of them.

The replicated update walks each leaf in slices of at most
``_UPDATE_CHUNK`` elements and applies the clip's scale there, so its f32
temporaries stay a slice's size and no clipped copy of the gradient tree
is made (every op is elementwise: the same bits as whole-leaf math and a
clipped tree). A full-width step's largest leaf (805 M elements in
mixtral-8x22b and musicgen-large) would otherwise hold ≈19 GB of them.

ZeRO-1 keeps the state in flat bucket space (a :class:`~repro_torch.core.
bucketing.BucketPlan`'s padded buffers) and each rank holds only its
``1/N`` shard of every bucket (the reference stores the global buffers
under a ``P(data)`` spec; here :func:`sharded_adamw_init` builds the
rank's shard alone).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.bucketing import BucketPlan, ShardLayout
from repro_torch.tree import tree_flatten, tree_leaves, tree_map


# elements of a leaf updated at once (f32 temporaries of 256 MiB each)
_UPDATE_CHUNK = 1 << 26


class AdamWState(NamedTuple):
    m: Any
    v: Any
    count: torch.Tensor   # int32 scalar


def adamw_init(params, moment_dtype=torch.float32) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
    dev = tree_leaves(params)[0].device
    return AdamWState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                      count=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(tree, sharded: Optional[Sequence[Any]] = None,
                psum: Optional[Callable[[Dict[Any, torch.Tensor]],
                                        torch.Tensor]] = None
                ) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, summed leaf
    by leaf in the reference's leaf order.

    Over sliced leaves (``sharded[i]``: falsy where every rank holds leaf
    ``i`` whole, else a key naming the ranks it is split over, e.g.
    ``"data"``, ``"model"``, ``"both"``) each key's squares are summed
    here and ``psum`` takes ``{key: partial sum}`` to the sum of every
    key's squares over the ranks that split it, each element counted once;
    the whole leaves' squares, equal on every rank, are added once."""
    leaves = tree_leaves(tree)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    if sharded is None:
        for l in leaves:
            total = total + torch.sum(torch.square(l.float()))
        return torch.sqrt(total)
    parts: Dict[Any, torch.Tensor] = {}
    for l, s in zip(leaves, sharded):
        sq = torch.sum(torch.square(l.float()))
        if s:
            parts[s] = parts.get(s, torch.zeros_like(total)) + sq
        else:
            total = total + sq
    return torch.sqrt(psum(parts) + total)


def _chunks(t: torch.Tensor):
    """``t``'s elements as views of at most ``_UPDATE_CHUNK`` each (in-place
    writes reach ``t``; a tensor that cannot be viewed flat raises)."""
    return t.view(-1).split(_UPDATE_CHUNK)


@torch.no_grad()
def adamw_update(
    grads,
    state: AdamWState,
    params,
    *,
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    max_grad_norm: Optional[float] = 1.0,
    sharded: Optional[Sequence[bool]] = None,
    psum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[Any, AdamWState, dict]:
    """One AdamW step. Writes the new params and moments into ``params``,
    ``state.m`` and ``state.v`` and returns them with the new count.

    The FSDP update (``comm="gspmd"`` over a ``(data, model)`` mesh):
    params, grads and moments are this rank's slices of the leaves that
    ``sharded`` marks, whole copies of the rest; ``psum`` sums the sliced
    leaves' squares over the ranks for the clip's global norm
    (:func:`global_norm`). Everything else is
    elementwise, and weight decay keeps the leaf's rule (``ndim >= 2``:
    a slice has its leaf's rank)."""
    gnorm = global_norm(grads, sharded, psum)
    scale = None if max_grad_norm is None else torch.clamp(
        max_grad_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    count = state.count + 1
    cf = count.float()
    c1 = 1.0 - torch.tensor(b1, dtype=torch.float32, device=cf.device) ** cf
    c2 = 1.0 - torch.tensor(b2, dtype=torch.float32, device=cf.device) ** cf
    lr = torch.as_tensor(lr, dtype=torch.float32, device=cf.device)

    flat_g, treedef = tree_flatten(grads)
    flat_m, m_def = tree_flatten(state.m)
    flat_v, v_def = tree_flatten(state.v)
    flat_p, p_def = tree_flatten(params)
    if not treedef == m_def == v_def == p_def:
        raise ValueError("grads, moments and params differ in structure")
    for g, m, v, p in zip(flat_g, flat_m, flat_v, flat_p):
        decay = p.dim() >= 2  # decoupled weight decay on matrices only
        for gc, mc, vc, pc in zip(g.reshape(-1).split(_UPDATE_CHUNK),
                                  _chunks(m), _chunks(v), _chunks(p)):
            gf = gc.float()
            if scale is not None:   # the clipped gradient, in g's dtype
                gf = (gf * scale).to(g.dtype).float()
            mf = mc.float() * b1 + gf * (1 - b1)
            vf = vc.float() * b2 + torch.square(gf) * (1 - b2)
            step = (mf / c1) / (torch.sqrt(vf / c2) + eps)
            if decay:
                step = step + weight_decay * pc.float()
            pc.copy_(pc.float() - lr * step)
            mc.copy_(mf)
            vc.copy_(vf)
    return params, AdamWState(state.m, state.v, count), {"grad_norm": gnorm}


# ---------------------------------------------------------------------------
# ZeRO-1: sharded AdamW in flat bucket space
# ---------------------------------------------------------------------------

class ShardedAdamWState(NamedTuple):
    """ZeRO-1 optimizer state of one rank: per-bucket 1-D shards (bucket
    ``b``'s ``[r*S_b, (r+1)*S_b)``, ``S_b = padded_size / N``). ``master``
    is the f32 master copy of the packed params, the source of truth for
    the update; the param tree is its gathered, leaf-dtype view."""

    m: Tuple[torch.Tensor, ...]
    v: Tuple[torch.Tensor, ...]
    master: Tuple[torch.Tensor, ...]
    count: torch.Tensor   # int32 scalar


def bucket_decay_masks(plan: BucketPlan) -> Tuple[np.ndarray, ...]:
    """Per-bucket f32 masks carrying the per-leaf weight-decay rule into
    flat space: 1.0 on elements of ``ndim >= 2`` leaves, 0.0 on vector and
    scalar leaves and on alignment padding (the reference's)."""
    masks = []
    for b in plan.buckets:
        mask = np.zeros((b.padded_size,), np.float32)
        for s in b.slots:
            if len(s.shape) >= 2:
                mask[s.offset:s.offset + s.size] = 1.0
        masks.append(mask)
    return tuple(masks)


def _shard_pieces(plan: BucketPlan, bid: int, axis_size: int, rank: int):
    """(slot, start, stop) for every slot of bucket ``bid`` that overlaps
    ``rank``'s shard, in bucket offsets."""
    b = plan.buckets[bid]
    size = b.padded_size // axis_size
    lo, hi = rank * size, (rank + 1) * size
    for s in b.slots:
        start, stop = max(lo, s.offset), min(hi, s.offset + s.size)
        if start < stop:
            yield s, start, stop


def shard_decay_masks(plan: BucketPlan, axis_size: int, rank: int,
                      device=None) -> Tuple[torch.Tensor, ...]:
    """``rank``'s shard of each :func:`bucket_decay_masks` mask, as bool
    tensors on ``device``, made without the full masks."""
    layout = ShardLayout(plan, axis_size)
    out = []
    for bid, size in enumerate(layout.shard_sizes):
        mask = torch.zeros((size,), dtype=torch.bool, device=device)
        for s, start, stop in _shard_pieces(plan, bid, axis_size, rank):
            if len(s.shape) >= 2:
                mask[start - rank * size:stop - rank * size] = True
        out.append(mask)
    return tuple(out)


@torch.no_grad()
def sharded_adamw_init(params, plan: BucketPlan, moment_dtype=torch.float32,
                       *, axis_size: int = 1, rank: int = 0
                       ) -> ShardedAdamWState:
    """``rank``'s ZeRO-1 state over ``axis_size`` ranks: its shard of the
    f32 master (the packed params, zero on padding) and zero moments. Only
    the shards are allocated; with ``axis_size=1`` the shard is the
    reference's global buffer."""
    leaves, treedef = tree_flatten(params)
    if treedef != plan.treedef:
        raise ValueError("params tree does not match the bucket plan's tree")
    layout = ShardLayout(plan, axis_size)
    dev = leaves[0].device
    master = []
    for bid, size in enumerate(layout.shard_sizes):
        buf = torch.zeros((size,), dtype=torch.float32, device=dev)
        for s, start, stop in _shard_pieces(plan, bid, axis_size, rank):
            src = leaves[s.index].reshape(-1)[start - s.offset:
                                              stop - s.offset]
            buf[start - rank * size:stop - rank * size].copy_(src)
        master.append(buf)
    zeros = [torch.zeros((size,), dtype=moment_dtype, device=dev)
             for size in layout.shard_sizes]
    return ShardedAdamWState(
        m=tuple(zeros), v=tuple(torch.zeros_like(z) for z in zeros),
        master=tuple(master),
        count=torch.zeros((), dtype=torch.int32, device=dev))


@torch.no_grad()
def sharded_adamw_bucket_update(
    g: torch.Tensor,
    m: torch.Tensor,
    v: torch.Tensor,
    master: torch.Tensor,
    decay_mask: torch.Tensor,
    *,
    lr,
    count: torch.Tensor,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """AdamW on ONE bucket's owned shard, written into ``master``, ``m``
    and ``v``, which it returns. ``g`` is already mean-reduced and
    clip-scaled (f32); ``count`` is the incremented step count."""
    cf = count.float()
    c1 = 1.0 - torch.tensor(b1, dtype=torch.float32, device=cf.device) ** cf
    c2 = 1.0 - torch.tensor(b2, dtype=torch.float32, device=cf.device) ** cf
    wd = decay_mask.float()
    mf = m.float() * b1 + g * (1 - b1)
    vf = v.float() * b2 + torch.square(g) * (1 - b2)
    step = (mf / c1) / (torch.sqrt(vf / c2) + eps) + \
        weight_decay * wd * master
    master.copy_(master - lr * step)
    m.copy_(mf)
    v.copy_(vf)
    return master, m, v


@torch.no_grad()
def sharded_adamw_update(
    grad_shards: Sequence[torch.Tensor],
    state: ShardedAdamWState,
    *,
    lr,
    layout: ShardLayout,
    decay_masks: Sequence[torch.Tensor],
    psum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    max_grad_norm: Optional[float] = 1.0,
    bucket_order: Optional[Sequence[int]] = None,
) -> Tuple[Tuple[torch.Tensor, ...], ShardedAdamWState, dict]:
    """AdamW on this rank's shard of every bucket. ``grad_shards[b]`` is
    the rank's mean-reduced shard of bucket ``b``, ``decay_masks[b]`` its
    shard of the decay mask, ``psum`` sums a scalar over the ranks (the
    cross-shard half of the global-norm clip). Returns the updated f32
    master shards (for the param all_gather), the state and
    ``{"grad_norm"}``. ``bucket_order`` sets the order of the per-bucket
    updates (default bucket id; the overlap step passes
    ``CommPlan.ready_order``); results stay indexed by bucket id."""
    if psum is None:
        psum = lambda x: x  # noqa: E731
    shard_sizes = layout.shard_sizes
    grads = [g.float() for g in grad_shards]
    for bid, (g, wd) in enumerate(zip(grads, decay_masks)):
        expect = (shard_sizes[bid],)
        if tuple(g.shape) != expect or tuple(wd.shape) != expect:
            raise ValueError(
                f"bucket {bid}: grad shard {tuple(g.shape)} / decay mask "
                f"{tuple(wd.shape)} do not match the layout shard {expect}")
    # the shards tile the buckets and padding is zero, so this is the
    # replicated tree-wise norm up to summation order
    sumsq = sum(torch.sum(torch.square(g)) for g in grads)
    gnorm = torch.sqrt(psum(sumsq))
    scale = None
    if max_grad_norm is not None:
        scale = torch.clamp(max_grad_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    count = state.count + 1
    lr = torch.as_tensor(lr, dtype=torch.float32, device=count.device)
    for bid in (range(len(grads)) if bucket_order is None
                else bucket_order):
        g = grads[bid] if scale is None else grads[bid] * scale
        sharded_adamw_bucket_update(
            g, state.m[bid], state.v[bid], state.master[bid],
            decay_masks[bid], lr=lr, count=count, b1=b1, b2=b2, eps=eps,
            weight_decay=weight_decay)
    new_state = ShardedAdamWState(state.m, state.v, state.master, count)
    return state.master, new_state, {"grad_norm": gnorm}
