"""Attention: GQA/MQA, causal + sliding-window masks, KV-cache decode.

Port of ``repro.models.attention``: full (prefill/train) attention with
the per-row ``start`` pad mask through the flash-attention kernel, and
three decode cache layouts:

* the contiguous cache ``(B, S_max, KV, hd)`` with a write cursor;
* the ring cache ``(B, W, KV, hd)`` of a sliding-window arch whose window
  ``W`` is shorter than ``max_len``: slot ``i`` holds the newest position
  congruent to ``i`` modulo ``W``, so decode runs in O(W) memory at any
  context length;
* the paged cache (page pool + per-slot page table).

A contiguous or ring cache may hold one rank's slice of the sequence
(:class:`SeqSplit`, the GSPMD serve route's layout where the KV heads do
not divide the model axis or the batch does not divide the data line):
the rank writes only the positions its slice holds and attends them with
:func:`partial_attention`; one gather of every shard's ``(out, max,
sum-exp)`` a layer and :func:`combine_partials` give the attention over
the whole sequence.

Caches are updated IN PLACE (``index_put_`` / slice assignment into the
cache tensors) where the reference returns new arrays from donated inputs;
each update function still returns a cache object carrying the advanced
write cursor, so call sites read like the reference's. The cursor
(``length``) is a host ``int``: the engine drives it from the host anyway.

``decode_kv_expand = e > 1`` stores each KV head ``e`` times (so that the
stored heads divide a TP degree): incoming K/V heads are repeated to the
cache's count before every write, a pure layout change.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import (NEG_INF, flash_attention,
                                                  repeat_kv)
from repro_torch.kernels.paged_kv import paged_gather


def attention(cfg: ModelConfig, q, k, v, *,
              start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full (prefill/train) attention. q: (B,Sq,H,hd), k/v: (B,Skv,KV,hd),
    with the causal (and sliding-window) mask.

    ``start`` — (B,) int32 left-pad lengths — masks each row's pad prefix
    (key positions ``< start[b]``). Runs
    :func:`repro_torch.kernels.flash_attention.flash_attention`: the CUDA
    kernel on the card, the reference's materialising math on the CPU.
    """
    return flash_attention(q, k, v, causal=True, window=cfg.sliding_window,
                           start=start)


# ---------------------------------------------------------------------------
# contiguous KV cache
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SeqSplit:
    """A cache whose sequence is split into ``count`` equal slices over
    ranks: this rank holds slice ``index`` (positions ``[index * n,
    (index + 1) * n)`` of the cache's ``S``, ``n`` its local length).
    ``comm`` joins one tensor of every slice's rank along a dim, in slice
    order (``all_gather(x, gather_axis=)``, a
    :class:`repro_torch.dist.tp.LineComm`)."""

    index: int
    count: int
    comm: Any


class KVCache:
    """KV cache ``(B, S_cache, KV, hd)`` (or layer-stacked ``(L, B,
    S_cache, KV, hd)``) with a host write cursor. ``S_cache`` is
    ``max_len``, or the window ``W`` of a ``ring`` cache; under ``split``
    (a :class:`SeqSplit`) the tensors hold this rank's ``S_cache /
    split.count`` of it."""

    def __init__(self, k, v, length: int, ring: bool = False,
                 split: Optional[SeqSplit] = None):
        self.k = k
        self.v = v
        self.length = int(length)   # tokens written so far (absolute)
        self.ring = bool(ring)
        self.split = split

    def span(self) -> Tuple[int, int]:
        """``(lo, S_cache)``: the first cache position this rank holds, and
        the whole cache's length (over every slice)."""
        n = self.k.shape[-3]
        if self.split is None:
            return 0, n
        return self.split.index * n, n * self.split.count


def is_ring(cfg: ModelConfig, max_len: int) -> bool:
    """Whether ``cfg`` decodes through a ring cache at ``max_len``: its
    sliding window is shorter than the cache would be."""
    w = cfg.sliding_window
    return w is not None and w < max_len


# the largest finite float8_e4m3fn
FP8_MAX = 448.0


def to_cache_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` cast to a cache's ``dtype``: every K/V write goes through it.
    A ``float8_e4m3fn`` cache (``kv_fp8``) saturates: a value past e4m3's
    range stores +-448 on every device and torch build. torch's own cast
    does not agree across builds (2.13's CPU cast saturates; 2.11's, on
    the CPU and on a card, gives NaN from 466 up, as the reference's
    ``ml_dtypes`` cast does), so the clamp comes first; within the range
    the clamp changes nothing and the cast rounds as everywhere."""
    if dtype == torch.float8_e4m3fn and x.dtype != dtype:
        x = x.clamp(-FP8_MAX, FP8_MAX)
    return x.to(dtype)


def kv_cache_shape(cfg: ModelConfig, batch: int, max_len: int):
    """``(B, S_cache, KV, hd)``: ``S_cache`` is the window for a ring
    cache (:func:`is_ring`), else ``max_len``."""
    s = cfg.sliding_window if is_ring(cfg, max_len) else max_len
    return (batch, s, _stored_kv_heads(cfg), cfg.head_dim)


def _stored_kv_heads(cfg: ModelConfig) -> int:
    return cfg.num_kv_heads * max(1, cfg.decode_kv_expand)


def _expand_heads(k_new, kv_stored: int):
    """OPT(decode_cache): the cache may store each KV head ``e`` times (so
    stored heads == TP degree and attention shards losslessly); expand the
    incoming head dim (axis 2 of (B,S,KV,hd)) to match."""
    kv_n = k_new.shape[2]
    if kv_stored == kv_n:
        return k_new
    if kv_stored % kv_n:
        raise ValueError(f"cache stores {kv_stored} KV heads, not a "
                         f"multiple of the {kv_n} incoming")
    return torch.repeat_interleave(k_new, kv_stored // kv_n, dim=2)


def _expand_to_cache(cache, k_new):
    return _expand_heads(k_new, cache.k.shape[-2])


def cache_update_decode(cache: KVCache, k_new, v_new) -> KVCache:
    """Append ONE token (k_new/v_new: (B,1,KV,hd)) in place: at ``length
    % W`` in a ring cache, else at ``min(length, S - 1)``; under a
    :class:`SeqSplit` only the rank whose slice holds that position
    writes."""
    k_new = _expand_to_cache(cache, k_new)
    v_new = _expand_to_cache(cache, v_new)
    lo, s_cache = cache.span()
    pos = (cache.length % s_cache if cache.ring
           else min(cache.length, s_cache - 1)) - lo
    if 0 <= pos < cache.k.shape[1]:
        cache.k[:, pos] = to_cache_dtype(k_new[:, 0], cache.k.dtype)
        cache.v[:, pos] = to_cache_dtype(v_new[:, 0], cache.v.dtype)
    return KVCache(cache.k, cache.v, cache.length + 1, cache.ring,
                   cache.split)


def decode_attention(cfg: ModelConfig, q, cache: KVCache,
                     start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-token attention against the cache. q: (B,1,H,hd).

    The cache position of the current token must already be written
    (call :func:`cache_update_decode` first). ``start`` — (B,) int — marks
    each row's first valid cache slot (left pad / late admission); slots
    outside ``[start, length)`` are masked with ``NEG_INF``, so a row with
    no valid slot gets the reference's uniform softmax, not NaN.

    A ring cache's valid slots are ``[0, min(length, W))``: every written
    slot holds one of the last ``W`` positions. It takes no ``start`` (its
    slots are reused, so a per-row offset means nothing there; the engine
    serves ring archs by equal prompt length) — the reference ignores one,
    the port raises.

    Under a :class:`SeqSplit` each rank attends its slice
    (:func:`partial_attention`, validity computed at the slots' whole-cache
    positions), the slices' ``(out, m, l)`` are gathered once over the
    split's ranks and combined (:func:`combine_partials`).
    """
    if cache.ring and start is not None:
        raise ValueError("a ring cache takes no start offsets: its slots "
                         "are reused modulo the window")
    b, _, h, hd = q.shape
    s_loc = cache.k.shape[1]
    lo, s_cache = cache.span()
    idx = lo + torch.arange(s_loc, device=q.device)
    valid = (idx < min(cache.length, s_cache) if cache.ring
             else idx < cache.length).expand(b, s_loc)
    if start is not None:
        valid = valid & (idx[None, :] >= start[:, None])
    if cache.split is not None:
        return _split_attention(q, cache, valid)
    n_rep = h // cache.k.shape[2]
    k = repeat_kv(cache.k, n_rep).to(q.dtype)
    v = repeat_kv(cache.v, n_rep).to(q.dtype)
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# ---------------------------------------------------------------------------
# paged KV cache: fixed page pool + per-slot page table
# ---------------------------------------------------------------------------

class PagedKVCache:
    """Layer-stacked paged KV cache.

    K/V live in a fixed pool of fixed-size pages ``(L, num_pages,
    page_size, KV, hd)`` with a per-slot page table ``(B, max_pages)``
    int32 mapping each slot's logical page (virtual position ``p`` ->
    logical page ``p // page_size``) to a pool page, ``-1`` = unmapped.
    Pool page 0 is the TRASH page: writes through an unmapped entry (pad
    prefix, finished slots) land there and are never validly read —
    attention masks by ``[start, length)`` exactly as on the contiguous
    cache, so the two layouts are token-identical. The table is shared by
    every layer; allocation lives in :mod:`repro_torch.serve.paging`.
    """

    def __init__(self, k, v, table, length: int, page_size: int):
        self.k = k                # (L, NP, PS, KV, hd)
        self.v = v
        self.table = table        # (B, MAXP) int32
        self.length = int(length)
        self.page_size = int(page_size)


class PagedKVLayer:
    """One layer's view of a :class:`PagedKVCache` (pool slice + the shared
    table/cursor) — what the per-layer block code sees in place of a
    :class:`KVCache`. The pool slice is a view: writes reach the stack."""

    def __init__(self, k, v, table, length: int, page_size: int):
        self.k = k                # (NP, PS, KV, hd)
        self.v = v
        self.table = table        # (B, MAXP) int32
        self.length = int(length)
        self.page_size = int(page_size)


def _paged_write_ids(table, pos, page_size: int):
    """Pool page ids for writing virtual position(s) ``pos`` per slot;
    unmapped entries route to the trash page (0)."""
    ids = table[:, pos // page_size].long()   # (B,) or (B, n)
    return torch.where(ids >= 0, ids, 0)


def paged_update_decode(layer: PagedKVLayer, k_new, v_new) -> PagedKVLayer:
    """Append ONE token (k_new/v_new: (B,1,KV,hd)) at the shared cursor, in
    place: slot ``b`` writes pool page ``table[b, cur // PS]`` at offset
    ``cur % PS``. Distinct slots own distinct pages, so writes collide only
    in the trash page, whose content is never read."""
    ps = layer.page_size
    k_new = _expand_to_cache(layer, k_new)
    v_new = _expand_to_cache(layer, v_new)
    pos = layer.length
    ids = _paged_write_ids(layer.table, pos, ps)               # (B,)
    layer.k[ids, pos % ps] = to_cache_dtype(k_new[:, 0], layer.k.dtype)
    layer.v[ids, pos % ps] = to_cache_dtype(v_new[:, 0], layer.v.dtype)
    return PagedKVLayer(layer.k, layer.v, layer.table, pos + 1, ps)


def paged_prefill_update(layer: PagedKVLayer, k_new, v_new) -> PagedKVLayer:
    """Write a fresh prefill (k_new/v_new: (B,S,KV,hd)) at positions
    ``[0, S)`` in place — whole pages scattered into the pool; positions
    whose pages are unmapped (each slot's left-pad prefix) go to the trash
    page."""
    ps = layer.page_size
    k_new = _expand_to_cache(layer, k_new)
    v_new = _expand_to_cache(layer, v_new)
    b, s = k_new.shape[:2]
    npg = -(-s // ps)
    pad = npg * ps - s
    if pad:
        k_new = F.pad(k_new, (0, 0, 0, 0, 0, pad))
        v_new = F.pad(v_new, (0, 0, 0, 0, 0, pad))
    kp = k_new.reshape((b, npg, ps) + tuple(k_new.shape[2:]))
    vp = v_new.reshape((b, npg, ps) + tuple(v_new.shape[2:]))
    ids = layer.table[:, :npg].long()
    ids = torch.where(ids >= 0, ids, 0)                        # (B, npg)
    layer.k[ids] = to_cache_dtype(kp, layer.k.dtype)
    layer.v[ids] = to_cache_dtype(vp, layer.v.dtype)
    return PagedKVLayer(layer.k, layer.v, layer.table, layer.length + s, ps)


def paged_splice(cache: PagedKVCache, slot: int, dest: int, k_rows, v_rows
                 ) -> PagedKVCache:
    """Admission splice, in place: write ``k_rows``/``v_rows`` (``(L, S,
    KV, hd)``) into ``slot``'s pages at virtual positions ``[dest, dest +
    S)`` — page-table-indirect and not page-aligned (positions below the
    admitted request's ``start`` fall through unmapped entries to the trash
    page)."""
    ps = cache.page_size
    ll, np_, _, kv, hd = cache.k.shape
    s = k_rows.shape[1]
    pos = dest + torch.arange(s, device=cache.table.device)
    ids = cache.table[slot][pos // ps].long()
    ids = torch.where(ids >= 0, ids, 0)
    flat = ids * ps + pos % ps                                 # (S,)
    cache.k.view(ll, np_ * ps, kv, hd)[:, flat] = to_cache_dtype(
        k_rows, cache.k.dtype)
    cache.v.view(ll, np_ * ps, kv, hd)[:, flat] = to_cache_dtype(
        v_rows, cache.v.dtype)
    return cache


def paged_decode_attention(cfg: ModelConfig, q, layer: PagedKVLayer,
                           start: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """One-token attention against the paged cache: gather each slot's
    pages into sequence order (:func:`repro_torch.kernels.paged_kv.
    paged_gather` — the CUDA kernel on the card), then the standard masked
    decode attention. Validity is ``[start, length)`` as on the contiguous
    layout, which makes the two layouts token-identical."""
    k_view = paged_gather(layer.k, layer.table)
    v_view = paged_gather(layer.v, layer.table)
    return decode_attention(cfg, q, KVCache(k_view, v_view, layer.length),
                            start=start)


# ---------------------------------------------------------------------------
# flash-decode partial-softmax combine (a sequence-sharded cache: the
# long-context layout)
# ---------------------------------------------------------------------------

def partial_attention(q, k, v, valid
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention of q ``(B,Q,H,hd)`` over one sequence SHARD k/v ``(B,S,KV,
    hd)`` whose key ``j`` counts where ``valid[j]`` (``(S,)`` bool, or
    ``(B,S)`` a row's own). Returns ``(out, m, l)``: the unnormalised
    ``out`` ``(B,Q,H,hd)`` in q's dtype, the f32 row max ``m`` and sum of
    exponentials ``l``, both ``(B,H,Q,1)``, so that shards combine exactly
    (:func:`combine_partials`)."""
    hd = q.shape[-1]
    n_rep = q.shape[2] // k.shape[2]
    k, v = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(hd)
    if valid.dim() == 1:
        valid = valid[None]
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)                     # (B,H,Q,1)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), v)
    return out, m, l


def combine_partials(outs, ms, ls) -> torch.Tensor:
    """Combine per-shard ``(out, m, l)`` stacked on a new leading axis —
    outs ``(N,B,Q,H,hd)``, ms/ls ``(N,B,H,Q,1)`` — into the attention over
    the whole sequence, in outs' dtype."""
    m_glob = ms.amax(dim=0)                                   # (B,H,Q,1)
    alpha = torch.exp(ms - m_glob)                            # (N,B,H,Q,1)
    l_glob = (ls * alpha).sum(dim=0)
    out = (outs.float() * alpha.transpose(2, 3)).sum(dim=0)   # (B,Q,H,hd)
    l_o = l_glob.transpose(1, 2)                              # (B,Q,H,1)
    return (out / l_o.clamp(min=1e-30)).to(outs.dtype)


def _split_attention(q, cache: KVCache, valid) -> torch.Tensor:
    """One-token attention over a sequence-split cache: this rank's slice
    through :func:`partial_attention`, every slice's ``(out, m, l)`` packed
    into one f32 tensor ``(B, H, hd + 2)`` and gathered once over the
    split's ranks, then :func:`combine_partials`. A row with no valid key
    in any slice gets the uniform mean, as the whole cache gives it."""
    b, _, h, hd = q.shape
    split = cache.split
    out, m, l = partial_attention(q, cache.k.to(q.dtype),
                                  cache.v.to(q.dtype), valid)
    packed = torch.cat([out.float().reshape(b, h, hd), m.reshape(b, h, 1),
                        l.reshape(b, h, 1)], -1)
    got = split.comm.all_gather(packed[None], gather_axis=0)
    n = split.count
    outs = got[..., :hd].reshape(n, b, 1, h, hd)
    ms = got[..., hd].reshape(n, b, h, 1, 1)
    ls = got[..., hd + 1].reshape(n, b, h, 1, 1)
    return combine_partials(outs, ms, ls).to(q.dtype)
