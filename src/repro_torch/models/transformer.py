"""The model for the dense, MoE, SSM, hybrid, VLM and audio families
(PyTorch port).

Port of the attention-stack branch of ``repro.models.transformer``. Params
are a plain nested dict of tensors in the reference's layout: per-layer
weights stacked on a leading ``L`` axis, ``(L, in, out)``, applied as
``x @ W`` — so :mod:`repro_torch.bridge` copies the reference's params
without a transpose. The layer stack is a Python loop in place of
``lax.scan``, and decode caches are updated in place (see
:mod:`repro_torch.models.attention`).
The training forward (no cache, autograd on) recomputes each block in the
backward when ``cfg.remat != "none"`` (``torch.utils.checkpoint``):
``"block"`` keeps only each block's input, ``"dots"`` also the outputs of
its matmuls (the reference's ``checkpoint_dots``, see :func:`_dots_policy`).
A block is a dense or MoE layer, a Mamba2 block, or a hybrid's
shared-attention site.

MoE layers (mixtral, arctic) replace the FFN with
:func:`repro_torch.models.moe.moe_ffn` and sum its aux losses over the
layers. The SSM family (mamba2) stacks Mamba2 blocks
(:mod:`repro_torch.models.ssm`) with an :class:`SSMState` per layer in the
decode cache. The hybrid family (zamba2) runs groups of
``hybrid_attn_every`` Mamba2 blocks, each group followed by one
shared-weight attention block (``params["shared_attn"]``) whose KV cache
is the site's slice of a stack of ``L // hybrid_attn_every``; the
``L % hybrid_attn_every`` remainder blocks come last. A sliding-window
arch whose window is shorter than the cache decodes through the ring
cache (:mod:`repro_torch.models.attention`). The VLM family (phi-3-vision)
projects precomputed image patch embeddings (``batch["image_embeds"]``,
``(B, P, IMG_EMBED_DIM)``) with ``img_proj`` and puts them before the text
embeddings; its decode is text-only after that prefix. The audio family
(musicgen) sums ``num_codebooks`` token embeddings a position and has one
LM head a codebook: tokens ``(B, K, S)``, logits ``(B, K, S, V)``. Both
run the dense attention layers.

Tensor parallelism runs at the same sites under either path: the serve
path's ``comm`` (a :class:`repro_torch.serve.comm.ServeComm`) or the
model line of a ``shard`` with a model axis (``shard.tp``, a
:class:`repro_torch.dist.tp.LineComm`, whose collectives carry their
backwards). Attention splits its heads (``wq``/``wk``/``wv`` column,
``wo`` row, ``bo`` after the sum), the gated FFN its d_ff, the embedding
its vocabulary (a masked lookup, then a sum) and the head its vocabulary
(the logits gathered); each site's input enters through one ``copy``, so
the parallel block's attention and FFN share one. Under ``shard`` a
Mamba2 block splits its heads and conv channels over ``model`` too
(:func:`_ssm_block`), its decode state a rank's slice. The leaves that
the rule table slices over ``model`` but whose site is not
tensor-parallel are gathered whole over ``model`` where they are used and
computed replicated: the VLM's ``img_proj`` (its output dim is d_model),
the attention leaves of an arch whose heads do not divide the axis
(gemma-2b's one KV head) and a Mamba2 block's whose heads or channels do
not.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models.attention import (
    KVCache,
    PagedKVCache,
    PagedKVLayer,
    SeqSplit,
    _expand_to_cache,
    _stored_kv_heads,
    attention,
    cache_update_decode,
    decode_attention,
    is_ring,
    kv_cache_shape,
    paged_decode_attention,
    paged_prefill_update,
    paged_update_decode,
    to_cache_dtype,
)
from repro_torch.models.layers import (
    apply_norm,
    apply_rope,
    dense_init,
    embed_init,
    gated_ffn,
    maybe_bf16_grads,
)
from repro_torch.models.moe import moe_ffn
from repro_torch.models.ssm import SSMState, mamba2_decode, mamba2_forward

IMG_EMBED_DIM = 1024  # stubbed CLIP patch-embedding width (phi-3-vision)

# remat="dots": the ops whose outputs the backward keeps (``aten.matmul``
# and ``einsum`` reach the dispatcher as the first three; then the flash
# forward, ``(o, lse)``, and the SSD intra-chunk step, ``(y, states)``, as
# the reference's XLA attention and SSD einsums keep their products)
_DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default,
                      torch.ops.repro_torch.flash_fwd.default,
                      torch.ops.repro_torch.ssd_chunk.default})


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective activation checkpoint for ``remat="dots"``, as
    ``jax.checkpoint_policies.checkpoint_dots``: save the outputs of the
    matmuls, the flash forward and the SSD intra-chunk step, recompute
    everything else (so the backward launches no second flash or SSD
    forward)."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_contexts():
    return create_selective_checkpoint_contexts(_dots_policy)

# a cursor is a host int here and an int32 scalar in the reference; cache
# byte counts charge it at the reference's width so the two engines report
# the same ``cache_bytes_resident``.
_CURSOR_BYTES = 4


# ---------------------------------------------------------------------------
# parameter initialization
# ---------------------------------------------------------------------------

def _keep_all(path, t):
    return t


def _norm_params(cfg: ModelConfig, dims, device, keep=_keep_all, at=()):
    if cfg.norm == "nonparametric":
        return None
    p = {"scale": keep(at + ("scale",),
                       torch.ones(dims + (cfg.d_model,), device=device))}
    if cfg.norm == "layernorm":
        p["bias"] = keep(at + ("bias",),
                         torch.zeros(dims + (cfg.d_model,), device=device))
    return p


def _attn_params(cfg: ModelConfig, gen, dims, dtype, device, keep=_keep_all,
                 at=()):
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p = {}
    for name, shape in (("wq", (d, qd)), ("wk", (d, kvd)), ("wv", (d, kvd)),
                        ("wo", (qd, d))):
        p[name] = keep(at + (name,), dense_init(gen, dims + shape,
                                                dtype=dtype, device=device))
    if cfg.use_bias:
        for name, n in (("bq", qd), ("bk", kvd), ("bv", kvd), ("bo", d)):
            p[name] = keep(at + (name,), torch.zeros(
                dims + (n,), dtype=dtype, device=device))
    return p


def _ffn_params(cfg: ModelConfig, gen, dims, dtype, device, keep=_keep_all,
                at=()):
    d, dff = cfg.d_model, cfg.d_ff
    p = {}
    for name, shape in (("w_gate", (d, dff)), ("w_up", (d, dff)),
                        ("w_down", (dff, d))):
        p[name] = keep(at + (name,), dense_init(gen, dims + shape,
                                                dtype=dtype, device=device))
    if cfg.use_bias:
        for name, n in (("b_up", dff), ("b_down", d)):
            p[name] = keep(at + (name,), torch.zeros(
                dims + (n,), dtype=dtype, device=device))
    return p


def _moe_params(cfg: ModelConfig, gen, dims, dtype, device, keep=_keep_all,
                at=()):
    m = cfg.moe
    d, ff, e = cfg.d_model, cfg.d_ff, m.num_experts
    # the router stays float32 whatever param_dtype is, as there
    p = {"router": keep(at + ("router",), dense_init(
        gen, dims + (d, e), dtype=torch.float32, device=device))}
    for name, shape in (("w_gate", (e, d, ff)), ("w_up", (e, d, ff)),
                        ("w_down", (e, ff, d))):
        p[name] = keep(at + (name,), dense_init(gen, dims + shape,
                                                dtype=dtype, device=device))
    if m.dense_residual:
        p["residual"] = _ffn_params(cfg, gen, dims, dtype, device, keep,
                                    at + ("residual",))
    return p


def _ssm_params(cfg: ModelConfig, gen, dims, dtype, device):
    c = cfg.ssm
    d = cfg.d_model
    d_in = c.d_inner(d)
    nh = c.num_heads(d)
    d_bc = 2 * c.ngroups * c.d_state
    proj_out = 2 * d_in + d_bc + nh
    f32 = torch.float32
    # dt bias initialized so softplus(dt_bias) spans [1e-3, 1e-1] (mamba2 init)
    u = torch.rand(dims + (nh,), generator=gen, device=device)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    a_init = torch.log(torch.linspace(1.0, 16.0, nh, device=device))
    conv_w = 0.1 * torch.randn(dims + (c.conv_width, d_in + d_bc),
                               generator=gen, device=device)
    return {
        "in_proj": dense_init(gen, dims + (d, proj_out), dtype=dtype,
                              device=device),
        "conv_w": conv_w.to(dtype),
        "A_log": a_init.expand(dims + (nh,)).contiguous(),
        "D": torch.ones(dims + (nh,), dtype=f32, device=device),
        "dt_bias": dt_bias,
        "gate_norm": torch.ones(dims + (d_in,), dtype=f32, device=device),
        "out_proj": dense_init(gen, dims + (d_in, d), dtype=dtype,
                               device=device),
    }


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None,
                shard=None) -> Dict[str, Any]:
    """Random params from ``seed`` (a ``torch.Generator`` on ``device``), in
    ``cfg.param_dtype``, made directly on the device. The same tree as the
    reference's ``init_params`` (norm params in float32); the numbers differ
    from JAX's — the conformance tests carry JAX's params over with
    :func:`repro_torch.bridge.params_from_numpy` instead.

    ``shard(path, leaf)`` — a tensor-parallel rank's cut (e.g.
    :func:`repro_torch.serve.comm.param_sharder`) — is applied to each
    leaf of the text attention archs as soon as it is made, in the
    generator's order, so one rank holds one full leaf at a time and the
    numbers equal a slice of the unsharded init's."""
    keep = shard or _keep_all
    # the meta device gives the tree's shapes and dtypes without memory
    # (``repro_torch.dist.sharding.param_shapes``); it takes no generator
    meta = device is not None and torch.device(device).type == "meta"
    dev = torch.device("meta") if meta else resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)
    gen = None
    if not meta:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    dims = (cfg.num_layers,)
    # audio: one table and one head a codebook
    books = (cfg.num_codebooks,) if cfg.modality == "audio" else ()
    params: Dict[str, Any] = {"embed": {"tok": keep(("embed", "tok"),
                                                    embed_init(
        gen, books + (cfg.vocab_size, cfg.d_model), dtype, dev))}}
    if cfg.modality == "vlm":
        params["img_proj"] = {"w": dense_init(
            gen, (IMG_EMBED_DIM, cfg.d_model), dtype=dtype, device=dev)}
    if cfg.family in ("ssm", "hybrid"):
        layer = {"ssm": _ssm_params(cfg, gen, dims, dtype, dev),
                 "norm1": _norm_params(cfg, dims, dev)}
        if cfg.family == "hybrid":   # one block, shared by every site
            params["shared_attn"] = {k: v for k, v in {
                "attn": _attn_params(cfg, gen, (), dtype, dev),
                "ffn": _ffn_params(cfg, gen, (), dtype, dev),
                "norm1": _norm_params(cfg, (), dev),
                "norm2": _norm_params(cfg, (), dev)}.items()
                if v is not None}
    else:
        ly = ("layers",)
        layer = {"attn": _attn_params(cfg, gen, dims, dtype, dev, keep,
                                      ly + ("attn",)),
                 "norm1": _norm_params(cfg, dims, dev, keep, ly + ("norm1",))}
        if cfg.moe is not None:
            layer["moe"] = _moe_params(cfg, gen, dims, dtype, dev, keep,
                                       ly + ("moe",))
        else:
            layer["ffn"] = _ffn_params(cfg, gen, dims, dtype, dev, keep,
                                       ly + ("ffn",))
        if not cfg.parallel_block:
            layer["norm2"] = _norm_params(cfg, dims, dev, keep,
                                          ly + ("norm2",))
    params["layers"] = {k: v for k, v in layer.items() if v is not None}
    fn = _norm_params(cfg, (), dev, keep, ("final_norm",))
    if fn is not None:
        params["final_norm"] = fn
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": keep(("lm_head", "w"), dense_init(
            gen, books + (cfg.d_model, cfg.vocab_size), dtype=dtype,
            device=dev))}
    return params


def layer_params(params: Dict[str, Any], l: int) -> Dict[str, Any]:
    """Layer ``l``'s slice of the stacked per-layer params (views)."""
    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[l]
    return take(params["layers"])


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

@dataclass
class DecodeCache:
    """Decode state: a stacked contiguous, ring or paged KV cache
    (attention archs: one a layer; hybrid: one a shared-attention site;
    ``None`` for SSM), the absolute token cursor, and the layer-stacked
    SSM state (SSM and hybrid archs). Updated in place; the model returns a
    new ``DecodeCache`` holding the same tensors and the advanced cursor."""

    kv: Optional[Union[KVCache, PagedKVCache]]
    length: int
    ssm: Optional[SSMState] = None

    def nbytes(self) -> int:
        """Resident bytes, counted as the reference counts its pytree."""
        n = _CURSOR_BYTES
        kv = self.kv
        if kv is not None:
            n += kv.k.nbytes + kv.v.nbytes + _CURSOR_BYTES
            if isinstance(kv, PagedKVCache):
                n += kv.table.nbytes
        if self.ssm is not None:
            n += self.ssm.conv.nbytes + self.ssm.ssd.nbytes
        return n


def cache_dtype(cfg: ModelConfig, dtype) -> torch.dtype:
    """The dtype a cache asked for in ``dtype`` stores: ``float8_e4m3fn``
    under ``kv_fp8`` when ``dtype`` is bf16 (the reference's OPT(kv_fp8):
    half the decode step's cache bytes, upcast to the query's dtype at
    every read), else ``dtype``."""
    if "kv_fp8" in cfg.opts and dtype == torch.bfloat16:
        return torch.float8_e4m3fn
    return dtype


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None,
               kv_heads: Optional[int] = None,
               seq_split: Optional[SeqSplit] = None,
               ssm_parts: int = 1) -> DecodeCache:
    """KV cache ``(L, B, S, KV, hd)`` of zeros on ``device`` (CUDA unless
    ``"cpu"`` is asked for): ``S = max_len``, or the window for a ring
    cache. SSM archs: an :class:`SSMState` stacked on ``L`` instead (conv
    tail in ``dtype``, SSD state in f32; no per-position storage, so
    ``max_len`` does not size it). Hybrid archs: both, the KV cache stacked
    on the ``L // hybrid_attn_every`` shared-attention sites. A prefill
    re-types the conv tail to the activations' dtype, as the reference's
    does (:meth:`Model.forward`). ``kv_heads`` — a tensor-parallel rank's
    local count — replaces the stored KV heads; ``seq_split`` (a
    :class:`~repro_torch.models.attention.SeqSplit`) keeps this rank's
    slice of ``S``; ``ssm_parts`` — the model ranks a tensor-parallel
    Mamba2 block splits over — keeps one rank's ``CH / ssm_parts`` conv
    channels and ``H / ssm_parts`` SSD heads. Under ``kv_fp8`` a bf16
    cache stores ``float8_e4m3fn`` (:func:`cache_dtype`), the conv tail
    included, as the reference types it before the KV cache."""
    dev = resolve_device(device)
    dtype = cache_dtype(cfg, dtype)
    kv = ssm = None
    n_kv = cfg.num_layers
    if cfg.family in ("ssm", "hybrid"):
        st = SSMState.init(cfg, batch, dtype=dtype, device=dev,
                           parts=ssm_parts)
        ssm = SSMState(*(t.expand((cfg.num_layers,) + t.shape).clone()
                         for t in st))
        n_kv = (cfg.num_layers // cfg.hybrid_attn_every
                if cfg.family == "hybrid" else 0)
    if n_kv:
        shape = (n_kv,) + kv_cache_shape(cfg, batch, max_len)
        if kv_heads is not None:
            shape = shape[:3] + (kv_heads,) + shape[4:]
        if seq_split is not None:
            if shape[2] % seq_split.count:
                raise ValueError(f"a cache of {shape[2]} positions does not "
                                 f"split into {seq_split.count} slices")
            shape = shape[:2] + (shape[2] // seq_split.count,) + shape[3:]
        kv = KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                     torch.zeros(shape, dtype=dtype, device=dev), 0,
                     ring=is_ring(cfg, max_len), split=seq_split)
    return DecodeCache(kv, 0, ssm)


def init_paged_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                     page_size: int, num_pages: int, dtype=torch.bfloat16,
                     device=None, kv_heads: Optional[int] = None
                     ) -> DecodeCache:
    """Paged decode cache: a fixed pool of ``num_pages`` pages of
    ``page_size`` tokens (page 0 reserved as trash) + an all-unmapped
    per-slot page table covering virtual positions ``[0, max_len)``.
    Text attention archs only: SSM state has no per-position pages, and
    the VLM and audio families keep the reference's contiguous layout.
    ``kv_heads`` — a tensor-parallel rank's local count — replaces the
    stored KV heads."""
    if cfg.family not in ("dense", "moe") or cfg.modality != "text":
        raise NotImplementedError(
            f"paged KV cache needs a text attention arch, got "
            f"family={cfg.family!r} modality={cfg.modality!r}")
    if is_ring(cfg, max_len):
        raise NotImplementedError(
            "paged KV cache does not support ring (sliding-window) caches; "
            "use the contiguous cache")
    if page_size < 1 or num_pages < 2:
        raise ValueError(f"need page_size >= 1 and num_pages >= 2 "
                         f"(page 0 is the trash page), got "
                         f"{page_size}/{num_pages}")
    dtype = cache_dtype(cfg, dtype)    # kv_fp8: see init_cache
    max_pages = -(-max_len // page_size)
    shape = (cfg.num_layers, num_pages, page_size,
             _stored_kv_heads(cfg) if kv_heads is None else kv_heads,
             cfg.head_dim)
    dev = resolve_device(device)
    kv = PagedKVCache(torch.zeros(shape, dtype=dtype, device=dev),
                      torch.zeros(shape, dtype=dtype, device=dev),
                      torch.full((batch, max_pages), -1, dtype=torch.int32,
                                 device=dev),
                      0, page_size)
    return DecodeCache(kv, 0)


def _layer_kv(kv, l: int):
    """Layer (or site) ``l``'s view of a stacked contiguous, ring or paged
    KV cache."""
    if isinstance(kv, PagedKVCache):
        return PagedKVLayer(kv.k[l], kv.v[l], kv.table, kv.length,
                            kv.page_size)
    return KVCache(kv.k[l], kv.v[l], kv.length, kv.ring, kv.split)


def _advanced(kv, n: int):
    """The stacked cache with its cursor moved by ``n`` (same tensors)."""
    if isinstance(kv, PagedKVCache):
        return PagedKVCache(kv.k, kv.v, kv.table, kv.length + n, kv.page_size)
    return KVCache(kv.k, kv.v, kv.length + n, kv.ring, kv.split)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _attn_apply(cfg: ModelConfig, x, p, positions, kv=None,
                decode: bool = False, start=None, comm=None):
    """Attention sub-block. ``kv`` is a layer's contiguous or paged cache
    view (written in place); ``start`` the per-row left-pad offset.
    ``comm`` (:class:`repro_torch.serve.comm.ServeComm`) selects manual TP:
    the weights arrive Megatron-sharded, the head counts below are LOCAL,
    and the row-parallel ``wo`` partial sum is all-reduced on the
    ``tp_attn`` VCI stream before the bias."""
    b, s, _ = x.shape
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.use_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, -1, cfg.head_dim)
    k = k.reshape(b, s, -1, cfg.head_dim)
    v = v.reshape(b, s, -1, cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    new_kv = None
    # a cache of every KV head beside tensor-parallel heads (the GSPMD
    # route's layout for a batch too small for the data line): the heads
    # are gathered over model where they are written, and a decode attends
    # every head and keeps this rank's
    whole = (comm is not None and isinstance(kv, KVCache)
             and k.shape[2] < cfg.num_kv_heads
             and kv.k.shape[-2] == _stored_kv_heads(cfg))
    if decode:
        if isinstance(kv, PagedKVLayer):
            new_kv = paged_update_decode(kv, k, v)
            o = paged_decode_attention(cfg, q, new_kv, start=start)
        elif whole:
            hl = q.shape[2]
            q_all, k_all, v_all = _heads_gathered(comm, q, k, v)
            new_kv = cache_update_decode(kv, k_all, v_all)
            o = decode_attention(cfg, q_all, new_kv, start=start)
            o = o[:, :, comm.rank() * hl:(comm.rank() + 1) * hl]
        else:
            new_kv = cache_update_decode(kv, k, v)
            o = decode_attention(cfg, q, new_kv, start=start)
    else:
        o = attention(cfg, q, k, v, start=start)
        if isinstance(kv, PagedKVLayer):  # prefill: write the page pool
            new_kv = paged_prefill_update(kv, k, v)
        elif whole:
            new_kv = _prefill_cache(kv, *_heads_gathered(comm, k, v))
        elif kv is not None:              # prefill: write the cache
            new_kv = _prefill_cache(kv, k, v)
    o = o.reshape(b, s, -1) @ p["wo"].to(x.dtype)
    if comm is not None:
        o = comm.psum(o, "tp_attn")
    if cfg.use_bias:
        o = o + p["bo"]
    return o, new_kv


def _heads_gathered(comm, *xs):
    """Each of ``xs`` (``(B, S, heads, hd)``, this rank's heads) with the
    model line's heads joined in rank order, by one gather."""
    b, s, _, hd = xs[0].shape
    n = [x.shape[2] for x in xs]
    got = comm.all_gather(torch.cat(xs, 2), "tp_attn", gather_axis=2)
    got = got.reshape(b, s, -1, sum(n), hd)
    return tuple(t.reshape(b, s, -1, hd) for t in got.split(n, dim=3))


def _prefill_cache(kv: KVCache, k, v) -> KVCache:
    """Write a prefill's K/V at positions ``[0, S)`` of a contiguous cache.
    A ring cache shorter than the prompt keeps its last ``W`` positions,
    rolled by ``S % W`` so that slot ``i`` holds the newest position
    congruent to ``i`` modulo ``W``. A sequence-split cache keeps the
    slots of its slice."""
    k = _expand_to_cache(kv, k)
    v = _expand_to_cache(kv, v)
    s = k.shape[1]
    lo, s_cache = kv.span()
    if kv.ring and s > s_cache:
        k, v = k[:, -s_cache:], v[:, -s_cache:]
        shift = s % s_cache
        if shift:
            k, v = torch.roll(k, shift, 1), torch.roll(v, shift, 1)
    n = min(s, lo + kv.k.shape[1]) - lo
    if n > 0:
        kv.k[:, :n] = to_cache_dtype(k[:, lo:lo + n], kv.k.dtype)
        kv.v[:, :n] = to_cache_dtype(v[:, lo:lo + n], kv.v.dtype)
    return KVCache(kv.k, kv.v, kv.length + s, kv.ring, kv.split)


def _ffn_apply(cfg: ModelConfig, h, p, inference: bool, comm=None,
               shard=None):
    """The block's FFN: dense, or MoE with its aux losses. (out, aux).
    ``h`` enters a tensor-parallel dense FFN already through ``comm.copy``;
    the MoE takes its own (:func:`repro_torch.models.moe.moe_ffn`)."""
    if cfg.moe is not None:
        return moe_ffn(cfg, h, p["moe"], shard, inference=inference,
                       comm=None if shard is not None else comm)
    return gated_ffn(cfg, h, p["ffn"], comm=comm), {}


def _sites(comm, shard, p, at):
    """``(p, attention's comm, the dense FFN's comm)`` of a block: the
    serve path's ``comm`` at both, or under ``shard`` its model line where
    each site is tensor-parallel (its fallbacks gathered whole,
    :meth:`repro_torch.dist.sharding.Sharder.tp_sites`)."""
    if shard is None:
        return p, comm, comm
    return shard.tp_sites(p, at)


def _entered(h, *comms):
    """``h`` through ONE ``copy`` (identity forward, the model line's
    all-reduce backward) for every column-parallel site it feeds: the
    parallel block's attention and FFN share it. ``(h for each comm)``."""
    live = next((c for c in comms if c is not None), None)
    hc = h if live is None else live.copy(h)
    return tuple(h if c is None else hc for c in comms)


def _dense_block(cfg: ModelConfig, x, p, positions, kv=None, decode=False,
                 start=None, comm=None, shard=None):
    """Standard (or parallel) transformer block. Returns (x, new_kv, aux);
    ``aux`` holds the MoE router losses (empty for a dense FFN). ``shard``
    (a :class:`repro_torch.dist.sharding.Sharder`): ``p`` is this rank's
    slice of the layer, its data slices gathered here right before use and
    its model slices computed tensor-parallel on the model line."""
    if shard is not None:
        p = shard.materialize(p, ("layers",))  # the ZeRO/FSDP weight gather
    p, attn_c, ffn_c = _sites(comm, shard, p, ("layers",))
    if cfg.moe is not None:
        ffn_c = comm if shard is None else None
    inference = decode or kv is not None
    h = apply_norm(cfg, x, p.get("norm1"))
    h = maybe_bf16_grads(cfg, h)  # opt bf16_grads: bf16 cotangents
    if cfg.parallel_block:
        ha, hf = _entered(h, attn_c, ffn_c)
    else:
        (ha,) = _entered(h, attn_c)
    attn_out, new_kv = _attn_apply(cfg, ha, p["attn"], positions, kv=kv,
                                   decode=decode, start=start, comm=attn_c)
    if cfg.parallel_block:
        ffn_out, aux = _ffn_apply(cfg, hf, p, inference, ffn_c, shard)
        x = x + attn_out + ffn_out
    else:
        x = x + attn_out
        h2 = apply_norm(cfg, x, p.get("norm2"))
        h2 = maybe_bf16_grads(cfg, h2)
        (h2,) = _entered(h2, ffn_c)
        ffn_out, aux = _ffn_apply(cfg, h2, p, inference, ffn_c, shard)
        x = x + ffn_out
    if shard is not None:
        x = shard.hidden(x)
    return x, new_kv, aux


def _shared_attn_block(cfg: ModelConfig, x, p, positions, kv=None,
                       decode: bool = False, shard=None):
    """A hybrid's shared-weight attention block (norm1, attention, norm2,
    gated FFN, each with a residual): (x, new_kv). Under ``shard`` its
    weights are gathered at every site (the reference leaves them to
    XLA)."""
    if shard is not None:
        p = shard.materialize(p, ("shared_attn",))
    p, attn_c, ffn_c = _sites(None, shard, p, ("shared_attn",))
    h = apply_norm(cfg, x, p.get("norm1"))
    (h,) = _entered(h, attn_c)
    o, new_kv = _attn_apply(cfg, h, p["attn"], positions, kv=kv,
                            decode=decode, comm=attn_c)
    x = x + o
    h2 = apply_norm(cfg, x, p.get("norm2"))
    (h2,) = _entered(h2, ffn_c)
    return x + gated_ffn(cfg, h2, p["ffn"], comm=ffn_c), new_kv


def _ssm_block(cfg: ModelConfig, x, p, state: Optional[SSMState] = None,
               decode: bool = False, shard=None):
    """Pre-norm Mamba2 block with a residual: (x, new_state). Under a
    ``shard`` with a model axis whose size divides the block's heads and
    conv channels (:attr:`repro_torch.dist.sharding.Sharder.ssm_tp`) the
    block is tensor-parallel over ``model``: the normed input enters
    through one ``copy``, each model rank projects, convolves and scans
    its own heads and channels (``in_proj`` gathered whole over the model
    line, the conv output gathered once), sums the gated norm's squares
    and its row-parallel ``out_proj`` over the line, and ``state`` is its
    slice (:func:`repro_torch.models.ssm.mamba2_forward`). Elsewhere the
    block computes replicated: ``in_proj`` and ``out_proj`` gathered
    whole over ``model``, the state whole."""
    comm = None
    if shard is not None:
        p = shard.materialize(p, ("layers",))  # the ZeRO/FSDP weight gather
        p, comm = shard.ssm_site(p, ("layers",))
    h = apply_norm(cfg, x, p.get("norm1"))
    (h,) = _entered(h, comm)
    if decode:
        out, new_state = mamba2_decode(cfg, h, p["ssm"], state, comm=comm)
    else:
        out, new_state = mamba2_forward(cfg, h, p["ssm"], shard,
                                        initial=state, comm=comm)
    x = x + out
    if shard is not None:
        x = shard.hidden(x)
    return x, new_state


def _ssm_layer(ssm: SSMState, l: int) -> SSMState:
    """Layer ``l``'s view of the stacked SSM state."""
    return SSMState(ssm.conv[l], ssm.ssd[l])


def _write_ssm(ssm: SSMState, l: int, new: SSMState) -> None:
    """Write layer ``l``'s new state into the stacked cache, in place."""
    ssm.conv[l].copy_(new.conv)
    ssm.ssd[l].copy_(new.ssd)


def _sum_aux(auxes) -> Dict[str, torch.Tensor]:
    """Per-layer aux dicts -> each key summed over the layers (the
    reference's ``aux_v[:, i].sum()``); empty when no layer has any."""
    if not auxes or not auxes[0]:
        return {}
    return {k: torch.stack([a[k] for a in auxes]).sum() for k in auxes[0]}


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class Model:
    def __init__(self, cfg: ModelConfig, shard=None, comm=None):
        """``comm`` — :class:`repro_torch.serve.comm.ServeComm` for the
        manual-TP serve path: the params are this rank's Megatron shard
        (:func:`repro_torch.serve.comm.serve_param_specs`) and every
        cross-rank exchange is an explicit collective on a per-purpose
        CommContext/VCI stream. ``shard`` — a :class:`repro_torch.dist.
        sharding.Sharder` on a ``(data, model)`` mesh (the
        ``comm="gspmd"`` train step, and the serve engine's GSPMD route):
        the params are this rank's slices, each layer's data slices
        gathered where it runs (``materialize``), the embedding, final
        norm and head where they are used, and the model slices computed
        tensor-parallel on the model line (``shard.tp``: the same sites as
        ``comm``'s, with a backward); the MoE aux losses and the loss are
        the global batch's (:func:`repro_torch.models.moe.moe_ffn`,
        :func:`repro_torch.train.losses.total_loss`)."""
        if shard is not None and comm is not None:
            raise ValueError("shard and comm are exclusive")
        self.cfg = cfg
        self.shard = shard
        self.comm = comm
        # the vocab-parallel embedding and head's comm (either path's)
        self.tp = comm if shard is None else shard.tp

    def _gathered(self, params, key: str, whole: bool = False):
        """``params[key]`` with its data slices gathered under ``shard``
        (``whole``: its model slices too, for a site that computes
        replicated over ``model``: the VLM's ``img_proj``, whose output
        dim is d_model)."""
        p = params[key]
        if self.shard is None:
            return p
        p = self.shard.materialize(p, (key,))
        return self.shard.model_whole(p, (key,)) if whole else p

    # -- embeddings ------------------------------------------------------
    def _tok_embed(self, params, tok) -> torch.Tensor:
        """Token lookup in the activations' dtype: (B,S) -> (B,S,d); audio
        sums the K codebook embeddings, (B,K,S) -> (B,S,d). Vocab-parallel
        (a masked lookup + a psum on the ``sample`` stream) when the table
        arrives row-sharded over TP."""
        emb = self._gathered(params, "embed")["tok"].to(
            torch_dtype(self.cfg.dtype))
        tok = tok.long()
        v_loc = emb.shape[-2]
        parallel = self.tp is not None and v_loc != self.cfg.vocab_size
        if parallel:
            tok = tok - self.tp.rank() * v_loc
            ok = (tok >= 0) & (tok < v_loc)
            tok = tok.clamp(0, v_loc - 1)
        if self.cfg.modality == "audio":               # emb: (K,V,d)
            books = torch.arange(emb.shape[0], device=tok.device)
            x = emb[books[:, None], tok]                # (B,K,S,d)
            if parallel:
                x = torch.where(ok[..., None], x, torch.zeros(
                    (), dtype=emb.dtype, device=emb.device))
                return self.tp.psum(x.sum(1), "sample")
            return x.sum(1)
        x = emb[tok]
        if parallel:
            x = torch.where(ok[..., None], x, torch.zeros(
                (), dtype=emb.dtype, device=emb.device))
            return self.tp.psum(x, "sample")
        return x

    def embed(self, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (x: (B,S,d), positions: (S,)). VLM: the projected image
        patches come first, so ``S = P + S_txt``."""
        tok = batch["tokens"]
        x = self._tok_embed(params, tok)
        if self.cfg.modality == "vlm":
            img = batch["image_embeds"].to(x.dtype)            # (B,P,1024)
            w = self._gathered(params, "img_proj", whole=True)["w"]
            x = torch.cat([img @ w.to(x.dtype), x], 1)
        if self.shard is not None:
            x = self.shard.hidden(x)
        return x, torch.arange(x.shape[1], device=tok.device)

    def unembed(self, params, x) -> torch.Tensor:
        """Logits (B,S,V); audio (B,K,S,V), one head a codebook."""
        x = apply_norm(self.cfg, x, None if "final_norm" not in params
                       else self._gathered(params, "final_norm"))
        if self.cfg.tie_embeddings:
            w = self._gathered(params, "embed")["tok"].T
        else:
            w = self._gathered(params, "lm_head")["w"]
        parallel = self.tp is not None and w.shape[-1] != self.cfg.vocab_size
        if parallel:   # the column-parallel head's entry
            x = self.tp.copy(x)
        if self.cfg.modality == "audio":
            logits = torch.einsum("bsd,kdv->bksv", x, w.to(x.dtype))
        else:
            logits = x @ w.to(x.dtype)
        if self.shard is not None:
            logits = self.shard.logits(logits)
        if parallel:
            # vocab-parallel logits: gather shards on the sampling stream
            logits = self.tp.all_gather(logits, "sample",
                                        gather_axis=logits.dim() - 1)
        return logits

    # -- full-sequence forward (prefill) ----------------------------------
    def forward(self, params, batch, *, cache: Optional[DecodeCache] = None,
                start: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                           Optional[DecodeCache]]:
        """Returns (logits, aux, new_cache). ``cache`` non-None => prefill
        (the cache is written in place). ``aux`` holds the MoE router losses
        ``load_balance``/``router_z`` summed over the layers; it is empty
        for the dense family.

        ``start`` — (B,) int left-pad lengths for mixed-length prefill:
        row ``b``'s real tokens occupy positions ``[start[b], S)``; pad
        positions are masked out of attention and RoPE positions are shifted
        so each row computes exactly what it would alone (attention archs
        only — SSM state offers no per-row pad mask).
        """
        x, positions = self.embed(params, batch)
        if self.cfg.family in ("ssm", "hybrid"):
            if start is not None:
                raise NotImplementedError(
                    "left-padded prefill needs attention masking; SSM "
                    "recurrent state has no per-row pad mask")
            x, new_cache = self._ssm_stack(params, x, positions, cache)
            return self.unembed(params, x), {}, new_cache
        if start is not None:
            # per-row RoPE positions: the first real token sits at 0
            positions = torch.clamp(positions[None, :] - start[:, None], min=0)
        # training forward: each block recomputed in the backward (the
        # reference's jax.checkpoint around the scan body)
        ckpt = self._checkpoint_kw(cache)
        auxes = []
        for l in range(self.cfg.num_layers):
            if ckpt is not None:
                x, aux = checkpoint(functools.partial(
                    self._train_block, params, positions, start, l), x,
                    **ckpt)
            else:
                kv = None if cache is None else _layer_kv(cache.kv, l)
                x, _, aux = _dense_block(self.cfg, x, layer_params(params, l),
                                         positions, kv=kv, decode=False,
                                         start=start, comm=self.comm,
                                         shard=self.shard)
            auxes.append(aux)
        new_cache = None
        if cache is not None:
            s = x.shape[1]
            new_cache = DecodeCache(_advanced(cache.kv, s), cache.length + s)
        return self.unembed(params, x), _sum_aux(auxes), new_cache

    def _ssm_stack(self, params, x, positions, cache: Optional[DecodeCache]):
        """The Mamba2 layers over a full sequence (a hybrid's shared
        attention block after every ``hybrid_attn_every``-th); with a cache
        (prefill) each layer starts from its cached SSD state and its final
        state is written back in place, and each attention site writes its
        slice of the KV stack. The conv tail comes out in the activations'
        dtype, as the reference's prefill returns it: a cache of another
        dtype gets a new conv stack rather than a rounded copy."""
        ssm = None if cache is None else cache.ssm
        if ssm is not None and ssm.conv.dtype != x.dtype:
            ssm = SSMState(torch.empty_like(ssm.conv, dtype=x.dtype), ssm.ssd)
        # training forward: each Mamba2 block and each shared-attention site
        # is recomputed in the backward (the reference's jax.checkpoint of
        # ssm_body and group_body)
        ckpt = self._checkpoint_kw(cache)
        for l in range(self.cfg.num_layers):
            site = self._site_after(l)
            if ckpt is not None:
                x = checkpoint(functools.partial(self._train_ssm_block,
                                                 params, l), x, **ckpt)
                if site is not None:
                    x = checkpoint(functools.partial(
                        self._train_site, params, positions), x, **ckpt)
                continue
            st = None if ssm is None else _ssm_layer(ssm, l)
            x, new_st = _ssm_block(self.cfg, x, layer_params(params, l),
                                   state=st, shard=self.shard)
            if ssm is not None:
                _write_ssm(ssm, l, new_st)
            if site is not None:
                kv = None if cache is None else _layer_kv(cache.kv, site)
                x, _ = _shared_attn_block(self.cfg, x, params["shared_attn"],
                                          positions, kv=kv, shard=self.shard)
        if cache is None:
            return x, None
        s = x.shape[1]
        kv = None if cache.kv is None else _advanced(cache.kv, s)
        return x, DecodeCache(kv, cache.length + s, ssm)

    def _site_after(self, l: int) -> Optional[int]:
        """The hybrid's shared-attention site that follows layer ``l``
        (every ``hybrid_attn_every``-th layer closes a group), else
        ``None``."""
        k = self.cfg.hybrid_attn_every
        if self.cfg.family != "hybrid" or (l + 1) % k:
            return None
        return l // k

    def _checkpoint_kw(self, cache) -> Optional[Dict[str, Any]]:
        """``torch.utils.checkpoint``'s keywords for a training forward (no
        cache, autograd on, ``cfg.remat != "none"``), else ``None``;
        ``"dots"`` keeps the outputs of :data:`_DOT_OPS`."""
        if cache is not None or self.cfg.remat == "none" or \
                not torch.is_grad_enabled():
            return None
        if self.cfg.remat == "dots":
            return {"use_reentrant": False, "context_fn": _dots_contexts}
        return {"use_reentrant": False}

    def _train_block(self, params, positions, start, l: int, x):
        """Layer ``l`` without a cache (the unit that remat recomputes):
        (x, aux)."""
        x, _, aux = _dense_block(self.cfg, x, layer_params(params, l),
                                 positions, start=start, shard=self.shard)
        return x, aux

    def _train_ssm_block(self, params, l: int, x):
        """Mamba2 layer ``l`` without a cache (a unit remat recomputes)."""
        return _ssm_block(self.cfg, x, layer_params(params, l),
                          shard=self.shard)[0]

    def _train_site(self, params, positions, x):
        """A hybrid's shared-attention block without a cache (a unit remat
        recomputes)."""
        return _shared_attn_block(self.cfg, x, params["shared_attn"],
                                  positions, shard=self.shard)[0]

    # -- one-token decode --------------------------------------------------
    def decode_step(self, params, tokens, cache: DecodeCache,
                    start: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, DecodeCache]:
        """tokens: (B,1) (audio: (B,K,1)). Returns (logits, new_cache); the
        cache is written in place at the shared cursor (a VLM's cursor
        already counts its image positions).

        ``start`` — (B,) int per-row first-valid cache slot (the serve
        engine's left-pad/late-admission offset): cache reads mask slots
        below it and RoPE positions count from it.
        """
        x = self._tok_embed(params, tokens)
        if self.cfg.family in ("ssm", "hybrid"):
            if start is not None:
                raise NotImplementedError(
                    "per-row start offsets need attention masking")
            positions = torch.full((x.shape[0], 1), cache.length,
                                   device=x.device)
            for l in range(self.cfg.num_layers):
                x, new_st = _ssm_block(self.cfg, x, layer_params(params, l),
                                       state=_ssm_layer(cache.ssm, l),
                                       decode=True, shard=self.shard)
                _write_ssm(cache.ssm, l, new_st)
                site = self._site_after(l)
                if site is not None:
                    x, _ = _shared_attn_block(
                        self.cfg, x, params["shared_attn"], positions,
                        kv=_layer_kv(cache.kv, site), decode=True,
                        shard=self.shard)
            kv = None if cache.kv is None else _advanced(cache.kv, 1)
            return self.unembed(params, x), DecodeCache(
                kv, cache.length + 1, cache.ssm)
        if start is not None:
            positions = (cache.length - start)[:, None]
        else:
            positions = torch.full((x.shape[0], 1), cache.length,
                                   device=x.device)
        for l in range(self.cfg.num_layers):  # aux dropped, as there
            x, _, _ = _dense_block(self.cfg, x, layer_params(params, l),
                                   positions, kv=_layer_kv(cache.kv, l),
                                   decode=True, start=start, comm=self.comm,
                                   shard=self.shard)
        new_cache = DecodeCache(_advanced(cache.kv, 1), cache.length + 1)
        return self.unembed(params, x), new_cache
