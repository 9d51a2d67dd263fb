"""Flash attention: hand-written CUDA forward and backward kernels + plain
versions.

Port of ``repro.kernels.flash_attention`` (the blockwise online-softmax
forward) for every full-sequence attention of the dense models: serve
prefill, the training forward and its remat recompute. The reference
takes q ``(B,H,Sq,hd)`` and k/v ``(B,KV,Skv,hd)``; here every function
takes the model's layout, q ``(B,Sq,H,hd)`` and k/v ``(B,Skv,KV,hd)``, so
no transpose copies are made.

Masks: causal (key ``kp <= qp``), an optional sliding window (``kp > qp -
window``), GQA/MQA (query head ``h`` reads KV head ``h // (H // KV)``),
and a per-row ``start`` (keys ``< start[b]`` masked: the serve engine's
left pad), which the reference kernel lacks. Masked logits are ``NEG_INF
= -1e30``, so a row with no valid key (a pad row) gets the model's
uniform softmax: the mean of V over all ``Skv`` keys.

* :func:`flash_attention` — the entry point the model calls: the
  dispatcher op :func:`flash_fwd` (``repro_torch::flash_fwd``, with a
  fake implementation and its autograd registered, so a selective
  checkpoint can keep its output). On a CUDA tensor its forward launches the
  ``sm_90a`` kernel of ``csrc/flash_attention.cu`` (which replaces
  ``flash_attention_pallas``; f32 or bf16, head_dim in
  ``_KERNEL_HEAD_DIMS``) and adds one to ``flash_attention.launches``;
  on a CPU tensor it runs :func:`flash_attention_fwd_plain`. Its backward
  is the dispatcher op :func:`flash_bwd` (``repro_torch::flash_bwd``, with
  a fake for meta tensors): on a CUDA tensor the kernel of
  ``csrc/flash_attention_bwd.cu`` (the TPU kernel has no backward; the
  reference differentiates its XLA math), counted in
  ``flash_attention_bwd.launches``; on a CPU tensor
  :func:`flash_attention_bwd_plain`. There is no fallback: a CUDA call
  launches the kernel or raises.
* :func:`flash_attention_fwd` — that forward alone, ``(o, lse)``.
* :func:`flash_attention_bwd` — that backward alone, ``(dq, dk, dv)``.
* :func:`flash_attention_fwd_plain` — the model's materialising math;
  returns ``(o, lse)``.
* :func:`flash_attention_bwd_plain` — recomputes the probabilities from
  the saved log-sum-exp; returns ``(dq, dk, dv)``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (64, 96, 112, 128, 256)


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B,S,KV,hd) -> (B,S,KV*n_rep,hd) for GQA."""
    if n_rep == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, hd).reshape(
        b, s, kv * n_rep, hd)


def attention_mask(q_len: int, kv_len: int, *, causal: bool = True,
                   window: Optional[int] = None,
                   start: Optional[torch.Tensor] = None,
                   device=None) -> torch.Tensor:
    """(1 or B, q_len, kv_len) bool: True where query ``qp`` may read key
    ``kp`` (``kp <= qp`` if causal, ``kp > qp - window``, ``kp >=
    start[b]``)."""
    q_pos = torch.arange(q_len, device=device)[:, None]
    k_pos = torch.arange(kv_len, device=device)[None, :]
    m = (k_pos <= q_pos if causal
         else torch.ones((q_len, kv_len), dtype=torch.bool, device=device))
    if window is not None:
        m = m & (k_pos > q_pos - window)
    m = m[None]
    if start is not None:
        m = m & (k_pos >= start[:, None, None])
    return m


def flash_attention_fwd_plain(q, k, v, *, causal: bool = True,
                              window: Optional[int] = None,
                              start: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B,Sq,H,hd), k/v: (B,Skv,KV,hd). Returns ``o`` (B,Sq,H,hd) in
    q's dtype — logits in q's dtype, then f32 scale, mask and softmax,
    probabilities back in q's dtype (the model's math) — and ``lse``, the
    f32 (B,H,Sq) log-sum-exp of the masked, scaled logits."""
    b, sq, h, hd = q.shape
    n_rep = h // k.shape[2]
    k, v = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    mask = attention_mask(sq, k.shape[1], causal=causal, window=window,
                          start=start, device=q.device)
    logits = torch.where(mask[:, None], logits, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v), lse


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              window: Optional[int] = None, start=None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Gradients of :func:`flash_attention_fwd_plain`'s ``o`` given ``do``
    (all in the model's layout), recomputed from the saved ``lse``:
    ``P = exp(s*scale - lse)``, ``dS = P*(dO V^T - rowsum(dO*O))``. Products
    run in q's dtype, the softmax algebra in f32. dk and dv are summed over
    the query heads of each KV group. Training has no ``start``: passing
    one raises."""
    if start is not None:
        raise ValueError("flash_attention_bwd_plain takes no start: the "
                         "backward is for training, which has no pad rows")
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    n_rep = h // kvh
    kr, vr = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    scale = 1.0 / math.sqrt(hd)
    mask = attention_mask(sq, skv, causal=causal, window=window,
                          device=q.device)[:, None]           # (1,1,Sq,Skv)
    # in place, one pass each: the (B,H,Sq,Skv) f32 tensors dominate
    p = torch.einsum("bqhd,bkhd->bhqk", q, kr).float().mul_(scale)
    p.masked_fill_(~mask, NEG_INF).sub_(lse[..., None]).exp_()  # masked: 0
    empty = window is not None and sq - window >= skv
    if empty:
        # rows past skv + window - 1 have no valid key: the forward's
        # uniform softmax (without start no other row can be empty)
        p = torch.where(mask.any(-1, keepdim=True), p, 1.0 / skv)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype), do)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)  # (B,H,Sq)
    ds = torch.einsum("bqhd,bkhd->bhqk", do, vr).float()
    ds.sub_(delta[..., None]).mul_(p)                  # 0 where p is 0
    if empty:
        ds.masked_fill_(~mask, 0.0)
    ds = ds.to(q.dtype)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr).mul_(scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q).mul_(scale)
    if n_rep > 1:
        dk = dk.float().reshape(b, skv, kvh, n_rep, hd).sum(3).to(k.dtype)
        dv = dv.float().reshape(b, skv, kvh, n_rep, hd).sum(3).to(v.dtype)
    return dq, dk, dv


def _check_cuda_args(q, k, v, start, window) -> None:
    for name, t in (("k", k), ("v", v), ("start", start)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}, got {t.device}")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes q/k/v of one dtype "
                        f"in {tuple(_KERNEL_DTYPES)}, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B,Sq,H,hd) and k/v (B,Skv,KV,hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or k.shape[2] < 1 or \
            h % k.shape[2] or k.shape[1] < 1:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}"
                         f" (same B and hd, H a multiple of KV, Skv >= 1)")
    if hd not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{_KERNEL_HEAD_DIMS}, got {hd}")
    vec = 16 // q.element_size()          # elements in a 16-byte load
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have a contiguous last dim")
        if t.data_ptr() % 16 or any(st % vec for st in t.stride()[:3]):
            raise ValueError(f"{name} must be 16-byte aligned with strides "
                             f"a multiple of 16 bytes, got {t.stride()}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if start is not None and (start.shape != (b,) or
                              start.dtype != torch.int32):
        raise ValueError(f"start must be ({b},) int32, got "
                         f"{tuple(start.shape)} {start.dtype}")


def _check_bwd_args(q, k, v, o, lse, do, window) -> None:
    """What the backward kernel takes beyond the forward's q/k/v: ``o`` and
    ``do`` contiguous in q's shape and dtype, ``lse`` (B,H,Sq) contiguous
    f32, each 16-byte aligned."""
    _check_cuda_args(q, k, v, None, window)
    b, sq, h, _ = q.shape
    for name, t in (("o", o), ("lse", lse), ("do", do)):
        if t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}, got {t.device}")
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape:
            raise ValueError(f"{name} must have q's shape {tuple(q.shape)}, "
                             f"got {tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} must be in q's dtype {q.dtype}, got "
                            f"{t.dtype}")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({b}, {h}, {sq}) float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    for name, t in (("o", o), ("lse", lse), ("do", do)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous last dim")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned, got strides {t.stride()}")


def _fwd_kernel(q, k, v, causal: bool, window: Optional[int],
                start: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA forward on the current stream: (o, lse)."""
    if not q.is_cuda:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    from repro_torch.kernels._build import load
    _check_cuda_args(q, k, v, start, window)
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    o = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    if start is not None:
        start = start.contiguous()
    launch = load("flash_attention")
    with torch.cuda.device(q.device):
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     lse.data_ptr(), 0 if start is None else start.data_ptr(),
                     *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                     b, h, kvh, sq, skv, hd, int(causal),
                     0 if window is None else int(window),
                     _KERNEL_DTYPES[q.dtype],
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return o, lse


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        start: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward of :func:`flash_attention`, ``(o, lse)``: the kernel on a
    CUDA tensor (counted), :func:`flash_attention_fwd_plain` on a CPU
    tensor."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal=causal,
                                         window=window, start=start)
    return _fwd_kernel(q, k, v, causal, window, start)


def _bwd_kernel(q, k, v, o, lse, do, causal: bool, window: Optional[int]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the CUDA backward on the current stream: (dq, dk, dv), each
    contiguous in q's dtype. A strided ``do`` (autograd may give one) is
    copied contiguous first."""
    if not q.is_cuda:
        raise ValueError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
    from repro_torch.kernels._build import load
    do = do.contiguous()
    _check_bwd_args(q, k, v, o, lse, do, window)
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    launch = load("flash_attention_bwd")
    with torch.cuda.device(q.device):
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                     dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                     *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                     b, h, kvh, sq, skv, hd, int(causal),
                     0 if window is None else int(window),
                     _KERNEL_DTYPES[q.dtype],
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: Optional[int] = None, start=None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of :func:`flash_attention` given the forward's ``(o,
    lse)`` and ``do``: the kernel on a CUDA tensor (counted),
    :func:`flash_attention_bwd_plain` on a CPU tensor; any other device
    raises. Training has no ``start``: passing one raises."""
    if start is not None:
        raise ValueError("flash_attention_bwd takes no start: the backward "
                         "is for training, which has no pad rows")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         window=window)
    return _bwd_kernel(q, k, v, o, lse, do, causal, window)


@torch.library.custom_op("repro_torch::flash_fwd", mutates_args=())
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              start: Optional[torch.Tensor], causal: bool,
              window: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_fwd` as one dispatcher op, so that a
    selective checkpoint (``remat="dots"``) sees it and can keep its
    ``(o, lse)``. Returns fresh tensors (``o`` contiguous)."""
    o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                 start=start)
    return o.contiguous(), lse


@flash_fwd.register_fake
def _flash_fwd_fake(q, k, v, start, causal, window):
    b, sq, h, _ = q.shape
    return (q.new_empty(q.shape),
            q.new_empty((b, h, sq), dtype=torch.float32))


@torch.library.custom_op("repro_torch::flash_bwd", mutates_args=())
def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
              causal: bool, window: Optional[int]
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_bwd` as one dispatcher op, so that a meta
    tensor (the dry-run's step) gets its fake's shapes and no arithmetic."""
    return flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                               window=window)


@flash_bwd.register_fake
def _flash_bwd_fake(q, k, v, o, lse, do, causal, window):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _flash_setup(ctx, inputs, output):
    q, k, v, start, causal, window = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.causal, ctx.window = causal, window
    ctx.has_start = start is not None


def _flash_backward(ctx, do, dlse):
    if ctx.has_start:
        raise ValueError("flash_attention has no backward with start")
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = flash_bwd(q, k, v, o, lse, do, ctx.causal, ctx.window)
    return dq, dk, dv, None, None, None


flash_fwd.register_autograd(_flash_backward, setup_context=_flash_setup)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of q (B,Sq,H,hd) over k/v (B,Skv,KV,hd) with the masks of
    the module doc; returns o (B,Sq,H,hd) in q's dtype. Differentiable in
    q, k and v (without ``start``)."""
    return flash_fwd(q, k, v, start, causal, window)[0]


flash_attention.launches = 0
flash_attention_bwd.launches = 0
