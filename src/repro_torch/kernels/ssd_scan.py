"""Mamba2 SSD intra-chunk step: hand-written CUDA kernel + plain version.

Port of ``repro.kernels.ssd_scan``. The blocked SSD scan
(:func:`repro_torch.models.ssm.ssd_chunked`) splits into a quadratic
intra-chunk part and a short inter-chunk recurrence; this module is the
intra-chunk part, in the model's layout rather than the Pallas kernel's
``(b*h, nc, c, ...)`` one:

* :func:`ssd_chunk` — the entry point the model calls. A CUDA tensor goes
  to the ``sm_90a`` kernel in ``csrc/ssd_chunk.cu`` (which replaces
  ``ssd_chunk_pallas``); a CPU tensor goes to :func:`ssd_chunk_plain`.
  There is no fallback: a CUDA call launches the kernel or raises. bf16
  inputs with ``chunk <= 256`` run on the tensor cores (one ``C B^T`` for
  many heads of a group); f32 inputs, and longer chunks, on FFMA.
* :func:`ssd_chunk_plain` — plain f32 einsums (``ssd_chunk_batched_ref``
  in the reference); the CPU path, and what the kernel is held against on
  the card.

Per (batch, head, chunk), with ``i, j`` rows of the chunk::

    L[i,j] = exp(cum_i - cum_j)  for j <= i, else 0
    y      = ((C B^T) o L o dt_j) x
    state  = (B o dt o exp(cum_last - cum))^T x

The heads of a group read the group's ``B``/``C`` (head ``hh`` reads group
``hh // (h // g)``); nothing is repeated over heads. The kernel has no
backward: a CUDA tensor that requires grad is refused (SSM and hybrid
training are a later slice, ROADMAP.md Queue 1 item 12b).
"""

from __future__ import annotations

from typing import Tuple

import torch

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_MAX_N = 256   # d_state
_KERNEL_MAX_P = 128   # head_dim


def _shapes(x, dt, cum, B, C, chunk: int):
    """(b, s, h, p, g, n, nc) after checking the shapes fit together."""
    if x.dim() != 4 or dt.dim() != 3 or cum.dim() != 3 or B.dim() != 4 \
            or C.shape != B.shape:
        raise ValueError(f"ssd_chunk takes x (b,s,h,p), dt/cum (b,s,h) and "
                         f"B/C (b,s,g,n), got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(cum.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if dt.shape != (b, s, h) or cum.shape != (b, s, h) or \
            B.shape[:2] != (b, s) or g < 1 or h % g:
        raise ValueError(f"ssd_chunk: shapes do not fit: x {tuple(x.shape)}, "
                         f"dt {tuple(dt.shape)}, cum {tuple(cum.shape)}, B/C "
                         f"{tuple(B.shape)} (h must be a multiple of g)")
    if chunk < 1 or s % chunk:
        raise ValueError(f"ssd_chunk: s={s} must be a multiple of "
                         f"chunk={chunk}")
    return b, s, h, p, g, n, s // chunk


def ssd_chunk_plain(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, chunk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b,s,h,p); dt, cum (b,s,h); B, C (b,s,g,n); ``s % chunk == 0``.
    Returns ``y_intra (b,s,h,p)`` and ``states (b,nc,h,n,p)``, both f32."""
    b, s, h, p, g, n, nc = _shapes(x, dt, cum, B, C, chunk)
    rep = h // g
    f32 = torch.float32
    xs = x.to(f32).reshape(b, nc, chunk, h, p)
    dts = dt.to(f32).reshape(b, nc, chunk, h)
    cs = cum.to(f32).reshape(b, nc, chunk, h)
    Bs = B.to(f32).reshape(b, nc, chunk, g, n)
    Cs = C.to(f32).reshape(b, nc, chunk, g, n)
    # L[i,j] = exp(cum_i - cum_j) on and below the diagonal; above it the
    # difference is positive and exp could overflow, so it is never taken
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()[None, None, :, :, None]
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]           # (b,nc,i,j,h)
    L = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)
    CB = torch.einsum("bnigq,bnjgq->bnijg", Cs, Bs)
    W = CB.repeat_interleave(rep, dim=4) * L * dts[:, :, None, :, :]
    y = torch.einsum("bnijh,bnjhp->bnihp", W, xs).reshape(b, s, h, p)
    decay_end = torch.exp(cs[:, :, -1:, :] - cs)                 # (b,nc,c,h)
    Br = Bs.repeat_interleave(rep, dim=3)                        # (b,nc,c,h,n)
    states = torch.einsum("bnchq,bnchp,bnch->bnhqp", Br, xs,
                          dts * decay_end)
    return y, states


def _check_cuda_args(x, dt, cum, B, C, chunk: int):
    """Validate the kernel's inputs; returns :func:`_shapes`."""
    for name, t in (("dt", dt), ("cum", cum), ("B", B), ("C", C)):
        if t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}, got {t.device}")
    if x.dtype not in _KERNEL_DTYPES or B.dtype != x.dtype or \
            C.dtype != x.dtype:
        raise TypeError(f"ssd_chunk kernel takes x/B/C of one dtype in "
                        f"{tuple(_KERNEL_DTYPES)}, got {x.dtype}, {B.dtype}, "
                        f"{C.dtype}")
    if dt.dtype != torch.float32 or cum.dtype != torch.float32:
        raise TypeError(f"ssd_chunk kernel takes dt and cum in float32, got "
                        f"{dt.dtype}, {cum.dtype}")
    b, s, h, p, g, n, nc = _shapes(x, dt, cum, B, C, chunk)
    if n > _KERNEL_MAX_N or p > _KERNEL_MAX_P:
        raise ValueError(f"ssd_chunk kernel takes d_state <= {_KERNEL_MAX_N} "
                         f"and head_dim <= {_KERNEL_MAX_P}, got {n}, {p}")
    if b * h > 65535 or nc > 65535:
        raise ValueError(f"ssd_chunk kernel: b*h={b * h} and nc={nc} must "
                         f"each be <= 65535")
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have a contiguous last dim")
    if any(t.requires_grad for t in (x, dt, cum, B, C)):
        raise NotImplementedError(
            "ssd_chunk's CUDA kernel has no backward (the TPU kernel has "
            "none); SSM training is a later slice (ROADMAP.md Queue 1 item "
            "12b)")
    return b, s, h, p, g, n, nc


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor, chunk: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The intra-chunk SSD step (see the module doc): ``(y_intra (b,s,h,p),
    states (b,nc,h,n,p))``, both f32. On a CUDA tensor this launches the
    hand-written kernel on the current stream and adds one to
    ``ssd_chunk.launches``; on a CPU tensor it runs :func:`ssd_chunk_plain`
    and counts nothing."""
    if x.device.type == "cpu":
        return ssd_chunk_plain(x, dt, cum, B, C, chunk)
    if not x.is_cuda:
        raise ValueError(f"ssd_chunk: unsupported device {x.device}")
    from repro_torch.kernels._build import load
    b, s, h, p, g, n, nc = _check_cuda_args(x, dt, cum, B, C, chunk)
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    states = torch.empty((b, nc, h, n, p), dtype=torch.float32,
                         device=x.device)
    if y.numel() == 0 or states.numel() == 0:
        return y, states
    launch = load("ssd_chunk")
    with torch.cuda.device(x.device):
        err = launch(x.data_ptr(), dt.data_ptr(), cum.data_ptr(),
                     B.data_ptr(), C.data_ptr(), y.data_ptr(),
                     states.data_ptr(), *x.stride()[:3], *dt.stride(),
                     *cum.stride(), *B.stride()[:3], *C.stride()[:3],
                     b, s, h, p, g, n, chunk, _KERNEL_DTYPES[x.dtype],
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk kernel launch failed: CUDA error "
                           f"{err}")
    ssd_chunk.launches += 1
    return y, states


ssd_chunk.launches = 0
