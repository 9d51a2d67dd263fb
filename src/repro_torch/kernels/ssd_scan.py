"""Mamba2 SSD intra-chunk step and its backward: hand-written CUDA kernels
+ plain versions.

Port of ``repro.kernels.ssd_scan``. The blocked SSD scan
(:func:`repro_torch.models.ssm.ssd_chunked`) splits into a quadratic
intra-chunk part and a short inter-chunk recurrence; this module is the
intra-chunk part, in the model's layout rather than the Pallas kernel's
``(b*h, nc, c, ...)`` one:

* :func:`ssd_chunk` — the entry point the model calls: the dispatcher op
  ``repro_torch::ssd_chunk`` (``torch.library.custom_op``, with a fake
  for meta tensors and its autograd registered, so that ``remat="dots"``
  can keep its outputs). A CUDA tensor goes to the ``sm_90a`` kernel in
  ``csrc/ssd_chunk.cu`` (which replaces ``ssd_chunk_pallas``); a CPU
  tensor goes to :func:`ssd_chunk_plain`. There is no fallback: a CUDA
  call launches the kernel or raises. bf16 inputs with ``chunk <= 256``
  run on the tensor cores (one ``C B^T`` for many heads of a group); f32
  inputs, and longer chunks, on FFMA.
* Its backward, :func:`ssd_chunk_bwd`: on a CUDA tensor one of two
  hand-written routes (:func:`bwd_route`; counted in
  ``ssd_chunk_bwd.launches``): bf16 inputs with ``chunk <= 256`` (the
  training path of both SSM families) on the tensor cores,
  ``csrc/ssd_chunk_bwd_tc.cu`` (also counted in
  ``ssd_chunk_bwd.tc_launches``), the rest on FFMA, ``csrc/ssd_chunk_bwd.cu``;
  :func:`ssd_chunk_bwd_plain` on a CPU tensor. The TPU kernel has no
  backward: the reference differentiates its einsums through XLA.
* ``C`` may be float32 beside bf16 ``x`` and ``B``, provided its values are
  bf16's: the model passes the one f32 copy of C that also feeds the
  inter-chunk term, so that C's gradient is rounded once. The kernels read
  it rounded to bf16 (exact), and the backward returns dC in float32.
* :func:`ssd_chunk_plain` and :func:`ssd_chunk_bwd_plain` — plain f32
  einsums (``ssd_chunk_batched_ref`` in the reference, and its vjp); the
  CPU path, and what the kernels are held against on the card.

Per (batch, head, chunk), with ``i, j`` rows of the chunk::

    L[i,j] = exp(cum_i - cum_j)  for j <= i, else 0
    y      = ((C B^T) o L o dt_j) x
    state  = (B o dt o exp(cum_last - cum))^T x

and, given the output gradients ``dy`` and ``dst``, with ``CB = C B^T``,
``W = CB o L o dt_j``, ``e = exp(cum_last - cum)``, ``G = (dy x^T) o L``,
``M = G o CB o dt_j`` and ``r_j = sum_q B[j,q] (x_j . dst[q,:])``::

    dx   = W^T dy + (dt o e) o (B dst)
    dC   = (G o dt_j) B
    dB   = (G o dt_j)^T C + (dt o e) o (x dst^T)
    ddt  = colsum(G o CB) + e o r
    dcum = rowsum(M) - colsum(M) - dt o e o r,  dcum_last += sum_j dt_j e_j r_j

``dB`` and ``dC`` are summed over the heads of a group in f32 before they
are rounded to the inputs' dtype. The heads of a group read the group's
``B``/``C`` (head ``hh`` reads group ``hh // (h // g)``); nothing is
repeated over heads. ``L`` is taken only on and below the diagonal: above
it ``cum_i - cum_j > 0`` and ``exp`` can overflow, and a masked ``inf``
would turn the backward's zero cotangents into NaN.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_MAX_N = 256   # d_state
_KERNEL_MAX_P = 128   # head_dim
# the backward kernel keeps a chunk's 64-row tiles of x, B, dy and C in
# shared memory, up to 128 wide
_BWD_MAX_N = 128
_BWD_MAX_P = 128
# the backward's tensor-core route (bwd_route): S^T of a warp's 16 rows
# against up to 4 query tiles in registers, dx up to 64 wide, dB/dC up to
# 128; per-head row sums of at most 24 heads a block in shared memory
_TC_MAX_CHUNK = 256
_TC_MAX_P = 64
_TC_MAX_N = 128
_TC_MAX_HEADS = 24


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
            C.dtype not in (x.dtype, torch.float32):
        raise TypeError(f"ssd_chunk kernel takes x/B/C of one dtype in "
                        f"{tuple(_KERNEL_DTYPES)} (C may be float32 beside "
                        f"bf16 x), got {x.dtype}, {B.dtype}, {C.dtype}")
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
    return b, s, h, p, g, n, nc


def _kernel_C(x, C):
    """C as the kernels read it: an f32 C beside bf16 x (the model's one f32
    copy, whose values are bf16's) rounded to x's dtype, which is exact."""
    return C.to(x.dtype) if C.dtype != x.dtype else C


def _fwd(x, dt, cum, B, C, chunk: int):
    """The forward on ``x``'s device: the kernel (counted) or the plain
    version."""
    if x.device.type == "cpu":
        return ssd_chunk_plain(x, dt, cum, B, C, chunk)
    if not x.is_cuda:
        raise ValueError(f"ssd_chunk: unsupported device {x.device}")
    from repro_torch.kernels._build import load
    b, s, h, p, g, n, nc = _check_cuda_args(x, dt, cum, B, C, chunk)
    C = _kernel_C(x, C)
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


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------

def ssd_chunk_bwd_plain(x, dt, cum, B, C, dy: torch.Tensor,
                        dst: Optional[torch.Tensor], chunk: int):
    """The backward of :func:`ssd_chunk_plain` (the module doc's formulas
    as f32 einsums): given ``dy (b,s,h,p)`` and ``dst (b,nc,h,n,p)``
    (``None`` for zeros), returns ``(dx, ddt, dcum, dB, dC)``: ``dx`` in
    x's dtype, ``dB``/``dC`` in B's (summed over a group's heads in f32,
    then rounded once), ``ddt``/``dcum`` in f32."""
    b, s, h, p, g, n, nc = _shapes(x, dt, cum, B, C, chunk)
    rep = h // g
    f32 = torch.float32
    xs = x.to(f32).reshape(b, nc, chunk, h, p)
    dys = dy.to(f32).reshape(b, nc, chunk, h, p)
    dts = dt.to(f32).reshape(b, nc, chunk, h)
    cs = cum.to(f32).reshape(b, nc, chunk, h)
    Bh = B.to(f32).reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    Ch = C.to(f32).reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()[None, None, :, :, None]
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]           # (b,nc,i,j,h)
    L = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)
    CB = torch.einsum("bnihq,bnjhq->bnijh", Ch, Bh)
    dtj = dts[:, :, None, :, :]
    G = torch.einsum("bnihp,bnjhp->bnijh", dys, xs) * L
    Gd = G * dtj
    dx = torch.einsum("bnijh,bnihp->bnjhp", CB * L * dtj, dys)
    dCh = torch.einsum("bnijh,bnjhq->bnihq", Gd, Bh)
    dBh = torch.einsum("bnijh,bnihq->bnjhq", Gd, Ch)
    GCB = G * CB
    ddt = GCB.sum(2)
    M = GCB * dtj
    dcum = M.sum(3) - M.sum(2)
    if dst is not None:
        dsts = dst.to(f32)                                       # (b,nc,h,n,p)
        e = torch.exp(cs[:, :, -1:, :] - cs)                     # (b,nc,c,h)
        dte = dts * e
        dx = dx + dte[..., None] * torch.einsum("bnchq,bnhqp->bnchp", Bh,
                                                dsts)
        XD = torch.einsum("bnchp,bnhqp->bnchq", xs, dsts)
        dBh = dBh + dte[..., None] * XD
        r = (Bh * XD).sum(-1)
        ddt = ddt + e * r
        t = dte * r
        dcum = dcum - t
        dcum[:, :, -1, :] += t.sum(2)
    dB = dBh.reshape(b, nc, chunk, g, rep, n).sum(4).reshape(b, s, g, n)
    dC = dCh.reshape(b, nc, chunk, g, rep, n).sum(4).reshape(b, s, g, n)
    return (dx.reshape(b, s, h, p).to(x.dtype), ddt.reshape(b, s, h),
            dcum.reshape(b, s, h), dB.to(B.dtype), dC.to(C.dtype))


def _check_bwd_args(x, dt, cum, B, C, dy, dst, chunk: int):
    """Validate the backward kernel's inputs; returns :func:`_shapes`."""
    b, s, h, p, g, n, nc = _check_cuda_args(x, dt, cum, B, C, chunk)
    if n > _BWD_MAX_N or p > _BWD_MAX_P:
        raise ValueError(f"ssd_chunk_bwd kernel takes d_state <= "
                         f"{_BWD_MAX_N} and head_dim <= {_BWD_MAX_P}, got "
                         f"{n}, {p}")
    for name, t, shape in (("dy", dy, (b, s, h, p)),
                           ("dst", dst, (b, nc, h, n, p))):
        if t is None:
            continue
        if t.device != x.device or t.dtype != torch.float32 or \
                t.shape != shape:
            raise ValueError(f"ssd_chunk_bwd takes {name} {shape} float32 "
                             f"on {x.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    if dy.stride(3) != 1:
        raise ValueError("dy must have a contiguous last dim")
    if dst is not None and not dst.is_contiguous():
        raise ValueError("dst must be contiguous")
    return b, s, h, p, g, n, nc


def _vec_rows(t: torch.Tensor, elems: int) -> bool:
    """16-byte aligned base and rows: every stride over a dim longer than
    one and the last dim's size are multiples of ``elems`` elements."""
    return t.data_ptr() % 16 == 0 and t.shape[-1] % elems == 0 and all(
        st % elems == 0 for st, sz in zip(t.stride()[:-1], t.shape[:-1])
        if sz > 1)


def bwd_route(x, B, C, dy, dst, chunk: int) -> str:
    """The backward kernel's route for these inputs (``C`` as the kernels
    read it, :func:`_kernel_C`; both routes are held against
    :func:`ssd_chunk_bwd_plain`): ``"tc"``, the tensor cores
    (``csrc/ssd_chunk_bwd_tc.cu``) for bf16 x, B and C, ``chunk <= 256`` a
    multiple of 4, head_dim <= 64 and d_state <= 128, multiples of 8, on
    16-byte aligned rows; ``"ffma"``
    (``csrc/ssd_chunk_bwd.cu``) for everything else the kernels take."""
    p, n = x.shape[3], B.shape[3]
    tc = (x.dtype == torch.bfloat16 and B.dtype == torch.bfloat16
          and chunk <= _TC_MAX_CHUNK and chunk % 4 == 0 and p <= _TC_MAX_P
          and n <= _TC_MAX_N
          and C.dtype == torch.bfloat16 and _vec_rows(x, 8)
          and _vec_rows(B, 8) and _vec_rows(C, 8) and _vec_rows(dy, 4)
          and (dst is None or dst.data_ptr() % 16 == 0))
    return "tc" if tc else "ffma"


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def tc_heads_per_block(b: int, nc: int, g: int, rep: int, nt: int,
                       sms: int) -> int:
    """Heads a block of the tensor-core route takes: the fewest head sets
    a group (the least recomputing of C B^T and the fewest dB / dC
    partial sums) that still give each of its kernels' grids 4 blocks an
    SM (two are resident), at most ``_TC_MAX_HEADS`` heads a set, the
    heads shared evenly."""
    sets = -(-rep // _TC_MAX_HEADS)
    while sets < rep and b * nc * g * nt * sets < 4 * sms:
        sets += 1
    return -(-rep // sets)


def ssd_chunk_bwd(x, dt, cum, B, C, dy: torch.Tensor,
                  dst: Optional[torch.Tensor], chunk: int,
                  route: Optional[str] = None):
    """The backward of :func:`ssd_chunk`, ``(dx, ddt, dcum, dB, dC)`` as
    :func:`ssd_chunk_bwd_plain` returns them (dC in C's dtype). On a CUDA
    tensor this launches the hand-written kernel of :func:`bwd_route`'s
    route on the current stream and adds one to ``ssd_chunk_bwd.launches``
    (and, on the tensor cores, to ``ssd_chunk_bwd.tc_launches``); on a CPU
    tensor it runs :func:`ssd_chunk_bwd_plain` and counts nothing.
    ``route="ffma"`` takes the FFMA kernel whatever the inputs (to time it
    beside the other)."""
    if x.device.type == "cpu":
        return ssd_chunk_bwd_plain(x, dt, cum, B, C, dy, dst, chunk)
    if not x.is_cuda:
        raise ValueError(f"ssd_chunk_bwd: unsupported device {x.device}")
    from repro_torch.kernels._build import load
    b, s, h, p, g, n, nc = _check_bwd_args(x, dt, cum, B, C, dy, dst, chunk)
    if route not in (None, "ffma"):
        raise ValueError(f"ssd_chunk_bwd: unknown route {route!r}")
    Ck = _kernel_C(x, C)
    route = route or bwd_route(x, B, Ck, dy, dst, chunk)
    dev = x.device
    dx = torch.empty((b, s, h, p), dtype=x.dtype, device=dev)
    ddt = torch.empty((b, s, h), dtype=torch.float32, device=dev)
    dcum = torch.empty((b, s, h), dtype=torch.float32, device=dev)
    dB = torch.empty((b, s, g, n), dtype=B.dtype, device=dev)
    dC = torch.empty((b, s, g, n), dtype=C.dtype, device=dev)
    if dx.numel() == 0 or dB.numel() == 0:
        return dx.zero_(), ddt.zero_(), dcum.zero_(), dB.zero_(), dC.zero_()
    ptrs = (x.data_ptr(), dt.data_ptr(), cum.data_ptr(), B.data_ptr(),
            Ck.data_ptr(), dy.data_ptr(),
            0 if dst is None else dst.data_ptr(), dx.data_ptr(),
            ddt.data_ptr(), dcum.data_ptr(), dB.data_ptr(), dC.data_ptr())
    strides = (*x.stride()[:3], *dt.stride(), *cum.stride(),
               *B.stride()[:3], *Ck.stride()[:3], *dy.stride()[:3])
    dc_f32 = int(C.dtype != x.dtype)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == "tc":
        nt = -(-chunk // 64)
        hpb = tc_heads_per_block(b, nc, g, h // g, nt,
                                 _sm_count(dev.index or 0))
        f32, bf16 = torch.float32, torch.bfloat16
        # each head set's f32 dB and dC rows, dcum's row sums and the
        # state term's sums over each key tile, summed by the same launch;
        # dy and dst split into bf16 hi + lo and dt, cum by head, made by
        # its first kernel
        part = torch.empty((2, -(-(h // g) // hpb), b, s, g, n), dtype=f32,
                           device=dev)
        mrow = torch.empty((b, s, h), dtype=f32, device=dev)
        tsum = torch.empty((b, nc, h, nt), dtype=f32, device=dev)
        dy_split = torch.empty((2, b, s, h, p), dtype=bf16, device=dev)
        dst_split = None if dst is None else torch.empty(
            (2,) + dst.shape, dtype=bf16, device=dev)
        vecs = torch.empty((2, b, h, s), dtype=f32, device=dev)
        launch = load("ssd_chunk_bwd_tc")
        with torch.cuda.device(dev):
            err = launch(*ptrs, part.data_ptr(), mrow.data_ptr(),
                         tsum.data_ptr(), dy_split[0].data_ptr(),
                         dy_split[1].data_ptr(),
                         0 if dst is None else dst_split[0].data_ptr(),
                         0 if dst is None else dst_split[1].data_ptr(),
                         vecs[0].data_ptr(), vecs[1].data_ptr(), *strides,
                         b, s, h, p, g, n, chunk, hpb, dc_f32, stream)
    else:
        # each head's dB and dC rows in f32, summed over the group's heads
        # by the same launch
        part = torch.empty((2, b, s, h, n), dtype=torch.float32, device=dev)
        launch = load("ssd_chunk_bwd")
        with torch.cuda.device(dev):
            err = launch(*ptrs, part.data_ptr(), *strides, b, s, h, p, g, n,
                         chunk, _KERNEL_DTYPES[x.dtype], dc_f32, stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk_bwd kernel ({route}) launch failed: "
                           f"CUDA error {err}")
    ssd_chunk_bwd.launches += 1
    if route == "tc":
        ssd_chunk_bwd.tc_launches += 1
    return dx, ddt, dcum, dB, dC


# ---------------------------------------------------------------------------
# the dispatcher op
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::ssd_chunk", mutates_args=())
def ssd_chunk_op(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, chunk: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`ssd_chunk` as one dispatcher op with its autograd. An f32
    ``C`` beside bf16 ``x`` must hold values of x's dtype (the kernels round
    it to bf16); its gradient comes back in f32."""
    return _fwd(x, dt, cum, B, C, chunk)


@ssd_chunk_op.register_fake
def _ssd_chunk_fake(x, dt, cum, B, C, chunk):
    b, s, h, p = x.shape
    return (x.new_empty((b, s, h, p), dtype=torch.float32),
            x.new_empty((b, s // chunk, h, B.shape[3], p),
                        dtype=torch.float32))


def _ssd_chunk_setup(ctx, inputs, output):
    x, dt, cum, B, C, chunk = inputs
    ctx.save_for_backward(x, dt, cum, B, C)
    ctx.chunk = chunk


def _ssd_chunk_backward(ctx, dy, dst):
    x, dt, cum, B, C = ctx.saved_tensors
    dst = None if dst is None else dst.contiguous()
    dx, ddt, dcum, dB, dC = ssd_chunk_bwd(x, dt, cum, B, C, dy, dst,
                                          ctx.chunk)
    return dx, ddt.to(dt.dtype), dcum.to(cum.dtype), dB, dC, None


ssd_chunk_op.register_autograd(_ssd_chunk_backward,
                               setup_context=_ssd_chunk_setup)


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor, chunk: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The intra-chunk SSD step (see the module doc): ``(y_intra (b,s,h,p),
    states (b,nc,h,n,p))``, both f32. On a CUDA tensor this launches the
    hand-written kernel on the current stream and adds one to
    ``ssd_chunk.launches``; on a CPU tensor it runs :func:`ssd_chunk_plain`
    and counts nothing. Differentiable in x, dt, cum, B and C (the backward
    is :func:`ssd_chunk_bwd`). C may be float32 beside bf16 x and B if its
    values are bf16's (see the module doc)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_chunk: unsupported device {x.device}")
    return ssd_chunk_op(x, dt, cum, B, C, chunk)


ssd_chunk.launches = 0
ssd_chunk_bwd.launches = 0
ssd_chunk_bwd.tc_launches = 0
