"""Mamba2 / SSD (state-space duality) layer [arXiv:2405.21060], PyTorch port.

Port of ``repro.models.ssm``. Prefill uses the blocked SSD algorithm: the
sequence is split into chunks of ``chunk_size``; within a chunk the
quadratic (attention-dual) form runs in
:func:`repro_torch.kernels.ssd_scan.ssd_chunk` (the hand-written kernel on
the card), across chunks a short recurrence carries the ``(h, n, p)``
state. Decode is the O(1) recurrent update. Everything that is not the
intra-chunk step is plain torch in f32, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ssd_chunk
from repro_torch.models.layers import rms_norm

# ---------------------------------------------------------------------------
# the SSD scan itself (head-parallel; f32 internally)
# ---------------------------------------------------------------------------


def ssd_chunked(x, dt, A, B, C, *, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked SSD.

    x:  (b, s, h, p)   values
    dt: (b, s, h)      positive step sizes (already softplus'd + bias)
    A:  (h,)           negative per-head decay rates
    B:  (b, s, g, n)   input projections  (g groups broadcast over heads)
    C:  (b, s, g, n)   output projections
    initial_state: (b, h, n, p) or None (zeros)
    returns (y: (b,s,h,p) in x's dtype, final_state: (b,h,n,p) f32)
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    s_orig = s
    f32 = torch.float32
    dt = dt.to(f32)
    if s % chunk:
        # pad with dt=0 steps: decay exp(0)=1 keeps the state, dt_j=0 zeroes
        # the padded tokens' contributions — exact for y[:s] and final_state.
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
        s = s + pad
    nc = s // chunk
    rep = h // g

    cum = (dt * A.to(f32)).reshape(b, nc, chunk, h).cumsum(dim=2)
    # one f32 copy of C feeds the intra-chunk step and the inter-chunk
    # term, as in the reference, so that autograd adds their two f32
    # gradients and C's dtype conversion rounds the sum once
    Cs = C.to(f32)
    y_intra, st_loc = ssd_chunk(x, dt, cum.reshape(b, s, h), B, Cs, chunk)

    # ---- inter-chunk recurrence: a loop over the nc chunks ----------------
    a = torch.exp(cum[:, :, -1, :])[..., None, None]          # (b,nc,h,1,1)
    state = (torch.zeros((b, h, n, p), dtype=f32, device=x.device)
             if initial_state is None else initial_state.to(f32))
    entering = []                     # state ENTERING chunk k
    for k in range(nc):
        entering.append(state)
        state = a[:, k] * state + st_loc[:, k]
    s_prev = torch.stack(entering, dim=1).reshape(b, nc, g, rep, n, p)

    decay_in = torch.exp(cum).reshape(b, nc, chunk, g, rep, 1)
    y_inter = torch.einsum("bncgq,bngrqp->bncgrp",
                           Cs.reshape(b, nc, chunk, g, n), s_prev) * decay_in
    y = y_intra + y_inter.reshape(b, s, h, p)
    return y[:, :s_orig].to(x.dtype), state


def ssd_decode_step(state, x, dt, A, B, C):
    """O(1) recurrent step.

    state: (b,h,n,p); x: (b,h,p); dt: (b,h); A: (h,); B,C: (b,g,n)
    returns (y: (b,h,p), new_state)
    """
    f32 = torch.float32
    rep = x.shape[1] // B.shape[1]
    Bh = B.to(f32).repeat_interleave(rep, dim=1)              # (b,h,n)
    Ch = C.to(f32).repeat_interleave(rep, dim=1)
    dtf = dt.to(f32)
    decay = torch.exp(dtf * A.to(f32))[..., None, None]       # (b,h,1,1)
    inject = torch.einsum("bhq,bhp,bh->bhqp", Bh, x.to(f32), dtf)
    new_state = decay * state.to(f32) + inject
    y = torch.einsum("bhq,bhqp->bhp", Ch, new_state)
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# the full Mamba2 block (projections + conv + scan + gated norm)
# ---------------------------------------------------------------------------

class SSMState(NamedTuple):
    conv: torch.Tensor   # (b, conv_width-1, d_conv_channels)
    ssd: torch.Tensor    # (b, h, n, p) f32

    @classmethod
    def init(cls, cfg: ModelConfig, batch: int, dtype=torch.float32,
             device=None, parts: int = 1) -> "SSMState":
        """Zeros; ``parts`` > 1: one model rank's slice of a block split
        over ``parts`` ranks (``CH / parts`` conv channels, ``h / parts``
        heads, the reference's ``cache_shardings`` layout)."""
        c = cfg.ssm
        d_in = c.d_inner(cfg.d_model)
        ch = d_in + 2 * c.ngroups * c.d_state
        h = c.num_heads(cfg.d_model)
        if ch % parts or h % parts:
            raise ValueError(f"{cfg.name}: {ch} conv channels and {h} heads "
                             f"do not split into {parts} slices")
        return cls(
            torch.zeros((batch, c.conv_width - 1, ch // parts), dtype=dtype,
                        device=device),
            torch.zeros((batch, h // parts, c.d_state, c.head_dim),
                        dtype=torch.float32, device=device),
        )


class _Part(NamedTuple):
    """A model rank's part of a Mamba2 block split over ``size`` ranks
    (``size`` 1: the whole block): rank ``index``'s ``d_in`` channels of
    ``z`` and of the gated norm (its heads' values), its ``ch`` conv
    channels (a contiguous slice of x | B | C before the conv), its ``h``
    heads, and the ``g`` B/C groups from ``g0`` that its heads read."""

    index: int
    size: int
    d_in: int
    ch: int
    h: int
    g0: int
    g: int

    @classmethod
    def of(cls, cfg: ModelConfig, comm=None) -> "_Part":
        c = cfg.ssm
        n = 1 if comm is None else comm.size
        r = 0 if comm is None else comm.index
        d_in = c.d_inner(cfg.d_model)
        h = c.num_heads(cfg.d_model) // n
        rep = c.num_heads(cfg.d_model) // c.ngroups
        g0 = r * h // rep
        return cls(r, n, d_in // n, (d_in + 2 * c.ngroups * c.d_state) // n,
                   h, g0, (r * h + h - 1) // rep + 1 - g0)


def _rank_params(cfg: ModelConfig, p, part: _Part):
    """The block's leaves cut to ``part``: ``in_proj``'s columns of its
    ``z``, its pre-conv channels and its ``dt`` as one weight; ``conv_w``'s
    channels; ``A_log``, ``D`` and ``dt_bias`` of its heads; ``gate_norm``
    of its heads' values. ``out_proj`` arrives as the rank's row slice,
    which is its heads' values (the heads divide the line)."""
    c = cfg.ssm
    d_in = c.d_inner(cfg.d_model)
    r, dl, cl, hl = part.index, part.d_in, part.ch, part.h
    lo_x, lo_dt = d_in, 2 * d_in + 2 * c.ngroups * c.d_state
    w = p["in_proj"]
    heads = slice(r * hl, (r + 1) * hl)
    vals = slice(r * dl, (r + 1) * dl)
    return {
        "in_proj": torch.cat([w[:, vals],
                              w[:, lo_x + r * cl:lo_x + (r + 1) * cl],
                              w[:, lo_dt + r * hl:lo_dt + (r + 1) * hl]], -1),
        "conv_w": p["conv_w"][:, r * cl:(r + 1) * cl],
        "A_log": p["A_log"][heads], "D": p["D"][heads],
        "dt_bias": p["dt_bias"][heads], "gate_norm": p["gate_norm"][vals],
        "out_proj": p["out_proj"],
    }


def _split_proj(cfg: ModelConfig, zxbcdt, part: Optional[_Part] = None):
    """``(z, x | B | C before the conv, dt)`` of the projection (of
    ``part``'s columns; the whole block's by default)."""
    part = part or _Part.of(cfg)
    return torch.split(zxbcdt, [part.d_in, part.ch, part.h], dim=-1)


def _heads_in(cfg: ModelConfig, xbc, part: _Part, comm=None):
    """The conv's output (``(..., ch)``, this part's channels) -> the
    part's head values ``(..., d_in)`` and its groups' B and C ``(..., g
    * n)``. Split over model ranks, one gather of the line's channels
    first: every rank's heads read B and C, so its backward
    reduce-scatters (``gather_sum``)."""
    c = cfg.ssm
    gn = c.ngroups * c.d_state
    if comm is None:
        return torch.split(xbc, [part.d_in, gn, gn], dim=-1)
    xbc = comm.gather_sum(xbc, -1)
    d_in = part.d_in * part.size
    lo, hi = part.g0 * c.d_state, (part.g0 + part.g) * c.d_state
    xv = xbc[..., part.index * part.d_in:(part.index + 1) * part.d_in]
    # contiguous heads: the kernels' vector loads need aligned rows
    return (xv.contiguous(), xbc[..., d_in + lo:d_in + hi],
            xbc[..., d_in + gn + lo:d_in + gn + hi])


def _causal_conv(xbc, w):
    """Depthwise causal conv. xbc: (b,s,ch); w: (width, ch). The
    reference's ``width`` shifted multiply-adds in f32 (no cuDNN, so no
    TF32 on the card)."""
    width = w.shape[0]
    s = xbc.shape[1]
    xp = F.pad(xbc, (0, 0, width - 1, 0)).float()
    wf = w.float()
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(width):
        out = out + xp[:, i: i + s] * wf[i]
    return out.to(xbc.dtype)


def _line_rms_norm(x, scale, comm, width: int, eps: float = 1e-6):
    """:func:`rms_norm` of a row split over ``comm``'s ranks (``width``
    elements in all): the sum of squares summed over the line. Each rank's
    factor scales only its own slice, so the sum's gradient is summed over
    the line too (``copy`` of ``psum``)."""
    dt = x.dtype
    x = x.float()
    ss = comm.copy(comm.psum(torch.sum(x * x, dim=-1, keepdim=True)))
    x = x * torch.rsqrt(ss / width + eps)
    x = x * scale.float()
    return x.to(dt)


def _heads_out(cfg: ModelConfig, y, xv, z, p, comm=None):
    """``y + D x``, the gate ``silu(z)``, the gated RMS norm and
    ``out_proj`` (shared by prefill and decode; ``y``/``xv`` end in
    ``(h, head_dim)``). Split over ``comm``'s ranks: the norm's sum of
    squares summed over the line, ``out_proj`` row-parallel and its
    partial sums summed."""
    y = y + xv * p["D"].float()[:, None].to(xv.dtype)
    y = y.reshape(y.shape[:-2] + (-1,))
    y = y * F.silu(z.float()).to(y.dtype)
    if comm is None:
        return rms_norm(y, p["gate_norm"]) @ p["out_proj"].to(y.dtype)
    y = _line_rms_norm(y, p["gate_norm"], comm, cfg.ssm.d_inner(cfg.d_model))
    return comm.psum(y @ p["out_proj"].to(y.dtype))


def _check_state(cfg: ModelConfig, state: Optional[SSMState], part: _Part):
    if state is not None and (state.conv.shape[-1] != part.ch
                              or state.ssd.shape[1] != part.h):
        raise ValueError(
            f"{cfg.name}: a rank of {part.size} computes {part.ch} conv "
            f"channels and {part.h} heads, but its state holds "
            f"{state.conv.shape[-1]} and {state.ssd.shape[1]}")


def mamba2_forward(cfg: ModelConfig, x, p, shard=None,
                   initial: Optional[SSMState] = None, comm=None
                   ) -> Tuple[torch.Tensor, SSMState]:
    """Full-sequence Mamba2 block. x: (b,s,d) -> (y: (b,s,d), final state).
    ``initial.ssd`` seeds the scan; the conv starts from zeros (as the
    reference's prefill does). ``shard`` (a :class:`repro_torch.dist.
    sharding.Sharder`) hooks the heads, as the reference's does.

    ``comm`` (a model line, :class:`repro_torch.dist.tp.LineComm`): the
    block is split over its ranks and ``x`` has entered through its
    ``copy``. Rank ``r`` projects its ``z``, its slice of the pre-conv
    channels and its ``dt`` from ``p`` (``in_proj`` whole, ``out_proj``
    its row slice, :meth:`~repro_torch.dist.sharding.Sharder.ssm_site`),
    convolves its channels, gathers the line's conv output once, scans
    its heads and returns its part of the output, summed over the line,
    and its slice of the state: ``(b, width-1, CH/n)`` and ``(b, h/n, n,
    p)``."""
    c = cfg.ssm
    b, s, _ = x.shape
    part = _Part.of(cfg, comm)
    _check_state(cfg, initial, part)
    if comm is not None:
        p = _rank_params(cfg, p, part)

    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, raw_xbc, dt = _split_proj(cfg, zxbcdt, part)
    xbc = F.silu(_causal_conv(raw_xbc, p["conv_w"]))
    xv, B, C = _heads_in(cfg, xbc, part, comm)
    xv = xv.reshape(b, s, part.h, c.head_dim)
    B = B.reshape(b, s, part.g, c.d_state)
    C = C.reshape(b, s, part.g, c.d_state)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    if shard is not None:
        xv = shard.heads(xv)

    init_ssd = initial.ssd if initial is not None else None
    y, final = ssd_chunked(xv, dt, A, B, C, chunk=c.chunk_size,
                           initial_state=init_ssd)
    out = _heads_out(cfg, y, xv, z, p, comm)

    # conv tail state for decode continuation: the last width-1 rows of the
    # unpadded pre-conv channels (left zero-padded for a short prompt)
    pad_needed = c.conv_width - 1
    conv_state = raw_xbc[:, -pad_needed:] if s >= pad_needed else F.pad(
        raw_xbc, (0, 0, pad_needed - s, 0))
    return out, SSMState(conv_state, final)


def mamba2_decode(cfg: ModelConfig, x, p, state: SSMState, comm=None
                  ) -> Tuple[torch.Tensor, SSMState]:
    """One-token Mamba2 step. x: (b,1,d). ``comm``: split over the line's
    ranks as :func:`mamba2_forward` is; ``state`` is this rank's slice."""
    c = cfg.ssm
    b = x.shape[0]
    part = _Part.of(cfg, comm)
    _check_state(cfg, state, part)
    if comm is not None:
        p = _rank_params(cfg, p, part)

    zxbcdt = x[:, 0] @ p["in_proj"].to(x.dtype)              # (b, proj)
    z, xbc, dt = _split_proj(cfg, zxbcdt, part)
    # conv over [state ; new], in the wider of the two dtypes as the
    # reference's concatenate promotes (an fp8 tail, which the reference
    # cannot promote, is read in the activations' dtype); the new tail is
    # stored back in the cache's dtype
    cdt = state.conv.dtype
    wdt = xbc.dtype if cdt == torch.float8_e4m3fn else \
        torch.promote_types(cdt, xbc.dtype)
    window = torch.cat([state.conv.to(wdt), xbc[:, None].to(wdt)],
                       dim=1)                                 # (b,w,ch)
    w = p["conv_w"].float()
    xbc = F.silu(torch.einsum("bwc,wc->bc", window.float(), w)).to(x.dtype)
    new_conv = window[:, 1:].to(cdt)

    xv, B, C = _heads_in(cfg, xbc, part, comm)
    xv = xv.reshape(b, part.h, c.head_dim)
    B = B.reshape(b, part.g, c.d_state)
    C = C.reshape(b, part.g, c.d_state)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    y, new_ssd = ssd_decode_step(state.ssd, xv, dt, A, B, C)
    out = _heads_out(cfg, y, xv, z, p, comm)[:, None]
    return out, SSMState(new_conv, new_ssd)
