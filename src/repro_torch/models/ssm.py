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
             device=None) -> "SSMState":
        c = cfg.ssm
        d_in = c.d_inner(cfg.d_model)
        ch = d_in + 2 * c.ngroups * c.d_state
        h = c.num_heads(cfg.d_model)
        return cls(
            torch.zeros((batch, c.conv_width - 1, ch), dtype=dtype,
                        device=device),
            torch.zeros((batch, h, c.d_state, c.head_dim),
                        dtype=torch.float32, device=device),
        )


def _split_proj(cfg: ModelConfig, zxbcdt):
    c = cfg.ssm
    d_in = c.d_inner(cfg.d_model)
    d_bc = 2 * c.ngroups * c.d_state
    nh = c.num_heads(cfg.d_model)
    return torch.split(zxbcdt, [d_in, d_in + d_bc, nh], dim=-1)


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


def _heads_out(cfg: ModelConfig, y, xv, z, p):
    """``y + D x``, the gate ``silu(z)``, the gated RMS norm and
    ``out_proj`` (shared by prefill and decode; ``y``/``xv`` end in
    ``(h, head_dim)``)."""
    y = y + xv * p["D"].float()[:, None].to(xv.dtype)
    y = y.reshape(y.shape[:-2] + (-1,))
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["gate_norm"])
    return y @ p["out_proj"].to(y.dtype)


def mamba2_forward(cfg: ModelConfig, x, p, shard=None,
                   initial: Optional[SSMState] = None
                   ) -> Tuple[torch.Tensor, SSMState]:
    """Full-sequence Mamba2 block. x: (b,s,d) -> (y: (b,s,d), final state).
    ``initial.ssd`` seeds the scan; the conv starts from zeros (as the
    reference's prefill does). ``shard`` (a :class:`repro_torch.dist.
    sharding.Sharder`) hooks the heads, as the reference's does."""
    c = cfg.ssm
    b, s, _ = x.shape
    d_in = c.d_inner(cfg.d_model)
    h = c.num_heads(cfg.d_model)

    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, raw_xbc, dt = _split_proj(cfg, zxbcdt)
    xbc = F.silu(_causal_conv(raw_xbc, p["conv_w"]))
    xv, B, C = torch.split(xbc, [d_in, c.ngroups * c.d_state,
                                 c.ngroups * c.d_state], dim=-1)
    xv = xv.reshape(b, s, h, c.head_dim)
    B = B.reshape(b, s, c.ngroups, c.d_state)
    C = C.reshape(b, s, c.ngroups, c.d_state)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    if shard is not None:
        xv = shard.heads(xv)

    init_ssd = initial.ssd if initial is not None else None
    y, final = ssd_chunked(xv, dt, A, B, C, chunk=c.chunk_size,
                           initial_state=init_ssd)
    out = _heads_out(cfg, y, xv, z, p)

    # conv tail state for decode continuation: the last width-1 rows of the
    # unpadded pre-conv channels (left zero-padded for a short prompt)
    pad_needed = c.conv_width - 1
    conv_state = raw_xbc[:, -pad_needed:] if s >= pad_needed else F.pad(
        raw_xbc, (0, 0, pad_needed - s, 0))
    return out, SSMState(conv_state, final)


def mamba2_decode(cfg: ModelConfig, x, p, state: SSMState
                  ) -> Tuple[torch.Tensor, SSMState]:
    """One-token Mamba2 step. x: (b,1,d)."""
    c = cfg.ssm
    b = x.shape[0]
    d_in = c.d_inner(cfg.d_model)
    h = c.num_heads(cfg.d_model)

    zxbcdt = x[:, 0] @ p["in_proj"].to(x.dtype)              # (b, proj)
    z, xbc, dt = _split_proj(cfg, zxbcdt)
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

    xv, B, C = torch.split(xbc, [d_in, c.ngroups * c.d_state,
                                 c.ngroups * c.d_state], dim=-1)
    xv = xv.reshape(b, h, c.head_dim)
    B = B.reshape(b, c.ngroups, c.d_state)
    C = C.reshape(b, c.ngroups, c.d_state)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    y, new_ssd = ssd_decode_step(state.ssd, xv, dt, A, B, C)
    out = _heads_out(cfg, y, xv, z, p)[:, None]
    return out, SSMState(new_conv, new_ssd)
