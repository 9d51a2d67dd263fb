"""Shared neural-net building blocks (plain PyTorch functions on tensors).

Port of ``repro.models.layers``: the same math and the same layouts
(``(B, S, H, hd)`` activations, ``(in, out)`` weights used as ``x @ W``).
Norms and RoPE compute in float32 and cast back, as the reference does.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------


def rms_norm(x, scale=None, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    if scale is not None:
        x = x * scale.float()
    return x.to(dt)


def layer_norm(x, scale=None, bias=None, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        x = x * scale.float()
    if bias is not None:
        x = x + bias.float()
    return x.to(dt)


def apply_norm(cfg: ModelConfig, x, params: Optional[dict]):
    """Dispatch on cfg.norm. ``nonparametric`` (OLMo) takes no params."""
    if cfg.norm == "nonparametric":
        return layer_norm(x, None, None)
    if cfg.norm == "layernorm":
        return layer_norm(x, params["scale"], params.get("bias"))
    return rms_norm(x, params["scale"])


# ---------------------------------------------------------------------------
# activations / gated FFN
# ---------------------------------------------------------------------------

def act_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(name)


def gated_ffn(cfg: ModelConfig, x, p, comm=None, purpose: str = "tp_mlp"):
    """GeGLU/SwiGLU: act(x @ w_gate) * (x @ w_up) @ w_down.

    Under the manual-TP serve path (``comm``, a
    :class:`repro_torch.serve.comm.ServeComm`) w_gate/w_up arrive
    column-sharded and w_down row-sharded, so ``h @ w_down`` is a partial
    sum: it is all-reduced on the purpose's VCI stream, and the replicated
    ``b_down`` is added AFTER the reduce (adding it to the partial would
    count it tp times).
    """
    a = act_fn(cfg.hidden_act)
    h = a(x @ p["w_gate"]) * (x @ p["w_up"])
    if "b_up" in p:
        h = h + p["b_up"]
    y = h @ p["w_down"]
    if comm is not None:
        y = comm.psum(y, purpose)
    if "b_down" in p:
        y = y + p["b_down"]
    return y


# ---------------------------------------------------------------------------
# gradient dtype boundary (opt "bf16_grads")
# ---------------------------------------------------------------------------

class _BF16GradBoundary(torch.autograd.Function):
    """Identity forward; the backward rounds the cotangent through bf16
    (the reference's ``bf16_grad_boundary`` custom_vjp). Autograd casts
    the bf16 cotangent back to the input's dtype."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16)


def maybe_bf16_grads(cfg: ModelConfig, x):
    if "bf16_grads" in cfg.opts:
        return _BF16GradBoundary.apply(x)
    return x


# ---------------------------------------------------------------------------
# rotary embeddings (interleaved pairs x[..., ::2] / x[..., 1::2])
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, hd); positions: (B, S) or (S,)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)           # (hd/2,)
    ang = positions[..., None].float() * freqs               # (B,S,hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if ang.ndim == 2:  # (S, hd/2) -> broadcast batch
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]        # (B,S,1,hd/2)
    dt = x.dtype
    x1, x2 = x[..., ::2].float(), x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(dt)


# ---------------------------------------------------------------------------
# init (seeded torch.Generator; generated in float32 on the target device)
# ---------------------------------------------------------------------------

# a narrower leaf of more elements than this is drawn in pieces of this
# many: its float32 draw then never needs a float32 copy of the whole leaf
# on the card (a 4.46 B-element bf16 expert table would need 17.8 GB)
_DRAW_CHUNK = 1 << 28


def _trunc_normal(gen: torch.Generator, shape: Sequence[int], std: float,
                  dtype, device) -> torch.Tensor:
    shape = tuple(shape)
    n = math.prod(shape)
    if n <= _DRAW_CHUNK or dtype == torch.float32:
        t = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                    generator=gen)
        return t.mul_(std).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for i in range(0, n, _DRAW_CHUNK):
        t = torch.empty((min(_DRAW_CHUNK, n - i),), dtype=torch.float32,
                        device=device)
        torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                    generator=gen)
        flat[i:i + t.numel()].copy_(t.mul_(std))
    return out


def dense_init(gen: torch.Generator, shape, in_axis: int = -2,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Truncated normal at +-2 sigma, std ``1/sqrt(fan_in)``."""
    return _trunc_normal(gen, shape, 1.0 / math.sqrt(shape[in_axis]), dtype,
                         device)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Truncated normal at +-2 sigma, std 0.02."""
    return _trunc_normal(gen, shape, 0.02, dtype, device)
