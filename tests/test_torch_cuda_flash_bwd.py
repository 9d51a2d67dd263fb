"""The flash-attention backward kernel (``csrc/flash_attention_bwd.cu``)
against the plain backward, on a CUDA card (marker ``cuda``).

A hand-written kernel has no CPU mode, so these skip without a card. On
the GPU machine (no JAX there; this file imports none):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_flash_bwd.py

Tolerances, each against the plain backward (``flash_attention_bwd_plain``)
on the same q, k, v, dO and the forward kernel's o and lse:

* f32: max |kernel - plain| <= 2e-5 x max(1, max |plain|) for dq, dk and
  dv. Both are f32 with no TF32; they sum in other orders (dk and dv over
  up to Sq x H / KV terms), which costs a few ulps of the largest term;
* bf16: max |kernel - f32| <= 1.25 x max |plain bf16 - f32| + 1e-3 x max
  |f32|, where "f32" is the plain backward run in f32 on the upcast
  inputs: the kernel may be no worse than the plain bf16 version's own
  rounding (it rounds P and dS to bf16 as the plain version does, and
  keeps S and dP in f32 where the plain version rounds them too).
"""

import pytest
import torch

import _torch_cpu  # noqa: F401  (one intra-op thread: see its docstring)
from repro_torch.kernels import flash_attention as fa

pytestmark = pytest.mark.cuda

HEAD_DIMS = (64, 96, 112, 128, 256)
# name, (B, Sq, Skv, H, KV), causal, window, q/k/v as views of one fused
# (B, S, H + 2 KV, hd) projection
CASES = (
    ("mha causal", (2, 256, 256, 4, 4), True, None, False),
    ("gqa 4:2", (2, 200, 200, 4, 2), False, None, False),
    ("gqa 6:1 window", (1, 192, 192, 12, 2), True, 64, False),
    ("mqa", (2, 128, 128, 8, 1), True, None, False),
    # rows qp >= Skv + window - 1 have no valid key (uniform softmax)
    ("empty rows causal", (1, 300, 100, 4, 2), True, 40, False),
    ("empty rows", (1, 160, 64, 2, 1), False, 32, False),
    ("ragged 1000", (1, 1000, 1000, 2, 2), True, None, False),
    ("strided fused qkv", (2, 130, 130, 6, 2), True, None, True),
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _inputs(dev, dtype, b, sq, skv, h, kvh, hd, fused, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    if fused:
        assert sq == skv
        qkv = torch.randn((b, sq, h + 2 * kvh, hd), generator=gen,
                          device=dev).to(dtype)
        q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kvh], qkv[:, :, h + kvh:]
    else:
        q = torch.randn((b, sq, h, hd), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((b, skv, kvh, hd), generator=gen,
                            device=dev).to(dtype) for _ in range(2))
    do = torch.randn((b, sq, h, hd), generator=gen, device=dev).to(dtype)
    return q, k, v, do


def _check(q, k, v, do, causal, window):
    """The kernel twice (equal bits, one launch a call) against the plain
    backward at the module doc's tolerance; returns the errors."""
    kw = dict(causal=causal, window=window)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    o = o.contiguous()
    n0 = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == n0 + 2
    errs = []
    for name, g, a, t in zip(("dq", "dk", "dv"), got, again, (q, k, v)):
        assert g.shape == t.shape and g.dtype == t.dtype, name
        assert torch.equal(_bits(g), _bits(a)), f"{name}: other bits"
        assert bool(torch.isfinite(g).all()), name
    if q.dtype == torch.float32:
        want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            err = (g - w).abs().max().item()
            tol = 2e-5 * max(1.0, w.abs().max().item())
            assert err <= tol, f"{name}: err {err:.3e} > tol {tol:.3e}"
            errs.append(err)
    else:
        ref = fa.flash_attention_bwd_plain(
            *(t.float() for t in (q, k, v, o)), lse, do.float(), **kw)
        plain = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        for name, g, p, r in zip(("dq", "dk", "dv"), got, plain, ref):
            err = (g.float() - r).abs().max().item()
            perr = (p.float() - r).abs().max().item()
            tol = 1.25 * perr + 1e-3 * r.abs().max().item()
            assert err <= tol, (f"{name}: err {err:.3e} > tol {tol:.3e} "
                                f"(plain bf16 err {perr:.3e})")
            errs.append(err)
    return errs


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_bwd_kernel_matches_plain(cuda_device, case, dtype, hd):
    _, (b, sq, skv, h, kvh), causal, window, fused = case
    q, k, v, do = _inputs(cuda_device, dtype, b, sq, skv, h, kvh, hd, fused)
    if fused:
        assert not q.is_contiguous() and q.stride(3) == 1
    _check(q, k, v, do, causal, window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_launches_the_bwd_kernel_once(cuda_device, monkeypatch,
                                               dtype):
    """``torch.autograd.grad`` through :func:`flash_attention` on CUDA
    tensors: one forward and one backward launch, the plain versions never
    run, and the gradients equal the backward kernel's own call."""
    q, k, v, do = _inputs(cuda_device, dtype, 2, 256, 256, 8, 2, 128, True)
    o, lse = fa.flash_attention_fwd(q, k, v, window=100)
    want = fa.flash_attention_bwd(q, k, v, o.contiguous(), lse, do,
                                  window=100)

    def refuse(*a, **kw):
        raise AssertionError("a plain version ran on the card")
    monkeypatch.setattr(fa, "flash_attention_fwd_plain", refuse)
    monkeypatch.setattr(fa, "flash_attention_bwd_plain", refuse)
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    n0 = (fa.flash_attention.launches, fa.flash_attention_bwd.launches)
    grads = torch.autograd.grad(fa.flash_attention(*ins, window=100), ins,
                                do)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches - n0[0],
            fa.flash_attention_bwd.launches - n0[1]) == (1, 1)
    for g, w in zip(grads, want):
        assert torch.equal(_bits(g), _bits(w))


def test_bwd_kernel_refuses_what_it_cannot_take(cuda_device):
    q, k, v, do = _inputs(cuda_device, torch.float16, 1, 16, 16, 2, 2, 64,
                          False)
    lse = torch.zeros((1, 2, 16), device=cuda_device)
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention_bwd(q, k, v, q, lse, do)
    q, k, v, do = _inputs(cuda_device, torch.bfloat16, 1, 16, 16, 2, 2, 32,
                          False)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_bwd(q, k, v, q, lse, do)
    with pytest.raises(ValueError, match="start"):
        fa.flash_attention_bwd(q, k, v, q, lse, do,
                               start=torch.zeros(1, dtype=torch.int32,
                                                 device=cuda_device))
