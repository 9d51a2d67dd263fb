"""The gradient of the port's SSD scan against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and fed to both sides, all in
float32. Tolerance: rtol 1e-5 and atol 1e-5 x max |want| (the same f32
products summed in other orders).

* ``ssd_chunk_bwd_plain`` (the CPU path of the SSD backward kernel, and
  what the kernel is held against on the card) against ``jax.vjp`` of
  ``ssd_chunk_batched_ref`` in its ``(b*h, nc, c, ...)`` layout, with
  ``B``/``C`` repeated over the heads and their cotangents summed back,
  and against torch autograd of ``ssd_chunk_plain``.
* The gradients of the port's ``ssd_chunked`` (through the dispatcher op
  ``repro_torch::ssd_chunk`` and its registered backward) with respect to
  x, dt, A, B and C, against ``jax.grad`` of ``repro.models.ssm.
  ssd_chunked``; the reference's gradients are asserted finite, so that
  a change of sizes cannot pass on NaN.
* The reference's overflow: it takes ``exp(cum_i - cum_j)`` over the whole
  chunk before it masks, which overflows above the diagonal once
  ``cum_i - cum_j`` passes ~88.7 in f32, and its backward multiplies the
  masked zero cotangent by ``inf``. At a 256-row chunk, dt 0.1 and A down
  to -16 its dt and A gradients hold NaN; the port's, which masks before
  ``exp``, are finite and equal torch autograd of ``ssd_chunk_plain``.
* The op's forward runs once a layer a training step under
  ``remat="none"`` and ``"dots"`` (the op's outputs are kept), twice under
  ``"block"``, and its backward once a layer.
* In bf16, C's gradient is rounded once, as in the reference: the port's
  dx, dB and dC each agree with the reference's in all but 0.1% of their
  elements, by at most one bf16 ulp. The op takes the model's f32 copy of
  C beside bf16 x and returns dC in f32.
* The backward's route (the tensor cores or FFMA) and the tensor-core
  route's heads a block, which are decided on the host from shapes and
  pointers.

The CUDA kernel is held against ``ssd_chunk_bwd_plain`` on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (warms torch.exp: see its docstring)
from repro.kernels.ref import ssd_chunk_batched_ref
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.kernels import ssd_scan
from repro_torch.models import ssm as tssm
from repro_torch.models.transformer import Model
from repro_torch.train.losses import total_loss
from repro_torch.train.trainer import train_state_init
from repro_torch.tree import tree_flatten, tree_unflatten

RTOL = 1e-5


def _close(got, want, what=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()),
                               err_msg=what)


def _inputs(seed, b, s, h, p, g, n):
    """x, dt, A, B, C as f32 numpy: dt in softplus(dt_bias)'s range, A < 0."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(1e-3, 0.1, size=(b, s, h)).astype(np.float32)
    A = -rng.uniform(1.0, 16.0, size=(h,)).astype(np.float32)
    B = rng.normal(size=(b, s, g, n)).astype(np.float32)
    C = rng.normal(size=(b, s, g, n)).astype(np.float32)
    return x, dt, A, B, C


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_chunk_bwd_plain_matches_jax_vjp(g):
    b, s, h, p, n, chunk = 2, 64, 4, 16, 8, 32
    nc, rep = s // chunk, h // g
    x, dt, A, B, C = _inputs(10 + g, b, s, h, p, g, n)
    cum = (dt * A).reshape(b, nc, chunk, h).cumsum(2).reshape(b, s, h)
    rng = np.random.default_rng(20 + g)
    dy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dst = rng.normal(size=(b, nc, h, n, p)).astype(np.float32)
    got = ssd_scan.ssd_chunk_bwd_plain(*(_t(a) for a in (x, dt, cum, B, C)),
                                       _t(dy), _t(dst), chunk)

    def flat(a):  # (b, s, h, ...) -> (b*h, nc, c, ...)
        a = jnp.asarray(a).reshape((b, nc, chunk, h) + a.shape[3:])
        return jnp.moveaxis(a, 3, 1).reshape((b * h, nc, chunk) + a.shape[4:])

    def unflat(a):  # the inverse of flat
        a = np.asarray(a).reshape((b, h, nc, chunk) + a.shape[3:])
        return np.moveaxis(a, 1, 3).reshape((b, s, h) + a.shape[4:])

    Bh, Ch = (np.repeat(a, rep, axis=2) for a in (B, C))
    jdst = jnp.asarray(dst.transpose(0, 2, 1, 3, 4).reshape(b * h, nc, n, p))
    vjp = jax.jit(lambda *a: jax.vjp(ssd_chunk_batched_ref, *a[:5])[1](a[5:]))
    jdx, jddt, jdcum, jdB, jdC = (unflat(a) for a in vjp(
        flat(x), flat(dt), flat(cum), flat(Bh), flat(Ch), flat(dy), jdst))
    want = (jdx, jddt, jdcum,
            jdB.reshape(b, s, g, rep, n).sum(3),
            jdC.reshape(b, s, g, rep, n).sum(3))
    # and torch autograd of the plain forward
    ins = [_t(a, grad=True) for a in (x, dt, cum, B, C)]
    y, st = ssd_scan.ssd_chunk_plain(*ins, chunk)
    torch.autograd.backward((y, st), (_t(dy), _t(dst)))
    for name, got_, w, t in zip(("dx", "ddt", "dcum", "dB", "dC"), got,
                                want, ins):
        assert got_.shape == t.shape and got_.dtype == torch.float32, name
        _close(got_, w, f"{name} vs jax.vjp")
        _close(got_, t.grad, f"{name} vs torch autograd")


def _jax_grads(x, dt, A, B, C, wy, wf, chunk):
    def loss(x, dt, A, B, C):
        y, final = jssm.ssd_chunked(x, dt, A, B, C, chunk=chunk)
        return (y * wy).sum() + (final * wf).sum()
    return jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        *(jnp.asarray(a) for a in (x, dt, A, B, C)))


def _port_grads(x, dt, A, B, C, wy, wf, chunk):
    ins = [_t(a, grad=True) for a in (x, dt, A, B, C)]
    y, final = tssm.ssd_chunked(*ins, chunk=chunk)
    ((y * _t(wy)).sum() + (final * _t(wf)).sum()).backward()
    return [t.grad for t in ins]


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("s", [96, 80])          # 80: padded to 96
def test_ssd_chunked_grads_match_reference(s, g):
    b, h, p, n, chunk = 2, 4, 16, 8, 32
    x, dt, A, B, C = _inputs(30 + s + g, b, s, h, p, g, n)
    rng = np.random.default_rng(40 + s + g)
    wy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    wf = rng.normal(size=(b, h, n, p)).astype(np.float32)
    want = _jax_grads(x, dt, A, B, C, wy, wf, chunk)
    n0 = ssd_scan.ssd_chunk_bwd.launches
    got = _port_grads(x, dt, A, B, C, wy, wf, chunk)
    assert ssd_scan.ssd_chunk_bwd.launches == n0     # CPU: no kernel
    for name, gt, w in zip("x dt A B C".split(), got, want):
        assert np.isfinite(np.asarray(w)).all(), f"reference d{name}"
        _close(gt, w, f"d{name}")


def test_bf16_grads_round_once_as_the_reference_does():
    """bf16 x, B and C through both packages' ``ssd_chunked``, gradients of
    ``sum(y * w)``. C feeds the intra-chunk step and the inter-chunk term;
    the reference makes one f32 copy for both, so autograd sums the two f32
    gradients and rounds dC to bf16 once. The port does the same, so its
    dC agrees with the reference's as closely as dx and dB do: at most
    0.1% of the elements of each differ, each by at most one bf16 ulp of
    the reference's value (the sums' orders differ). Two copies, each
    rounded to bf16 before autograd adds them, put 553 of the 6,144 dC
    elements off, by up to 865 ulps where the two terms cancel."""
    b, s, h, p, g, n, chunk = 2, 96, 4, 16, 1, 32, 32
    rng = np.random.default_rng(0)

    def bf16(a):  # values exact in bf16
        return torch.from_numpy(a).bfloat16().float().numpy()

    x = bf16(rng.normal(size=(b, s, h, p)).astype(np.float32))
    dt = rng.uniform(1e-3, 0.1, size=(b, s, h)).astype(np.float32)
    A = -rng.uniform(1.0, 16.0, size=(h,)).astype(np.float32)
    B = bf16(rng.normal(size=(b, s, g, n)).astype(np.float32))
    C = bf16(rng.normal(size=(b, s, g, n)).astype(np.float32))
    w = rng.normal(size=(b, s, h, p)).astype(np.float32)

    def loss(x, B, C):
        y, _ = jssm.ssd_chunked(x, jnp.asarray(dt), jnp.asarray(A), B, C,
                                chunk=chunk)
        return (y.astype(jnp.float32) * w).sum()

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *(jnp.asarray(a, jnp.bfloat16) for a in (x, B, C)))
    ins = [torch.from_numpy(a).bfloat16().requires_grad_()
           for a in (x, B, C)]
    y, _ = tssm.ssd_chunked(ins[0], _t(dt), _t(A), ins[1], ins[2],
                            chunk=chunk)
    (y.float() * _t(w)).sum().backward()
    for name, t, wv in zip("x B C".split(), ins, want):
        assert t.grad.dtype == torch.bfloat16, name
        got = t.grad.float().numpy()
        ref = np.asarray(wv.astype(jnp.float32))
        ulp = np.ldexp(np.float32(1), np.frexp(ref)[1] - 8)
        off = got != ref
        assert off.sum() <= got.size // 1000, (name, int(off.sum()))
        assert (np.abs(got - ref)[off] <= ulp[off]).all(), name


def _bf16_views(b, s, h, p, g, n, offset=0):
    """x, B and C as the model passes them: bf16 views of one
    (b, s, channels) tensor, ``offset`` elements into it."""
    xbc = torch.zeros((b, s, offset + h * p + 2 * g * n), dtype=torch.bfloat16)
    xbc = xbc[..., offset:]
    return (xbc[..., : h * p].reshape(b, s, h, p),
            xbc[..., h * p: h * p + g * n].reshape(b, s, g, n),
            xbc[..., h * p + g * n:].reshape(b, s, g, n))


@pytest.mark.parametrize("case,want", [
    (dict(), "tc"),                         # mamba2-780m's training widths
    (dict(n=64, h=112), "tc"),               # zamba2-7b's
    (dict(p=32, n=16, chunk=32), "tc"),      # the smoke archs'
    (dict(chunk=100, s=200), "tc"),          # a chunk off the 64-row tiles
    (dict(chunk=98, s=196), "ffma"),         # not a multiple of 4
    (dict(chunk=512), "ffma"),               # more than 4 tiles of S^T
    (dict(p=128), "ffma"),                   # dx wider than 64
    (dict(n=256), "ffma"),                   # dB/dC wider than 128
    (dict(offset=1), "ffma"),                # rows not 16-byte aligned
    (dict(f32=True), "ffma"),
])
def test_bwd_route(case, want):
    """The backward's route for the model's bf16 views (the tensor cores)
    and for what they do not take (FFMA); decided on the shapes and the
    pointers, so it holds for CPU tensors too."""
    c = dict(b=2, s=512, h=48, p=64, g=1, n=128, chunk=256, offset=0,
             f32=False)
    c.update(case)
    x, B, C = _bf16_views(c["b"], c["s"], c["h"], c["p"], c["g"], c["n"],
                          c["offset"])
    if c["f32"]:
        x, B, C = x.float(), B.float(), C.float()
    dy = torch.zeros(x.shape)
    assert ssd_scan.bwd_route(x, B, C.float() if c["f32"] else C, dy, None,
                              c["chunk"]) == want


@pytest.mark.parametrize("shape,sms,want", [
    ((8, 4, 1, 48, 4), 132, 10),   # mamba2-780m training: 5 sets of 10
    ((4, 4, 1, 112, 4), 132, 13),  # zamba2-7b: 9 sets, the last of 8
    ((64, 4, 1, 48, 4), 132, 24),  # a large grid: at most 24 a set
    ((1, 2, 1, 48, 4), 132, 1),    # a small grid: a head a block
    ((2, 3, 2, 3, 2), 132, 1),
])
def test_tc_heads_per_block(shape, sms, want):
    """The fewest head sets that give each kernel's grid 4 blocks an SM,
    at most 24 heads a set, shared evenly."""
    assert ssd_scan.tc_heads_per_block(*shape, sms) == want


def test_op_takes_f32_C_beside_bf16_x_on_the_cpu():
    """bf16 x and B with an f32 C (the model's call): the plain backward
    returns dC in f32, unrounded, equal to the all-f32 op's dC."""
    b, s, h, p, g, n, chunk = 1, 64, 4, 16, 1, 8, 32
    x, dt, A, B, C = _inputs(60, b, s, h, p, g, n)
    cum = (dt * A).reshape(b, s // chunk, chunk, h).cumsum(2).reshape(b, s, h)
    x, B, C = (torch.from_numpy(a).bfloat16() for a in (x, B, C))
    rng = np.random.default_rng(61)
    dy = _t(rng.normal(size=(b, s, h, p)).astype(np.float32))
    grads = {}
    for name, ins in (("mixed", (x, B, C.float())),
                      ("f32", (x.float(), B.float(), C.float()))):
        xs, Bs, Cs = (t.clone().requires_grad_() for t in ins)
        y, _ = ssd_scan.ssd_chunk(xs, _t(dt), _t(cum), Bs, Cs, chunk)
        (y * dy).sum().backward()
        grads[name] = Cs.grad
    assert grads["mixed"].dtype == torch.float32
    assert torch.equal(grads["mixed"], grads["f32"])


def test_reference_overflows_where_the_port_stays_finite(monkeypatch):
    """One chunk of 256 rows, dt 0.1, A = -linspace(1, 16, 4): above the
    diagonal cum_i - cum_j reaches 25.5 x 16 = 408 > 88.7."""
    b, s, h, p, g, n, chunk = 1, 256, 4, 16, 1, 8, 256
    x, _, _, B, C = _inputs(50, b, s, h, p, g, n)
    dt = np.full((b, s, h), 0.1, np.float32)
    A = -np.linspace(1.0, 16.0, h).astype(np.float32)
    rng = np.random.default_rng(51)
    wy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    wf = rng.normal(size=(b, h, n, p)).astype(np.float32)
    jdx, jddt, jdA, _, _ = _jax_grads(x, dt, A, B, C, wy, wf, chunk)
    assert np.isnan(np.asarray(jddt)).any() and np.isnan(np.asarray(jdA)).any()
    got = _port_grads(x, dt, A, B, C, wy, wf, chunk)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    # the same scan with the intra-chunk step differentiated by autograd
    monkeypatch.setattr(tssm, "ssd_chunk", ssd_scan.ssd_chunk_plain)
    want = _port_grads(x, dt, A, B, C, wy, wf, chunk)
    for name, gt, w in zip("x dt A B C".split(), got, want):
        _close(gt, w, f"d{name}")


@pytest.mark.parametrize("remat,calls", [("none", 1), ("block", 2),
                                         ("dots", 1)])
def test_remat_runs_the_ssd_forward_once_or_twice_a_layer(monkeypatch, remat,
                                                          calls):
    """The SSD step is one dispatcher op, so ``remat="dots"`` keeps its
    outputs and the backward does not run it again; ``"block"`` reruns
    each Mamba2 block. Its backward runs once a layer."""
    seen = {"fwd": 0, "bwd": 0}
    fwd, bwd = ssd_scan._fwd, ssd_scan.ssd_chunk_bwd

    def counted_fwd(*a, **kw):
        seen["fwd"] += 1
        return fwd(*a, **kw)

    def counted_bwd(*a, **kw):
        seen["bwd"] += 1
        return bwd(*a, **kw)

    monkeypatch.setattr(ssd_scan, "_fwd", counted_fwd)
    monkeypatch.setattr(ssd_scan, "ssd_chunk_bwd", counted_bwd)
    cfg = dataclasses.replace(get_config("mamba2-780m-smoke"), remat=remat)
    params = train_state_init(cfg, 0, device="cpu").params
    batch = {k: torch.from_numpy(v) for k, v in
             synthetic_batch(cfg, 2, 48, seed=0).items()}
    leaves, treedef = tree_flatten(params)
    leaves = [t.detach().requires_grad_() for t in leaves]
    logits, aux, _ = Model(cfg).forward(tree_unflatten(treedef, leaves),
                                        batch)
    loss, _ = total_loss(cfg, logits, batch["labels"], aux)
    grads = torch.autograd.grad(loss, leaves)
    assert all(bool(torch.isfinite(t).all()) for t in grads)
    assert seen == {"fwd": calls * cfg.num_layers, "bwd": cfg.num_layers}
