"""The SSD step of the port's SSM slice against the JAX reference, on the
CPU: inputs made with numpy from a seed and fed to both sides, in float32
(``x``/``B``/``C`` also in bf16 for the intra-chunk step, upcast by both
sides).

* ``ssd_chunk_plain`` (the CPU path of the SSD kernel) against
  ``ssd_chunk_pallas`` in interpret mode and ``ssd_chunk_batched_ref``, in
  their ``(b*h, nc, c, ...)`` layout with ``B``/``C`` repeated over heads:
  within 1e-5 (the same f32 products, summed in another order).
* ``ssd_chunked`` against ``repro.models.ssm.ssd_chunked`` (with and
  without an initial state, with and without padding to a chunk multiple)
  and ``repro.kernels.ops.ssd_chunked``: within 1e-5 — the inter-chunk
  loop sums in another order than ``lax.associative_scan``.
* ``ssd_decode_step``: within 1e-5.

The Mamba2 block, the model and the engine are ``tests/test_torch_ssm.py``'s.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (one intra-op thread: see its docstring)
from _torch_ssm import close, tensor
from repro.kernels import ops as jops
from repro.kernels.ref import ssd_chunk_batched_ref
from repro.kernels.ssd_scan import ssd_chunk_pallas
from repro.models import ssm as jssm
from repro_torch.bridge import tensor_from_numpy
from repro_torch.kernels import ssd_scan
from repro_torch.models import ssm as tssm


def _ssd_inputs(seed, b, s, h, p, g, n, dtype=np.float32):
    """x, dt, A, B, C as numpy: dt = softplus-range steps, A < 0."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(dtype)
    dt = rng.uniform(1e-3, 0.1, size=(b, s, h)).astype(np.float32)
    A = -rng.uniform(1.0, 16.0, size=(h,)).astype(np.float32)
    B = rng.normal(size=(b, s, g, n)).astype(dtype)
    C = rng.normal(size=(b, s, g, n)).astype(dtype)
    return x, dt, A, B, C


def _cum(dt, A, chunk):
    b, s, h = dt.shape
    return (dt * A).reshape(b, s // chunk, chunk, h).cumsum(2).reshape(
        b, s, h).astype(np.float32)


# ---------------------------------------------------------------------------
# the intra-chunk step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [1, 2])
def test_ssd_chunk_plain_matches_reference(g, dtype):
    b, s, h, p, n, chunk = 2, 64, 4, 8, 16, 32
    np_dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    x, dt, A, B, C = _ssd_inputs(g, b, s, h, p, g, n, np_dt)
    cum = _cum(dt, A, chunk)
    before = ssd_scan.ssd_chunk.launches
    y, st = ssd_scan.ssd_chunk(*(tensor_from_numpy(a, "cpu")
                                 for a in (x, dt, cum, B, C)), chunk)
    assert ssd_scan.ssd_chunk.launches == before   # CPU: no kernel
    assert y.dtype == st.dtype == torch.float32
    assert y.shape == (b, s, h, p) and st.shape == (b, s // chunk, h, n, p)

    # the Pallas layout: (b*h, nc, c, ...), B/C repeated over the heads
    nc, rep = s // chunk, h // g

    def flat(a):  # (b, s, h, ...) -> (b*h, nc, c, ...)
        a = jnp.asarray(a).reshape((b, nc, chunk, h) + a.shape[3:])
        a = jnp.moveaxis(a, 3, 1)
        return a.reshape((b * h, nc, chunk) + a.shape[4:])

    Bh, Ch = (np.repeat(a, rep, axis=2) for a in (B, C))
    args = (flat(x), flat(dt), flat(cum), flat(Bh), flat(Ch))

    def unflat(yk, sk):
        yk = np.asarray(yk).reshape(b, h, s, p).transpose(0, 2, 1, 3)
        sk = np.asarray(sk).reshape(b, h, nc, n, p).transpose(0, 2, 1, 3, 4)
        return yk, sk

    for yk, sk in (unflat(*ssd_chunk_pallas(*args, interpret=True)),
                   unflat(*ssd_chunk_batched_ref(*args))):
        close(y, yk)
        close(st, sk)


@pytest.mark.parametrize("case", ["dtype", "dt_dtype", "shape", "chunk",
                                  "groups", "d_state", "strided",
                                  "requires_grad", "device"])
def test_ssd_chunk_kernel_refusals(case):
    """What the CUDA kernel cannot take is refused before a launch (checked
    here on CPU tensors; a CPU tensor itself never reaches the kernel)."""
    b, s, h, p, g, n = 1, 8, 2, 4, 1, 4
    x, dt, cum = torch.zeros(b, s, h, p), torch.zeros(b, s, h), \
        torch.zeros(b, s, h)
    B, C = torch.zeros(b, s, g, n), torch.zeros(b, s, g, n)
    chunk, err, match = 4, ValueError, None
    if case == "dtype":
        x, B, C = x.double(), B.double(), C.double()
        err, match = TypeError, "one dtype"
    elif case == "dt_dtype":
        dt, err, match = dt.bfloat16(), TypeError, "float32"
    elif case == "shape":
        cum, match = torch.zeros(b, s, h + 1), "do not fit"
    elif case == "chunk":
        chunk, match = 3, "multiple of chunk"
    elif case == "groups":
        B, C, match = torch.zeros(b, s, 3, n), torch.zeros(b, s, 3, n), \
            "multiple of g"
    elif case == "d_state":
        B, C, match = torch.zeros(b, s, g, 300), torch.zeros(b, s, g, 300), \
            "d_state"
    elif case == "strided":
        x, match = torch.zeros(b, s, h, 2 * p)[..., ::2], "contiguous"
    elif case == "requires_grad":
        # a tensor that requires grad goes in (the op's backward is the
        # backward kernel); the backward refuses an output gradient it
        # cannot take
        x.requires_grad_()
        assert ssd_scan._check_cuda_args(x, dt, cum, B, C, chunk)[0] == b
        with pytest.raises(ValueError, match="dy"):
            ssd_scan._check_bwd_args(x, dt, cum, B, C, x.detach().double(),
                                     None, chunk)
        err, match = ValueError, "d_state <= 128"
        B, C = torch.zeros(b, s, g, 200), torch.zeros(b, s, g, 200)
        with pytest.raises(err, match=match):
            ssd_scan._check_bwd_args(x, dt, cum, B, C, torch.zeros(b, s, h, p),
                                     None, chunk)
        return
    else:
        dt, match = torch.zeros(b, s, h, device="meta"), "must be on"
    with pytest.raises(err, match=match):
        ssd_scan._check_cuda_args(x, dt, cum, B, C, chunk)


def test_ssd_chunk_refuses_other_devices():
    t = torch.zeros(1, 4, 2, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ssd_scan.ssd_chunk(t, t[..., 0], t[..., 0], t[:, :, :1], t[:, :, :1],
                           4)


# ---------------------------------------------------------------------------
# the blocked scan and the decode step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [64, 50])          # 50: padded to 64
@pytest.mark.parametrize("initial", [False, True])
@pytest.mark.parametrize("g", [1, 2])
def test_ssd_chunked_matches_model_reference(s, initial, g):
    b, h, p, n, chunk = 2, 4, 8, 16, 16
    x, dt, A, B, C = _ssd_inputs(7, b, s, h, p, g, n)
    init = (np.random.default_rng(8).normal(size=(b, h, n, p))
            .astype(np.float32) if initial else None)
    y, fs = tssm.ssd_chunked(tensor(x), tensor(dt), tensor(A), tensor(B), tensor(C), chunk=chunk,
                             initial_state=None if init is None else tensor(init))
    wy, wfs = jssm.ssd_chunked(
        jnp.asarray(x), jnp.asarray(dt), jnp.asarray(A), jnp.asarray(B),
        jnp.asarray(C), chunk=chunk,
        initial_state=None if init is None else jnp.asarray(init))
    assert y.shape == (b, s, h, p) and fs.dtype == torch.float32
    close(y, wy)
    close(fs, wfs)


def test_ssd_chunked_matches_pallas_wrapper():
    """``kernels/ops.py::ssd_chunked`` (the Pallas kernel in interpret mode
    + an associative scan) takes no initial state and s % chunk == 0."""
    b, s, h, p, g, n, chunk = 2, 96, 4, 8, 2, 16, 32
    x, dt, A, B, C = _ssd_inputs(9, b, s, h, p, g, n)
    y, fs = tssm.ssd_chunked(tensor(x), tensor(dt), tensor(A), tensor(B), tensor(C), chunk=chunk)
    wy, wfs = jops.ssd_chunked(jnp.asarray(x), jnp.asarray(dt),
                               jnp.asarray(A), jnp.asarray(B),
                               jnp.asarray(C), chunk=chunk, interpret=True)
    close(y, wy)
    close(fs, wfs)


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_decode_step_matches_reference(g):
    rng = np.random.default_rng(10 + g)
    b, h, p, n = 3, 4, 8, 16
    state = rng.normal(size=(b, h, n, p)).astype(np.float32)
    x = rng.normal(size=(b, h, p)).astype(np.float32)
    dt = rng.uniform(1e-3, 0.1, size=(b, h)).astype(np.float32)
    A = -rng.uniform(1.0, 16.0, size=(h,)).astype(np.float32)
    B = rng.normal(size=(b, g, n)).astype(np.float32)
    C = rng.normal(size=(b, g, n)).astype(np.float32)
    y, ns = tssm.ssd_decode_step(*(tensor(a) for a in (state, x, dt, A, B, C)))
    wy, wns = jssm.ssd_decode_step(*(jnp.asarray(a)
                                     for a in (state, x, dt, A, B, C)))
    close(y, wy)
    close(ns, wns)
