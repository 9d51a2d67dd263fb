"""The port's flash attention forward (its plain version, on the CPU)
against the JAX reference.

Inputs are made with numpy from a seed and fed to both sides. The plain
forward is held against ``repro.kernels.ops.flash_attention`` run in
interpret mode (the Pallas kernel's own CPU route, as
``tests/test_kernels.py`` runs it) with that file's tolerances: shapes,
causal or not, GQA and MQA, sliding windows, dtypes and head dims. The
``start`` masks, the log-sum-exp, the recompute backward, the dispatcher
op and a windowed model are ``tests/test_torch_flash_attention_op.py``'s.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (one intra-op thread: see its docstring)
from _torch_flash import model_layout, qkv, to_numpy
from repro.kernels.ops import flash_attention as pallas_flash_attention
from repro_torch.kernels import flash_attention as fa

_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),      # tests/test_kernels.py
        torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _pallas_case(seed, b, h, kv, sq, sk, hd, *, dtype=torch.float32,
                 causal=True, window=None, block=64):
    q, k, v = qkv(seed, b, h, kv, sq, sk, hd)
    want = pallas_flash_attention(
        *(jnp.asarray(x).astype(_JNP[dtype]) for x in (q, k, v)),
        causal=causal, window=window, block_q=block, block_k=block,
        interpret=True)
    got, lse = fa.flash_attention_fwd_plain(
        *(model_layout(x, dtype) for x in (q, k, v)), causal=causal,
        window=window)
    assert got.dtype == dtype and lse.dtype == torch.float32
    assert lse.shape == (b, h, sq)
    np.testing.assert_allclose(to_numpy(got.transpose(1, 2)),
                               np.asarray(want.astype(jnp.float32)),
                               **_TOL[dtype])


# ---------------------------------------------------------------------------
# (1) the plain forward against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq,sk", [(128, 128), (96, 160), (64, 64),
                                   (100, 100)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_shapes_causal(sq, sk, causal):
    _pallas_case(0, 1, 2, 2, sq, sk, 64, causal=causal)


@pytest.mark.parametrize("h,kv", [(8, 8), (8, 2), (8, 1)])
def test_plain_matches_pallas_gqa_mqa(h, kv):
    _pallas_case(1, 1, h, kv, 64, 64, 64)


@pytest.mark.parametrize("window", [32, 64, 128])
def test_plain_matches_pallas_sliding_window(window):
    _pallas_case(2, 1, 2, 2, 192, 192, 32, window=window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_matches_pallas_dtypes(dtype):
    _pallas_case(3, 1, 4, 2, 64, 64, 64, dtype=dtype)


def test_plain_matches_pallas_head_dim_256():
    _pallas_case(5, 1, 4, 1, 64, 64, 256)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [96, 112])
def test_plain_matches_pallas_head_dims_96_112(hd, dtype):
    """phi-3-vision's and zamba2-7b's head widths, which the kernel takes
    as two 64-column boxes with the columns past hd zero-filled."""
    _pallas_case(6, 1, 4, 2, 100, 100, hd, dtype=dtype)
