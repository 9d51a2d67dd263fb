"""The port's paged-gather kernel module against the JAX reference.

On the CPU the wrapper runs the plain version, which must equal the Pallas
kernel (interpret mode) and the scalar oracle exactly: the op is a copy.
The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.paged_kv import paged_gather_pallas, paged_gather_ref
from repro_torch.bridge import tensor_from_numpy
from repro_torch.kernels import paged_kv


def _tables(rng, b, maxp, np_pages):
    # mapped entries draw WITHOUT replacement (allocator invariant); ~1/3
    # of entries unmapped; page 0 (trash) unused
    perm = rng.permutation(np_pages - 1) + 1
    table = np.full((b, maxp), -1, np.int32)
    k = 0
    for i in range(b):
        for p in range(maxp):
            if rng.random() < 0.67 and k < perm.size:
                table[i, p] = perm[k]
                k += 1
    return table


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _tbits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,maxp,np_pages,ps,kv,hd", [
    (1, 2, 4, 4, 1, 4),
    (3, 4, 16, 8, 2, 8),
    (2, 3, 5, 2, 4, 16),
])
def test_plain_matches_reference_kernel(b, maxp, np_pages, ps, kv, hd, dtype):
    rng = np.random.default_rng(b * 100 + maxp)
    np_dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    pool = rng.normal(size=(np_pages, ps, kv, hd)).astype(np_dt)
    table = _tables(rng, b, maxp, np_pages)
    want_k = np.asarray(paged_gather_pallas(jnp.asarray(pool),
                                            jnp.asarray(table),
                                            interpret=True))
    want_r = np.asarray(paged_gather_ref(jnp.asarray(pool),
                                         jnp.asarray(table)))
    before = paged_kv.paged_gather.launches
    got = paged_kv.paged_gather(tensor_from_numpy(pool, "cpu"),
                                torch.from_numpy(table))
    assert paged_kv.paged_gather.launches == before  # CPU: plain, no launch
    assert tuple(got.shape) == (b, maxp * ps, kv, hd)
    got = _tbits(got).numpy()
    np.testing.assert_array_equal(got, _bits(want_k))
    np.testing.assert_array_equal(got, _bits(want_r))


def test_out_of_range_ids_clip_like_reference():
    """Ids >= NP clip to the last page, as ``paged_gather_take`` does."""
    pool = np.arange(3 * 2 * 1 * 4, dtype=np.float32).reshape(3, 2, 1, 4)
    table = np.asarray([[5, -1, 0]], np.int32)
    got = paged_kv.paged_gather_plain(torch.from_numpy(pool),
                                      torch.from_numpy(table)).numpy()
    np.testing.assert_array_equal(got[0, :2], pool[2])
    np.testing.assert_array_equal(got[0, 2:4], 0.0)
    np.testing.assert_array_equal(got[0, 4:], pool[0])


def test_unsupported_device_raises():
    pool = torch.zeros((2, 2, 1, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        paged_kv.paged_gather(pool, torch.zeros((1, 1), dtype=torch.int32))
