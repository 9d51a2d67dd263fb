"""Tests of the port that need a CUDA card (marker ``cuda``).

A hand-written kernel has no CPU mode, so these skip without a card. On
the GPU machine (no JAX there; this file imports none):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import bucket_pack, paged_kv
from repro_torch.models.transformer import init_params
from repro_torch.serve.engine import Request, ServeEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape", [(65, 16, 16, 128), (13, 8, 2, 64),
                                   (5, 3, 1, 8)])
def test_kernel_matches_plain(cuda_device, dtype, shape):
    """Bit-equal to the plain version, incl. unmapped and out-of-range ids
    (clipped to the last page), and one launch counted per call."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    table = torch.randint(-1, shape[0] + 2, (4, 16), generator=gen,
                          device=cuda_device, dtype=torch.int32)
    pool = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    n0 = paged_kv.paged_gather.launches
    got = paged_kv.paged_gather(pool, table)
    torch.cuda.synchronize()
    assert paged_kv.paged_gather.launches == n0 + 1
    want = paged_kv.paged_gather_plain(pool, table)
    assert got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))


def test_kernel_rejects_what_it_cannot_take(cuda_device):
    pool = torch.zeros((4, 2, 1, 8), device=cuda_device)
    table = torch.zeros((1, 2), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError, match="int32"):
        paged_kv.paged_gather(pool, table.long())
    with pytest.raises(ValueError, match="must be on"):
        paged_kv.paged_gather(pool, table.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        paged_kv.paged_gather(torch.zeros((4, 2, 2, 8), device=cuda_device
                                          ).transpose(1, 2), table)
    with pytest.raises(ValueError, match="16 bytes"):
        paged_kv.paged_gather(torch.zeros((4, 1, 1, 3), device=cuda_device),
                              table)


def test_engine_paged_equals_contiguous_on_card(cuda_device):
    """olmo-1b-smoke on the card: paged tokens equal contiguous tokens, and
    every decode step launched the gather twice per layer."""
    cfg = get_config("olmo-1b-smoke")
    params = init_params(cfg, 0, device=cuda_device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32)
               for n in (5, 9, 4, 7, 6)]
    toks = {}
    for paged in (True, False):
        eng = ServeEngine(cfg, params, batch_size=2, max_len=64,
                          device=cuda_device, paged=paged, page_size=8,
                          num_pages=13)
        paged_kv.paged_gather.launches = 0
        reqs = eng.generate([Request(prompt=p, max_new_tokens=6)
                             for p in prompts])
        want = 2 * cfg.num_layers * eng.decode_steps if paged else 0
        assert paged_kv.paged_gather.launches == want
        toks[paged] = [r.generated.tolist() for r in reqs]
    assert toks[True] == toks[False]


def _tables(rng, n_tiles, src_tiles, tile):
    """Random tables: some tiles unused (valid 0), some partial, some full;
    each used tile reads a distinct source tile."""
    block = rng.permutation(src_tiles)[:n_tiles].astype(np.int32)
    valid = rng.integers(0, tile + 1, n_tiles).astype(np.int32)
    valid[::5] = tile
    valid[1::7] = 0
    valid[2::11] = 1
    return block, valid


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_tiles,src_tiles", [(1, 1), (7, 9), (300, 301)])
def test_bucket_pack_kernel_matches_plain(cuda_device, dtype, n_tiles,
                                          src_tiles):
    """pack and unpack bit for bit against the plain version, into a fresh
    buffer and into a slice of a larger one; one launch counted each."""
    tile = bucket_pack.TILE
    rng = np.random.default_rng(n_tiles)
    blk, val = _tables(rng, n_tiles, src_tiles, tile)
    blk, val = (torch.from_numpy(a).to(cuda_device) for a in (blk, val))
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    src = torch.randn(src_tiles * tile, generator=gen,
                      device=cuda_device).to(dtype)
    want = bucket_pack.bucket_pack_plain(src, blk, val, n_tiles * tile)
    for fn, name in ((bucket_pack.bucket_pack, "pack"),
                     (bucket_pack.bucket_unpack, "unpack")):
        n0 = fn.launches
        got = fn(src, blk, val, n_tiles * tile)
        big = torch.full((n_tiles * tile + 2 * tile,), 7.0, dtype=dtype,
                         device=cuda_device)
        fn(src, blk, val, n_tiles * tile, out=big[tile:-tile])
        torch.cuda.synchronize()
        assert fn.launches == n0 + 2, name
        assert torch.equal(_bits(got), _bits(want)), name
        assert torch.equal(_bits(big[tile:-tile]), _bits(want)), name
        assert bool((big[:tile] == 7).all() and (big[-tile:] == 7).all())


def test_bucket_pack_rejects_what_it_cannot_take(cuda_device):
    tile = bucket_pack.TILE
    src = torch.zeros(2 * tile, device=cuda_device)
    t = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError, match="int32"):
        bucket_pack.bucket_pack(src, t.long(), t, 2 * tile)
    with pytest.raises(TypeError, match="takes"):
        bucket_pack.bucket_pack(src.half(), t, t, 2 * tile)
    with pytest.raises(ValueError, match="must be on"):
        bucket_pack.bucket_pack(src, t.cpu(), t, 2 * tile)
    with pytest.raises(ValueError, match="entries"):
        bucket_pack.bucket_pack(src, t[:1], t, 2 * tile)
    with pytest.raises(ValueError, match="contiguous"):
        bucket_pack.bucket_pack(src, t, t, 2 * tile,
                                out=torch.zeros((2 * tile, 2),
                                                device=cuda_device)[:, 0])
