"""The archs brought to the card at full width (gemma-2b, command-r-35b,
arctic-480b, and yi-9b's training), on the CPU at small size.

``init_params`` draws each leaf on the card as it is made. A bf16 leaf
used to be drawn as one float32 tensor and then cast, so its draw needed
twice the leaf's bytes on top of it: command-r-35b's 7.38 B-element
``w_gate`` stack a 29.5 GB float32 temporary beside 46 GB of finished
leaves, and arctic-480b's expert tables (4.46 B elements a layer and a
projection) one of 17.8 GB a layer, so neither could be made on one
80 GB card. A narrow leaf past ``_DRAW_CHUNK`` elements is now drawn in
pieces of that many. These tests hold the pieces (patched small): no
float32 temporary above one piece, the numbers deterministic and in the
truncated normal's range, a sharded init a slice of the whole one, and
a model made of such leaves serving the same tokens paged and
contiguous.
"""

import dataclasses

import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (one intra-op thread: see its docstring)
from repro_torch.configs import get_config
from repro_torch.models import layers as tlayers
from repro_torch.models.transformer import init_params
from repro_torch.serve.comm import param_sharder, shard_params
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.tree import tree_flatten_with_paths

CHUNK = 1000


@pytest.fixture
def small_chunks(monkeypatch):
    monkeypatch.setattr(tlayers, "_DRAW_CHUNK", CHUNK)


def _f32_sizes(monkeypatch):
    """The sizes of the float32 tensors ``torch.empty`` makes from now."""
    sizes, empty = [], torch.empty

    def spy(*shape, **kw):
        t = empty(*shape, **kw)
        if t.dtype == torch.float32:
            sizes.append(t.numel())
        return t

    monkeypatch.setattr(torch, "empty", spy)
    return sizes


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_a_large_narrow_leaf_is_drawn_in_pieces(small_chunks, monkeypatch,
                                                 dtype):
    sizes = _f32_sizes(monkeypatch)
    shape = (3, 1500)           # 4,500 elements: 5 pieces, the last short
    gen = torch.Generator().manual_seed(0)
    t = tlayers.dense_init(gen, shape, dtype=dtype)
    assert t.dtype == dtype and tuple(t.shape) == shape
    assert sizes == [CHUNK] * 4 + [500]
    std = 1.0 / np.sqrt(shape[-2])
    x = t.float().numpy()
    assert np.abs(x).max() <= 2 * std * (1 + 2 ** -7)
    assert abs(x.mean()) < 0.1 * std and 0.7 * std < x.std() < 0.95 * std
    again = tlayers.dense_init(torch.Generator().manual_seed(0), shape,
                               dtype=dtype)
    assert torch.equal(t, again)
    # float32 leaves and small leaves are drawn whole, as before
    sizes.clear()
    tlayers.dense_init(gen, shape, dtype=torch.float32)
    tlayers.dense_init(gen, (10, 90), dtype=dtype)
    assert sizes == [4500, 900]


@pytest.mark.parametrize("arch", ["gemma-2b-smoke", "command-r-35b-smoke",
                                  "arctic-480b-smoke"])
def test_a_sharded_init_is_a_slice_of_the_whole_one(small_chunks, arch):
    """Leaves past a piece, bf16: a tensor-parallel rank's init (each leaf
    cut as it is made) equals its slice of the whole init."""
    cfg = dataclasses.replace(get_config(arch), param_dtype="bfloat16",
                              num_kv_heads=2)
    whole = init_params(cfg, 0, device="cpu")
    assert any(t.numel() > CHUNK and t.dtype == torch.bfloat16
               for _, t in tree_flatten_with_paths(whole))
    for rank in range(2):
        got = init_params(cfg, 0, device="cpu",
                          shard=param_sharder(cfg, 2, rank))
        want = shard_params(cfg, whole, 2, rank)
        for (p, a), (_, b) in zip(tree_flatten_with_paths(got),
                                  tree_flatten_with_paths(want)):
            assert torch.equal(a, b), (arch, rank, p)


@pytest.mark.parametrize("arch", ["gemma-2b-smoke", "command-r-35b-smoke",
                                  "arctic-480b-smoke"])
def test_pieces_drawn_params_serve_paged_as_contiguous(small_chunks, arch):
    """bf16 params drawn in pieces, a bf16 cache: the engine's paged and
    contiguous tokens agree (phase 18's check, at small size)."""
    cfg = dataclasses.replace(get_config(arch), param_dtype="bfloat16",
                              dtype="bfloat16")
    params = init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    lens = (9, 30, 17, 24, 5)
    toks = []
    for paged in (True, False):
        eng = ServeEngine(cfg, params, batch_size=2, max_len=64,
                          device="cpu", paged=paged, page_size=8,
                          cache_dtype=torch.bfloat16)
        reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, (n,),
                                            dtype=np.int32),
                        max_new_tokens=6) for n in lens]
        rng = np.random.default_rng(0)
        eng.generate(reqs)
        toks.append([r.generated.tolist() for r in reqs])
    assert toks[0] == toks[1]
