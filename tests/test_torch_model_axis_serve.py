"""Serving on a ``data x model`` mesh: the GSPMD route (no comm plan) on
4 spawned gloo ranks (``tests/test_torch_ranks.py model_axis_serve``):
every family's greedy tokens against the single-device engines', the VLM
through its prefill, and the sequence-split decode cache against the
reference's engine and the port's whole cache. Float32 smoke configs from
``init_params(cfg, 0)`` on the CPU. The tensor-parallel Mamba2 block is
``tests/test_torch_model_axis_ssm.py``'s.
"""

import json

import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (one intra-op thread: see its docstring)
from _torch_model_axis import N, jax_engine_tokens, ranks_running
from repro_torch.configs import get_config

from test_torch_ranks import (AXIS_FP8, AXIS_SERVE, AXIS_SPLIT,
                              AXIS_SPLIT_LOGITS, axis_logits,
                              axis_serve_requests, axis_split_cfg,
                              axis_split_requests, axis_split_rows,
                              axis_vlm_tokens)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 2 x 2 world's serve outputs: ``(None, dir)``."""
    d = tmp_path_factory.mktemp("axis_serve")
    with ranks_running("model_axis_serve", d):
        pass
    return None, d


SERVE_CASES = [pytest.param(a, lay, "", id=f"{a}-{lay}")
               for a, lays in AXIS_SERVE.items() for lay in lays] + [
    pytest.param(AXIS_FP8, lay, "kv_fp8", id=f"{AXIS_FP8}-{lay}-kv_fp8")
    for lay in ("contiguous", "paged")]


@pytest.mark.parametrize("arch,layout,opt", SERVE_CASES)
def test_gspmd_serve_route_tokens_equal_single_device(world, arch, layout,
                                                      opt):
    """The GSPMD route (a 2 x 2 mesh without a comm plan: FSDP weights
    gathered over data where they run, TP collectives on the model line's
    one group) gives the single-device contiguous engine's greedy tokens
    (batch 4) on every rank, and a paged run also the single-device paged
    engine's (batch 2, the same pool): dense and MoE paged and contiguous,
    gemma's one KV head (its attention whole over model, its contiguous
    cache's sequence split over model; its paged pool, which keeps every
    position, is refused by name), yi-9b (its heads split), the SSM, the
    hybrid and audio on the grouped path, and yi-9b under ``kv_fp8`` with
    a bf16 cache (fp8 over the same splits)."""
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import ServeEngine
    _, d = world
    key = f"{arch} {layout} {opt}".strip()
    if (arch, layout) == ("gemma-2b-smoke", "paged"):
        for r in range(N):
            got = json.load(open(d / f"axis_serve_r{r}.json"))[key]
            assert "paged pool" in got["refused"], got
            assert "contiguous route" in got["refused"], got
        return
    cfg = get_config(arch)
    params = init_params(cfg, 0, device="cpu")
    kw = {}
    if opt:
        cfg = cfg.with_opts(opt)
        kw["cache_dtype"] = torch.bfloat16
    layouts = [dict(batch_size=4)]
    if layout == "paged":
        layouts.append(dict(batch_size=2, paged=True, page_size=8,
                            num_pages=11))
    wants = []
    for lay in layouts:
        eng = ServeEngine(cfg, params, max_len=48, device="cpu", **kw, **lay)
        reqs = axis_serve_requests(cfg)
        eng.generate(reqs)
        wants.append([r.generated.tolist() for r in reqs])
    for r in range(N):
        got = json.load(open(d / f"axis_serve_r{r}.json"))[key]
        for want in wants:
            assert got["tokens"] == want, (r, got["tokens"], want)
        assert got["tally"]["model_all_reduce"] > 0
        assert ("tokens" in got["tally"]) == (layout == "contiguous")


@pytest.mark.parametrize("case", list(AXIS_SPLIT))
def test_gspmd_split_cache_tokens_equal_reference(world, case):
    """The GSPMD route's sequence-split decode cache gives the reference's
    single-device engine's greedy tokens on every rank: gemma-2b and
    yi-9b (one and two KV heads) on 1 x 4 split the sequence over model,
    one request on 2 x 2 over all four ranks (olmo: its tensor-parallel
    KV heads gathered whole into the cache), gemma's ring of 16 slots over
    model on 2 x 2. Each rank holds its slice: ``1/N`` of the cache's
    positions and of its bytes; a decode step gathers the slices' partial
    attention once a layer, on the line that holds the split."""
    from repro_torch.models.attention import kv_cache_shape
    from repro_torch.models.transformer import init_params
    _, d = world
    arch, dims, batch, window = AXIS_SPLIT[case]
    cfg = axis_split_cfg(case)
    params = init_params(cfg, 0, device="cpu")
    reqs = axis_split_requests(case, cfg)
    want = jax_engine_tokens(cfg, params, batch, reqs)
    n = dims[1] if batch % dims[0] == 0 else dims[0] * dims[1]
    s_cache = kv_cache_shape(cfg, 1, 48)[1]
    line = "model" if n == dims[1] else "world"
    for r in range(N):
        got = json.load(open(d / f"axis_split_r{r}.json"))[case]
        assert got["tokens"] == want, (r, got["tokens"], want)
        # (layers, rows, S / n, every KV head, hd), f32 K and V
        for shape in got["shapes"]:
            assert shape[0] == cfg.num_layers and shape[2] * n == s_cache \
                and shape[3:] == [cfg.num_kv_heads, cfg.head_dim], got
        assert got["bytes"] - 8 == max(
            2 * 4 * int(np.prod(x)) for x in got["shapes"]), got
        assert got["tally"][f"{line}_all_gather"] >= \
            cfg.num_layers * got["steps"], got["tally"]


@pytest.mark.parametrize("case", AXIS_SPLIT_LOGITS)
def test_gspmd_split_cache_logits_match_whole_cache(world, case):
    """f32 logits of a prefill and 4 greedy decode steps through the
    sequence-split cache (gemma on 1 x 4: over model; one row on 2 x 2:
    over every rank) lie within 1e-4 of the port's whole-cache decode."""
    from repro_torch.models.transformer import init_params
    _, d = world
    cfg = axis_split_cfg(case)
    want = axis_logits(cfg, init_params(cfg, 0, device="cpu"),
                       axis_split_rows(case))[0]
    for r in range(N):
        got = np.load(d / f"axis_split_{case.replace(' ', '_')}_r{r}.npy")
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0,
                                   err_msg=f"rank {r}")


def test_gspmd_serve_route_vlm_tokens_equal_single_device(world):
    """phi-3-vision through ``make_prefill`` (tokens and image embeddings)
    and ``make_serve_step`` on the 2 x 2 GSPMD route: its single-device
    greedy tokens on every rank (its ``img_proj`` gathered whole over
    model, its batch rows split over data)."""
    from repro_torch.models.transformer import init_params
    _, d = world
    cfg = get_config("phi-3-vision-4.2b-smoke")
    want = axis_vlm_tokens(cfg, init_params(cfg, 0, device="cpu"))
    for r in range(N):
        got = json.load(open(d / f"axis_serve_r{r}.json"))[cfg.name]
        assert got["tokens"] == want, (r, got["tokens"])
