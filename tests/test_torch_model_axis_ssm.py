"""The tensor-parallel Mamba2 block on the GSPMD route: mamba2-780m and
zamba2-7b smoke on 2 x 2 and 1 x 4 spawned gloo ranks
(``tests/test_torch_ranks.py model_axis_ssm``), against the reference's
single-device engine's greedy tokens, the port's replicated block's f32
logits, the reference's state slices and a decode step's collectives.
"""

import json

import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (one intra-op thread: see its docstring)
from _torch_model_axis import N, jax_engine_tokens, ranks_running
from repro_torch.configs import get_config

from test_torch_ranks import AXIS_SSM, axis_logits, axis_serve_requests


def _ssm_reference():
    """Per SSM arch of :data:`AXIS_SSM`: the reference's single-device
    engine's greedy tokens and the port's f32 logits with the block
    replicated (one rank, the whole state)."""
    from repro_torch.models.transformer import init_params
    out = {}
    for arch in sorted({a for a, _ in AXIS_SSM.values()}):
        cfg = get_config(arch)
        params = init_params(cfg, 0, device="cpu")
        out[arch] = (jax_engine_tokens(cfg, params, 4,
                                        axis_serve_requests(cfg)),
                     axis_logits(cfg, params, 2)[0])
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """:func:`_ssm_reference` and the 2 x 2 world's outputs: ``(reference,
    dir)``. The ranks run while the reference computes."""
    d = tmp_path_factory.mktemp("axis_ssm")
    with ranks_running("model_axis_ssm", d):
        ref = _ssm_reference()
    return ref, d


@pytest.fixture(scope="module")
def ssm_reference(world):
    return world[0]


def _ssm_dims(cfg):
    """(conv channels, heads) of the whole Mamba2 block."""
    c = cfg.ssm
    d_in = c.d_inner(cfg.d_model)
    return d_in + 2 * c.ngroups * c.d_state, c.num_heads(cfg.d_model)


@pytest.mark.parametrize("case", list(AXIS_SSM))
def test_gspmd_ssm_block_tokens_and_state_slices(world, ssm_reference,
                                                 case):
    """The tensor-parallel Mamba2 block on the GSPMD route (mamba2-780m
    and zamba2-7b smoke, 2 x 2 and 1 x 4) gives the reference's
    single-device engine's greedy tokens on every rank, and a rank's
    state is its slice by the reference's ``cache_shardings``: each
    group's rows over data where they divide (the engine's groups of 2
    and 1 rows), conv ``(L, B_r, W-1, CH/tp)``, SSD ``(L, B_r, H/tp, N,
    P)``, a ``tp``-th of one rank's bytes for the same rows."""
    from repro_torch.models.transformer import init_cache
    _, d = world
    arch, (dn, tp) = AXIS_SSM[case]
    cfg = get_config(arch)
    c, (ch, h) = cfg.ssm, _ssm_dims(cfg)
    L = cfg.num_layers
    rows = [g // dn if g % dn == 0 else g for g in (2, 1)]
    for r in range(N):
        got = json.load(open(d / f"axis_ssm_r{r}.json"))[case]
        assert got["tokens"] == ssm_reference[arch][0], (r, got["tokens"])
        assert [conv[1] for conv, _ in got["shapes"]] == rows, got
        state = []
        for (conv, ssd), b in zip(got["shapes"], rows):
            assert conv == [L, b, c.conv_width - 1, ch // tp], conv
            assert ssd == [L, b, h // tp, c.d_state, c.head_dim], ssd
            whole = init_cache(cfg, b, 48, dtype=torch.float32,
                               device="cpu").ssm
            state.append(4 * (int(np.prod(conv)) + int(np.prod(ssd))))
            assert state[-1] * tp == whole.conv.nbytes + whole.ssd.nbytes
        if cfg.family == "ssm":   # the cursor and the largest state
            assert got["bytes"] == 4 + max(state), (got["bytes"], state)


@pytest.mark.parametrize("case", list(AXIS_SSM))
def test_gspmd_ssm_block_logits_match_replicated_block(world, ssm_reference,
                                                       case):
    """f32 logits of a prefill (2 rows of 10 tokens) and 4 greedy decode
    steps through the tensor-parallel block and its sliced state lie
    within 1e-4 of the port's replicated block on one rank (the whole
    state), each rank's rows."""
    _, d = world
    arch, _ = AXIS_SSM[case]
    want = ssm_reference[arch][1]
    name = case.replace(" ", "_")
    for r in range(N):
        got = np.load(d / f"axis_ssm_{name}_r{r}.npy")
        first = json.load(open(d / f"axis_ssm_r{r}.json"))[case]["first"]
        np.testing.assert_allclose(got, want[first:first + got.shape[0]],
                                   atol=1e-4, rtol=0, err_msg=f"rank {r}")


# the model line's collectives of a decode step: a tensor-parallel Mamba2
# block gathers in_proj whole and its conv output once, and all-reduces
# its gated norm's sum of squares and its out_proj's partial sums (2 + 2);
# the vocab-parallel lookup all-reduces once and the head's logits gather
# once; zamba2's shared-attention site all-reduces attention's and the
# FFN's outputs on 2 x 2; on 1 x 4 its two KV heads do not divide model,
# so the site gathers its 4 attention leaves whole, all-reduces the FFN's
# output and gathers its sequence-split cache's partial attention once
SSM_STEP = {"mamba2 2x2": (2 * 2 + 1, 2 * 2 + 1),
            "mamba2 1x4": (2 * 2 + 1, 2 * 2 + 1),
            "zamba2 2x2": (2 * 2 + 1, 2 * 2 + 2 + 1),
            "zamba2 1x4": (2 * 2 + 4 + 1 + 1, 2 * 2 + 1 + 1)}


@pytest.mark.parametrize("case", list(AXIS_SSM))
def test_gspmd_ssm_block_collectives_a_decode_step(world, case):
    """A decode step's collectives on the model line, equal on every rank
    (see :data:`SSM_STEP`): 2 gathers and 2 all-reduces a Mamba2 block
    (both smoke archs have 2 layers)."""
    _, d = world
    gathers, reduces = SSM_STEP[case]
    for r in range(N):
        step = json.load(open(d / f"axis_ssm_r{r}.json"))[case]["step"]
        assert step.get("model_all_gather") == gathers and \
            step.get("model_all_reduce") == reduces and \
            not step.get("model_reduce_scatter"), (r, step)
