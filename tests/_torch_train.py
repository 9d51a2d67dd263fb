"""What the port's train-step tests share: the rules that hold a trained
port state against the reference's, the one-rank group, and the VCI step
cases (``tests/test_torch_train_vci.py`` and
``tests/test_torch_train_families.py`` split them; the gspmd, model-axis,
ZeRO-1, overlap and checkpoint tests hold their steps by the same rules).

Same params (the reference's ``init_params`` through
``repro_torch.bridge``), same numpy batches (``synthetic_batch``), float32
smoke configs on the CPU.

Tolerances. Loss and grad norm: rtol 1e-5, as the reference's own
conformance checks (``tests/_multidev_checks.py``). Params: the reference
checks hold two XLA programs to rtol 2e-5 / atol 1e-6; here two frameworks
sum the gradients in different orders, and AdamW divides each moment by
its own square root, so an element whose gradient is at the level of that
summation noise (≈1e-7 of the gradient norm) takes an update anywhere in
``±lr`` (lr = 3e-4). Every element must lie within rtol 2e-5 / atol 1e-4
(a third of one step's lr), and at most one element in 10^4 may lie
outside the reference's rtol 2e-5 / atol 1e-6. The VLM's step alone
has an element off by more than lr/3: a token embedding element whose
gradients (≈6e-8) differ by ≈1e-7 between the frameworks, 1.3e-4 apart
after 3 steps. For that case only, given the reference's second moments,
the elements whose gradient stayed nonzero but within ten times that noise
(≈1e-6 of the leaf's largest gradient here) — the root mean square of
their gradients over the steps, from AdamW's ``v``, above 0 and under
1e-5 of their leaf's largest — are held only to the second rule's count
and to ``steps × lr`` (what AdamW can move an element, beside its decay);
an element the reference's gradient never reached (a PAD or unseen-token
row) stays under the first rule. Where a config keeps its
AdamW moments in bf16 (arctic-480b), that noise also moves a moment across
a bf16 rounding boundary here and there: each step then reads a moment
off by one bf16 ulp (2^-8 relative), which moves that step's update by up
to ``2^-8 * lr``; the second rule's atol carries that once a step (1e-6 +
3 × 2^-8 × 3e-4 after 3 steps; with f32 moments arctic's step has 111
elements outside 1e-6 in 4,590,848, with bf16 moments 489, and 15 outside
the carried atol). The hybrid's step needs the same rule for another kind
of element: one whose gradient, at the first step that reaches it, is
nonzero but within the noise (under 1e-5 of its leaf's largest that step).
AdamW's first update of an element is about ``lr`` times the sign of that
gradient, whatever its size, so the two frameworks may move it in opposite
directions. At seq 96 one token embedding element of zamba2-7b-smoke (3
layers) first gets 8.0e-8 from the reference and -1.3e-8 from the port
(1e-6 of that row's largest), and ends 1.33e-4 apart after 3 steps while
the two steps' gradients agree within 3e-6 of each leaf's largest. Those
elements are found from the reference's first moments after each step
(the gradient of step t is ``(m_t - 0.9 m_(t-1)) / 0.1``, exact where
``m_(t-1)`` is 0) and held as the VLM's noise elements are.
"""

import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import _torch_cpu  # noqa: F401  (one intra-op thread: see its docstring)
from repro.compat import set_mesh
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import synthetic_batch as jax_synthetic_batch
from repro.train.trainer import make_train_step as jax_make_train_step
from repro.train.trainer import train_state_init as jax_train_state_init
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.train.trainer import make_train_step, train_state_init
from repro_torch.tree import tree_flatten

METRIC_RTOL = 1e-5


def first_noise(ref_m, i):
    """Leaf ``i``'s elements whose reference gradient, at the first step
    that reached them, was nonzero and under 1e-5 of the leaf's largest
    (see the module doc); ``ref_m``: the reference's first moments after
    each step."""
    seen = first = prev = 0
    for m in ref_m:
        m = np.asarray(m[i], np.float32)
        grad = (m - 0.9 * prev) / 0.1
        new = (grad != 0) & ~np.asarray(seen, bool)
        first = first | (new & (np.abs(grad) < 1e-5 * np.abs(grad).max()))
        seen, prev = seen | (grad != 0), m
    return np.asarray(first, bool)


def assert_params_close(got_leaves, want_leaves, what, bf16_steps=0,
                        ref_v=None, steps=3, ref_m=None):
    """The module doc's rules; ``bf16_steps``: the AdamW steps taken with
    bf16 moments (0 for f32 moments); ``ref_v`` (the VLM's case only): the
    reference's second moments after ``steps`` steps, which single out the
    elements whose nonzero gradient stayed at the noise level; ``ref_m``
    (the hybrid's case only): its first moments after each step, which
    single out the elements first reached by a gradient at that level."""
    atol = 1e-6 + bf16_steps * 2 ** -8 * 3e-4
    off = total = 0
    for i, (g, w) in enumerate(zip(got_leaves, want_leaves)):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        noise = np.zeros(w.shape, bool)
        if ref_v is not None:
            rms = np.sqrt(np.asarray(ref_v[i], np.float32))
            noise = (rms > 0) & (rms < 1e-5 * rms.max())
        if ref_m is not None:
            noise = noise | first_noise(ref_m, i)
        if noise.any():
            assert (np.abs(g - w)[noise] <= steps * 3e-4 * (1 + 1e-6)).all(), what
        np.testing.assert_allclose(g[~noise], w[~noise], rtol=2e-5,
                                   atol=1e-4, err_msg=what)
        off += int((np.abs(g - w) > atol + 2e-5 * np.abs(w)).sum())
        total += w.size
    assert off <= total * 1e-4, f"{what}: {off} of {total} elements off"


# arch, sequence length, which of the module doc's noise rules applies
# ("rms": the VLM's, "first": the hybrid's), the depth (None: the smoke
# arch's): the dense text archs, the MoE archs (mixtral's smoke window is
# 64, so seq 96 trains past it; arctic has a dense residual FFN beside its
# experts), the SSM and the hybrid at seq 96 (three chunks of 32), the
# hybrid at 3 layers (one group of two blocks and its attention site, then
# one remainder block: the shape of zamba2-7b's 81 = 13 x 6 + 3), the VLM
# (16 patches + 32 text tokens) and audio (4 codebooks)
STEP_CASES = [
    pytest.param("olmo-1b-smoke", 32, False, None, id="olmo-1b-smoke"),
    pytest.param("gemma-2b-smoke", 32, False, None, id="gemma-2b-smoke"),
    pytest.param("command-r-35b-smoke", 32, False, None,
                 id="command-r-35b-smoke"),
    pytest.param("mixtral-8x22b-smoke", 96, False, None,
                 id="mixtral-8x22b-smoke-seq96"),
    pytest.param("arctic-480b-smoke", 32, False, None,
                 id="arctic-480b-smoke"),
    pytest.param("mamba2-780m-smoke", 96, False, None,
                 id="mamba2-780m-smoke-seq96"),
    pytest.param("zamba2-7b-smoke", 96, "first", 3,
                 id="zamba2-7b-smoke-3l"),
    pytest.param("phi-3-vision-4.2b-smoke", 48, "rms", None,
                 id="phi-3-vision-4.2b-smoke"),
    pytest.param("musicgen-large-smoke", 32, False, None,
                 id="musicgen-large-smoke"),
]


def check_vci_step(arch, seq, noise_rule, layers):
    """``test_vci_step_matches_reference_vci_step``'s case (the caller holds
    the one-rank group): 3 steps of the port's pack="pallas" VCI step on
    a one-rank group against the reference's on a one-device mesh."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    if layers is not None:
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
        cfg = dataclasses.replace(cfg, num_layers=layers)
    knobs = dict(comm="vci", pack="pallas", num_streams=4, num_vcis=4)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jstate = jax_train_state_init(jcfg, jax.random.PRNGKey(0))
    jstep = jax.jit(jax_make_train_step(jcfg, mesh=mesh, token_impl="data",
                                        **knobs))
    state = train_state_init(cfg, params=params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate.params), "cpu"))
    step = make_train_step(cfg, **knobs)
    ref_m = []
    with set_mesh(mesh):
        for i in range(3):
            batch = jax_synthetic_batch(jcfg, 4, seq, seed=i)
            jstate, jm = jstep(jstate, batch)
            ref_m.append([np.asarray(t) for t in
                          jax.tree_util.tree_leaves(jstate.opt.m)])
            state, m = step(state, batch)
            for k in ("loss", "ce", "grad_norm", "tokens", "lr",
                      "load_balance", "router_z"):
                np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                           rtol=METRIC_RTOL,
                                           err_msg=f"{arch} step {i} {k}")
            assert (float(m["load_balance"]) > 0) == (cfg.moe is not None)
    assert int(state.step) == 3 and int(state.opt.count) == 3
    assert_params_close(tree_flatten(state.params)[0],
                        jax.tree_util.tree_leaves(jstate.params), arch,
                        bf16_steps=3 if cfg.optimizer_dtype == "bfloat16"
                        else 0,
                        ref_v=jax.tree_util.tree_leaves(jstate.opt.v)
                        if noise_rule == "rms" else None,
                        ref_m=ref_m if noise_rule == "first" else None)


def write_rank_inputs(path, arch, n, steps):
    """The reference's params (leaf order) and ``steps`` batches of 2 rows
    a rank, for ``test_torch_ranks.py``'s train runs."""
    jcfg = jax_get_config(arch)
    params = jax_train_state_init(jcfg, jax.random.PRNGKey(0)).params
    leaves = [np.asarray(l) for l in jax.tree_util.tree_leaves(params)]
    batches = {}
    for i in range(steps):
        b = jax_synthetic_batch(jcfg, 2 * n, 32, seed=i)
        batches[f"tokens{i}"], batches[f"labels{i}"] = (b["tokens"],
                                                        b["labels"])
    np.savez(path / "in.npz", arch=arch, n_leaves=len(leaves), steps=steps,
             **{f"p{i}": l for i, l in enumerate(leaves)}, **batches)
    return params, batches


def held(out, a, b, what):
    """Run ``a`` against run ``b`` with the reference's zero1/overlap
    tolerances; returns the number of param leaves compared."""
    np.testing.assert_allclose(out[f"{a}/metrics"], out[f"{b}/metrics"],
                               rtol=1e-5, err_msg=what)
    i = 0
    while f"{a}/p{i}" in out:
        np.testing.assert_allclose(out[f"{a}/p{i}"], out[f"{b}/p{i}"],
                                   rtol=2e-5, atol=1e-6,
                                   err_msg=f"{what} leaf {i}")
        i += 1
    return i
