"""What the tests of the port's ``comm="gspmd"`` train step (FSDP over the
data ranks) share: its cases against the reference's single-device
``comm="gspmd"`` step on the whole batch, split over
``tests/test_torch_gspmd.py`` (the dense and MoE archs) and
``tests/test_torch_gspmd_families.py`` (the SSM, VLM and audio archs).

Same params (the reference's ``init_params`` through the rank files, in
leaf order), same numpy batches, float32 smoke configs on the CPU. The
port runs on 1, 2 and 4 spawned gloo ranks (``tests/test_torch_ranks.py
gspmd``), each rank holding its slice of every leaf the rule table shards
over data; the reference runs ``make_train_step(comm="gspmd")`` with
``mesh=None``. Two steps of every case: the dense, MoE (the load balance
of the global batch), SSM, VLM (ranks holding different counts of
``PAD_LABEL``) and audio smoke archs, and the dense arch with two
microbatches.

Tolerances are ``tests/_torch_train.py``'s (its module doc): metrics
rtol 1e-5, params by its rules, the VLM's with its noise rule. The ranks'
metrics must be equal, and each rank must hold ``1/N`` of the sliced
leaves' params and moments plus the replicated leaves, to the byte.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (one intra-op thread: see its docstring)
from _torch_train import METRIC_RTOL, assert_params_close
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import PAD_LABEL
from repro.data.pipeline import synthetic_batch as jax_synthetic_batch
from repro.train.trainer import make_train_step as jax_make_train_step
from repro.train.trainer import train_state_init as jax_train_state_init
from repro_torch.configs import get_config
from repro_torch.dist.sharding import is_spec, param_shapes, param_specs
from repro_torch.tree import tree_flatten_with_paths

from test_torch_ranks import run_ranks

STEPS, BATCH = 2, 8
KEYS = ("loss", "ce", "grad_norm", "tokens", "load_balance", "router_z",
        "lr")
# case -> (arch, seq, accum)
CASES = {
    "olmo": ("olmo-1b-smoke", 32, 1),
    "olmo_accum2": ("olmo-1b-smoke", 32, 2),
    "mixtral": ("mixtral-8x22b-smoke", 32, 1),
    "mamba2": ("mamba2-780m-smoke", 40, 1),
    "phi3v": ("phi-3-vision-4.2b-smoke", 32, 1),
    "musicgen": ("musicgen-large-smoke", 16, 1),
}
RANKS = (1, 2, 4)


def _batches(jcfg, seq):
    out = []
    for i in range(STEPS):
        b = dict(jax_synthetic_batch(jcfg, BATCH, seq, seed=3, step=i))
        if jcfg.modality == "vlm":
            # ranks hold different counts of PAD labels
            labels = b["labels"].copy()
            labels[1, -4:] = PAD_LABEL
            labels[BATCH - 1, jcfg.num_patches:jcfg.num_patches + 3] = \
                PAD_LABEL
            b["labels"] = labels
        out.append(b)
    return out


def fixtures(cases):
    """The ``reference`` and ``ranks`` module fixtures of a test file that
    holds ``cases`` (names of ``CASES``): each case's inputs (for the rank
    files) and the reference's metrics a step, params and second moments
    after the steps; then those cases on ``n`` spawned gloo ranks, one
    world a rank count: ``(n, directory)``. The reference computes each
    case once a module."""

    @pytest.fixture(scope="module")
    def reference(tmp_path_factory):
        out = {}
        for case in cases:
            arch, seq, accum = CASES[case]
            jcfg = jax_get_config(arch)
            state = jax_train_state_init(jcfg, jax.random.PRNGKey(0))
            leaves = [np.asarray(l) for l in
                      jax.tree_util.tree_leaves(state.params)]
            batches = _batches(jcfg, seq)
            inputs = dict(arch=arch, accum=accum, steps=STEPS,
                          n_leaves=len(leaves),
                          **{f"p{i}": l for i, l in enumerate(leaves)})
            for i, b in enumerate(batches):
                inputs.update({f"{k}{i}": np.asarray(v)
                               for k, v in b.items()})
            step = jax.jit(jax_make_train_step(jcfg, comm="gspmd",
                                               accum_steps=accum))
            metrics = []
            for b in batches:
                state, m = step(state, b)
                metrics.append([float(m[k]) for k in KEYS])
            out[case] = SimpleNamespace(
                inputs=inputs, metrics=np.asarray(metrics),
                params=[np.asarray(l) for l in
                        jax.tree_util.tree_leaves(state.params)],
                v=[np.asarray(l) for l in
                   jax.tree_util.tree_leaves(state.opt.v)])
        return out

    @pytest.fixture(scope="module", params=RANKS, ids=lambda n: f"{n}ranks")
    def ranks(request, reference, tmp_path_factory):
        """The cases on ``n`` spawned gloo ranks: ``(n, directory)``."""
        n = request.param
        d = tmp_path_factory.mktemp(f"gspmd{n}")
        for case, ref in reference.items():
            np.savez(d / f"gspmd_{case}.npz", **ref.inputs)
        r = run_ranks("gspmd", d, n=n, timeout=600)
        assert r.returncode == 0, r.stdout + r.stderr
        return n, d

    return reference, ranks


def rank_out(d, case, rank):
    return np.load(d / f"gspmd_out_{case}_r{rank}.npz")


def expected_bytes(cfg, n):
    """(params, moments) bytes of one rank: ``1/n`` of each leaf the rule
    table shards over data, the whole of the rest."""
    mesh = SimpleNamespace(axis_names=("data",), shape={"data": n})
    specs = dict(tree_flatten_with_paths(param_specs(cfg, mesh),
                                         is_leaf=is_spec))
    p = m = 0
    mdt = torch.empty((), dtype=getattr(torch, cfg.optimizer_dtype))
    for path, leaf in tree_flatten_with_paths(param_shapes(cfg)):
        split = n if any(e == "data" for e in specs[path]) else 1
        p += leaf.numel() * leaf.element_size() // split
        m += 2 * leaf.numel() * mdt.element_size() // split
    return p, m


def check_step(reference, ranks, case):
    """``test_gspmd_step_matches_reference_gspmd_step``'s case."""
    n, d = ranks
    ref, out = reference[case], rank_out(d, case, 0)
    for i in range(STEPS):
        for j, k in enumerate(KEYS):
            np.testing.assert_allclose(out["metrics"][i, j],
                                       ref.metrics[i, j], rtol=METRIC_RTOL,
                                       err_msg=f"{case} {n} ranks step {i} "
                                               f"{k}")
    if CASES[case][0].startswith("mixtral"):
        assert (out["metrics"][:, KEYS.index("load_balance")] > 0).all()
    assert_params_close([out[f"p{i}"] for i in range(len(ref.params))],
                        ref.params, f"{case} {n} ranks", steps=STEPS,
                        ref_v=ref.v if case == "phi3v" else None)


def check_slices(ranks, case):
    """``test_gspmd_ranks_agree_and_hold_their_slices``'s case."""
    n, d = ranks
    cfg = get_config(CASES[case][0])
    want_p, want_m = expected_bytes(cfg, n)
    for r in range(n):
        out = rank_out(d, case, r)
        np.testing.assert_array_equal(out["metrics"],
                                      rank_out(d, case, 0)["metrics"])
        assert int(out["param_bytes"]) == want_p, (r, case)
        assert int(out["moment_bytes"]) == want_m, (r, case)
    if n > 1:
        full = sum(l.numel() * l.element_size() for _, l in
                   tree_flatten_with_paths(param_shapes(cfg)))
        assert want_p < full
