"""The port's VCI train step against the JAX reference, the SSM, hybrid,
VLM and audio archs (``tests/_torch_train.py``'s ``STEP_CASES`` from
mamba2 on; the dense and MoE archs are in
``tests/test_torch_train_vci.py``), and one step over 4 spawned gloo ranks
against the reference's gspmd step; held by that module's rules.
"""

import jax
import numpy as np
import pytest

from _torch_cpu import one_rank  # noqa: F401
from _torch_train import (METRIC_RTOL, STEP_CASES, assert_params_close,
                          check_vci_step)
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import synthetic_batch as jax_synthetic_batch
from repro.train.trainer import make_train_step as jax_make_train_step
from repro.train.trainer import train_state_init as jax_train_state_init

from test_torch_ranks import run_ranks

CASES = STEP_CASES[5:]


@pytest.mark.parametrize("arch,seq,noise_rule,layers", CASES)
def test_vci_step_matches_reference_vci_step(one_rank, arch, seq,
                                             noise_rule, layers):
    """3 steps of the port's pack="pallas" VCI step on a one-rank group
    against the reference's on a one-device mesh: the MoE archs through the
    row gather's backward and the aux losses, the SSM and hybrid archs
    through the SSD step's backward, the VLM's labels over image + text,
    audio's loss over the K codebook heads."""
    check_vci_step(arch, seq, noise_rule, layers)


def test_4_ranks_match_reference_gspmd_step(tmp_path):
    """One step over 4 spawned gloo ranks (each on its quarter of the
    batch), per progress mode, against the reference's single-device
    comm="gspmd" step on the whole batch (the analogue of
    check_vci_train_step_matches_gspmd)."""
    arch, n = "olmo-1b-smoke", 4
    jcfg = jax_get_config(arch)
    batch = jax_synthetic_batch(jcfg, 2 * n, 32, seed=1)
    state = jax_train_state_init(jcfg, jax.random.PRNGKey(0))
    leaves = [np.asarray(l) for l in jax.tree_util.tree_leaves(state.params)]
    np.savez(tmp_path / "in.npz", arch=arch, n_leaves=len(leaves),
             tokens=batch["tokens"], labels=batch["labels"],
             **{f"p{i}": l for i, l in enumerate(leaves)})
    ref_state, ref_m = jax.jit(jax_make_train_step(jcfg, comm="gspmd"))(
        state, batch)
    r = run_ranks("train", tmp_path, n=n)
    assert r.returncode == 0, r.stdout + r.stderr
    want = jax.tree_util.tree_leaves(ref_state.params)
    for progress in ("hybrid", "per_vci", "global"):
        out = np.load(tmp_path / f"out_{progress}.npz")
        np.testing.assert_allclose(float(out["loss"]), float(ref_m["loss"]),
                                   rtol=METRIC_RTOL, err_msg=progress)
        np.testing.assert_allclose(float(out["grad_norm"]),
                                   float(ref_m["grad_norm"]),
                                   rtol=METRIC_RTOL, err_msg=progress)
        assert_params_close([out[f"p{i}"] for i in range(len(want))], want,
                            progress)
