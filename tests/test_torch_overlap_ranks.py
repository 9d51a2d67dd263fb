"""The port's overlap schedule on spawned CPU ranks: 5 steps on
gemma-2b-smoke over 4 gloo ranks (``test_torch_ranks.py overlap``),
overlap against post for both optimizers and each post run against the
reference's post step. The one-rank checks are
``tests/test_torch_overlap.py``'s, the CLI's
``tests/test_torch_overlap_cli.py``'s.
"""

import jax
import numpy as np
from jax.sharding import Mesh

import _torch_cpu  # noqa: F401  (one intra-op thread: see its docstring)
from _torch_train import assert_params_close, held, write_rank_inputs
from repro.compat import set_mesh
from repro.configs import get_config as jax_get_config
from repro.train.trainer import make_train_step as jax_make_train_step
from repro.train.trainer import train_state_init as jax_train_state_init

from test_torch_ranks import run_ranks


def test_overlap_over_4_ranks_matches_post_and_reference(tmp_path):
    """5 steps on gemma-2b-smoke over 4 gloo ranks with 2 microbatches
    (the analogue of ``check_overlap_matches_post``): overlap against
    post for both optimizers, the hooks issuing in ready order inside the
    backward; and each post run against the reference's ``schedule=
    "post"`` step of that optimizer on one device over the whole batch
    (two frameworks: ``tests/_torch_train.py``'s params tolerance)."""
    arch, n, steps = "gemma-2b-smoke", 4, 5
    params, batches = write_rank_inputs(tmp_path, arch, n, steps)
    r = run_ranks("overlap", tmp_path, n=n)
    assert r.returncode == 0, r.stdout + r.stderr
    out = np.load(tmp_path / "out_overlap.npz")
    jcfg = jax_get_config(arch)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    for optimizer in ("replicated", "zero1"):
        post, ovl = f"{optimizer}/post/2", f"{optimizer}/overlap/2"
        leaves = held(out, ovl, post, f"{optimizer} overlap")
        np.testing.assert_array_equal(out[f"{ovl}/order"],
                                      out[f"{ovl}/ready_order"])
        assert int(out[f"{ovl}/in_backward"]) == len(out[f"{ovl}/order"])
        knobs = dict(comm="vci", pack="pallas", num_streams=4, num_vcis=4,
                     optimizer=optimizer, accum_steps=2)
        jstate = jax_train_state_init(jcfg, jax.random.PRNGKey(0),
                                      optimizer=optimizer, mesh=mesh,
                                      num_streams=4, pack="pallas")
        jstep = jax.jit(jax_make_train_step(jcfg, mesh=mesh,
                                            token_impl="data", **knobs))
        with set_mesh(mesh):
            for i in range(steps):
                jstate, jm = jstep(jstate, {
                    "tokens": batches[f"tokens{i}"],
                    "labels": batches[f"labels{i}"]})
                np.testing.assert_allclose(
                    out[f"{post}/metrics"][i],
                    [float(jm["loss"]), float(jm["grad_norm"])], rtol=1e-5,
                    err_msg=f"{optimizer} step {i}")
        assert_params_close([out[f"{post}/p{i}"] for i in range(leaves)],
                            jax.tree_util.tree_leaves(jstate.params),
                            optimizer)
