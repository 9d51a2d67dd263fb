"""The port's collectives and gradient reduction on spawned gloo ranks
(``tests/test_torch_ranks.py``): the runtime's collectives and window ops
on 8 ranks, each rank's values against numpy and each runtime's op and
join counts against the reference engine's; the paper's applications
(``examples_torch/``) on the same 8 ranks, one world for all of it, their
collective depths, the stencil against the reference's solver and BSPMM
against its closed form; and ``reduce_gradients`` on 4 ranks against the
tree mean.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import _torch_cpu  # noqa: F401  (one intra-op thread: see its docstring)
from repro.compat import shard_map

from test_torch_ranks import APP_DEPTHS, PROGRESS, example, run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_op_counts(progress, ops):
    """The reference engine's (issued, joins) after tracing ``ops(rt,
    world, x)`` on a one-device mesh (a perm of one rank: ``(0, 0)``)."""
    from repro.core.collectives import CommRuntime as JCommRuntime
    from repro.core.comm import CommWorld as JCommWorld
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    seen = {}

    def run(x):
        world = JCommWorld(num_vcis=4)
        rt = JCommRuntime(world, progress=progress, join_every=2)
        seen["engine"] = rt.engine
        return ops(rt, world, x)

    jax.jit(shard_map(run, mesh=mesh, in_specs=P("data"),
                      out_specs=P("data"), check_vma=False)).lower(
        np.zeros((1, 4), np.float32))
    return seen["engine"].issued, seen["engine"].joins


def _jax_numerics_ops(rt, world, x):
    c1, c2 = world.create("c1"), world.create("c2")
    w = world.create("w", kind="rma")
    ar = rt.all_reduce(x, c1, axis="data")
    ag = rt.all_gather(x, c2, axis="data")
    rs = rt.reduce_scatter(ag, c1, axis="data")
    a2a = rt.all_to_all(jnp.broadcast_to(x, (1,) + x.shape), c2,
                        axis="data", split_axis=0, concat_axis=1)
    sr = rt.sendrecv(x, c1, axis="data", perm=[(0, 0)])
    acc = rt.accumulate(x, w, axis="data")
    return rt.barrier(ar + rs + sr + acc + ag + a2a.sum())


def _jax_window_ops(ordered):
    import dataclasses

    def ops(rt, world, x):
        w = world.create("win", kind="rma")
        if not ordered:
            w = dataclasses.replace(w, ordered=False)
        g = rt.get(x, w, axis="data", perm=[(0, 0)])
        p = rt.put(x * 2, w, axis="data", perm=[(0, 0)])
        y = rt.flush(g + p, w)
        for ordering in ("rar", "none"):
            a = world.create(f"acc_{ordering}", kind="rma",
                             accumulate_ordering=ordering)
            y = y + rt.accumulate(x, a, axis="data") + \
                rt.accumulate(x * 2, a, axis="data")
        return rt.barrier(y)
    return ops


@pytest.fixture(scope="module")
def collectives_world(tmp_path_factory):
    """The 8 spawned gloo ranks of ``test_torch_ranks.py collectives``,
    run once for the tests below: their return and rank 0's results."""
    out_dir = tmp_path_factory.mktemp("collectives")
    r = run_ranks("collectives", out_dir, n=8)
    out = (np.load(out_dir / "out_collectives.npz")
           if r.returncode == 0 else None)
    return r, out


def test_collectives_and_window_ops_over_8_ranks_match_reference(
        collectives_world):
    """8 spawned gloo ranks (``test_torch_ranks.py collectives``): the
    analogues of ``check_collectives_numerics`` and
    ``check_accumulate_relaxed_matches_ordered`` for each progress mode,
    plus get/put on an ordered and an un-ordered window and a flush; each
    value against numpy on the ranks, and each runtime's (issued, joins)
    equal to the reference engine's for the same sequence."""
    r, out = collectives_world
    assert r.returncode == 0, r.stdout + r.stderr
    for progress in ("global", "per_vci", "hybrid"):
        want = _jax_op_counts(progress, _jax_numerics_ops)
        assert tuple(out[f"{progress}/numerics"]) == want, progress
        for ordered in (True, False):
            want = _jax_op_counts(progress, _jax_window_ops(ordered))
            assert tuple(out[f"{progress}/window/{ordered}"]) == want, \
                (progress, ordered)


def _reference_example(name):
    """``examples/<name>.py``, the reference's application, as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"examples_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("progress", PROGRESS)
@pytest.mark.parametrize("app", sorted(APP_DEPTHS))
def test_example_depth_over_8_ranks(collectives_world, app, progress):
    """The paper's applications (``examples_torch/``) on the 8 ranks: each
    run held its result on the ranks, and its ``CollectiveDepth`` is the
    count and depth of ``APP_DEPTHS``."""
    r, out = collectives_world
    assert r.returncode == 0, r.stdout + r.stderr
    assert tuple(out[f"{app}/{progress}"]) == APP_DEPTHS[app][progress]


def test_stencil_over_8_ranks_matches_reference_solver(collectives_world):
    """The stencil's grid from 2 x 4 ranks (hybrid progress) against the
    reference's own single-device solver, ``reference()`` of
    ``examples/stencil_halo.py``, within the reference's 1e-4."""
    r, out = collectives_world
    assert r.returncode == 0, r.stdout + r.stderr
    stencil = example("stencil_halo")
    rows, cols = stencil.grid(8)
    want = np.asarray(_reference_example("stencil_halo").reference(
        jnp.asarray(stencil.initial_grid(rows, cols)), stencil.STEPS))
    assert out["stencil/grid"].shape == want.shape
    assert np.abs(out["stencil/grid"] - want).max() < stencil.TOL


@pytest.mark.parametrize("progress", PROGRESS)
def test_bspmm_over_8_ranks_is_the_closed_form(collectives_world, progress):
    """BSPMM's C on 8 ranks equals ``8 · Σ_w A_w B_w`` (rtol 1e-5 of its
    largest element)."""
    r, out = collectives_world
    assert r.returncode == 0, r.stdout + r.stderr
    bspmm = example("bspmm_accumulate")
    want = bspmm.closed_form(*bspmm.tiles(), 8)
    np.testing.assert_allclose(out[f"bspmm/{progress}/C"], want,
                               rtol=bspmm.RTOL,
                               atol=bspmm.RTOL * np.abs(want).max())


def test_reduce_gradients_over_4_ranks_equals_mean(tmp_path):
    """4 spawned gloo ranks: every cell of pack x reduction x staging x
    plan persistence equals the tree mean (rtol 1e-5 / atol 1e-6, as
    tests/_multidev_checks.py), and the persistent cells hit the cache."""
    r = run_ranks("reduce", tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
