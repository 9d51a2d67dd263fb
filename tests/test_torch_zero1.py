"""The port's ZeRO-1 (sharded AdamW in flat bucket space, the shard
reduce_scatter and the param all_gather) against the JAX reference.

The flat-space units are ``tests/test_zero1.py``'s, held against the
reference's functions on the same seeded numpy inputs (equal, or within
1e-6). The step is held against the reference's ``optimizer="zero1"``
step on one rank, and against the port's replicated step on 4 gloo
ranks (``test_torch_ranks.py zero1``), with the reference's
``check_zero1_matches_replicated`` tolerances: loss and grad norm rtol
1e-5, params rtol 2e-5 / atol 1e-6.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, PartitionSpec as P

from repro.compat import set_mesh, shard_map
from repro.configs import get_config as jax_get_config
from repro.core import bucketing as jbk
from repro.data.pipeline import synthetic_batch as jax_synthetic_batch
from repro.models.transformer import init_params as jax_init_params
from repro.optim import adamw as jadamw
from repro.train.trainer import make_train_step as jax_make_train_step
from repro.train.trainer import train_state_init as jax_train_state_init
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import bucketing as tbk
from repro_torch.optim import adamw as tadamw
from repro_torch.train.trainer import make_train_step, train_state_init
from repro_torch.tree import tree_flatten, tree_unflatten

from test_torch_ranks import run_ranks
from test_torch_train import _assert_params_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A one-rank gloo data group in this process."""
    store = tmp_path_factory.mktemp("store") / "store"
    dist.init_process_group("gloo", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def _param_tree(seed=0):
    """``tests/test_zero1.py``'s tree, as numpy."""
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(16, 32)).astype(np.float32),
            "blk": {"wo": rng.normal(size=(8, 8, 4)).astype(np.float32),
                    "scale": rng.normal(size=(129,)).astype(np.float32)},
            "bias": rng.normal(size=(3,)).astype(np.float32)}


def _flat_grads(plan, seed):
    """Seeded f32 gradients laid into each bucket's flat buffer (zero
    padding), as numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for b in plan.buckets:
        flat = np.zeros((b.padded_size,), np.float32)
        for s in b.slots:
            flat[s.offset:s.offset + s.size] = rng.normal(
                size=s.size).astype(np.float32) * 0.1
        out.append(flat)
    return out


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(
        v.copy()) for k, v in tree.items()}


def _plans(align=8, nb=2):
    tree = _param_tree()
    return (tree, jbk.plan_buckets(tree, nb, align=align),
            tbk.plan_buckets(_torch_tree(tree), nb, align=align))


@pytest.mark.parametrize("max_grad_norm", [1.0, 0.05, None])
def test_sharded_adamw_matches_reference(max_grad_norm):
    """3 steps of ``sharded_adamw_update`` on one rank (the shard is the
    bucket) against the reference's on the same flat gradients: master,
    moments and grad norm within 1e-6; and the unpacked master against
    the port's per-leaf ``adamw_update`` (the reference's own check)."""
    tree, jplan, tplan = _plans()
    jlayout, tlayout = jbk.ShardLayout(jplan, 1), tbk.ShardLayout(tplan, 1)
    jmasks = jadamw.bucket_decay_masks(jplan)
    tmasks = tadamw.shard_decay_masks(tplan, 1, 0)
    jstate = jadamw.sharded_adamw_init(tree, jplan)
    tstate = tadamw.sharded_adamw_init(_torch_tree(tree), tplan)
    rparams = _torch_tree(tree)
    rstate = tadamw.adamw_init(rparams)
    for step in range(3):
        flat = _flat_grads(jplan, step)
        jshards, jstate, jm = jadamw.sharded_adamw_update(
            [jnp.asarray(f) for f in flat], jstate, lr=jnp.float32(1e-2),
            layout=jlayout, decay_masks=jmasks, max_grad_norm=max_grad_norm)
        tshards, tstate, tm = tadamw.sharded_adamw_update(
            [torch.from_numpy(f.copy()) for f in flat], tstate, lr=1e-2,
            layout=tlayout, decay_masks=tmasks, max_grad_norm=max_grad_norm)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for name in ("master", "m", "v"):
            for t, j in zip(getattr(tstate, name), getattr(jstate, name)):
                np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                           rtol=1e-6, atol=1e-7,
                                           err_msg=f"step {step} {name}")
        assert int(tstate.count) == int(jstate.count) == step + 1
        # the same gradients per leaf through the replicated update
        leaves = [None] * tplan.num_leaves
        for f, b in zip(flat, tplan.buckets):
            for idx, val in tbk.unpack_bucket(torch.from_numpy(f.copy()), b):
                leaves[idx] = val
        rparams, rstate, rm = tadamw.adamw_update(
            tree_unflatten(tplan.treedef, leaves), rstate, rparams, lr=1e-2,
            max_grad_norm=max_grad_norm)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-6)
        got = [None] * tplan.num_leaves
        for shard, b in zip(tshards, tplan.buckets):
            for idx, val in tbk.unpack_bucket(shard, b):
                got[idx] = val
        for g, r in zip(got, tree_flatten(rparams)[0]):
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-6,
                                       atol=1e-7)


def test_sharded_adamw_bucket_update_matches_reference():
    """One bucket's update at step 3 on seeded shards, against the
    reference's, within 1e-6; the port writes in place and returns the
    same tensors."""
    rng = np.random.default_rng(5)
    g, m, master = (rng.normal(size=300).astype(np.float32)
                    for _ in range(3))
    v = np.abs(rng.normal(size=300)).astype(np.float32)
    mask = (rng.random(300) > 0.5).astype(np.float32)
    want = jadamw.sharded_adamw_bucket_update(
        jnp.asarray(g), jnp.asarray(m), jnp.asarray(v), jnp.asarray(master),
        jnp.asarray(mask), lr=jnp.float32(3e-3),
        count=jnp.asarray(3, jnp.int32))
    ts = [torch.from_numpy(a.copy()) for a in (m, v, master)]
    got = tadamw.sharded_adamw_bucket_update(
        torch.from_numpy(g), *ts, torch.from_numpy(mask) > 0, lr=3e-3,
        count=torch.tensor(3, dtype=torch.int32))
    assert all(a is b for a, b in zip(got, (ts[2], ts[0], ts[1])))
    for t, j in zip(got, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-7)


def _arch_plans(arch, nb, pack):
    jparams = jax_init_params(jax_get_config(arch), jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    slot = tbk.TILE if pack == "pallas" else None
    return (jparams, tparams,
            jbk.plan_buckets(jparams, nb, slot_align=slot),
            tbk.plan_buckets(tparams, nb, slot_align=slot))


@pytest.mark.parametrize("pack", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ["olmo-1b-smoke", "gemma-2b-smoke"])
def test_decay_masks_equal_reference(arch, pack):
    """``bucket_decay_masks`` equals the reference's; every rank's
    ``shard_decay_masks`` is its slice of them."""
    _, _, jplan, tplan = _arch_plans(arch, 4, pack)
    want = jadamw.bucket_decay_masks(jplan)
    got = tadamw.bucket_decay_masks(tplan)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    for n in (1, 2, 4, 8):
        for r in range(n):
            for g, w in zip(tadamw.shard_decay_masks(tplan, n, r), want):
                s = w.size // n
                np.testing.assert_array_equal(g.float().numpy(),
                                              w[r * s:(r + 1) * s])


@pytest.mark.parametrize("arch", ["olmo-1b-smoke", "gemma-2b-smoke"])
def test_sharded_init_is_the_reference_state_sliced(arch):
    """Rank r's ``sharded_adamw_init`` over N ranks is the reference's
    global state's r-th slice (f32 master, zero moments in the moment
    dtype), and N such shards hold exactly the plan's padded elements."""
    jparams, tparams, jplan, tplan = _arch_plans(arch, 3, "pallas")
    want = jadamw.sharded_adamw_init(jparams, jplan)
    for n in (1, 2, 4, 8):
        total = 0
        for r in range(n):
            st = tadamw.sharded_adamw_init(tparams, tplan, torch.bfloat16,
                                           axis_size=n, rank=r)
            for bid, (mst, w) in enumerate(zip(st.master, want.master)):
                s = w.size // n
                assert mst.dtype == torch.float32
                np.testing.assert_array_equal(mst.numpy(),
                                              np.asarray(w)[r * s:(r + 1) * s])
                assert st.m[bid].dtype == st.v[bid].dtype == torch.bfloat16
                assert not st.m[bid].any() and not st.v[bid].any()
            total += sum(m.numel() for m in st.master)
        assert total == tplan.total_padded


def test_sharded_state_is_one_over_n():
    _, _, tplan = _plans(align=16, nb=3)
    for n in (1, 2, 4, 8):
        layout = tbk.ShardLayout(tplan, n)
        assert layout.total_shard_elems * n == tplan.total_padded


def test_rejects_indivisible_and_mismatched_trees():
    plan = tbk.plan_buckets({"a": torch.zeros(10)}, 1, align=5)  # padded 10
    with pytest.raises(ValueError, match="divisible"):
        tadamw.sharded_adamw_init({"a": torch.zeros(10)}, plan, axis_size=4)
    _, _, tplan = _plans()
    with pytest.raises(ValueError, match="tree"):
        tadamw.sharded_adamw_init({"other": torch.zeros(4)}, tplan)
    with pytest.raises(ValueError, match="shard"):
        tadamw.sharded_adamw_update(
            [torch.zeros(3)] * tplan.num_buckets,
            tadamw.sharded_adamw_init(_torch_tree(_param_tree()), tplan),
            lr=1e-3, layout=tbk.ShardLayout(tplan, 1),
            decay_masks=tadamw.shard_decay_masks(tplan, 1, 0))


def _jax_shard_counts(tree, *, progress, pack):
    """The reference engine's (issued, joins) after tracing one
    ``reduce_gradients(output="shards")`` on a one-device mesh."""
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    seen = {}

    def run(tr):
        cp = jbk.get_comm_plan(tr, num_streams=3, num_vcis=4, pack=pack,
                               progress=progress, join_every=3,
                               token_impl="data", persistent=False)
        rt = cp.runtime()
        seen["engine"] = rt.engine
        shards, _ = jbk.reduce_gradients(
            rt, tr, cp, axis="data", pack=pack, reduction="reduce_scatter",
            output="shards")
        return shards

    spec = jax.tree_util.tree_map(lambda _: P(), tree)
    jax.jit(shard_map(run, mesh=mesh, in_specs=(spec,), out_specs=P(),
                      check_vma=False)).lower(tree)
    return seen["engine"].issued, seen["engine"].joins


@pytest.mark.parametrize("pack", ["xla", "pallas"])
@pytest.mark.parametrize("progress", ["global", "per_vci", "hybrid"])
def test_shards_and_gather_on_one_rank(one_rank, progress, pack):
    """``reduce_gradients(output="shards")`` on one rank: each shard is
    its bucket packed in f32 (the mean of one rank), the layout is the
    reference's, the (issued, joins) equal the reference's; and
    ``all_gather_shards`` of those shards gives back the tree, in f32 and
    bf16 wire."""
    jparams, tparams, _, _ = _arch_plans("gemma-2b-smoke", 3, pack)
    cp = tbk.get_comm_plan(tparams, num_streams=3, num_vcis=4, pack=pack,
                           progress=progress, join_every=3, persistent=False)
    rt = cp.runtime()
    shards, layout = tbk.reduce_gradients(
        rt, tparams, cp, pack=pack, reduction="reduce_scatter",
        output="shards")
    assert (rt.engine.issued, rt.engine.joins) == _jax_shard_counts(
        jparams, progress=progress, pack=pack)
    assert layout.shard_sizes == tuple(b.padded_size
                                       for b in cp.plan.buckets)
    leaves = tree_flatten(tparams)[0]
    for shard, b in zip(shards, cp.plan.buckets):
        assert shard.dtype == torch.float32
        assert torch.equal(shard, tbk.pack_bucket(leaves, b))
    for wire in (None, torch.bfloat16):
        got = tbk.all_gather_shards(cp.runtime(), shards, cp,
                                    wire_dtype=wire,
                                    order=cp.ready_order)
        for g, w in zip(tree_flatten(got)[0], leaves):
            want = w if wire is None else w.to(wire).float()
            assert g.dtype == w.dtype and torch.equal(g, want)
    with pytest.raises(ValueError, match="reduce_scatter"):
        tbk.reduce_gradients(rt, tparams, cp, output="shards")


def test_zero1_step_matches_reference_zero1_step(one_rank):
    """3 steps of the port's ZeRO-1 step (pack "pallas") on a one-rank
    group against the reference's ``optimizer="zero1"`` step on a
    one-device mesh, with ``tests/test_torch_train.py``'s tolerances: loss
    and grad norm rtol 1e-5, params two frameworks apart."""
    arch = "olmo-1b-smoke"
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    knobs = dict(comm="vci", pack="pallas", num_streams=4, num_vcis=4,
                 optimizer="zero1")
    jstate = jax_train_state_init(jcfg, jax.random.PRNGKey(0),
                                  optimizer="zero1", mesh=mesh,
                                  num_streams=4, pack="pallas")
    jstep = jax.jit(jax_make_train_step(jcfg, mesh=mesh, token_impl="data",
                                        **knobs))
    state = train_state_init(cfg, params=params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate.params), "cpu"),
        optimizer="zero1", num_streams=4, pack="pallas")
    step = make_train_step(cfg, **knobs)
    with set_mesh(mesh):
        for i in range(3):
            batch = jax_synthetic_batch(jcfg, 4, 32, seed=i)
            jstate, jm = jstep(jstate, batch)
            state, m = step(state, batch)
            for k in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                           rtol=1e-5, err_msg=f"{i} {k}")
    assert int(state.step) == 3 and int(state.opt.count) == 3
    _assert_params_close(tree_flatten(state.params)[0],
                         jax.tree_util.tree_leaves(jstate.params), "zero1")
    for t, j in zip(state.opt.master, jstate.opt.master):
        _assert_params_close([t.numpy()], [np.asarray(j)], "master")


def _write_inputs(path, arch, n, steps):
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


def _held(out, a, b, what):
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


def test_zero1_over_4_ranks_matches_replicated(tmp_path):
    """5 steps on gemma-2b-smoke over 4 gloo ranks: ZeRO-1 against the
    replicated optimizer (the analogue of ``check_zero1_matches_
    replicated``), and a rank's optimizer state 1/N of the replicated
    state's up to the buckets' padding."""
    n = 4
    _write_inputs(tmp_path, "gemma-2b-smoke", n, 5)
    r = run_ranks("zero1", tmp_path, n=n)
    assert r.returncode == 0, r.stdout + r.stderr
    out = np.load(tmp_path / "out_zero1.npz")
    assert _held(out, "zero1/post/1", "replicated/post/1", "zero1") > 0
    cfg = get_config("gemma-2b-smoke")
    from repro_torch.models.transformer import init_params
    params = init_params(cfg, 0, device="cpu")
    plan = tbk.plan_buckets(params, 4, slot_align=tbk.TILE)
    full = sum(p.numel() for p in tree_flatten(params)[0])
    rep, z1 = int(out["replicated/post/1/opt_bytes"]), \
        int(out["zero1/post/1/opt_bytes"])
    # replicated: f32 m and v of every element (+ the int32 count); ZeRO-1:
    # f32 master, m and v of 1/N of the padded buckets, the padding less
    # than a tile a bucket
    assert rep == 8 * full + 4
    assert z1 == 12 * plan.total_padded // n + 4
    assert 0 <= plan.total_padded - full < plan.num_buckets * tbk.TILE


def _cli(*extra):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
           "cpu", "--arch", "olmo-1b-smoke", "--steps", "2", "--batch", "4",
           "--seq", "32", "--mesh", "2", "--comm", "vci", "--pack", "pallas",
           "--num-streams", "4", "--log-every", "1", *extra]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=240,
                       env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    return [ln.split()[:6] for ln in r.stdout.splitlines()
            if ln.startswith("step ")]


def test_cli_zero1_on_two_cpu_ranks():
    """``--optimizer zero1`` with f32 wire prints the replicated run's
    loss and grad norm lines; with ``--zero1-wire bfloat16`` it trains
    (finite losses)."""
    rep = _cli()
    assert len(rep) == 2
    assert _cli("--optimizer", "zero1") == rep
    bf16 = _cli("--optimizer", "zero1", "--zero1-wire", "bfloat16")
    assert len(bf16) == 2 and all(np.isfinite(float(ln[3])) for ln in bf16)
