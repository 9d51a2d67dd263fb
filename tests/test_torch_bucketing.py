"""The port's VCI core and gradient bucketing against the JAX reference.

Host-side state must match exactly: leaf order, bucket plans, pack tables,
VCI pool assignments and stats, and the progress engine's op and join
counts after one ``reduce_gradients``. The reductions themselves run on a
one-rank gloo group in this process; the spawned ranks' numerics are
``tests/test_torch_bucketing_ranks.py``'s.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from _torch_cpu import one_rank  # noqa: F401  (one intra-op thread: see its docstring)
from repro.compat import shard_map
from repro.configs import get_config as jax_get_config
from repro.core import bucketing as jbk
from repro.core.vci import POLICIES, VCIPool as JVCIPool
from repro.models.transformer import init_params as jax_init_params
from repro_torch.bridge import params_from_numpy
from repro_torch.core import bucketing as tbk
from repro_torch.core import vci as tvci
from repro_torch.tree import tree_flatten, tree_unflatten


TILE = tbk.TILE
ARCHS = ["olmo-1b-smoke", "gemma-2b-smoke"]


def _bridged(arch):
    jparams = jax_init_params(jax_get_config(arch), jax.random.PRNGKey(0))
    return jparams, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def _slots(plan):
    return [[(s.index, tuple(s.shape), s.offset, str(s.dtype).split(".")[-1])
             for s in b.slots] + [b.padded_size] for b in plan.buckets]


@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_order_is_jax_order(arch):
    jparams, tparams = _bridged(arch)
    j_leaves = jax.tree_util.tree_leaves_with_path(jparams)
    t_leaves, treedef = tree_flatten(tparams)
    assert len(j_leaves) == len(t_leaves)
    for (path, a), b in zip(j_leaves, t_leaves):
        assert tuple(a.shape) == tuple(b.shape), jax.tree_util.keystr(path)
    rebuilt = tree_unflatten(treedef, t_leaves)
    assert tree_flatten(rebuilt) == (t_leaves, treedef)


@pytest.mark.parametrize("slot_align", [None, TILE])
@pytest.mark.parametrize("partition", ["size", "contig"])
@pytest.mark.parametrize("arch", ARCHS)
def test_plans_equal_reference(arch, partition, slot_align):
    jparams, tparams = _bridged(arch)
    for nb in (1, 3, 4, 8):
        jp = jbk.plan_buckets(jparams, nb, slot_align=slot_align,
                              partition=partition)
        tp = tbk.plan_buckets(tparams, nb, slot_align=slot_align,
                              partition=partition)
        assert _slots(tp) == _slots(jp)
        assert (tp.align, tp.slot_align, tp.total_padded) == \
            (jp.align, jp.slot_align, jp.total_padded)
        assert tbk.bucket_ready_order(tp) == jbk.bucket_ready_order(jp)


@pytest.mark.parametrize("arch", ARCHS)
def test_comm_plan_tables_equal_reference(arch):
    jparams, tparams = _bridged(arch)
    for nb in (3, 8):
        jcp = jbk.get_comm_plan(jparams, num_streams=nb, pack="pallas",
                                persistent=False)
        tcp = tbk.get_comm_plan(tparams, num_streams=nb, pack="pallas",
                                persistent=False)
        jt, tt = jcp.tables, tcp.tables
        assert tt[0] == jt[0] and tt[2] == jt[2]
        np.testing.assert_array_equal(tt[1], jt[1])
        for (tb, tv), (jb, jv) in zip(tt[3], jt[3]):
            np.testing.assert_array_equal(tb, jb)
            np.testing.assert_array_equal(tv, jv)
        for a, b in zip(tt[4], jt[4]):
            np.testing.assert_array_equal(a, b)
        assert [c.vci.index for c in tcp.contexts] == \
            [c.vci.index for c in jcp.contexts]


def test_shard_layout_matches_reference():
    _, tparams = _bridged("olmo-1b-smoke")
    jparams = jax.tree_util.tree_map(lambda t: np.zeros(t.shape),
                                     _bridged("olmo-1b-smoke")[0])
    tl = tbk.ShardLayout(tbk.plan_buckets(tparams, 3), 8)
    jl = jbk.ShardLayout(jbk.plan_buckets(jparams, 3), 8)
    assert tl.shard_sizes == jl.shard_sizes
    for bid, b in enumerate(tl.plan.buckets):
        assert tl.shard_bounds(bid) == jl.shard_bounds(bid)
        for s, js in zip(b.slots, jl.plan.buckets[bid].slots):
            assert tl.slot_owners(bid, s) == jl.slot_owners(bid, js)


def test_vci_pool_matches_reference():
    """Assignments and stats of every policy, under a script of acquires,
    hinted acquires and releases that exhausts small pools."""
    script = ([("acquire", f"c{i}", None) for i in range(6)]
              + [("release", "c1", None), ("release", "c4", None),
                 ("acquire", "h0", "dedicated"), ("acquire", "h1", "shared"),
                 ("acquire", "h2", "dedicated"), ("release", "c0", None),
                 ("acquire", "c9", None)])
    for policy in POLICIES:
        for n in (1, 3, 8):
            pools = (JVCIPool(num_vcis=n, policy=policy),
                     tvci.VCIPool(num_vcis=n, policy=policy))
            for op, name, hint in script:
                got = [p.acquire(name, hint=hint).index if op == "acquire"
                       else p.release(name) for p in pools]
                assert got[0] == got[1], (policy, n, op, name)
            js, ts = pools[0].stats, pools[1].stats
            assert (ts.acquires, ts.fallback_hits, ts.releases,
                    ts.per_vci_contexts, ts.max_contexts_per_vci) == \
                (js.acquires, js.fallback_hits, js.releases,
                 js.per_vci_contexts, js.max_contexts_per_vci)
            assert pools[0].active == pools[1].active


def _jax_counts(tree, *, progress, reduction, pack, staging):
    """The reference engine's (issued, joins) after tracing one
    reduce_gradients on a one-device mesh."""
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    seen = {}

    def run(tr):
        cp = jbk.get_comm_plan(tr, num_streams=3, num_vcis=4, pack=pack,
                               progress=progress, join_every=3,
                               token_impl="data", persistent=False)
        rt = cp.runtime()
        seen["engine"] = rt.engine
        return jbk.reduce_gradients(rt, tr, cp, axis="data", pack=pack,
                                    reduction=reduction, staging=staging)

    spec = jax.tree_util.tree_map(lambda _: P(), tree)
    jax.jit(shard_map(run, mesh=mesh, in_specs=(spec,), out_specs=spec,
                      check_vma=False)).lower(tree)
    return seen["engine"].issued, seen["engine"].joins


@pytest.mark.parametrize("reduction", ["all_reduce", "reduce_scatter"])
@pytest.mark.parametrize("progress", ["global", "per_vci", "hybrid"])
def test_progress_counts_match_reference(one_rank, progress, reduction):
    jparams, tparams = _bridged("gemma-2b-smoke")
    for pack, staging in (("xla", "per_vci"), ("pallas", "shared")):
        want = _jax_counts(jparams, progress=progress, reduction=reduction,
                           pack=pack, staging=staging)
        cp = tbk.get_comm_plan(tparams, num_streams=3, num_vcis=4, pack=pack,
                               progress=progress, join_every=3,
                               persistent=False)
        rt = cp.runtime()
        got = tbk.reduce_gradients(rt, tparams, cp, pack=pack,
                                   reduction=reduction, staging=staging)
        assert want[0] > 0
        assert (rt.engine.issued, rt.engine.joins) == want
        # one rank: the mean is the gradient itself, bit for bit
        for a, b in zip(tree_flatten(got)[0], tree_flatten(tparams)[0]):
            assert torch.equal(a, b)


def test_pack_paths_agree_with_reference():
    """pack_bucket (concatenate) and the slot-by-slot pallas layout equal
    the reference's on slot-aligned plans; unpack inverts pack."""
    rng = np.random.default_rng(3)
    shapes = [(7,), (40,), (3, 9), (2,)]
    tree = {f"l{i}": rng.normal(size=s).astype(np.float32)
            for i, s in enumerate(shapes)}
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    jplan = jbk.plan_buckets(tree, 2, align=TILE, slot_align=TILE)
    tplan = tbk.plan_buckets(ttree, 2, align=TILE, slot_align=TILE)
    jleaves = [jnp.asarray(tree[k]) for k in sorted(tree)]
    tleaves = tree_flatten(ttree)[0]
    for jb, tb in zip(jplan.buckets, tplan.buckets):
        want = np.asarray(jbk.pack_bucket(jleaves, jb))
        np.testing.assert_array_equal(tbk.pack_bucket(tleaves, tb).numpy(),
                                      want)
        np.testing.assert_array_equal(
            tbk._pack_bucket_dma(tleaves, tb, torch.float32).numpy(), want)
        for idx, val in tbk.unpack_bucket(tbk.pack_bucket(tleaves, tb), tb):
            assert torch.equal(val, tleaves[idx])


def test_later_slices_raise(one_rank):
    """What this test once held refused (the ZeRO-1 shards and gather,
    the overlap boundaries, the p2p ops) now runs on one rank: the shards
    are the packed buckets, the gather gives the tree back, the hooked
    leaves' backward issues every bucket, sendrecv copies."""
    _, tparams = _bridged("olmo-1b-smoke")
    cp = tbk.get_comm_plan(tparams, num_streams=2)
    shards, layout = tbk.reduce_gradients(
        cp.runtime(), tparams, cp, output="shards",
        reduction="reduce_scatter")
    assert layout.shard_sizes == tuple(b.padded_size
                                       for b in cp.plan.buckets)
    back = tbk.all_gather_shards(cp.runtime(), shards, cp)
    for a, b in zip(tree_flatten(back)[0], tree_flatten(tparams)[0]):
        assert torch.equal(a, b)
    bnd = tbk.overlap_boundaries(cp, tparams)
    torch.autograd.grad(sum(leaf.sum() for leaf in bnd.leaves), bnd.leaves)
    assert sorted(bnd.issued) == list(range(cp.plan.num_buckets))
    for g in tree_flatten(bnd.wait())[0]:
        assert torch.equal(g, torch.ones_like(g))
    x = torch.arange(4.0)
    assert torch.equal(cp.runtime().sendrecv(x, cp.contexts[0],
                                             perm=[(0, 0)]), x)