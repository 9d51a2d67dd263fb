"""The port's bucket-ready overlap schedule (``schedule="overlap"``:
gradient hooks that issue each bucket's reduce inside the backward)
against its post schedule and the JAX reference.

The reference's own overlap check (``check_overlap_matches_post``) fails
on every run of its tests, so the port's post schedule is held to the
reference's ``schedule="post"`` step, and the overlap schedule to the
port's post schedule: loss and grad norm rtol 1e-5, params rtol 2e-5 /
atol 1e-6 (the reference's tolerances). Here on one rank; on 4 gloo ranks
in ``tests/test_torch_overlap_ranks.py``, the CLI in
``tests/test_torch_overlap_cli.py``.
"""

import weakref

import jax
import numpy as np
import pytest
import torch

from _torch_cpu import one_rank  # noqa: F401  (one intra-op thread: see its docstring)
from repro.configs import get_config as jax_get_config
from repro.core import bucketing as jbk
from repro.models.transformer import init_params as jax_init_params
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import bucketing as tbk
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.models.transformer import Model, init_params
from repro_torch.train.losses import total_loss
from repro_torch.train.trainer import make_train_step, train_state_init
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

ARCHS = ["olmo-1b-smoke", "gemma-2b-smoke"]


@pytest.mark.parametrize("arch", ARCHS)
def test_ready_order_equals_reference(arch):
    """``CommPlan.ready_order`` equals the reference's, for both plan
    layouts (post: size-balanced, overlap: contiguous) and both packs."""
    jparams = jax_init_params(jax_get_config(arch), jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    for nb in (1, 3, 4, 8):
        for schedule in ("post", "overlap"):
            for pack in ("xla", "pallas"):
                kw = dict(num_streams=nb, pack=pack, schedule=schedule,
                          persistent=False)
                assert tbk.get_comm_plan(tparams, **kw).ready_order == \
                    jbk.get_comm_plan(jparams, **kw).ready_order


def _loss_grads(cfg, params, batch):
    logits, aux, _ = Model(cfg).forward(params, batch)
    return total_loss(cfg, logits, batch["labels"], aux)[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_hooks_issue_each_bucket_in_the_backward_in_ready_order(one_rank,
                                                                arch):
    """``overlap_boundaries`` on one rank: the hooks issue every bucket
    during ``torch.autograd.grad``, in ``ready_order``, the first ones
    before the last leaf gradient exists; ``wait()`` gives the
    gradients (the mean of one rank), and the taps their packed buckets,
    after which no reference cycle keeps the boundaries alive; a carry is
    folded in as ``carry + ct / accum_steps``."""
    cfg = get_config(arch)
    params = init_params(cfg, 0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             synthetic_batch(cfg, 2, 16, seed=0).items()}
    leaves = [p.detach().requires_grad_() for p in tree_flatten(params)[0]]
    want = torch.autograd.grad(_loss_grads(
        cfg, tree_unflatten(tree_flatten(params)[1], leaves), batch), leaves)
    for pack in ("xla", "pallas"):
        cp = tbk.get_comm_plan(params, num_streams=4, num_vcis=4, pack=pack,
                               schedule="overlap", persistent=False)
        bnd = tbk.overlap_boundaries(cp, params, pack=pack)
        own = torch.autograd.grad(_loss_grads(cfg, bnd.params, batch),
                                  bnd.leaves)
        assert tuple(bnd.issued) == cp.ready_order
        assert min(bnd.hooks_seen.values()) < len(leaves) == \
            max(bnd.hooks_seen.values())
        for g, o, w in zip(tree_flatten(bnd.wait())[0], own, want):
            assert torch.equal(g, w) and torch.equal(o, w)
        # ZeRO-1 taps: this rank's shard of each bucket (the whole bucket)
        taps = [torch.zeros(b.padded_size) for b in cp.plan.buckets]
        bnd = tbk.overlap_boundaries(cp, params, pack=pack, taps=taps)
        torch.autograd.grad(_loss_grads(cfg, bnd.params, batch), bnd.leaves)
        assert bnd.wait() is taps
        for t, b in zip(taps, cp.plan.buckets):
            assert torch.equal(t, tbk.pack_bucket(want, b))
        # wait() removed the hooks: nothing but this name holds the
        # boundaries (and through them the taps) any more
        gone = weakref.ref(bnd)
        del bnd
        assert gone() is None
        # a carry of earlier microbatches: carry + ct / 2
        carry = tree_map(lambda p: torch.full_like(p, 0.5), params)
        bnd = tbk.overlap_boundaries(cp, params, pack=pack, carry=carry,
                                     accum_steps=2)
        torch.autograd.grad(_loss_grads(cfg, bnd.params, batch), bnd.leaves)
        for g, w in zip(tree_flatten(bnd.wait())[0], want):
            assert torch.equal(g, 0.5 + w / 2)


def test_boundaries_reject_what_they_cannot_take(one_rank):
    cfg = get_config("olmo-1b-smoke")
    params = init_params(cfg, 0, device="cpu")
    cp = tbk.get_comm_plan(params, num_streams=4, schedule="overlap")
    with pytest.raises(ValueError, match="tree"):
        tbk.overlap_boundaries(cp, {"x": torch.zeros(3)})
    with pytest.raises(ValueError, match="tap"):
        tbk.overlap_boundaries(cp, params, taps=[torch.zeros(3)])
    bnd = tbk.overlap_boundaries(cp, params)
    with pytest.raises(RuntimeError, match="issued"):
        bnd.wait()                      # no backward ran
    with pytest.raises(ValueError, match="staging"):
        make_train_step(cfg, comm="vci", schedule="overlap",
                        staging="shared")


@pytest.mark.parametrize("optimizer", ["replicated", "zero1"])
@pytest.mark.parametrize("accum", [1, 2])
def test_overlap_step_equals_post_on_one_rank(one_rank, optimizer, accum):
    """3 olmo-1b-smoke steps on one rank, overlap against post: loss,
    grad norm and params equal to the reference's tolerances (one rank's
    reduce is exact, so only the ZeRO-1 plans' other bucket layout moves
    the sums); every bucket issued inside the backward, in ready order."""
    cfg = get_config("olmo-1b-smoke")
    params = init_params(cfg, 0, device="cpu")
    runs = {}
    for schedule in ("post", "overlap"):
        knobs = dict(num_streams=4, pack="pallas", schedule=schedule)
        state = train_state_init(cfg, params=tree_map(torch.clone, params),
                                 optimizer=optimizer, **knobs)
        step = make_train_step(cfg, comm="vci", num_vcis=4,
                               optimizer=optimizer, accum_steps=accum,
                               **knobs)
        metrics = []
        for i in range(3):
            state, m = step(state, synthetic_batch(cfg, 4, 32, seed=i))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs[schedule] = (metrics, tree_flatten(state.params)[0])
        if schedule == "overlap":
            cp = tbk.get_comm_plan(state.params, num_streams=4, num_vcis=4,
                                   pack="pallas", schedule="overlap")
            assert step.last_issue["order"] == cp.ready_order
            assert step.last_issue["in_backward"] == cp.plan.num_buckets
        else:
            assert step.last_issue == {}
    np.testing.assert_allclose(runs["overlap"][0], runs["post"][0],
                               rtol=1e-5)
    for a, b in zip(runs["overlap"][1], runs["post"][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                   atol=1e-6)


def test_moe_zero1_overlap_equals_replicated_post(one_rank):
    """3 mixtral-8x22b-smoke steps on one rank (the row moves' backwards,
    the aux losses in the loss): ZeRO-1 under the overlap schedule against
    replicated AdamW under post, loss and grad norm within rtol 1e-5 and
    params within rtol 2e-5 / atol 1e-6; every bucket issued inside the
    backward, in ready order."""
    cfg = get_config("mixtral-8x22b-smoke")
    params = init_params(cfg, 0, device="cpu")
    runs = {}
    for optimizer, schedule in (("replicated", "post"), ("zero1", "overlap")):
        knobs = dict(num_streams=4, pack="pallas", schedule=schedule)
        state = train_state_init(cfg, params=tree_map(torch.clone, params),
                                 optimizer=optimizer, **knobs)
        step = make_train_step(cfg, comm="vci", num_vcis=4,
                               optimizer=optimizer, **knobs)
        metrics = []
        for i in range(3):
            state, m = step(state, synthetic_batch(cfg, 4, 32, seed=i))
            metrics.append((float(m["loss"]), float(m["grad_norm"]),
                            float(m["load_balance"]), float(m["router_z"])))
        runs[schedule] = (metrics, tree_flatten(state.params)[0])
    cp = tbk.get_comm_plan(state.params, num_streams=4, num_vcis=4,
                           pack="pallas", schedule="overlap")
    assert step.last_issue["order"] == cp.ready_order
    assert step.last_issue["in_backward"] == cp.plan.num_buckets
    np.testing.assert_allclose(runs["overlap"][0], runs["post"][0],
                               rtol=1e-5)
    for a, b in zip(runs["overlap"][1], runs["post"][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                   atol=1e-6)
