"""Multi-rank checks of the port: spawned gloo ranks on the CPU.

The analogue of the reference's 8-virtual-device mesh is N processes in a
``torch.distributed`` gloo group joined through a ``FileStore``. This file
imports no JAX, so the ranks start quickly; it is both a test module and
the script that runs the ranks:

    PYTHONPATH=src python tests/test_torch_ranks.py <check> <dir> <ranks>

``reduce`` holds ``reduce_gradients`` against the tree mean (the analogue
of ``check_bucket_fastpath_matches_pmean``); ``train`` runs one port train
step per progress mode from the params and batch in ``<dir>/in.npz`` and
writes rank 0's results to ``<dir>/out_<progress>.npz``, which
``tests/test_torch_train.py`` holds against the reference; ``seqshard``
holds the flash-decode combine over a sequence-sharded KV cache against
``decode_attention`` (the analogue of
``check_flash_decode_sequence_sharded``) and writes rank 0's error to
``<dir>/out_seqshard.npz`` (``tests/test_torch_ring.py``); ``serve_tp``
serves the cases in ``<dir>/in.npz`` through the manual-TP engine on a
``(ranks // 2) x 2`` mesh (``tests/test_torch_serve_tp.py``) and writes
each rank's tokens and plan statistics to ``<dir>/out_<rank>.npz``;
``all_to_all`` holds ``CommRuntime.all_to_all`` on a mesh axis and on the
data group against numpy; ``collectives`` holds the runtime's collectives
and its window/p2p ops against numpy and writes their op counts;
``zero1`` and ``overlap`` train 5 steps from ``in.npz`` as ZeRO-1 and
replicated, and post and overlap for both optimizers, and write rank 0's
results (``tests/test_torch_zero1.py``, ``tests/test_torch_overlap.py``);
``gspmd`` trains each ``gspmd_<case>.npz`` with ``comm="gspmd"`` (FSDP
over the ranks) and writes every rank's metrics, bytes and collectives
and rank 0's gathered params (``tests/test_torch_gspmd.py``);
``gather_grad`` holds ``Sharder.materialize``'s backward against
autograd of the whole leaves; ``ckpt_save`` and ``ckpt_load`` save the
replicated, ZeRO-1 and FSDP states of ``ckpt.npz`` and restore them on
another count of ranks (``tests/test_torch_checkpoint.py``);
``model_axis`` trains each ``axis_<case>.npz`` on a ``(ranks // 2) x 2``
``data x model`` mesh in both comm modes, checkpoints, restores and
serves through the GSPMD route, the tensor-parallel Mamba2 block on
``2 x 2`` and ``1 x 4`` among it (``tests/test_torch_model_axis.py``).
"""

import faulthandler
import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6   # tests/_multidev_checks.py reduce tolerances


def _rank_tree(n: int, rank: int):
    """Rank ``rank``'s leaves of a tree whose global arrays carry a leading
    rank axis (f32 leaves and one bf16 leaf), plus the expected mean."""
    rng = np.random.default_rng(7)
    full = {"a": rng.normal(size=(n, 16, 8)).astype(np.float32),
            "b": {"w": rng.normal(size=(n, 130)).astype(np.float32),
                  "s": rng.normal(size=(n, 3)).astype(np.float32)},
            "c": rng.normal(size=(n, 257)).astype(np.float32)}

    def pick(t, f):
        if isinstance(t, dict):
            return {k: pick(v, f) for k, v in t.items()}
        return f(t)
    mine = pick(full, lambda a: torch.from_numpy(a[rank].copy()))
    mine["c"] = mine["c"].to(torch.bfloat16)
    # the mean of the values each rank holds (bf16 ranks hold bf16 values)
    held = pick(full, lambda a: torch.from_numpy(a.copy()))
    held["c"] = held["c"].to(torch.bfloat16).float()
    expect = pick(held, lambda t: t.mean(0))
    expect["c"] = expect["c"].to(torch.bfloat16)
    return mine, expect


def check_reduce(rank: int, n: int, out_dir: str) -> None:
    """Every cell of pack x reduction x staging x plan persistence equals
    the tree mean; the persistent cells reuse their cached plans."""
    from repro_torch.core import (get_comm_plan, plan_cache_clear,
                                  plan_cache_stats, reduce_gradients)
    from repro_torch.tree import tree_flatten
    tree, expect = _rank_tree(n, rank)
    plan_cache_clear()
    for pack in ("xla", "pallas"):
        for reduction in ("all_reduce", "reduce_scatter"):
            for staging in ("per_vci", "shared"):
                for persistent in (True, False):
                    cp = get_comm_plan(tree, num_streams=3, num_vcis=4,
                                       pack=pack, persistent=persistent)
                    got = reduce_gradients(cp.runtime(), tree, cp, mean=True,
                                           staging=staging, pack=pack,
                                           reduction=reduction)
                    cell = f"{pack}/{reduction}/{staging}/{persistent}"
                    for g, e in zip(tree_flatten(got)[0],
                                    tree_flatten(expect)[0]):
                        assert g.dtype == e.dtype, cell
                        np.testing.assert_allclose(
                            g.float().numpy(), e.float().numpy(), rtol=RTOL,
                            atol=ATOL, err_msg=cell)
    assert plan_cache_stats()["hits"] >= 2, plan_cache_stats()


def check_train(rank: int, n: int, out_dir: str) -> None:
    """One port VCI train step per progress mode from the params/batch in
    ``in.npz``; rank 0 writes the new params (leaf order) and metrics."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.train.trainer import make_train_step, train_state_init
    from repro_torch.tree import tree_flatten, tree_unflatten
    data = np.load(os.path.join(out_dir, "in.npz"))
    cfg = get_config(str(data["arch"]))
    batch = {"tokens": data["tokens"], "labels": data["labels"]}
    treedef = tree_flatten(init_params(cfg, 0, device="cpu"))[1]
    for progress in ("hybrid", "per_vci", "global"):
        params = tree_unflatten(treedef, [
            torch.from_numpy(data[f"p{i}"].copy())
            for i in range(int(data["n_leaves"]))])
        step = make_train_step(cfg, comm="vci", num_streams=4, num_vcis=4,
                               progress=progress)
        state, metrics = step(train_state_init(cfg, params=params), batch)
        if rank == 0:
            leaves = tree_flatten(state.params)[0]
            np.savez(os.path.join(out_dir, f"out_{progress}.npz"),
                     loss=metrics["loss"].numpy(),
                     grad_norm=metrics["grad_norm"].numpy(),
                     **{f"p{i}": l.numpy() for i, l in enumerate(leaves)})


def check_seqshard(rank: int, n: int, out_dir: str) -> None:
    """Each rank holds a ``1/n`` sequence shard of one KV cache (a ring
    that has wrapped, and a full cache with its last slots unwritten),
    attends to it with ``partial_attention``, gathers every shard's
    ``(out, m, l)`` with ``CommRuntime.all_gather`` on a VCI context and
    combines them: within 2e-5 of ``decode_attention`` over the whole
    cache."""
    from repro_torch.configs import get_config
    from repro_torch.core.collectives import CommRuntime
    from repro_torch.core.comm import CommWorld
    from repro_torch.models.attention import (KVCache, combine_partials,
                                              decode_attention,
                                              partial_attention)
    cfg = get_config("yi-9b-smoke")
    b, s, kv, hd, h = 2, 64, cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.normal(size=(b, 1, h, hd)).astype(np.float32))
    kc, vc = (torch.from_numpy(rng.normal(size=(b, s, kv, hd)).astype(
        np.float32)) for _ in range(2))
    world = CommWorld(num_vcis=4)
    rt = CommRuntime(world)
    ctx = world.create("seqshard")
    w = s // n
    errs = []
    for length, ring in ((50, False), (150, True)):
        want = decode_attention(cfg, q, KVCache(kc, vc, length, ring))
        idx = rank * w + torch.arange(w)
        valid = idx < (min(length, s) if ring else length)
        parts = partial_attention(q, kc[:, rank * w:(rank + 1) * w],
                                  vc[:, rank * w:(rank + 1) * w], valid)
        reqs = [rt.all_gather(t.contiguous(), ctx) for t in parts]
        outs, ms, ls = (rt.wait(r).reshape((n,) + t.shape)
                        for r, t in zip(reqs, parts))
        got = combine_partials(outs, ms, ls)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                                   atol=2e-5, err_msg=f"ring={ring}")
        errs.append(float((got - want).abs().max()))
    if rank == 0:
        np.savez(os.path.join(out_dir, "out_seqshard.npz"),
                 err=np.asarray(errs), vci=ctx.vci.index)


def _serve_requests(cfg):
    """The reference's ``check_serve_streams_match_single_stream``
    requests: mixed prompt lengths, 5 new tokens each."""
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(7)
    return [Request(prompt=rng.integers(0, cfg.vocab_size, (plen,),
                                        dtype=np.int32), max_new_tokens=5)
            for plen in (5, 9, 3, 7)]


class _Calls:
    """Counts the calls of an engine's prefill."""

    def __init__(self, fn):
        self.fn, self.n = fn, 0

    def __call__(self, *a, **kw):
        self.n += 1
        return self.fn(*a, **kw)


def check_serve_tp(rank: int, n: int, out_dir: str) -> None:
    """Each case of ``in.npz`` (an arch, its full params in leaf order)
    through ``ServeEngine`` on a ``(n // 2, 2)`` RankMesh at num_vcis 1
    and 8: contiguous at batch 4, and paged at batch 2 (page_size 8, 11
    pages: admission under the mesh). Every rank writes its tokens, the
    realised VCI map, fallback hits, the page owners after the run, its
    resident cache bytes, the collectives by purpose and the forward
    calls; the test holds them against the JAX single-device engine."""
    from repro_torch.configs import get_config
    from repro_torch.core.collectives import RankMesh
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.comm import ServeCommPlan, shard_params
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.tree import tree_flatten, tree_unflatten
    import dataclasses
    data = np.load(os.path.join(out_dir, "in.npz"))
    mesh = RankMesh(n // 2, 2)
    out = {}
    for case in [str(c) for c in data["cases"]]:
        arch, experts = case.split(":")
        cfg = get_config(arch)
        if int(experts):
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, num_experts=int(experts)))
        treedef = tree_flatten(init_params(cfg, 0, device="cpu"))[1]
        full = tree_unflatten(treedef, [
            torch.from_numpy(data[f"{case}/p{i}"].copy())
            for i in range(int(data[f"{case}/n_leaves"]))])
        local = shard_params(cfg, full, 2, mesh.coords(rank)[1])
        for num_vcis in (1, 8):
            for layout, kw in (("contiguous", dict(batch_size=4)),
                               ("paged", dict(batch_size=2, paged=True,
                                              page_size=8, num_pages=11))):
                plan = ServeCommPlan(num_vcis=num_vcis, token_impl="data")
                eng = ServeEngine(cfg, local, max_len=48, device="cpu",
                                  mesh=mesh, comm_plan=plan, **kw)
                eng._prefill = _Calls(eng._prefill)
                reqs = _serve_requests(cfg)
                eng.generate(reqs)
                key = f"{case}/{layout}/{num_vcis}"
                for i, r in enumerate(reqs):
                    out[f"{key}/tokens{i}"] = r.generated
                out[f"{key}/vcis"] = np.asarray(sorted(
                    plan.vci_map().values()))
                out[f"{key}/fallback_hits"] = plan.stats.fallback_hits
                out[f"{key}/bytes"] = eng.cache_bytes_resident
                out[f"{key}/calls"] = eng._prefill.n + eng.decode_steps
                out[f"{key}/admit"] = int(eng._can_admit)
                for purpose, c in plan.tally.counts.items():
                    out[f"{key}/count/{purpose}"] = c
                if layout == "paged":
                    out[f"{key}/owner"] = np.asarray(eng._pages.owner)
    np.savez(os.path.join(out_dir, f"out_{rank}.npz"), **out)


def check_all_to_all(rank: int, n: int, out_dir: str) -> None:
    """``CommRuntime.all_to_all`` (tiled, split/concat on several axis
    pairs) on the data group and along both axes of a ``(2, n // 2)``
    mesh, against the same exchange done in numpy."""
    from repro_torch.core.collectives import CommRuntime, RankMesh
    from repro_torch.core.comm import CommWorld
    mesh = RankMesh(2, n // 2)
    world = CommWorld(num_vcis=4)
    rt = CommRuntime(world, mesh=mesh)
    ctx = world.create("a2a")
    rng = np.random.default_rng(3)
    full = rng.normal(size=(n, 4, 6, 8)).astype(np.float32)  # rank-major
    for axis in (None, "data", "model"):
        if axis is None:
            line = list(range(n))
        else:
            line = next(l for l in mesh.lines(axis) if rank in l)
        k = len(line)
        for split, concat in ((0, 0), (0, 1), (1, 2), (2, 0)):
            if full.shape[1 + split] % k:
                continue
            want = np.concatenate(
                [np.split(full[r], k, axis=split)[line.index(rank)]
                 for r in line], axis=concat)
            got = rt.wait(rt.all_to_all(torch.from_numpy(full[rank].copy()),
                                        ctx, split_axis=split,
                                        concat_axis=concat, axis=axis))
            np.testing.assert_array_equal(
                got.numpy(), want, err_msg=f"axis={axis} {split}->{concat}")
    if rank == 0:
        np.savez(os.path.join(out_dir, "out_all_to_all.npz"), ok=1)


def _collective_ops(rt, world, x, n):
    """The reference's ``check_collectives_numerics`` sequence on one
    runtime: all_reduce, all_gather, reduce_scatter of the gather,
    all_to_all, sendrecv one rank up and an accumulate, then a barrier.
    Returns the waited values."""
    c1, c2 = world.create("c1"), world.create("c2")
    w = world.create("w", kind="rma")
    ar = rt.all_reduce(x.clone(), c1)
    ag = rt.wait(rt.all_gather(x, c2))
    rs = rt.reduce_scatter(ag, c1)
    a2a = rt.all_to_all(x.expand((n,) + tuple(x.shape)).contiguous(), c2,
                        split_axis=0, concat_axis=1)
    sr = rt.sendrecv(x, c1, perm=[(i, (i + 1) % n) for i in range(n)])
    acc = rt.accumulate(x, w)
    rt.barrier()
    return [rt.wait(ar), ag, rt.wait(rs), rt.wait(a2a), sr, rt.wait(acc)]


def _window_ops(rt, world, x, n, ordered):
    """get from one rank down, put to one rank up on a window (``ordered``
    or not: un-chained issues), then ``flush`` of the window alone; a
    second window's accumulate pair under each ordering hint; a barrier.
    Returns the values and whether the get/put had completed by the
    flush."""
    import dataclasses
    w = world.create("win", kind="rma")
    if not ordered:
        w = dataclasses.replace(w, ordered=False)
    g = rt.get(x, w, perm=[(i, (i - 1) % n) for i in range(n)])
    p = rt.put(x * 2, w, perm=[(i, (i + 1) % n) for i in range(n)])
    rt.flush(w)
    flushed = g.op.work is None and p.op.work is None
    out = [g.value, p.value]
    for ordering in ("rar", "none"):
        a = world.create(f"acc_{ordering}", kind="rma",
                         accumulate_ordering=ordering)
        ra, rb = rt.accumulate(x, a), rt.accumulate(x * 2, a)
        out.append(rt.wait(ra) + rt.wait(rb))
    rt.barrier()
    return out, flushed


def check_collectives(rank: int, n: int, out_dir: str) -> None:
    """The reference's ``check_collectives_numerics`` and
    ``check_accumulate_relaxed_matches_ordered`` on the port's
    ``CommRuntime``, for each progress mode: every value against numpy,
    and each runtime's (issued, joins) written to
    ``<dir>/out_collectives.npz`` by rank 0, for the test to hold against
    the reference engine's counts of the same sequences. get/put go
    through an ordered and an un-ordered window; ``flush`` must complete
    both."""
    from repro_torch.core.collectives import CommRuntime
    from repro_torch.core.comm import CommWorld
    full = np.arange(n * 4, dtype=np.float32).reshape(n, 4)
    x = torch.from_numpy(full[rank:rank + 1].copy())
    total = full.sum(0, keepdims=True)
    out = {}
    for progress in ("global", "per_vci", "hybrid"):
        world = CommWorld(num_vcis=4)
        rt = CommRuntime(world, progress=progress, join_every=2)
        ar, ag, rs, a2a, sr, acc = _collective_ops(rt, world, x, n)
        np.testing.assert_allclose(ar.numpy(), total)
        np.testing.assert_allclose(ag.numpy().reshape(n, 4), full)
        np.testing.assert_allclose(rs.numpy(), full[rank] * n)
        np.testing.assert_allclose(a2a.numpy(), full[None])
        np.testing.assert_allclose(sr.numpy(), full[(rank - 1) % n][None])
        np.testing.assert_allclose(acc.numpy(), total)
        out[f"{progress}/numerics"] = (rt.engine.issued, rt.engine.joins)
        for ordered in (True, False):
            world = CommWorld(num_vcis=4)
            rt = CommRuntime(world, progress=progress, join_every=2)
            (g, p, rar, none), flushed = _window_ops(rt, world, x, n,
                                                     ordered)
            assert flushed, (progress, ordered)
            np.testing.assert_allclose(g.numpy(), full[(rank + 1) % n][None])
            np.testing.assert_allclose(p.numpy(),
                                       2 * full[(rank - 1) % n][None])
            np.testing.assert_allclose(rar.numpy(), 3 * total)
            np.testing.assert_array_equal(rar.numpy(), none.numpy())
            out[f"{progress}/window/{ordered}"] = (rt.engine.issued,
                                                   rt.engine.joins)
    # a rank that no pair sends to receives zeros; (r, r) is a copy
    rt = CommRuntime(CommWorld(num_vcis=2))
    ctx = rt.world.create("partial")
    got = rt.sendrecv(x, ctx, perm=[(0, 0), (1, 2)])
    want = {0: full[0:1], 2: full[1:2]}.get(rank, np.zeros((1, 4)))
    np.testing.assert_array_equal(got.numpy(), want)
    if rank == 0:
        np.savez(os.path.join(out_dir, "out_collectives.npz"),
                 **{k: np.asarray(v) for k, v in out.items()})


def _train_runs(out_dir: str, runs, name: str) -> None:
    """5 port VCI train steps (4 streams on 4 VCIs, pack "pallas") from
    the params and batches in ``in.npz`` for each ``(optimizer, schedule,
    accum)`` of ``runs``; rank 0 writes each run's per-step loss and grad
    norm, its params, its optimizer bytes and the overlap hooks' issue
    order beside ``CommPlan.ready_order`` to ``<dir>/out_<name>.npz``."""
    from repro_torch.configs import get_config
    from repro_torch.core import get_comm_plan
    from repro_torch.models.transformer import init_params
    from repro_torch.train.trainer import (make_train_step, optimizer_bytes,
                                           train_state_init)
    from repro_torch.tree import tree_flatten, tree_unflatten
    data = np.load(os.path.join(out_dir, "in.npz"))
    cfg = get_config(str(data["arch"]))
    treedef = tree_flatten(init_params(cfg, 0, device="cpu"))[1]
    out = {}
    for optimizer, schedule, accum in runs:
        key = f"{optimizer}/{schedule}/{accum}"
        params = tree_unflatten(treedef, [
            torch.from_numpy(data[f"p{i}"].copy())
            for i in range(int(data["n_leaves"]))])
        knobs = dict(num_streams=4, pack="pallas", schedule=schedule)
        state = train_state_init(cfg, params=params, optimizer=optimizer,
                                 **knobs)
        step = make_train_step(cfg, comm="vci", num_vcis=4,
                               optimizer=optimizer, accum_steps=accum,
                               **knobs)
        metrics = []
        for i in range(int(data["steps"])):
            batch = {"tokens": data[f"tokens{i}"],
                     "labels": data[f"labels{i}"]}
            state, m = step(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out[f"{key}/metrics"] = np.asarray(metrics)
        out[f"{key}/opt_bytes"] = optimizer_bytes(state.opt)
        for i, leaf in enumerate(tree_flatten(state.params)[0]):
            out[f"{key}/p{i}"] = leaf.numpy()
        if schedule == "overlap":
            cp = get_comm_plan(state.params, num_streams=4, num_vcis=4,
                               pack="pallas", schedule="overlap")
            out[f"{key}/order"] = np.asarray(step.last_issue["order"])
            out[f"{key}/ready_order"] = np.asarray(cp.ready_order)
            out[f"{key}/in_backward"] = step.last_issue["in_backward"]
    if dist.get_rank() == 0:
        np.savez(os.path.join(out_dir, f"out_{name}.npz"), **out)


def check_zero1(rank: int, n: int, out_dir: str) -> None:
    """ZeRO-1 against the replicated optimizer, post schedule (the
    analogue of ``check_zero1_matches_replicated``)."""
    _train_runs(out_dir, [("replicated", "post", 1), ("zero1", "post", 1)],
                "zero1")


def check_overlap(rank: int, n: int, out_dir: str) -> None:
    """Overlap against post for both optimizers, 2 microbatches (the
    analogue of ``check_overlap_matches_post``)."""
    _train_runs(out_dir, [(o, s, 2) for o in ("replicated", "zero1")
                          for s in ("post", "overlap")], "overlap")


def _case_params(cfg, data):
    """The full params of a case file (leaves ``p<i>`` in leaf order)."""
    from repro_torch.models.transformer import init_params
    from repro_torch.tree import tree_flatten, tree_unflatten
    treedef = tree_flatten(init_params(cfg, 0, device="meta"))[1]
    return tree_unflatten(treedef, [
        torch.from_numpy(data[f"p{i}"].copy())
        for i in range(int(data["n_leaves"]))])


def _case_cfg(data):
    from repro_torch.configs import get_config
    cfg = get_config(str(data["arch"]))
    return cfg.with_opts(str(data["opts"])) if "opts" in data else cfg


def _case_batch(data, i):
    return {k: data[f"{k}{i}"] for k in ("tokens", "labels", "image_embeds")
            if f"{k}{i}" in data}


def check_gspmd(rank: int, n: int, out_dir: str) -> None:
    """Each ``gspmd_<case>.npz`` of the directory (an arch, its full
    params, ``steps`` global batches, ``accum``): that many
    ``comm="gspmd"`` steps from the params, FSDP over the ``n`` ranks.
    Every rank writes its metrics a step, its collectives' tally, the
    bytes of its params and moments and their shapes to
    ``gspmd_out_<case>_r<rank>.npz``; rank 0 adds the gathered params."""
    from repro_torch.train.trainer import make_train_step, train_state_init
    from repro_torch.tree import tree_flatten
    cases = sorted(f[6:-4] for f in os.listdir(out_dir)
                   if f.startswith("gspmd_") and f.endswith(".npz")
                   and "_out_" not in f)
    keys = ("loss", "ce", "grad_norm", "tokens", "load_balance", "router_z",
            "lr")
    for case in cases:
        data = np.load(os.path.join(out_dir, f"gspmd_{case}.npz"))
        cfg = _case_cfg(data)
        state = train_state_init(cfg, params=_case_params(cfg, data),
                                 comm="gspmd")
        step = make_train_step(cfg, accum_steps=int(data["accum"]))
        metrics, tallies = [], []
        for i in range(int(data["steps"])):
            state, m = step(state, _case_batch(data, i))
            metrics.append([float(m[k]) for k in keys])
            tallies.append([step.comm_tally[k] for k in (
                "all_gather", "reduce_scatter", "all_reduce")])
        shard = step.sharder()
        out = {"metrics": np.asarray(metrics), "tally": np.asarray(tallies),
               "gather_bytes": step.comm_tally["gather_bytes"],
               "all_to_all": step.comm_tally["all_to_all"],
               "param_bytes": sum(t.nbytes for t in
                                  tree_flatten(state.params)[0]),
               "moment_bytes": sum(t.nbytes for t in
                                   tree_flatten((state.opt.m,
                                                 state.opt.v))[0])}
        for i, leaf in enumerate(tree_flatten(state.opt.m)[0]):
            out[f"m_shape{i}"] = np.asarray(leaf.shape)
        full = tree_flatten(shard.gather_params(state.params))[0]
        if rank == 0:
            out.update({f"p{i}": l.numpy() for i, l in enumerate(full)})
        np.savez(os.path.join(out_dir, f"gspmd_out_{case}_r{rank}.npz"),
                 **out)


def check_gather_grad(rank: int, n: int, out_dir: str) -> None:
    """``Sharder.materialize``'s backward against autograd of the
    whole-leaf forward: every rank's loss reads the gathered leaves of a
    layer with its own rows; the gradient of each rank's slice must be
    its slice of the whole leaf's gradient of the summed losses (computed
    here, in one process, from every rank's rows). Writes each rank's
    largest difference, relative to the leaf's largest gradient, to
    ``gather_grad_r<rank>.npy``."""
    from repro_torch.configs import get_config
    from repro_torch.core.collectives import RankMesh
    from repro_torch.dist.sharding import Sharder
    from repro_torch.models.transformer import init_params, layer_params
    from repro_torch.tree import (tree_flatten, tree_flatten_with_paths,
                                  tree_unflatten)
    cfg = get_config("olmo-1b-smoke")
    shard = Sharder(RankMesh(n, 1), cfg)
    layer = layer_params(init_params(cfg, 3, device="cpu"), 1)
    paths = [("layers",) + p for p, _ in tree_flatten_with_paths(layer)]
    leaves, treedef = tree_flatten(layer)
    rng = np.random.default_rng(11)
    xs = torch.from_numpy(rng.normal(size=(n, 3, cfg.d_model)).astype(
        np.float32))

    def loss(p, x):
        a, f = p["attn"], p["ffn"]
        h = torch.tanh(x @ a["wq"]) @ a["wo"] + (x @ a["wk"]) @ a["wv"].T
        return ((h @ f["w_gate"]) * (h @ f["w_up"]) @ f["w_down"]).square(
        ).sum()

    whole = [t.clone().requires_grad_() for t in leaves]
    total = sum(loss(tree_unflatten(treedef, whole), xs[r])
                for r in range(n))
    want = torch.autograd.grad(total, whole)
    mine = [shard.shard_leaf(p, t).detach().requires_grad_()
            for p, t in zip(paths, leaves)]
    got = torch.autograd.grad(loss(shard.materialize(
        tree_unflatten(treedef, mine), ("layers",)), xs[rank]), mine)
    err = 0.0
    for p, g, w in zip(paths, got, want):
        w = shard.shard_leaf(p, w)
        assert g.shape == w.shape, (p, g.shape, w.shape)
        err = max(err, float((g - w).abs().max() / w.abs().max()))
    sliced = sum(shard.sharded_dim(p) is not None for p in paths)
    assert sliced and shard.tally["all_gather"] == sliced, shard.tally
    assert shard.tally["reduce_scatter"] == sliced, shard.tally
    np.save(os.path.join(out_dir, f"gather_grad_r{rank}.npy"), err)


_CKPT_LAYOUTS = {"vci": dict(comm="vci"),
                 "zero1": dict(comm="vci", optimizer="zero1"),
                 "gspmd": dict(comm="gspmd")}


def _ckpt_state(cfg, data, layout):
    """A fresh state of ``layout`` from the case's params, and its step."""
    from repro_torch.train.trainer import make_train_step, train_state_init
    kw = _CKPT_LAYOUTS[layout]
    knobs = dict(num_streams=4, pack="pallas") if kw["comm"] == "vci" \
        else {}
    state = train_state_init(cfg, params=_case_params(cfg, data),
                             optimizer=kw.get("optimizer", "replicated"),
                             comm=kw["comm"], **knobs)
    step = make_train_step(cfg, comm=kw["comm"], num_vcis=4,
                           optimizer=kw.get("optimizer", "replicated"),
                           **knobs)
    return state, step


def check_ckpt_save(rank: int, n: int, out_dir: str) -> None:
    """Each layout (replicated VCI, ZeRO-1, FSDP) trains one step from
    ``ckpt.npz`` and saves it to ``save_<layout>`` (step 1), then a second
    step, saved to ``full_<layout>`` (step 2)."""
    from repro_torch.checkpoint import save_state
    data = np.load(os.path.join(out_dir, "ckpt.npz"))
    cfg = _case_cfg(data)
    for layout in _CKPT_LAYOUTS:
        state, step = _ckpt_state(cfg, data, layout)
        state, _ = step(state, _case_batch(data, 0))
        shard = step.sharder() if layout == "gspmd" else None
        save_state(os.path.join(out_dir, f"save_{layout}"), 1, state,
                   shard=shard)
        state, _ = step(state, _case_batch(data, 1))
        save_state(os.path.join(out_dir, f"full_{layout}"), 2, state,
                   shard=shard)


def check_ckpt_load(rank: int, n: int, out_dir: str) -> None:
    """Each layout's step-1 checkpoint loaded on these ranks into a fresh
    state of the layout, saved again to ``resave_<layout>_<n>`` (step 1),
    then one more step, saved to ``resume_<layout>_<n>`` (step 2)."""
    from repro_torch.checkpoint import latest_step, load_state, save_state
    from repro_torch.train.trainer import data_sharder
    data = np.load(os.path.join(out_dir, "ckpt.npz"))
    cfg = _case_cfg(data)
    for layout in _CKPT_LAYOUTS:
        like, step = _ckpt_state(cfg, data, layout)
        shard = data_sharder(cfg) if layout == "gspmd" else None
        src = os.path.join(out_dir, f"save_{layout}")
        state = load_state(src, latest_step(src), like, shard=shard)
        assert int(state.step) == 1
        save_state(os.path.join(out_dir, f"resave_{layout}_{n}"), 1, state,
                   shard=shard)
        state, _ = step(state, _case_batch(data, 1))
        save_state(os.path.join(out_dir, f"resume_{layout}_{n}"), 2, state,
                   shard=shard)


_AXIS_MODES = {"gspmd": dict(comm="gspmd"),
               "vci": dict(comm="vci", num_streams=4, pack="pallas"),
               "zero1": dict(comm="vci", optimizer="zero1", num_streams=4,
                             pack="pallas")}


def _axis_train(cfg, data, mesh, mode):
    """``steps`` steps of one mode on ``mesh`` from the case's params:
    (state, step, metrics a step, the gspmd step's tallies a step)."""
    from repro_torch.train.trainer import make_train_step, train_state_init
    kw = _AXIS_MODES[mode]
    state = train_state_init(cfg, params=_case_params(cfg, data), mesh=mesh,
                             **kw)
    step = make_train_step(cfg, mesh=mesh, num_vcis=4, **kw)
    keys = ("loss", "ce", "grad_norm", "tokens", "load_balance", "router_z",
            "lr")
    metrics, tallies = [], []
    for i in range(int(data["steps"])):
        state, m = step(state, _case_batch(data, i))
        metrics.append([float(m[k]) for k in keys])
        tallies.append(dict(getattr(step, "comm_tally", {})))
    return state, step, metrics, tallies


# the GSPMD route's serve cases: arch -> layouts (the grouped families
# serve contiguous only), and the arch served under kv_fp8
AXIS_SERVE = {"olmo-1b-smoke": ("contiguous", "paged"),
              "mixtral-8x22b-smoke": ("contiguous", "paged"),
              "gemma-2b-smoke": ("contiguous", "paged"),
              "yi-9b-smoke": ("contiguous", "paged"),
              "mamba2-780m-smoke": ("contiguous",),
              "zamba2-7b-smoke": ("contiguous",),
              "musicgen-large-smoke": ("contiguous",)}
AXIS_FP8 = "yi-9b-smoke"
# the GSPMD route's sequence-split decode cache: case -> (arch, mesh (data,
# model), engine batch, sliding window). gemma's one KV head and yi's two
# do not divide model 4: the sequence goes over model; one request (a batch
# of 1 on 2 x 2) splits it over all four ranks (olmo's attention stays
# tensor-parallel: the cache keeps every KV head, gathered over model);
# gemma with a window of 16 splits its ring over model
AXIS_SPLIT = {"gemma 1x4": ("gemma-2b-smoke", (1, 4), 4, None),
              "yi 1x4": ("yi-9b-smoke", (1, 4), 4, None),
              "olmo batch1": ("olmo-1b-smoke", (2, 2), 1, None),
              "gemma ring": ("gemma-2b-smoke", (2, 2), 4, 16)}
# cases whose f32 logits are held against the whole cache's decode
AXIS_SPLIT_LOGITS = ("gemma 1x4", "olmo batch1")


def axis_serve_requests(cfg):
    """The engine's requests of a case: ``_serve_requests``' mixed lengths
    for the left-padded families; the grouped ones (SSM, hybrid, audio)
    two equal-length groups of prompts of 3+ tokens (the reference's
    ``_causal_conv`` is not causal below 3)."""
    from repro_torch.serve.engine import Request
    if cfg.family in ("dense", "moe") and cfg.modality == "text":
        return _serve_requests(cfg)
    rng = np.random.default_rng(7)
    shape = (cfg.num_codebooks,) if cfg.modality == "audio" else ()
    return [Request(prompt=rng.integers(0, cfg.vocab_size, shape + (plen,),
                                        dtype=np.int32), max_new_tokens=4)
            for plen in (5, 5, 7)]


def axis_split_cfg(case):
    """A split case's config (its window, where it has one)."""
    from repro_torch.configs import get_config
    arch, _, _, window = AXIS_SPLIT[case]
    cfg = get_config(arch)
    return cfg if window is None else cfg.with_sliding_window(window)


def axis_split_requests(case, cfg):
    """A split case's requests: the engine's mixed lengths; the ring's
    prompts longer than its window, decoding past it again."""
    from repro_torch.serve.engine import Request
    if AXIS_SPLIT[case][3] is None:
        return _serve_requests(cfg)
    rng = np.random.default_rng(9)
    return [Request(prompt=rng.integers(0, cfg.vocab_size, (plen,),
                                        dtype=np.int32), max_new_tokens=10)
            for plen in (20, 20, 12, 12)]


def axis_logits(cfg, params, b, mesh=None, steps=4):
    """f32 logits of a case's model straight through ``Model``: a prefill
    of ``b`` rows of 10-token prompts and ``steps`` greedy decode steps,
    into the GSPMD route's cache on ``mesh`` (this rank's rows, where they
    split over data), or the whole cache on one rank. ``(logits, the
    rank's first row, the collectives of the last decode step)``."""
    from repro_torch.dist.sharding import Sharder
    from repro_torch.models.transformer import Model, init_cache
    from repro_torch.serve.engine import _data_rows, gspmd_cache
    rng = np.random.default_rng(10)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 10),
                                           dtype=np.int32))
    shard, rows = None, None
    if mesh is None:
        model = Model(cfg)
        cache = init_cache(cfg, b, 48, dtype=torch.float32, device="cpu")
    else:
        shard = Sharder(mesh, cfg)
        model = Model(cfg, shard)
        cache = gspmd_cache(cfg, shard, b, 48, dtype=torch.float32,
                            device="cpu")
        rows = _data_rows(cache, b, mesh)
        tokens = tokens if rows is None else tokens[rows]
    out, step = [], {}
    with torch.inference_mode():
        logits, _, cache = model.forward(params, {"tokens": tokens},
                                         cache=cache)
        out.append(logits[:, -1:])
        for _ in range(steps):
            nxt = out[-1].argmax(-1).to(torch.int32)
            before = {} if shard is None else dict(shard.tally)
            logits, cache = model.decode_step(params, nxt, cache)
            if shard is not None:
                step = {k: v - before[k] for k, v in shard.tally.items()
                        if v != before.get(k, 0)}
            out.append(logits)
    first = 0 if rows is None else rows.start
    return torch.cat(out, 1).numpy(), first, step


def axis_split_rows(case):
    """The rows of a split case's logits: its engine batch, at most 2
    (one row: data 1, or a batch of one)."""
    return min(2, AXIS_SPLIT[case][2])


def _axis_split(rank, out_dir):
    """The split cases on the world's ranks: each engine's tokens,
    collectives, cache bytes and its caches' local shapes, and the f32
    logits of :data:`AXIS_SPLIT_LOGITS`."""
    import json
    from repro_torch.core.collectives import RankMesh
    from repro_torch.dist.sharding import Sharder
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import ServeEngine
    out = {}
    for case, (arch, dims, batch, _) in AXIS_SPLIT.items():
        cfg = axis_split_cfg(case)
        mesh = RankMesh(*dims)
        params = Sharder(mesh, cfg, rank=rank).shard_params(
            init_params(cfg, 0, device="cpu"))
        eng = ServeEngine(cfg, params, max_len=48, device="cpu", mesh=mesh,
                          batch_size=batch)
        shapes = []

        def new_cache(b, n, make=eng._new_cache):
            cache = make(b, n)
            shapes.append(list(cache.kv.k.shape))
            return cache

        eng._new_cache = new_cache
        reqs = axis_split_requests(case, cfg)
        eng.generate(reqs)
        out[case] = dict(
            tokens=[r.generated.tolist() for r in reqs],
            tally={k: v for k, v in eng._sharder.tally.items() if v},
            bytes=eng.cache_bytes_resident, shapes=shapes,
            steps=eng.decode_steps)
        if case in AXIS_SPLIT_LOGITS:
            np.save(os.path.join(out_dir, f"axis_split_{case.replace(' ', '_')}"
                                          f"_r{rank}.npy"),
                    axis_logits(cfg, params, axis_split_rows(case), mesh)[0])
    with open(os.path.join(out_dir, f"axis_split_r{rank}.json"), "w") as f:
        json.dump(out, f)


# the GSPMD route's tensor-parallel Mamba2 block: case -> (arch, mesh (data,
# model)); the smoke archs' 16 heads and 544 conv channels split over model
# 2 and 4 (zamba2's two KV heads do not divide 4: on 1 x 4 its shared
# attention computes replicated and its cache splits the sequence)
AXIS_SSM = {"mamba2 2x2": ("mamba2-780m-smoke", (2, 2)),
            "mamba2 1x4": ("mamba2-780m-smoke", (1, 4)),
            "zamba2 2x2": ("zamba2-7b-smoke", (2, 2)),
            "zamba2 1x4": ("zamba2-7b-smoke", (1, 4))}


def _axis_ssm(rank, out_dir):
    """The SSM cases on the world's ranks: each engine's tokens, cache
    bytes and its caches' local state shapes, then the f32 logits of 2
    rows and a decode step's collectives (:func:`axis_logits`)."""
    import json
    from repro_torch.core.collectives import RankMesh
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import Sharder
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import ServeEngine
    out = {}
    for case, (arch, dims) in AXIS_SSM.items():
        cfg = get_config(arch)
        mesh = RankMesh(*dims)
        params = Sharder(mesh, cfg, rank=rank).shard_params(
            init_params(cfg, 0, device="cpu"))
        eng = ServeEngine(cfg, params, max_len=48, device="cpu", mesh=mesh,
                          batch_size=4)
        shapes = []

        def new_cache(b, n, make=eng._new_cache):
            cache = make(b, n)
            shapes.append([list(cache.ssm.conv.shape),
                           list(cache.ssm.ssd.shape)])
            return cache

        eng._new_cache = new_cache
        reqs = axis_serve_requests(cfg)
        eng.generate(reqs)
        logits, first, step = axis_logits(cfg, params, 2, mesh)
        np.save(os.path.join(out_dir, f"axis_ssm_{case.replace(' ', '_')}"
                                      f"_r{rank}.npy"), logits)
        out[case] = dict(tokens=[r.generated.tolist() for r in reqs],
                         bytes=eng.cache_bytes_resident, shapes=shapes,
                         first=first, step=step)
    with open(os.path.join(out_dir, f"axis_ssm_r{rank}.json"), "w") as f:
        json.dump(out, f)


def axis_vlm_batch(cfg):
    """The VLM case's prefill batch (2 rows, image + 6 text tokens)."""
    rng = np.random.default_rng(8)
    return {"tokens": rng.integers(0, cfg.vocab_size, (2, 6),
                                   dtype=np.int32),
            "image_embeds": rng.standard_normal(
                (2, cfg.num_patches, 1024)).astype(np.float32)}


def axis_vlm_tokens(cfg, params, mesh=None, steps=4):
    """phi-3-vision through ``make_prefill`` and ``make_serve_step`` (the
    engine serves no VLM): greedy tokens ``(2, 1 + steps)``."""
    from repro_torch.serve.engine import (gspmd_cache, make_prefill,
                                          make_serve_step)
    from repro_torch.models.transformer import init_cache
    batch = {k: torch.from_numpy(v) for k, v in axis_vlm_batch(cfg).items()}
    max_len = cfg.num_patches + 6 + steps
    prefill = make_prefill(cfg, mesh)
    if mesh is None:
        cache = init_cache(cfg, 2, max_len, dtype=torch.float32,
                           device="cpu")
    else:
        cache = gspmd_cache(cfg, prefill.sharder, 2, max_len,
                            dtype=torch.float32, device="cpu")
    with torch.inference_mode():
        nxt, cache = prefill(params, batch, cache)
        out = [nxt]
        step = make_serve_step(cfg, mesh, sharder=getattr(
            prefill, "sharder", None))
        for _ in range(steps):
            nxt, cache = step(params, nxt, cache)
            out.append(nxt)
    return torch.cat(out, 1).tolist()


def _axis_serve(rank, mesh, out_dir):
    """The GSPMD route (a mesh, no comm plan) on every family: the engine's
    cases of :data:`AXIS_SERVE` (and :data:`AXIS_FP8` under ``kv_fp8``
    with a bf16 cache), the VLM through ``make_prefill`` and the serve
    step: every rank's tokens and collectives, or the refusal of a paged
    pool whose sequence the mesh would split."""
    import json
    from repro_torch.dist.sharding import Sharder
    from repro_torch.models.transformer import init_params
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import ServeEngine
    out = {}
    cases = [(a, lay, "") for a, lays in AXIS_SERVE.items() for lay in lays]
    cases += [(AXIS_FP8, lay, "kv_fp8") for lay in ("contiguous", "paged")]
    for arch, layout, opt in cases:
        cfg = get_config(arch)
        params = Sharder(mesh, cfg, rank=rank).shard_params(
            init_params(cfg, 0, device="cpu"))
        kw = (dict(batch_size=4) if layout == "contiguous" else
              dict(batch_size=2, paged=True, page_size=8, num_pages=11))
        if opt:
            cfg = cfg.with_opts(opt)
            kw["cache_dtype"] = torch.bfloat16
        try:
            eng = ServeEngine(cfg, params, max_len=48, device="cpu",
                              mesh=mesh, **kw)
        except ValueError as e:   # a pool whose sequence would split
            out[f"{arch} {layout} {opt}".strip()] = dict(refused=str(e))
            continue
        reqs = axis_serve_requests(cfg)
        eng.generate(reqs)
        out[f"{arch} {layout} {opt}".strip()] = dict(
            tokens=[r.generated.tolist() for r in reqs],
            tally={k: v for k, v in eng._sharder.tally.items() if v})
    cfg = get_config("phi-3-vision-4.2b-smoke")
    params = Sharder(mesh, cfg, rank=rank).shard_params(
        init_params(cfg, 0, device="cpu"))
    out["phi-3-vision-4.2b-smoke"] = dict(
        tokens=axis_vlm_tokens(cfg, params, mesh))
    with open(os.path.join(out_dir, f"axis_serve_r{rank}.json"), "w") as f:
        json.dump(out, f)


def check_model_axis(rank: int, n: int, out_dir: str) -> None:
    """Each ``axis_<case>.npz`` (an arch, its opts, its full params,
    ``steps`` global batches, its ``modes`` of ``comm="gspmd"``, ``"vci"``
    and ``"vci"`` + ZeRO-1) trained on a ``(n // 2) x 2`` mesh: every
    rank writes its
    metrics, tallies, bytes and which leaves it holds sliced over data
    and over model to ``axis_out_<case>_<mode>_r<rank>.npz``, rank 0 the
    whole params. Then olmo's gspmd state after one step is saved on the
    mesh (``axis_ckpt``; rank 0 writes the whole leaves beside it), and
    every rank restores it as a data-only ``n x 1`` mesh and checks its
    slices bit for bit against the whole leaves; then olmo's gspmd steps
    and checkpoint on the pod mesh ``2 x (n // 4) x 2``
    (``axis_out_pod_r<rank>.npz``, ``axis_ckpt_pod``); then the GSPMD
    serve route (``_axis_serve``)."""
    from repro_torch.checkpoint import load_state, save_state
    from repro_torch.core.collectives import RankMesh
    from repro_torch.dist.sharding import Sharder
    from repro_torch.train.trainer import train_state_init
    from repro_torch.tree import tree_flatten, tree_flatten_with_paths
    mesh = RankMesh(n // 2, 2)
    cases = sorted(f[5:-4] for f in os.listdir(out_dir)
                   if f.startswith("axis_") and f.endswith(".npz")
                   and "_out_" not in f)
    for case in cases:
        data = np.load(os.path.join(out_dir, f"axis_{case}.npz"))
        cfg = _case_cfg(data)
        for mode in (str(m) for m in data["modes"]):
            state, step, metrics, tallies = _axis_train(cfg, data, mesh,
                                                        mode)
            out = {"metrics": np.asarray(metrics),
                   "param_bytes": sum(t.nbytes for t in
                                      tree_flatten(state.params)[0]),
                   "moment_bytes": sum(t.nbytes for t in tree_flatten(
                       (state.opt.m, state.opt.v))[0])}
            if mode == "gspmd":
                shard = step.sharder()
                keys = sorted(tallies[-1])
                out["tally_keys"] = np.asarray(keys)
                out["tally"] = np.asarray([[t[k] for k in keys]
                                           for t in tallies])
                out["shapes"] = np.asarray(
                    [str(tuple(t.shape)) for t in
                     tree_flatten(state.params)[0]])
                full = tree_flatten(shard.gather_params(state.params))[0]
            else:
                full = tree_flatten(state.params)[0]
            if rank == 0:
                out.update({f"p{i}": t.numpy() for i, t in enumerate(full)})
            np.savez(os.path.join(out_dir,
                                  f"axis_out_{case}_{mode}_r{rank}.npz"),
                     **out)
    # a checkpoint saved on the 2-D mesh, restored on a data-only one
    data = np.load(os.path.join(out_dir, "axis_olmo.npz"))
    cfg = _case_cfg(data)
    state, step, _, _ = _axis_train(cfg, {**data, "steps": 1}, mesh,
                                    "gspmd")
    ckpt = os.path.join(out_dir, "axis_ckpt")
    save_state(ckpt, 1, state, shard=step.sharder())
    whole = {"/".join(p): t.clone() for p, t in tree_flatten_with_paths(
        step.sharder().gather_params(state.params))}
    if rank == 0:
        np.savez(os.path.join(out_dir, "axis_ckpt_whole.npz"),
                 **{k: v.numpy() for k, v in whole.items()})
    flat = RankMesh(n, 1)
    like = train_state_init(cfg, 1, device="cpu", comm="gspmd", mesh=flat)
    back = load_state(ckpt, 1, like, shard=Sharder(flat, cfg))
    cut = Sharder(flat, cfg, rank=rank)
    same = all(torch.equal(t, cut.shard_leaf(p, whole["/".join(p)]))
               for p, t in tree_flatten_with_paths(back.params))
    np.save(os.path.join(out_dir, f"axis_ckpt_flat_r{rank}.npy"), same)
    # the pod axis: 2 x 1 x 2 has 2 x 2's lines, so its gspmd steps and
    # its checkpoint are 2 x 2's bit for bit
    pod = RankMesh(2, n // 4, 2)
    state, step, metrics, _ = _axis_train(cfg, data, pod, "gspmd")
    out = {"metrics": np.asarray(metrics)}
    full = tree_flatten(step.sharder().gather_params(state.params))[0]
    if rank == 0:   # (the gather is collective: every rank calls it)
        out.update({f"p{i}": t.numpy() for i, t in enumerate(full)})
    np.savez(os.path.join(out_dir, f"axis_out_pod_r{rank}.npz"), **out)
    state, step, _, _ = _axis_train(cfg, {**data, "steps": 1}, pod, "gspmd")
    save_state(os.path.join(out_dir, "axis_ckpt_pod"), 1, state,
               shard=step.sharder())
    _axis_serve(rank, mesh, out_dir)
    _axis_split(rank, out_dir)
    _axis_ssm(rank, out_dir)


CHECKS = {"reduce": check_reduce, "train": check_train,
          "seqshard": check_seqshard, "serve_tp": check_serve_tp,
          "all_to_all": check_all_to_all, "collectives": check_collectives,
          "zero1": check_zero1, "overlap": check_overlap,
          "gspmd": check_gspmd, "gather_grad": check_gather_grad,
          "ckpt_save": check_ckpt_save, "ckpt_load": check_ckpt_load,
          "model_axis": check_model_axis}


def _rank_main(rank: int, check: str, n: int, out_dir: str) -> None:
    # a rank that dies of a signal prints its Python stack
    faulthandler.enable(all_threads=True)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out_dir, "store"), n),
        rank=rank, world_size=n)
    try:
        CHECKS[check](rank, n, out_dir)
        # no rank tears its gloo pairs down while a peer is still in a
        # collective; a check that raised skips this, so that its peers
        # fail at once instead of waiting here
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(check: str, out_dir: str, n: int = 4,
              timeout: int = 240) -> subprocess.CompletedProcess:
    """Run ``check`` on ``n`` spawned gloo ranks in a fresh process."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, os.path.abspath(__file__), check,
                           str(out_dir), str(n)], capture_output=True,
                          text=True, timeout=timeout, env=env)


if __name__ == "__main__":
    check_name, directory, ranks = sys.argv[1], sys.argv[2], int(sys.argv[3])
    torch.multiprocessing.start_processes(
        _rank_main, args=(check_name, ranks, directory), nprocs=ranks,
        start_method="spawn")
