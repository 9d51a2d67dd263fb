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
``<dir>/out_seqshard.npz`` (``tests/test_torch_ring.py``).
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


CHECKS = {"reduce": check_reduce, "train": check_train,
          "seqshard": check_seqshard}


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
