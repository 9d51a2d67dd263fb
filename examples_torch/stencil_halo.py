"""Application example — §6.1 stencil halo exchange with VCI streams, on
the PyTorch port.

A 2D Jacobi iteration on a grid of ranks: each rank owns a block, halo
rows/columns travel over four independent CommContexts (the paper's
odd/even communicator sets collapse to per-direction contexts on a rank
grid). Convergence is verified against the single-rank solver, and the
collective critical depth of the run is recorded (``CollectiveDepth``).

    PYTHONPATH=src python examples_torch/stencil_halo.py              # card
    PYTHONPATH=src python examples_torch/stencil_halo.py --device cpu

The ranks are spawned gloo ranks of this host (they share the card).
Gloo sends no CUDA tensor point to point, so on the card each halo is
copied to the host before its exchange and back after it, here, and the
copies are counted; the Jacobi update stays on the card.
"""

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.collectives import CommRuntime
from repro_torch.core.comm import CommWorld
from repro_torch.device import resolve_device
from repro_torch.launch.ranks import HostStaging, spawn_ranks
from repro_torch.launch.roofline import CollectiveDepth

ROWS = 2
BLOCK = 32
STEPS = 50
TOL = 1e-4


def grid(n: int):
    """``(ROWS, n // ROWS)`` ranks; one row where ``n`` does not split."""
    return (ROWS, n // ROWS) if n >= ROWS and n % ROWS == 0 else (1, n)


def perms(rows: int, cols: int):
    def at(r, c):
        return r * cols + c
    return {
        "n": [(at(r, c), at((r - 1) % rows, c)) for r in range(rows)
              for c in range(cols)],
        "s": [(at(r, c), at((r + 1) % rows, c)) for r in range(rows)
              for c in range(cols)],
        "w": [(at(r, c), at(r, (c - 1) % cols)) for r in range(rows)
              for c in range(cols)],
        "e": [(at(r, c), at(r, (c + 1) % cols)) for r in range(rows)
              for c in range(cols)],
    }


def jacobi_step(u, rt, ctxs, pm, stage):
    halos = {"n": u[:1, :], "s": u[-1:, :], "w": u[:, :1], "e": u[:, -1:]}
    recv = {d: stage.back(rt.sendrecv(stage.out(h), ctxs[d], perm=pm[d]))
            for d, h in halos.items()}
    up = torch.cat([recv["s"], u[:-1, :]], dim=0)
    dn = torch.cat([u[1:, :], recv["n"]], dim=0)
    lf = torch.cat([recv["e"], u[:, :-1]], dim=1)
    rg = torch.cat([u[:, 1:], recv["w"]], dim=1)
    return 0.25 * (up + dn + lf + rg)


def reference(u0: torch.Tensor, steps: int) -> torch.Tensor:
    """The single-rank solver on the whole periodic grid."""
    u = u0
    for _ in range(steps):
        up = torch.roll(u, 1, dims=0)
        dn = torch.roll(u, -1, dims=0)
        lf = torch.roll(u, 1, dims=1)
        rg = torch.roll(u, -1, dims=1)
        u = 0.25 * (up + dn + lf + rg)
    return u


def initial_grid(rows: int, cols: int, seed: int = 0) -> np.ndarray:
    """The whole grid's starting values (the reference's)."""
    rng = np.random.default_rng(seed)
    return rng.normal(size=(rows * BLOCK, cols * BLOCK)).astype(np.float32)


def block_of(full, rank: int, cols: int):
    r, c = divmod(rank, cols)
    return full[r * BLOCK:(r + 1) * BLOCK, c * BLOCK:(c + 1) * BLOCK]


def solve(u: torch.Tensor, *, progress: str = "hybrid", steps: int = STEPS,
          stage: HostStaging):
    """This rank's block after ``steps`` Jacobi steps (every rank of the
    default group calls it with its own block)."""
    rows, cols = grid(dist.get_world_size())
    pm = perms(rows, cols)
    world = CommWorld(num_vcis=8)
    rt = CommRuntime(world, progress=progress, join_every=16,
                     token_impl="data")
    ctxs = {d: world.create(f"halo_{d}") for d in "nswe"}
    for _ in range(steps):
        u = jacobi_step(u, rt, ctxs, pm, stage)
    rt.barrier()
    return u


def run(device: torch.device, *, progress: str = "hybrid",
        steps: int = STEPS, seed: int = 0) -> dict:
    """The example on this rank (the default group initialised): the block
    solved twice, timed and then inside :class:`CollectiveDepth`; the
    largest error over the ranks against the single-rank solver (each rank
    solves the whole grid). Returns the numbers and this rank's block."""
    n, rank = dist.get_world_size(), dist.get_rank()
    rows, cols = grid(n)
    full = torch.from_numpy(initial_grid(rows, cols, seed)).to(device)
    u0 = block_of(full, rank, cols).contiguous()
    stage = HostStaging(device)
    dist.barrier()
    t0 = time.perf_counter()
    out = solve(u0, progress=progress, steps=steps, stage=stage)
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    copies = stage.copies
    with CollectiveDepth() as depth:
        again = solve(u0, progress=progress, steps=steps,
                      stage=HostStaging(device))
    if not torch.equal(out, again):
        raise AssertionError("the recorded run differs from the timed one")
    want = block_of(reference(full, steps), rank, cols)
    err = torch.tensor([float((out - want).abs().max())])
    dist.all_reduce(err, op=dist.ReduceOp.MAX)
    return {"grid": [rows, cols], "steps": steps, "progress": progress,
            "err": float(err), "copies": copies, "seconds": seconds,
            **dict(depth), "block": out.cpu().numpy()}


def _rank(device: torch.device, progress: str, steps: int,
          json_path: str) -> None:
    res = run(device, progress=progress, steps=steps)
    if dist.get_rank() != 0:
        return
    rows, cols = res["grid"]
    print(f"jacobi {steps} steps on {rows}x{cols} ranks "
          f"({device.type}, {dist.get_backend()}): "
          f"max|distributed - reference| = {res['err']:.2e}")
    print(f"progress={progress}: {res['collective_count']} collectives, "
          f"critical depth {res['critical_depth']}, parallelism "
          f"{res['parallelism']:.2f}; {res['copies']} host staging copies "
          f"on rank 0; {res['seconds']:.3f}s")
    if json_path:
        res.pop("block")
        with open(json_path, "w") as f:
            json.dump(res, f)
    if not res["err"] < TOL:
        raise AssertionError("halo exchange incorrect")
    print("OK — VCI-stream halo exchange matches the single-device solver",
          flush=True)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--progress", default="hybrid",
                    choices=("global", "per_vci", "hybrid"))
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--json", default="",
                    help="rank 0 writes its numbers here")
    return ap


def rank_args(args) -> tuple:
    """What :func:`_rank` takes after the device, from the command line."""
    return args.progress, args.steps, args.json


def main(argv=None):
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    spawn_ranks(_rank, args.ranks, device, *rank_args(args))


if __name__ == "__main__":
    main()
