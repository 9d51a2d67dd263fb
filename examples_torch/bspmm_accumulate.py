"""Application example — §6.3 BSPMM get-compute-update with the
accumulate-ordering hint, on the PyTorch port.

Block-sparse matmul across ranks: workers Get remote A/B tiles, multiply
locally, and Accumulate C tiles into a shared window. Demonstrates the
paper's §6.3 finding end-to-end: ``accumulate_ordering="none"`` lets the
library run accumulates on parallel streams while keeping the SAME numeric
result (the reduction is commutative). The chain is read with
``CollectiveDepth`` from the issue graph of the run.

    PYTHONPATH=src python examples_torch/bspmm_accumulate.py          # card
    PYTHONPATH=src python examples_torch/bspmm_accumulate.py --device cpu

The ranks are spawned gloo ranks of this host (they share the card).
Gloo sends no CUDA tensor point to point, so on the card each tile is
copied to the host before its get and back after it, and each product
before its accumulate and back, here, and the copies are counted; the
products stay on the card.
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

TILE = 64
WORKERS = 4
RTOL = 1e-5
ORDERINGS = ("rar", "none")


def tiles(seed: int = 0):
    """The reference's ``(WORKERS, TILE, TILE)`` A and B tiles, the same on
    every rank."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(WORKERS, TILE, TILE)).astype(np.float32)
    b = rng.normal(size=(WORKERS, TILE, TILE)).astype(np.float32)
    return a, b


def closed_form(a: np.ndarray, b: np.ndarray, n: int) -> np.ndarray:
    """C over ``n`` ranks: ``n · Σ_w A_w B_w`` (f64)."""
    return n * np.einsum("wij,wjk->ik", a.astype(np.float64),
                         b.astype(np.float64))


def multiply(a_tiles: torch.Tensor, b_tiles: torch.Tensor, *,
             ordering: str, progress: str = "hybrid",
             stage: HostStaging) -> torch.Tensor:
    """Every worker gets A and B from the left rank, multiplies, and
    accumulates its product into window C over the ranks: C."""
    n = dist.get_world_size()
    perm = [(i, (i + 1) % n) for i in range(n)]
    world = CommWorld(num_vcis=WORKERS + 1)
    rt = CommRuntime(world, progress=progress, join_every=4 * WORKERS,
                     token_impl="data")
    getw = [world.create(f"g{w}", kind="rma") for w in range(WORKERS)]
    cwin = world.create("C", kind="rma", accumulate_ordering=ordering)
    acc = []
    for w in range(WORKERS):
        ra = rt.get(stage.out(a_tiles[w]), getw[w], perm=perm)
        rb = rt.get(stage.out(b_tiles[w]), getw[w], perm=perm)
        a, b = stage.back(rt.wait(ra)), stage.back(rt.wait(rb))
        acc.append(rt.accumulate(stage.out(a @ b), cwin))
    c = torch.zeros((TILE, TILE), dtype=torch.float32,
                    device=a_tiles.device)
    for r in acc:
        c = c + stage.back(rt.wait(r))
    rt.barrier()
    return c


def run(device: torch.device, *, progress: str = "hybrid",
        seed: int = 0) -> dict:
    """The example on this rank (the default group initialised): C under
    each ordering, timed and then inside :class:`CollectiveDepth`; C held
    equal across the orderings and against the closed form. Returns the
    numbers and C."""
    n = dist.get_world_size()
    a_np, b_np = tiles(seed)
    a, b = torch.from_numpy(a_np).to(device), torch.from_numpy(b_np).to(device)
    want = closed_form(a_np, b_np, n)
    out = {"progress": progress, "ranks": n}
    cs = {}
    for ordering in ORDERINGS:
        stage = HostStaging(device)
        dist.barrier()
        t0 = time.perf_counter()
        c = multiply(a, b, ordering=ordering, progress=progress,
                     stage=stage)
        if device.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        with CollectiveDepth() as depth:
            again = multiply(a, b, ordering=ordering, progress=progress,
                             stage=HostStaging(device))
        if not torch.equal(c, again):
            raise AssertionError("the recorded run differs from the timed "
                                 "one")
        cs[ordering] = c.cpu().numpy()
        out[ordering] = {"seconds": seconds, "copies": stage.copies,
                         "err": float(np.abs(cs[ordering] - want).max()),
                         **dict(depth)}
    np.testing.assert_allclose(cs["rar"], cs["none"], rtol=RTOL)
    scale = float(np.abs(want).max())
    for ordering in ORDERINGS:
        np.testing.assert_allclose(cs[ordering], want, rtol=RTOL,
                                   atol=RTOL * scale)
    out["scale"] = scale
    out["C"] = cs["rar"]
    return out


def _rank(device: torch.device, progress: str, json_path: str) -> None:
    res = run(device, progress=progress)
    if dist.get_rank() != 0:
        return
    for ordering in ORDERINGS:
        d = res[ordering]
        print(f"ordering={ordering!r}: collective critical depth "
              f"{d['critical_depth']:.0f}, parallelism "
              f"{d['parallelism']:.2f}")
        print(f"  {d['collective_count']} collectives; max|C - n·ΣAB| = "
              f"{d['err']:.2e} (|C| up to {res['scale']:.1f}); "
              f"{d['copies']} host staging copies on rank 0; "
              f"{d['seconds']:.3f}s")
    if json_path:
        res.pop("C")
        with open(json_path, "w") as f:
            json.dump(res, f)
    if res["none"]["critical_depth"] > res["rar"]["critical_depth"]:
        raise AssertionError("relaxed ordering lengthened the chain")
    print("OK — relaxed ordering shortens the accumulate chain, values "
          "equal", flush=True)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--progress", default="hybrid",
                    choices=("global", "per_vci", "hybrid"))
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--json", default="",
                    help="rank 0 writes its numbers here")
    return ap


def rank_args(args) -> tuple:
    """What :func:`_rank` takes after the device, from the command line."""
    return args.progress, args.json


def main(argv=None):
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    spawn_ranks(_rank, args.ranks, device, *rank_args(args))


if __name__ == "__main__":
    main()
