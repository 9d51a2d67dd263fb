"""Application example — §6.2 EBMS energy-band remote fetch, on the
PyTorch port.

The OpenMC energy-banding pattern: cross-section data is distributed
across nodes; every iteration each worker fetches one band shard from a
remote node with MPI_Get + MPI_Win_flush (one window per worker — the
paper's Fig. 23 parallelism) and then tracks its particles (compute).
Verifies the fetched bands match the owner's data and reports the flush
dependency structure under per-VCI vs hybrid progress
(``CollectiveDepth``).

    PYTHONPATH=src python examples_torch/ebms_bands.py                # card
    PYTHONPATH=src python examples_torch/ebms_bands.py --device cpu

Each rank owns its own bands (the seed's bands plus a tenth of its
rank), so a band that came from any rank but the left neighbour fails the
check. The ranks are spawned gloo ranks of this host (they share the
card): gloo sends no CUDA tensor point to point, so on the card each band
is copied to the host before its get and back after it, here, and the
copies are counted; the tracking (``tanh(band).sum()``) stays on the
card.
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

WORKERS = 4
BAND = 4096
RTOL = 1e-6


def bands_of(owner: int, seed: int = 0) -> np.ndarray:
    """Rank ``owner``'s ``(WORKERS, BAND)`` cross-section bands."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(WORKERS, BAND)).astype(np.float32)
    return base + np.float32(0.1 * owner)


def fetch(bands: torch.Tensor, *, progress: str, stage: HostStaging):
    """Every worker gets its band from the left rank, flushes its window
    and tracks: ``(fetched (WORKERS, BAND), tracked (WORKERS,))``."""
    n = dist.get_world_size()
    perm = [(i, (i + 1) % n) for i in range(n)]  # fetch from the left
    world = CommWorld(num_vcis=WORKERS + 1)
    rt = CommRuntime(world, progress=progress, join_every=2 * WORKERS,
                     token_impl="data")
    wins = [world.create(f"band{w}", kind="rma") for w in range(WORKERS)]
    reqs = [rt.get(stage.out(bands[w]), wins[w], perm=perm)
            for w in range(WORKERS)]
    # MPI_Win_flush per worker, then the "particle tracking" compute
    for w in wins:
        rt.flush(w)
    flushed = [stage.back(rt.wait(r)) for r in reqs]
    tracked = [torch.tanh(f).sum() for f in flushed]
    rt.barrier()
    return torch.stack(flushed), torch.stack(tracked)


def run(device: torch.device, *, progress: str, seed: int = 0) -> dict:
    """The example on this rank (the default group initialised): the fetch
    timed, then again inside :class:`CollectiveDepth`; the fetched bands
    held against the owner's. Returns the numbers."""
    n, rank = dist.get_world_size(), dist.get_rank()
    bands = torch.from_numpy(bands_of(rank, seed)).to(device)
    stage = HostStaging(device)
    dist.barrier()
    t0 = time.perf_counter()
    fetched, tracked = fetch(bands, progress=progress, stage=stage)
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    with CollectiveDepth() as depth:
        again, _ = fetch(bands, progress=progress, stage=HostStaging(device))
    if not torch.equal(fetched, again):
        raise AssertionError("the recorded run differs from the timed one")
    owner = torch.from_numpy(bands_of((rank - 1) % n, seed))
    got = fetched.cpu()
    np.testing.assert_allclose(got.numpy(), owner.numpy(), rtol=RTOL)
    err = torch.tensor([float((got - owner).abs().max())])
    dist.all_reduce(err, op=dist.ReduceOp.MAX)
    return {"progress": progress, "err": float(err),
            "checksum": float(tracked.sum()), "copies": stage.copies,
            "seconds": seconds, **dict(depth)}


def _rank(device: torch.device, modes, json_path: str) -> None:
    results = [run(device, progress=p) for p in modes]
    if dist.get_rank() != 0:
        return
    for res in results:
        print(f"progress={res['progress']:8s} fetched {WORKERS} bands x "
              f"{BAND*4/1024:.0f}KB, checksum {res['checksum']:.3f}")
        print(f"  max|fetched - owner| = {res['err']:.2e}; "
              f"{res['collective_count']} collectives, critical depth "
              f"{res['critical_depth']}, parallelism "
              f"{res['parallelism']:.2f}; {res['copies']} host staging "
              f"copies on rank 0; {res['seconds']:.3f}s")
    if json_path:
        with open(json_path, "w") as f:
            json.dump(results, f)
    print(f"OK — EBMS remote fetch matches band owners under both progress "
          f"models ({dist.get_world_size()} {device.type} ranks, "
          f"{dist.get_backend()})", flush=True)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--json", default="",
                    help="rank 0 writes its numbers here")
    return ap


def rank_args(args) -> tuple:
    """What :func:`_rank` takes after the device, from the command line."""
    return ("per_vci", "hybrid"), args.json


def main(argv=None):
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    spawn_ranks(_rank, args.ranks, device, *rank_args(args))


if __name__ == "__main__":
    main()
