"""Training driver (PyTorch port).

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b-smoke \
        --steps 50 --batch 8 --seq 128 --comm vci --pack pallas

The flags are those of ``repro.launch.train`` plus ``--device``: the card
by default (raises without CUDA), ``--device cpu`` for the plain CPU path.
``--mesh N`` starts N data-parallel ranks with ``torch.multiprocessing``
(gloo on the CPU, NCCL on the card, one card a rank), joined through a
``FileStore`` in a temporary directory (no network); ``--mesh DxM`` starts
D x M ranks as a ``data x model`` mesh (the reference's form; rank ``r``
at ``(r // M, r % M)``), and ``--mesh PxDxM`` P x D x M ranks as a ``pod x
data x model`` mesh, whose data lines span ``pod x data`` (so ``2x1x2``
trains as ``2x2`` does); without it the step runs in this process as a
group of one. Rank 0 prints.

Every family trains: dense and MoE text (``--arch
mixtral-8x22b-smoke``), SSM and hybrid (``mamba2-780m-smoke``,
``zamba2-7b-smoke``), VLM (``phi-3-vision-4.2b-smoke``; ``--seq`` counts
the image patches too) and audio (``musicgen-large-smoke``).
``--comm gspmd`` (the default) is FSDP over the data ranks times tensor
parallelism over the model ranks, each line's collectives on its
fallback VCI (:mod:`repro_torch.dist.sharding`); ``--comm vci`` is the
paper's mode (bucketed VCI gradient reduction over the data ranks, the
model whole on every rank),
with ``--optimizer zero1`` (ZeRO-1: reduce_scatter, sharded AdamW, param
all_gather; ``--zero1-wire bfloat16`` sets the wire dtype of both) and
``--overlap`` (each bucket's reduce issued inside the backward).
``--ckpt-dir`` resumes from the directory's latest step (printing
``resumed from step N``), saves every ``--ckpt-every`` steps and at the
end, in the reference's format (:mod:`repro_torch.checkpoint`; sharded
states as whole leaves).
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint.io import latest_step, load_state, save_state
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.collectives import RankMesh
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.device import resolve_device
from repro_torch.launch.ranks import local_group, spawn_ranks
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.train.trainer import make_train_step, train_state_init


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b-smoke",
                    help=f"one of {ARCH_IDS} (+ -smoke / -swa<W> suffixes)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="none",
                    help='data-parallel ranks "N", "DxM" (data x model) or '
                         '"PxDxM" (pod x data x model) ("none": one rank '
                         'in this process)')
    ap.add_argument("--comm", choices=("gspmd", "vci"), default="gspmd")
    ap.add_argument("--progress", choices=("global", "per_vci", "hybrid"),
                    default="hybrid")
    ap.add_argument("--vci-policy", default="fcfs")
    ap.add_argument("--num-streams", type=int, default=8)
    ap.add_argument("--pack", choices=("xla", "pallas"), default="xla",
                    help="bucket pack impl: concatenate vs the tile-gather "
                         "kernel over a tile-aligned arena")
    ap.add_argument("--reduction", choices=("all_reduce", "reduce_scatter"),
                    default="all_reduce")
    ap.add_argument("--optimizer", choices=("replicated", "zero1"),
                    default="replicated")
    ap.add_argument("--zero1-wire", default=None)
    ap.add_argument("--overlap", action="store_true")
    ap.add_argument("--per-step-plan", action="store_true",
                    help="rebuild the comm plan every step (default uses "
                         "the persistent CommPlan cache)")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def build_mesh(spec: str) -> Optional[RankMesh]:
    """``--mesh``: ``none``, ``N`` (data), ``DxM`` (data x model) or
    ``PxDxM`` (pod x data x model), as the reference's ``build_mesh``
    reads it."""
    if spec in ("none", ""):
        return None
    dims = [int(d) for d in spec.split("x")]
    if len(dims) not in (1, 2, 3) or min(dims) < 1:
        raise ValueError(f"--mesh must be N, DxM or PxDxM with axes >= 1, "
                         f"got {spec}")
    return RankMesh(dims[0], 1) if len(dims) == 1 else RankMesh(*dims)


def _world_size(mesh: str) -> int:
    m = build_mesh(mesh)
    return 1 if m is None else m.size


def train(args: argparse.Namespace, device: torch.device) -> None:
    """The training loop of one rank (the data group is initialised)."""
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = build_mesh(args.mesh)
    cfg = get_config(args.arch)
    if rank == 0:
        print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
              f"devices={world} mesh={args.mesh} comm={args.comm} "
              f"device={device.type}", flush=True)

    def lr_fn(s):
        return cosine_schedule(s, peak=args.lr, warmup_steps=args.warmup,
                               total_steps=args.steps)

    schedule = "overlap" if args.overlap else "post"
    step = make_train_step(
        cfg, mesh=mesh, lr_fn=lr_fn, comm=args.comm, accum_steps=args.accum,
        num_streams=args.num_streams, progress=args.progress,
        vci_policy=args.vci_policy, pack=args.pack,
        reduction=args.reduction, persistent_plan=not args.per_step_plan,
        optimizer=args.optimizer, zero1_wire_dtype=args.zero1_wire,
        schedule=schedule)
    state = train_state_init(cfg, args.seed, optimizer=args.optimizer,
                             device=device, num_streams=args.num_streams,
                             pack=args.pack, schedule=schedule,
                             comm=args.comm, mesh=mesh)
    # the layout the checkpoint gathers and slices: the step's Sharder
    # (gspmd), the mesh's data lines (ZeRO-1)
    shard = step.sharder() if args.comm == "gspmd" else None
    start = 0
    if args.ckpt_dir and (ls := latest_step(args.ckpt_dir)) is not None:
        state = load_state(args.ckpt_dir, ls, state, shard=shard, mesh=mesh)
        start = ls
        if rank == 0:
            print(f"resumed from step {ls}", flush=True)

    def save(n: int) -> None:
        save_state(args.ckpt_dir, n, state, shard=shard, mesh=mesh,
                   metadata={"arch": cfg.name})

    t0 = time.time()
    tokens_done = 0
    for i in range(start, args.steps):
        batch = synthetic_batch(cfg, args.batch, args.seq, seed=args.seed,
                                step=i)
        state, metrics = step(state, batch)
        tokens_done += args.batch * args.seq
        if rank == 0 and ((i + 1) % args.log_every == 0
                          or i == args.steps - 1):
            loss = float(metrics["loss"])   # waits for the step
            dt = time.time() - t0
            print(f"step {i+1:5d}  loss {loss:7.4f}  "
                  f"ce {float(metrics['ce']):7.4f}  "
                  f"gnorm {float(metrics['grad_norm']):6.3f}  "
                  f"tok/s {tokens_done/dt:9.0f}", flush=True)
        if args.ckpt_dir and args.ckpt_every and \
                (i + 1) % args.ckpt_every == 0:
            save(i + 1)
    if args.ckpt_dir:
        save(args.steps)
        if rank == 0:
            print(f"checkpoint -> {args.ckpt_dir}", flush=True)


def main(argv=None) -> None:
    args = parse_args(argv)
    device = resolve_device(args.device)
    world = _world_size(args.mesh)
    if device.type == "cuda" and world > torch.cuda.device_count():
        raise ValueError(f"--mesh {world} needs {world} cards, "
                         f"{torch.cuda.device_count()} visible")
    if world == 1:
        with local_group(device):
            train(args, device)
    else:
        spawn_ranks(_train_rank, world, device, args)


def _train_rank(device: torch.device, args: argparse.Namespace) -> None:
    """One spawned rank (its group joined): train."""
    train(args, device)


if __name__ == "__main__":
    main()
