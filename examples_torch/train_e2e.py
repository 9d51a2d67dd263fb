"""End-to-end training example on the PyTorch port: a ~100M-param dense
model for a few hundred steps on the synthetic successor corpus, with
checkpointing and the paper's VCI gradient-communication path (buckets
packed by the hand-written kernel on the card).

    PYTHONPATH=src python examples_torch/train_e2e.py                 # full (~100M), card
    PYTHONPATH=src python examples_torch/train_e2e.py --tiny --device cpu

The model is the olmo-1b family shrunk to ~100M (12 layers, d_model=768),
i.e. a *same-family* config — the framework treats it like any other entry
in the zoo.
"""

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint.io import save_state
from repro_torch.configs import get_config
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.device import resolve_device
from repro_torch.launch.ranks import local_group
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.train.trainer import make_train_step, train_state_init


def config_100m():
    base = get_config("olmo-1b")
    return dataclasses.replace(
        base, name="olmo-100m", num_layers=12, d_model=768, num_heads=12,
        num_kv_heads=12, head_dim=64, d_ff=3072, vocab_size=8192,
        dtype="float32", param_dtype="float32", remat="none")


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def train(cfg, device: torch.device, *, steps: int, batch: int, seq: int,
          ckpt_dir: str, pack: str = "pallas", log=print) -> dict:
    """Train ``cfg`` from seed 0 for ``steps`` steps (vci buckets, one
    rank) and save the state as step ``steps``'s checkpoint. Returns the
    ce of every step, tokens/s, the peak bytes on the card (None on the
    CPU), the checkpoint's directory and bytes, and the state."""
    log(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
        f"{steps} steps x {batch}x{seq} tokens on {device.type}")
    lr = lambda s: cosine_schedule(s, peak=3e-4, warmup_steps=steps // 10,
                                   total_steps=steps)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with local_group(device):
        state = train_state_init(cfg, 0, device=device, pack=pack)
        step = make_train_step(cfg, lr_fn=lr, comm="vci", pack=pack)
        t0 = time.time()
        ces = []
        for i in range(steps):
            b = synthetic_batch(cfg, batch, seq, seed=0, step=i)
            state, m = step(state, b)
            ces.append(float(m["ce"]))
            if (i + 1) % max(1, steps // 10) == 0:
                tok_s = batch * seq * (i + 1) / (time.time() - t0)
                log(f"  step {i+1:4d}  ce {ces[-1]:7.4f}  "
                    f"gnorm {float(m['grad_norm']):6.3f}  "
                    f"tok/s {tok_s:8.0f}")
        tok_s = batch * seq * steps / (time.time() - t0)
        peak = (torch.cuda.max_memory_allocated()
                if device.type == "cuda" else None)
        first, last = ces[0], ces[-1]
        if not np.isfinite(last):
            raise FloatingPointError(f"ce {last} at step {steps}")
        log(f"ce: {first:.3f} -> {last:.3f} "
            f"({100 * (1 - last / first):.0f}% reduction)")
        out = save_state(ckpt_dir, steps, state,
                         metadata={"arch": cfg.name, "ce": last})
    log(f"checkpoint: {out}")
    return {"ce": ces, "tok_s": tok_s, "peak_bytes": peak,
            "ckpt": out, "ckpt_bytes": dir_bytes(out), "state": state}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_e2e_ckpt"))
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.tiny:
        cfg = get_config("olmo-1b-smoke")
        steps, batch, seq = args.steps or 30, 8, 64
    else:
        cfg = config_100m()
        steps, batch, seq = args.steps or 200, 8, 256
    res = train(cfg, device, steps=steps, batch=batch, seq=seq,
                ckpt_dir=args.ckpt_dir)
    print(f"tok/s {res['tok_s']:.0f}, peak bytes {res['peak_bytes']}, "
          f"checkpoint bytes {res['ckpt_bytes']}")


if __name__ == "__main__":
    main()
