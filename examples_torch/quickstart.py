"""Quickstart: the public API of the PyTorch port in ~60 lines.

1. Pick an assigned architecture (reduced -smoke variant).
2. Train a few steps with the paper's VCI-bucketed gradient communication.
3. Serve a few tokens from the trained model.

    PYTHONPATH=src python examples_torch/quickstart.py                # card
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.device import resolve_device
from repro_torch.launch.ranks import local_group
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train.trainer import make_train_step, train_state_init


def quickstart(device: torch.device, *, arch: str = "gemma-2b-smoke",
               steps: int = 30, new_tokens: int = 12, log=print) -> dict:
    """Train ``arch`` for ``steps`` steps, then serve 4 requests of
    ``new_tokens`` tokens. Returns the losses and the requests."""
    # --- the model zoo: 10 assigned architectures, one config each --------
    cfg = get_config(arch)   # reduced same-family variant
    log(f"model: {cfg.name} ({cfg.family}), "
        f"{cfg.param_count()/1e6:.1f}M params, on {device.type}")

    # --- train (the VCI buckets need a data group: one rank here) --------
    lr = lambda s: cosine_schedule(s, peak=1e-3, warmup_steps=5,
                                   total_steps=steps)
    losses = []
    with local_group(device):
        state = train_state_init(cfg, 0, device=device)
        step = make_train_step(cfg, lr_fn=lr, comm="vci")
        for i in range(steps):
            batch = synthetic_batch(cfg, batch=8, seq=64, seed=0, step=i)
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            if (i + 1) % 10 == 0:
                log(f"  step {i+1:3d}  loss {losses[-1]:.4f}")

    # --- serve -------------------------------------------------------------
    engine = ServeEngine(cfg, state.params, batch_size=4, max_len=128,
                         device=device)
    prompts = [Request(prompt=np.arange(16, dtype=np.int32) % cfg.vocab_size,
                       max_new_tokens=new_tokens) for _ in range(4)]
    done = engine.generate(prompts)
    for i, r in enumerate(done):
        log(f"  generated[{i}]: {r.generated.tolist()}")
    return {"losses": losses, "requests": done}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    quickstart(resolve_device(args.device), steps=args.steps)


if __name__ == "__main__":
    main()
