#!/usr/bin/env python3
"""Train-step times of the port's attention archs on one CUDA card.

    python3 tools/train_step_ms.py [--checkout DIR] [--label NAME]
                                   [--archs olmo-1b,gemma-2b,...]

Trains each arch of ``ARCHS`` at full width (its depth cut as
``chip_smoke.py`` cuts it) with ``chip_smoke.py``'s knobs (vci post,
``pack="pallas"``, ``remat="block"``, one-rank group) from seed 0: a
warm-up step, then ``STEPS`` steps on the host clock after a synchronise.
It prints, for each arch, the mean ms a step, the peak memory, and the
device ms a step spent in the attention backward: CUDA events recorded
around each call of the attention op's backward function (the kernel
call, or the plain version where the checkout has no kernel), summed over
the step. ``--checkout`` imports ``repro_torch`` from another checkout's
``src`` (a ``git archive`` of a parent commit, say), so that two trees
are timed by the same script on the same card one after another: run
parent, change, change, parent. It prints the card's name and power
limit first, then one JSON line an arch, and exits non-zero without a
card. ``chip_smoke.py`` is the check; this script only measures.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402  (the training cells and knobs)

# (arch, layers (None: all), batch, text tokens) as chip_smoke.py trains
# them: phases 9, 13b, 13c, 14c and 18
ARCHS = ((cs.TRAIN_ARCH, None, cs.TRAIN_BATCH, cs.TRAIN_SEQ),
         (cs.MOE_ARCH, cs.MOE_TRAIN_LAYERS, cs.TRAIN_BATCH, cs.TRAIN_SEQ),
         (cs.VLM_ARCH, cs.VLM_TRAIN_LAYERS, cs.MM_TRAIN_BATCH, cs.VLM_TEXT),
         (cs.AUDIO_ARCH, None, cs.MM_TRAIN_BATCH, cs.AUDIO_TRAIN_FRAMES),
         (cs.HYB_ARCH, cs.HYB_TRAIN_LAYERS, cs.MM_TRAIN_BATCH, cs.TRAIN_SEQ),
         ) + cs.ARCH_TRAINS
STEPS = 3
KNOBS = cs.TRAIN_KNOBS


class BwdTimer:
    """Wraps the attention op's backward function of ``fa`` (the module)
    with CUDA events; ``ms()`` sums the recorded spans since ``reset``."""

    def __init__(self, fa):
        self.fa = fa
        # the kernel's op where the checkout has it, else the plain version
        self.attr = ("flash_bwd" if hasattr(fa, "flash_attention_bwd")
                     else "flash_attention_bwd_plain")
        self.fn = getattr(fa, self.attr)
        self.spans = []
        setattr(fa, self.attr, self)

    def __call__(self, *a, **kw):
        import torch
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        out = self.fn(*a, **kw)
        t1.record()
        self.spans.append((t0, t1))
        return out

    def reset(self):
        self.spans = []

    def ms(self) -> float:
        import torch
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.spans)


def run_arch(arch, layers, batch, seq, timer) -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.train.trainer import make_train_step, train_state_init
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, remat="block",
                              num_layers=layers or cfg.num_layers)
    seq += cfg.num_patches            # a VLM's labels span image + text
    batches = [synthetic_batch(cfg, batch, seq, seed=0, step=i)
               for i in range(STEPS + 1)]
    t0 = time.time()
    state = train_state_init(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats()     # the state stays counted
    step = make_train_step(cfg, **KNOBS)
    state, m = step(state, batches[0])
    torch.cuda.synchronize()
    times, bwd, losses = [], [], []
    for b in batches[1:]:
        timer.reset()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        bwd.append(timer.ms())
        losses.append(float(m["loss"]))
    out = dict(arch=arch, layers=cfg.num_layers, batch=batch, seq=seq,
               ms=sum(times) / len(times), step_ms=times,
               attn_bwd_ms=sum(bwd) / len(bwd), attn_bwd_calls=len(
                   timer.spans), peak=torch.cuda.max_memory_allocated(),
               loss=losses, init_s=round(init_s, 1))
    del state, step, m
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkout", default=HERE)
    ap.add_argument("--label", default="tree")
    ap.add_argument("--archs", default=",".join(a[0] for a in ARCHS))
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(args.checkout), "src"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("train_step_ms: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    import repro_torch
    import torch.distributed as dist
    from repro_torch.kernels import flash_attention as fa
    src = os.path.dirname(repro_torch.__file__)
    timer = BwdTimer(fa)
    print(f"train_step_ms {args.label}: repro_torch from {src}; the "
          f"attention backward timed at {timer.attr}", flush=True)
    tmp = tempfile.mkdtemp(prefix="train_step_ms_")
    dist.init_process_group("cpu:gloo,cuda:nccl", store=dist.FileStore(
        os.path.join(tmp, "store"), 1), rank=0, world_size=1)
    want = args.archs.split(",")
    try:
        for arch, layers, batch, seq in ARCHS:
            if arch not in want:
                continue
            row = dict(run_arch(arch, layers, batch, seq, timer),
                       label=args.label, card=card, bwd=timer.attr)
            print(f"train_step_ms {args.label}: {json.dumps(row)}",
                  flush=True)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
