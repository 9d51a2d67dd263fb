"""Application example — batched serving across architecture families, on
the PyTorch port.

Prefill + iterative decode for a dense GQA model, an attention-free SSM, a
hybrid and the multi-codebook audio model, through the same ServeEngine
API.

    PYTHONPATH=src python examples_torch/serve_batch.py               # card
    PYTHONPATH=src python examples_torch/serve_batch.py --device cpu
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_params
from repro_torch.serve.engine import Request, ServeEngine

ARCHS = ("yi-9b",           # dense GQA, full KV cache
         "mamba2-780m",     # SSM: O(1) recurrent state
         "zamba2-7b",       # hybrid: SSM + shared-attention KV sites
         "musicgen-large")  # audio: 4 codebook streams per step


def tokens_of(done) -> int:
    """Tokens generated over the requests (every codebook's counted)."""
    return sum(r.generated.shape[-1] * (r.generated.shape[0]
               if r.generated.ndim > 1 else 1) for r in done)


def demo(arch: str, device: torch.device, prompt_len=16, new=16, nreq=4,
         log=print):
    cfg = get_config(arch + "-smoke")
    params = init_params(cfg, 0, device=device)
    engine = ServeEngine(cfg, params, batch_size=2, max_len=128,
                         device=device)
    rng = np.random.default_rng(0)
    shape = ((cfg.num_codebooks, prompt_len) if cfg.modality == "audio"
             else (prompt_len,))
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, shape,
                                        dtype=np.int32),
                    max_new_tokens=new) for _ in range(nreq)]
    t0 = time.time()
    done = engine.generate(reqs)
    dt = time.time() - t0
    log(f"  {arch:16s} [{cfg.family:6s}] {len(done)} requests, "
        f"{tokens_of(done)} tokens, {dt:.2f}s")
    return done


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(f"batched serving across families ({device.type}):")
    for arch in ARCHS:
        demo(arch, device, new=args.new)
    print("OK")


if __name__ == "__main__":
    main()
