"""Serving driver (PyTorch port): continuous-batching prefill + decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b-smoke \
        --requests 8 --prompt-len 32 --max-new 32

Paged KV cache (pool of fixed-size pages + per-slot page table; the decode
gathers pages with the CUDA kernel on the card):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \
        --vary-prompts --paged --page-size 16

An MoE arch on the CPU, paged while its sliding window (64 in the smoke
config) covers ``--max-len``:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch mixtral-8x22b-smoke --max-len 64 --paged

Past the window the cache is a ring of ``W`` slots and requests go through
the grouped equal-length path (``--paged`` is not used then):

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch mixtral-8x22b-smoke --max-len 160 --prompt-len 80

``--arch mixtral-8x22b --max-len 6144`` takes the same path on the card,
given the memory for its 141 B parameters (``chip_smoke.py`` serves it
cut to 4 layers). zamba2-7b at full size fits one card:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
        --prompt-len 1000 --max-len 1056

An SSM arch (mamba2) or a hybrid (zamba2: Mamba2 groups with a shared
attention block) on the CPU, through the grouped equal-length path
(requests grouped by prompt length; the SSD intra-chunk step and the
hybrid's prefill attention are CUDA kernels on the card):

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch mamba2-780m-smoke --vary-prompts
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch zamba2-7b-smoke

An audio arch (musicgen: prompts of ``(num_codebooks, prompt-len)``
codebook tokens, one head a codebook) takes the grouped path too:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch musicgen-large-smoke --requests 4 --max-new 8

A VLM arch (phi-3-vision) is refused, as the reference's engine cannot
serve one either: serve it with ``make_prefill`` on a batch holding
``image_embeds``, then ``make_serve_step`` (``repro_torch.serve.engine``).

The flags are those of ``repro.launch.serve`` plus ``--device``: the card
by default, ``--device cpu`` for the plain CPU path. ``--tp`` > 1 (the
tensor-parallel decode on VCI streams) is not ported yet and raises.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_params
from repro_torch.serve.engine import Request, ServeEngine, check_servable


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b-smoke")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--vary-prompts", action="store_true",
                    help="draw prompt lengths in [prompt-len/2, prompt-len] "
                         "to exercise the left-padded mixed-length path")
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="engine-default sampling temperature (0 = greedy)")
    ap.add_argument("--stop", type=int, default=None,
                    help="stop token id applied to every request")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree; only 1 is ported so far")
    ap.add_argument("--num-vcis", type=int, default=8,
                    help="VCI pool size for the serve comm plan (tp>1)")
    ap.add_argument("--policy", default="fcfs",
                    choices=("fcfs", "round_robin", "hash", "hinted"),
                    help="VCI pool assignment policy (tp>1)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache (page pool + per-slot page table)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per page (paged cache)")
    ap.add_argument("--pages", type=int, default=None,
                    help="page-pool size incl. the trash page (default: "
                         "full provision batch*ceil(max_len/page_size)+1)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    if args.tp > 1:
        raise NotImplementedError(
            "--tp > 1 (tensor-parallel decode on VCI streams) is not ported "
            "yet; see ROADMAP.md Queue 1")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    check_servable(cfg)
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M")
    params = init_params(cfg, args.seed, device=device)

    engine = ServeEngine(cfg, params, batch_size=args.batch,
                         max_len=args.max_len, device=device,
                         temperature=args.temperature, seed=args.seed,
                         paged=args.paged, page_size=args.page_size,
                         num_pages=args.pages)
    if args.paged and engine._paged:
        print(f"paged cache: page_size={args.page_size} "
              f"num_pages={engine._num_pages} (admit_under_mesh=True)")
    elif args.paged:
        why = (f"family={cfg.family!r}" if cfg.family not in ("dense", "moe")
               else f"the ring cache (sliding window {cfg.sliding_window} "
                    f"< max_len {args.max_len})")
        print(f"paged cache: not used for {why} (ring, SSM, hybrid and "
              f"audio caches have no paged layout); the grouped "
              f"equal-length contiguous path serves it")

    rng = np.random.default_rng(args.seed)
    reqs = []
    for _ in range(args.requests):
        plen = (int(rng.integers(max(1, args.prompt_len // 2),
                                 args.prompt_len + 1))
                if args.vary_prompts else args.prompt_len)
        shape = ((cfg.num_codebooks, plen)
                 if cfg.modality == "audio" else (plen,))
        reqs.append(Request(
            prompt=rng.integers(0, cfg.vocab_size, shape, dtype=np.int32),
            max_new_tokens=args.max_new, stop_token=args.stop))

    t0 = time.time()
    done = engine.generate(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    n_tok = sum(r.generated.shape[-1] for r in done)
    print(f"{len(done)} requests, {n_tok} new tokens in {dt:.2f}s "
          f"({n_tok/dt:.1f} tok/s) "
          f"cache_bytes_resident={engine.cache_bytes_resident}")
    for i, r in enumerate(done[:4]):
        print(f"  req{i}: first tokens {r.generated[..., :8].tolist()}")


if __name__ == "__main__":
    main()
