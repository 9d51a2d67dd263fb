#!/usr/bin/env python3
"""Where the row gather's read-once route starts to win, on one CUDA card.

    python3 tools/row_gather_routes.py

Times the row gather's two routes (gather, read-once) at top-2 dispatches
of 4 to 8,192 mixtral-8x22b token rows, as alternating pairs: the
crossover that ``moe_gather._READ_ONCE_MIN_BYTES`` encodes. It builds the
kernel from the checkout, prints the card's name and power limit first,
and exits non-zero without a card. ``chip_smoke.py`` is the check of the
kernels; this script only measures.
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "src"))

import chip_smoke as cs  # noqa: E402  (paired_ms, routing tables)


def gather_routes() -> None:
    import torch
    from repro_torch.kernels import moe_gather
    gen = torch.Generator(device="cuda").manual_seed(3)
    for groups, tokens, cf in ((4, 1, 2.0), (1, 64, 2.0), (1, 256, 1.25),
                               (2, 256, 1.25), (4, 256, 1.25),
                               (8, 256, 1.25), (4, 1024, 1.25),
                               (8, 1024, 1.25)):
        idx, inv, _ = cs._routed(groups, tokens, 8, 2, cf, gen)
        t = groups * tokens
        src = torch.randn((t, 6144), generator=gen,
                          device="cuda").to(torch.bfloat16)
        once, gather, wins = cs.paired_ms(
            lambda i: cs._read_once_forced(src, idx, inv),
            lambda i: moe_gather.row_gather(src, idx), n_iter=20, reps=3)
        spared = t * src.shape[1] * src.element_size()
        print(f"gather-routes T={t} M={idx.numel()} spared={spared} B: "
              f"read-once ms={once:.5f} gather ms={gather:.5f}, read-once "
              f"faster in {wins} of {cs.PAIRS} (the wrapper takes "
              f"{'read-once' if moe_gather._read_once(src, 2) else 'gather'}"
              f")", flush=True)
        del src


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("row_gather_routes: needs a CUDA card")
    cs.phase_device()
    from repro_torch.kernels import _build
    _build.build_all(["row_gather"])
    gather_routes()


if __name__ == "__main__":
    main()
