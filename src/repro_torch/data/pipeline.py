"""Deterministic synthetic data (port of ``repro.data.pipeline``, text).

The token stream is a *learnable* noisy successor process — token[t+1] =
(token[t] + stride) mod V with probability 1-noise. Batches are numpy, so
the conformance tests feed the same batch to the reference and the port.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.configs.base import ModelConfig

PAD_LABEL = -1


def _succ_tokens(rng: np.random.Generator, shape, vocab: int,
                 stride: int = 7, noise: float = 0.1) -> np.ndarray:
    """Noisy successor sequences along the last axis."""
    out = np.empty(shape, np.int32)
    first = rng.integers(0, vocab, shape[:-1])
    out[..., 0] = first
    for t in range(1, shape[-1]):
        nxt = (out[..., t - 1] + stride) % vocab
        flip = rng.random(shape[:-1]) < noise
        rnd = rng.integers(0, vocab, shape[:-1])
        out[..., t] = np.where(flip, rnd, nxt)
    return out


def synthetic_batch(cfg: ModelConfig, batch: int, seq: int, *,
                    seed: int = 0, step: int = 0) -> Dict[str, np.ndarray]:
    """``{"tokens": (B, S), "labels": (B, S)}`` int32, the reference's
    batch for the same (seed, step). Text archs only so far."""
    if cfg.modality != "text":
        raise NotImplementedError(
            f"synthetic {cfg.modality} batches come with the VLM/audio "
            f"families (ROADMAP.md Queue 1 item 13b)")
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    toks = _succ_tokens(rng, (batch, seq + 1), cfg.vocab_size)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

