"""Deterministic synthetic data (port of ``repro.data.pipeline``).

The token stream is a *learnable* noisy successor process — token[t+1] =
(token[t] + stride) mod V with probability 1-noise. Batches are numpy, so
the conformance tests feed the same batch to the reference and the port.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import IMG_EMBED_DIM

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
    """The reference's batch for the same (seed, step): ``{"tokens": (B,
    S), "labels": (B, S)}`` int32; audio ``(B, K, S)`` each; VLM ``tokens``
    ``(B, S - P)``, ``labels`` ``(B, S)`` over the whole image + text
    sequence (``PAD_LABEL`` over the image) and ``image_embeds`` ``(B, P,
    IMG_EMBED_DIM)`` f32."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    if cfg.modality == "audio":
        toks = _succ_tokens(rng, (batch, cfg.num_codebooks, seq + 1),
                            cfg.vocab_size)
        return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    if cfg.modality == "vlm":
        s_txt = seq - cfg.num_patches
        if s_txt <= 1:
            raise ValueError(f"seq {seq} must exceed num_patches "
                             f"{cfg.num_patches} + 1")
        toks = _succ_tokens(rng, (batch, s_txt + 1), cfg.vocab_size)
        img = rng.standard_normal(
            (batch, cfg.num_patches, IMG_EMBED_DIM)).astype(np.float32)
        labels = np.full((batch, seq), PAD_LABEL, np.int32)
        labels[:, cfg.num_patches:] = toks[:, 1:]
        return {"tokens": toks[:, :-1], "labels": labels, "image_embeds": img}
    toks = _succ_tokens(rng, (batch, seq + 1), cfg.vocab_size)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

