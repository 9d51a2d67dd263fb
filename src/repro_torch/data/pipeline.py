"""Deterministic synthetic data (port of ``repro.data.pipeline``).

The token stream is a *learnable* noisy successor process — token[t+1] =
(token[t] + stride) mod V with probability 1-noise. Batches are numpy, so
the conformance tests feed the same batch to the reference and the port.
:func:`batch_spec` gives every input's shape and dtype (the dry-run's),
:func:`batch_shardings` its rows over a mesh's data line, and
:func:`place_batch` puts this rank's rows on its device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.device import resolve_device
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



def synthetic_batches(cfg: ModelConfig, batch: int, seq: int, *,
                      seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """The endless stream of :func:`synthetic_batch` steps 0, 1, ..."""
    step = 0
    while True:
        yield synthetic_batch(cfg, batch, seq, seed=seed, step=step)
        step += 1


# ---------------------------------------------------------------------------
# dry-run specs + per-rank placement
# ---------------------------------------------------------------------------

def batch_spec(cfg: ModelConfig, shape: InputShape, mesh=None
               ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """``{name: (shape, dtype)}`` of every model input of ``shape``: the
    reference's ``ShapeDtypeStruct``s (``image_embeds`` bf16, the rest
    int32). ``mesh`` is unused, as there."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "decode":
        if cfg.modality == "audio":
            return {"tokens": ((b, cfg.num_codebooks, 1), i32)}
        return {"tokens": ((b, 1), i32)}
    spec: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
    if cfg.modality == "audio":
        spec["tokens"] = ((b, cfg.num_codebooks, s), i32)
        if shape.kind == "train":
            spec["labels"] = ((b, cfg.num_codebooks, s), i32)
    elif cfg.modality == "vlm":
        spec["tokens"] = ((b, s - cfg.num_patches), i32)
        spec["image_embeds"] = ((b, cfg.num_patches, IMG_EMBED_DIM),
                                torch.bfloat16)
        if shape.kind == "train":
            spec["labels"] = ((b, s), i32)
    else:
        spec["tokens"] = ((b, s), i32)
        if shape.kind == "train":
            spec["labels"] = ((b, s), i32)
    return spec


@dataclass(frozen=True)
class RowSplit:
    """One input's layout over a mesh: its rows in ``parts`` blocks over
    the data line (``pod x data``), or whole (``parts == 1``). ``spec``
    is the reference's ``PartitionSpec`` entry for entry."""

    spec: Tuple
    parts: int
    model: int

    def rows(self, rank: int, n: int) -> slice:
        """Rank ``rank``'s rows of ``n``: its data index's block."""
        if self.parts == 1:
            return slice(0, n)
        per = n // self.parts
        d = rank // self.model
        return slice(d * per, (d + 1) * per)


def batch_shardings(cfg: ModelConfig, shape: InputShape, mesh
                    ) -> Dict[str, RowSplit]:
    """Each input's :class:`RowSplit` on ``mesh`` (a
    :class:`~repro_torch.core.collectives.RankMesh` or an object with
    ``axis_names`` and a ``shape`` dict): rows over every axis but
    ``model`` when they divide, as the reference's ``batch_shardings``."""
    names = tuple(getattr(mesh, "axis_names", dict(mesh.shape)))
    sizes = dict(mesh.shape)
    dp = tuple(a for a in names if a in ("pod", "data"))
    dpn = int(np.prod([sizes[a] for a in dp])) if dp else 1
    out = {}
    for k, (shp, _) in batch_spec(cfg, shape, mesh).items():
        split = shp[0] % dpn == 0 and shp[0] >= dpn
        lead = (dp[0] if len(dp) == 1 else dp) if split else None
        out[k] = RowSplit((lead,) + (None,) * (len(shp) - 1),
                          dpn if split else 1, sizes.get("model", 1))
    return out


def place_batch(batch: Dict[str, np.ndarray],
                shardings: Dict[str, RowSplit], *, rank: Optional[int] = None,
                device=None) -> Dict[str, torch.Tensor]:
    """This rank's rows of every input of ``batch`` as tensors on
    ``device`` (``rank``: torch.distributed's, or 0 without a group)."""
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    dev = resolve_device(device)
    return {k: torch.as_tensor(v[shardings[k].rows(rank, v.shape[0])]).to(
        dev) for k, v in batch.items()}
