"""Loss functions: masked next-token cross-entropy plus the MoE aux terms
(port of ``repro.train.losses``). The CE is shape-generic: audio's
``(B,K,S,V)`` logits against ``(B,K,S)`` labels are the mean over every
codebook's tokens; a VLM's labels span image + text with ``PAD_LABEL``
over the patches."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import PAD_LABEL

LOAD_BALANCE_COEF = 0.01
ROUTER_Z_COEF = 1e-3


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked CE in float32. logits: (..., S, V); labels: (..., S) with
    ``PAD_LABEL`` masked. Returns (sum_loss, num_tokens)."""
    mask = labels != PAD_LABEL
    safe = torch.where(mask, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, safe[..., None])[..., 0]
    loss = -torch.where(mask, ll, 0.0)
    return loss.sum(), mask.sum()


def total_loss(cfg: ModelConfig, logits, labels, aux: Dict[str, torch.Tensor],
               shard=None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean CE over the unmasked tokens, plus ``LOAD_BALANCE_COEF * lb +
    ROUTER_Z_COEF * rz`` for MoE configs (the aux losses averaged over the
    layers), in the reference's fixed metric structure
    (``load_balance``/``router_z`` are zero for dense archs).

    ``shard`` (a :class:`repro_torch.dist.sharding.Sharder` over N data
    ranks, the ``comm="gspmd"`` step): the loss is the reference's
    global-batch loss, split into ranks' shares that sum to it. The CE
    sum of this rank's rows is divided by the unmasked tokens of every
    rank (summed over the data ranks: ranks may hold different counts of
    ``PAD_LABEL``), and ``aux`` already holds this rank's shares
    (:func:`repro_torch.models.moe.moe_ffn`). ``tokens`` is the global
    count; the other metrics are this rank's shares, which the step sums
    over the ranks."""
    ce_sum, n = cross_entropy(logits, labels)
    if shard is not None:
        n = shard.data_sum_(n.clone())
    ce = ce_sum / torch.clamp(n, min=1)
    zero = torch.zeros((), device=ce.device)
    lb = aux.get("load_balance", zero) / max(1, cfg.num_layers)
    rz = aux.get("router_z", zero) / max(1, cfg.num_layers)
    loss = ce
    if cfg.moe is not None:
        loss = loss + LOAD_BALANCE_COEF * lb + ROUTER_Z_COEF * rz
    metrics = {"ce": ce, "tokens": n.float(), "load_balance": lb,
               "router_z": rz, "loss": loss}
    return loss, metrics
