"""The data-parallel train step (port of ``repro.train.trainer``).

``comm="vci"`` is the paper's mode: every rank of the data group (the
default ``torch.distributed`` group, which takes the place of the
reference's mesh) holds the full params (DDP), computes the gradients of
its contiguous ``1/N`` of the batch rows (``P(data)``), and the gradient
tree is partitioned into buckets, each assigned a CommContext -> VCI (its
own process group) and reduced on independent streams by
:func:`repro_torch.core.bucketing.reduce_gradients`. ``progress`` /
``num_streams`` / ``vci_policy`` / ``pack`` / ``reduction`` / ``staging``
select the same design space as the reference.

The step is eager: autograd computes the gradients (each block recomputed
in the backward when ``cfg.remat != "none"``), the reduction is issued
asynchronously on the VCI groups, and AdamW updates params and moments in
place. With NCCL nothing in the step blocks the host on the card except
reading metrics, which the caller does.

Later slices, each raising ``NotImplementedError``: ``optimizer="zero1"``
(ROADMAP.md Queue 1 item 7), ``schedule="overlap"`` (item 8),
``comm="gspmd"`` (item 14), and families other than dense text (SSM and
hybrid training are item 12b, MoE training is item 15).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core import get_comm_plan, reduce_gradients
from repro_torch.device import torch_dtype
from repro_torch.models.transformer import Model, init_params
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.train.losses import total_loss
from repro_torch.tree import tree_flatten, tree_unflatten

METRIC_KEYS = ("ce", "tokens", "load_balance", "router_z", "loss",
               "grad_norm", "lr")


class TrainState(NamedTuple):
    params: Any
    opt: Any                     # AdamWState
    step: torch.Tensor           # int32 scalar on the params' device


def _zero1_later() -> NotImplementedError:
    return NotImplementedError(
        "optimizer='zero1' (ZeRO-1 sharded AdamW) is ROADMAP.md Queue 1 "
        "item 7 (not ported yet)")


def train_state_init(cfg: ModelConfig, seed: int = 0, *,
                     optimizer: str = "replicated", device=None,
                     params: Optional[Any] = None) -> TrainState:
    """Fresh params (``init_params(cfg, seed)`` on ``device``, or the given
    ``params``, e.g. the reference's carried over by ``repro_torch.bridge``)
    and zero AdamW moments in ``cfg.optimizer_dtype``."""
    if optimizer == "zero1":
        raise _zero1_later()
    if optimizer != "replicated":
        raise ValueError(f"unknown optimizer {optimizer!r}")
    if params is None:
        params = init_params(cfg, seed, device=device)
    opt = adamw_init(params, moment_dtype=torch_dtype(cfg.optimizer_dtype))
    return TrainState(params, opt, torch.zeros(
        (), dtype=torch.int32, device=opt.count.device))


def _loss_fn(model: Model, cfg: ModelConfig, params, batch):
    logits, aux, _ = model.forward(params, batch)
    return total_loss(cfg, logits, batch["labels"], aux)


def _rank_slice(batch, device) -> Dict[str, torch.Tensor]:
    """This rank's contiguous ``1/N`` of the global batch's rows, on
    ``device`` (the reference's ``P(data)`` in_spec)."""
    n = dist.get_world_size()
    r = dist.get_rank()
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        if v.shape[0] % n:
            raise ValueError(f"batch of {v.shape[0]} rows does not split "
                             f"over {n} data ranks")
        rows = v.shape[0] // n
        out[k] = v[r * rows:(r + 1) * rows].to(device)
    return out


def make_train_step(
    cfg: ModelConfig,
    *,
    lr_fn: Optional[Callable] = None,
    comm: str = "gspmd",
    accum_steps: int = 1,
    # --- vci-mode knobs (paper §4/§5) ---
    num_streams: int = 8,
    num_vcis: int = 8,
    vci_policy: str = "fcfs",
    progress: str = "hybrid",
    join_every: int = 8,
    token_impl: str = "barrier",
    staging: str = "per_vci",
    bucket_align: int = 8 * 128,
    # --- fast-path knobs (persistent plans + tile-gather pack) ---
    pack: str = "xla",
    reduction: str = "all_reduce",
    persistent_plan: bool = True,
    max_grad_norm: Optional[float] = 1.0,
    # --- optimizer layout (ZeRO-1) ---
    optimizer: str = "replicated",
    zero1_wire_dtype: Optional[str] = None,
    # --- comm schedule (bucket-ready overlap) ---
    schedule: str = "post",
) -> Callable[[TrainState, Any], tuple]:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    The keywords and their defaults are the reference's, without ``mesh``:
    the data group is ``torch.distributed``'s default group, which must be
    initialised (one rank is a legal group). ``batch`` is the GLOBAL batch
    (numpy arrays or tensors); each rank trains on its contiguous ``1/N``
    of the rows. ``metrics`` are float32 tensors on the params' device,
    averaged over the data group, with the keys of :data:`METRIC_KEYS`.
    The state's params and moments are updated in place.
    """
    if cfg.modality != "text":
        raise NotImplementedError(
            f"{cfg.modality} training is a later slice (ROADMAP.md Queue 1 "
            f"item 13c: the (B,K,S,V) and image-masked losses); the "
            f"{cfg.family} family serves only")
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{'SSM' if cfg.family == 'ssm' else 'hybrid'} training is a "
            f"later slice (ROADMAP.md Queue 1 item 12b: the SSD kernel has "
            f"no backward); the {cfg.family} family serves only")
    if cfg.moe is not None:
        raise NotImplementedError(
            "MoE training is a later slice (ROADMAP.md Queue 1 item 15: "
            "the row gather's backward); the train step runs the dense "
            "text family so far")
    if optimizer == "zero1" or zero1_wire_dtype is not None:
        raise _zero1_later()
    if optimizer != "replicated":
        raise ValueError(f"unknown optimizer {optimizer!r}")
    if schedule == "overlap":
        raise NotImplementedError(
            "schedule='overlap' (bucket-ready overlap) is ROADMAP.md Queue 1 "
            "item 8 (not ported yet)")
    if schedule != "post":
        raise ValueError(f"unknown schedule {schedule!r}")
    if comm == "gspmd":
        raise NotImplementedError(
            "comm='gspmd' (FSDP/DTensor sharding) is ROADMAP.md Queue 1 item "
            "14 (not ported yet); comm='vci' is the ported mode")
    if comm != "vci":
        raise ValueError(f"unknown comm mode {comm!r}")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if lr_fn is None:
        lr_fn = lambda step: 3e-4  # noqa: E731
    model = Model(cfg)

    def value_and_grad(params, batch):
        leaves, treedef = tree_flatten(params)
        leaves = [p.detach().requires_grad_() for p in leaves]
        _, metrics = _loss_fn(model, cfg, tree_unflatten(treedef, leaves),
                              batch)
        grads = torch.autograd.grad(metrics["loss"], leaves)
        return (tree_unflatten(treedef, list(grads)),
                {k: v.detach() for k, v in metrics.items()})

    def grads_and_metrics(params, batch):
        if accum_steps == 1:
            return value_and_grad(params, batch)
        # microbatch accumulation: split the rows, mean the grads in f32
        rows = next(iter(batch.values())).shape[0]
        if rows % accum_steps:
            raise ValueError(f"{rows} rows do not split into {accum_steps} "
                             f"microbatches")
        mb = rows // accum_steps
        acc_g = acc_m = None
        for i in range(accum_steps):
            g, m = value_and_grad(params, {k: v[i * mb:(i + 1) * mb]
                                           for k, v in batch.items()})
            g_leaves, treedef = tree_flatten(g)
            if acc_g is None:
                acc_g = [torch.zeros_like(x, dtype=torch.float32)
                         for x in g_leaves]
                acc_m = {k: torch.zeros_like(v) for k, v in m.items()}
            for a, x in zip(acc_g, g_leaves):
                a.add_(x.float() / accum_steps)
            for k in acc_m:
                acc_m[k] = acc_m[k] + m[k] / accum_steps
        p_leaves = tree_flatten(params)[0]
        grads = [a.to(p.dtype) for a, p in zip(acc_g, p_leaves)]
        return tree_unflatten(treedef, grads), acc_m

    def apply_update(state: TrainState, grads, metrics):
        lr = torch.as_tensor(lr_fn(state.step), dtype=torch.float32,
                             device=state.step.device)
        new_p, new_opt, om = adamw_update(
            grads, state.opt, state.params, lr=lr,
            max_grad_norm=max_grad_norm)
        metrics = dict(metrics) | om | {"lr": lr}
        return TrainState(new_p, new_opt, state.step + 1), metrics

    def data_mean(metrics):
        """The reference's ``pmean`` over the data axis: one all_reduce of
        the stacked metrics on the default group (not a VCI stream)."""
        keys = sorted(metrics)
        stacked = torch.stack([metrics[k].float() for k in keys])
        dist.all_reduce(stacked)
        stacked = stacked / dist.get_world_size()
        return {k: stacked[i] for i, k in enumerate(keys)}

    def inner_step(state: TrainState, batch):
        grads, metrics = grads_and_metrics(state.params, batch)
        # Persistent plan: BucketPlan + CommWorld + contexts + pack tables
        # cached on (treedef, shapes, knobs); the runtime is per step.
        cp = get_comm_plan(grads, num_streams=num_streams,
                           align=bucket_align, pack=pack, num_vcis=num_vcis,
                           vci_policy=vci_policy, progress=progress,
                           join_every=join_every, token_impl=token_impl,
                           schedule=schedule, persistent=persistent_plan)
        grads = reduce_gradients(cp.runtime(), grads, cp, mean=True,
                                 staging=staging, pack=pack,
                                 reduction=reduction)
        return apply_update(state, grads, data_mean(metrics))

    def train_step(state: TrainState, batch):
        if not dist.is_initialized():
            raise RuntimeError(
                "comm='vci' trains over torch.distributed's default group; "
                "initialise it first (one rank is a legal group)")
        return inner_step(state, _rank_slice(batch, state.step.device))

    return train_step
