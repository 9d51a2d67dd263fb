"""The train step (port of ``repro.train.trainer``).

The ranks of ``torch.distributed``'s default group take the place of the
reference's mesh: ``mesh`` (a :class:`~repro_torch.core.collectives.
RankMesh`) lays them out as a row-major ``data x model`` grid; without it
they are all data ranks. A rank's *data line* is the ranks that share its
model index, its *model line* those that share its data index; the ranks
of a model line train on the same batch rows.

``comm="vci"`` is the paper's mode: every rank holds the full params
(DDP) and runs the model whole (the reference leaves the model axis to
GSPMD, which replicates the model over it: ``Model(cfg, None)``, params
``P()``), computes the gradients of its data line's contiguous ``1/N`` of
the batch rows (``P(data)``), and the gradient tree is partitioned into
buckets, each assigned a CommContext -> VCI (its own process group, along
the data line on a mesh with a model axis) and reduced on independent
streams by :func:`repro_torch.core.bucketing.reduce_gradients`; the
metrics are their mean over the data line. ``progress`` /
``num_streams`` / ``vci_policy`` / ``pack`` / ``reduction`` / ``staging``
select the same design space as the reference.

``optimizer="zero1"``: each bucket is reduce-scattered instead, each rank
updates its ``1/N`` shard of the f32 master and the moments
(:func:`~repro_torch.optim.adamw.sharded_adamw_update`) and the updated
params are all-gathered back on the bucket's VCI. ``schedule="overlap"``:
each bucket's reduce (or reduce_scatter) is issued inside the backward by
the gradient hooks of :func:`~repro_torch.core.bucketing.
overlap_boundaries`, the moment its last leaf gradient exists; with
microbatches only the last one's backward carries the hooks.

The step is eager: autograd computes the gradients (each block recomputed
in the backward when ``cfg.remat != "none"``), the reduction is issued
asynchronously on the VCI groups, and AdamW updates params and moments in
place. With NCCL nothing in the step blocks the host on the card except
reading metrics, which the caller does.

``comm="gspmd"`` (the reference's default) is FSDP over the data ranks
times tensor parallelism over the model ranks: each rank keeps its slice
of every leaf along both of the rule table's dims
(:mod:`repro_torch.dist.sharding`; ``train_state_init(comm="gspmd")``);
each layer's data slices are all-gathered over the data line where the
layer runs and their gradient reduce-scattered back
(``Sharder.materialize``), the model slices compute Megatron tensor
parallelism on the model line (:mod:`repro_torch.dist.tp`), expert tables
whose E dim lies over data stay where they are and the MoE moves its rows
to them (an all_to_all), the gradients of the leaves whole over data are
summed by one all-reduce a dtype over the data line, and AdamW updates
the slices (its clip's norm summed so that every element counts once).
The loss is the reference's global-batch loss (each data rank's share,
:func:`repro_torch.train.losses.total_loss`), so the mesh gives the
single-device step on the whole batch; with one rank it is that step.
Each line's collectives run on its fallback VCI (the default group on a
data-only mesh).

Every family trains: dense and MoE text (the MoE row moves through the
row-gather kernels forward and backward, the loss with the router's aux
terms), SSM and hybrid (the SSD intra-chunk step through its forward and
backward kernels, plain CE), VLM (image + text labels) and audio (the K
codebook heads), in both modes and on either mesh.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core import TILE, get_comm_plan, reduce_gradients
from repro_torch.core.bucketing import (ShardLayout, all_gather_shards,
                                        overlap_boundaries, plan_buckets)
from repro_torch.core.collectives import RankMesh, vci_group
from repro_torch.device import torch_dtype
from repro_torch.dist.sharding import Sharder
from repro_torch.models.transformer import Model, init_params
from repro_torch.optim.adamw import (adamw_init, adamw_update,
                                     shard_decay_masks, sharded_adamw_init,
                                     sharded_adamw_update)
from repro_torch.train.losses import total_loss
from repro_torch.tree import (tree_flatten, tree_flatten_with_paths,
                              tree_leaves, tree_map_with_paths,
                              tree_unflatten)

METRIC_KEYS = ("ce", "tokens", "load_balance", "router_z", "loss",
               "grad_norm", "lr")


class TrainState(NamedTuple):
    params: Any
    opt: Any                     # AdamWState | ShardedAdamWState (zero1)
    step: torch.Tensor           # int32 scalar on the params' device


def _zero1_plan(params_or_grads, *, num_streams: int, align: int, pack: str,
                schedule: str = "post"):
    """The bucket plan the zero1 path uses, the one the step's
    ``get_comm_plan`` builds, so that state init and update agree on the
    layout (``schedule="overlap"`` plans use-order-contiguous buckets)."""
    return plan_buckets(params_or_grads, num_streams, align=align,
                        slot_align=align if pack == "pallas" else None,
                        partition="contig" if schedule == "overlap"
                        else "size")


def default_mesh() -> Optional[RankMesh]:
    """The mesh of a step given none: every rank of torch.distributed's
    default group a data rank (``None``: one rank, or no group)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    return RankMesh(n, 1) if n > 1 else None


def data_sharder(cfg: ModelConfig, mesh: Optional[RankMesh] = None
                 ) -> Sharder:
    """The :class:`Sharder` of a ``comm="gspmd"`` step in this process on
    ``mesh`` (default :func:`default_mesh`). Collective on a mesh with a
    model axis (it makes the lines' groups): every rank builds it at the
    same point."""
    return Sharder(mesh if mesh is not None else default_mesh(), cfg)


class DataLine:
    """This rank's data line of ``mesh``: its ``size`` ranks, this rank's
    ``index`` on it, and its ``group`` (the line's fallback VCI; ``None``,
    the default group, on a data-only mesh). Collective on a mesh with a
    model axis (it makes the lines' groups)."""

    def __init__(self, mesh: Optional[RankMesh] = None):
        mesh = mesh if mesh is not None else default_mesh()
        rank = dist.get_rank() if dist.is_initialized() else 0
        if mesh is None:
            self.size, self.index, self.group = 1, 0, None
        else:
            if not dist.is_initialized() or \
                    dist.get_world_size() != mesh.size:
                raise ValueError(f"a mesh of {mesh.size} ranks needs "
                                 f"torch.distributed's default group of "
                                 f"{mesh.size} ranks")
            self.size, self.index = mesh.data_size, mesh.coords(rank)[0]
            self.group = (vci_group(0, 1, axis="data", mesh=mesh)
                          if mesh.model > 1 else None)


def train_state_init(cfg: ModelConfig, seed: int = 0, *,
                     optimizer: str = "replicated", device=None,
                     params: Optional[Any] = None, num_streams: int = 8,
                     bucket_align: int = TILE, pack: str = "xla",
                     schedule: str = "post", comm: str = "vci",
                     mesh: Optional[RankMesh] = None) -> TrainState:
    """Fresh params (``init_params(cfg, seed)`` on ``device``, or the given
    ``params``, e.g. the reference's carried over by ``repro_torch.bridge``)
    and zero AdamW moments in ``cfg.optimizer_dtype``.

    ``optimizer="zero1"`` builds this rank's ZeRO-1 shard state over the
    default group (which must be initialised): pass the ``num_streams``,
    ``bucket_align``, ``pack`` and ``schedule`` that ``make_train_step``
    gets, since the bucket plan, and so every buffer's layout, derives
    from them.

    ``comm="gspmd"`` builds this rank's state on ``mesh`` (default: every
    rank of the default group a data rank; one rank without it): its slice
    of every leaf along the rule table's dims over data and over model (a
    copy, the full leaf freed), whole copies of the rest, and moments of
    the slices' shapes. ``comm="vci"`` (the default here) keeps every
    leaf whole on every rank; its ZeRO-1 shards split over the data line
    of ``mesh``."""
    if optimizer not in ("replicated", "zero1"):
        raise ValueError(f"unknown optimizer {optimizer!r}")
    if comm not in ("vci", "gspmd"):
        raise ValueError(f"unknown comm mode {comm!r}")
    if comm == "gspmd" and optimizer != "replicated":
        raise ValueError("optimizer='zero1' requires comm='vci' (the "
                         "bucketed reduce_scatter path)")
    if comm == "gspmd":
        shard = data_sharder(cfg, mesh)
        if params is None:
            # the text attention archs' leaves are cut as they are made,
            # so that one whole leaf at a time is on the device
            params = init_params(cfg, seed, device=device,
                                 shard=shard.shard_leaf)
        params = tree_map_with_paths(
            lambda p, t: t if tuple(t.shape) == shard.local_shape(p)
            else shard.shard_leaf(p, t), params)
    elif params is None:
        params = init_params(cfg, seed, device=device)
    moment_dtype = torch_dtype(cfg.optimizer_dtype)
    if optimizer == "replicated":
        opt = adamw_init(params, moment_dtype=moment_dtype)
    else:
        if not dist.is_initialized():
            raise ValueError("optimizer='zero1' shards over torch."
                             "distributed's default group; initialise it "
                             "first (one rank is a legal group)")
        plan = _zero1_plan(params, num_streams=num_streams,
                           align=bucket_align, pack=pack, schedule=schedule)
        line = DataLine(mesh)
        opt = sharded_adamw_init(params, plan, moment_dtype,
                                 axis_size=line.size, rank=line.index)
    return TrainState(params, opt, torch.zeros(
        (), dtype=torch.int32, device=opt.count.device))


def optimizer_bytes(opt) -> int:
    """Bytes of an optimizer state on this rank (every tensor in it)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(
        {"m": opt.m, "v": opt.v,
         "master": getattr(opt, "master", ()), "count": opt.count}))


def _loss_fn(model: Model, cfg: ModelConfig, params, batch):
    logits, aux, _ = model.forward(params, batch)
    return total_loss(cfg, logits, batch["labels"], aux, shard=model.shard)


def _rank_slice(batch, device, line: Optional[DataLine] = None
                ) -> Dict[str, torch.Tensor]:
    """This rank's contiguous ``1/N`` of the global batch's rows, on
    ``device`` (the reference's ``P(data)`` in_spec): its data line's
    ``line.index`` of ``line.size``, or, without a line, its rank of the
    default group's."""
    n, i = ((dist.get_world_size(), dist.get_rank()) if line is None
            else (line.size, line.index))
    return _microbatch_rows(batch, device, n, i, 1)


def _microbatch_rows(batch, device, n: int, rank: int, accum: int
                     ) -> Dict[str, torch.Tensor]:
    """This rank's rows of the global batch for a ``comm="gspmd"`` step:
    its contiguous ``1/n`` of each of the ``accum`` microbatches (the
    reference splits the global batch into microbatches first), so that
    the rank's microbatch ``i`` is its slice of the global microbatch
    ``i``; with one microbatch, its contiguous ``1/n`` of the rows."""
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        if v.shape[0] % (n * accum):
            raise ValueError(f"batch of {v.shape[0]} rows does not split "
                             f"into {accum} microbatches over {n} data "
                             f"ranks")
        mb = v.shape[0] // accum
        part = mb // n
        out[k] = torch.cat([v[i * mb + rank * part:i * mb + (rank + 1) * part]
                            for i in range(accum)]).to(device)
    return out


def make_train_step(
    cfg: ModelConfig,
    *,
    mesh: Optional[RankMesh] = None,
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

    The keywords and their defaults are the reference's. ``mesh`` (a
    :class:`RankMesh` over the default group's ranks; default: all data
    ranks) places them; ``comm="vci"`` needs the group initialised (one
    rank is a legal group; ``comm="gspmd"`` runs on one rank without it).
    The step builds its groups at its first call, which every rank makes
    at the same point. ``batch`` is the GLOBAL batch (numpy arrays or
    tensors); each rank trains on its data line's contiguous ``1/N`` of
    the rows (under ``comm="gspmd"`` with ``accum_steps`` microbatches,
    its ``1/N`` of each). ``metrics`` are float32 tensors on the params'
    device, equal on every rank, with the keys of :data:`METRIC_KEYS`:
    ``comm="vci"`` averages each rank's values over the data line (the
    reference's ``pmean``), ``comm="gspmd"`` gives the global batch's. The
    state's params and moments are updated in place.

    ``comm="gspmd"`` needs a state from ``train_state_init(comm="gspmd",
    mesh=mesh)`` on the same ranks; ``step.comm_tally`` then holds the
    last step's count of each collective, the data line's
    (``all_gather``, ``reduce_scatter``, ``all_reduce``, ``all_to_all``,
    and the bytes gathered and scattered) apart from the model line's
    (``model_all_reduce``, ``model_all_gather``,
    ``model_reduce_scatter``).

    ``optimizer="zero1"`` needs a state from ``train_state_init(optimizer=
    "zero1")`` with the same ``num_streams``/``bucket_align``/``pack``/
    ``schedule``; ``zero1_wire_dtype`` (e.g. ``"bfloat16"``) is the payload
    dtype of both the gradient scatter and the param gather (``None``: f32).
    ``schedule="overlap"`` issues the reduces inside the backward (see the
    module docstring); with ``optimizer="zero1"`` the shard updates and
    the param gathers then run in ``CommPlan.ready_order``.
    """
    if optimizer not in ("replicated", "zero1"):
        raise ValueError(f"unknown optimizer {optimizer!r}")
    if optimizer == "zero1" and comm != "vci":
        raise ValueError("optimizer='zero1' requires comm='vci' (the "
                         "bucketed reduce_scatter path)")
    if schedule not in ("post", "overlap"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if schedule == "overlap" and comm != "vci":
        raise ValueError("schedule='overlap' requires comm='vci' (the "
                         "bucketed reduction path)")
    if comm not in ("vci", "gspmd"):
        raise ValueError(f"unknown comm mode {comm!r}")
    if schedule == "overlap" and staging != "per_vci":
        raise ValueError("schedule='overlap' requires staging='per_vci': "
                         "shared staging threads one buffer through every "
                         "bucket, which re-serializes the backward-issued "
                         "reduces it exists to overlap")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if lr_fn is None:
        lr_fn = lambda step: 3e-4  # noqa: E731
    # the model (and, under gspmd, its Sharder; under vci, the data line),
    # built at the first step on the ranks of that moment
    built: Dict[str, Any] = {"model": Model(cfg), "shard": None,
                             "line": None}

    def data_line() -> DataLine:
        if built["line"] is None:
            built["line"] = DataLine(mesh)
        return built["line"]
    wire = torch_dtype(zero1_wire_dtype) if zero1_wire_dtype else \
        torch.float32

    def value_and_grad(params, batch, leaves=None):
        """Loss metrics and the gradients w.r.t. ``leaves`` (default: fresh
        detached leaves of ``params``; the overlap step passes its hooked
        ones)."""
        if leaves is None:
            leaves = [p.detach().requires_grad_()
                      for p in tree_flatten(params)[0]]
        treedef = tree_flatten(params)[1]
        _, metrics = _loss_fn(built["model"], cfg,
                              tree_unflatten(treedef, leaves), batch)
        grads = torch.autograd.grad(metrics["loss"], leaves)
        return (tree_unflatten(treedef, list(grads)),
                {k: v.detach() for k, v in metrics.items()})

    def microbatches(batch):
        rows = next(iter(batch.values())).shape[0]
        if rows % accum_steps:
            raise ValueError(f"{rows} rows do not split into {accum_steps} "
                             f"microbatches")
        mb = rows // accum_steps
        return [{k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                for i in range(accum_steps)]

    def accumulate(params, mbs):
        """The f32 sums of the microbatches' gradients and metrics, each
        divided by ``accum_steps``."""
        acc_g = acc_m = None
        for b in mbs:
            g, m = value_and_grad(params, b)
            g_leaves = tree_flatten(g)[0]
            if acc_g is None:
                acc_g = [torch.zeros_like(x, dtype=torch.float32)
                         for x in g_leaves]
                acc_m = {k: torch.zeros_like(v) for k, v in m.items()}
            for a, x in zip(acc_g, g_leaves):
                a.add_(x.float() / accum_steps)
            for k in acc_m:
                acc_m[k] = acc_m[k] + m[k] / accum_steps
        return acc_g, acc_m

    def grads_and_metrics(params, batch):
        if accum_steps == 1:
            return value_and_grad(params, batch)
        # microbatch accumulation: split the rows, mean the grads in f32
        acc_g, acc_m = accumulate(params, microbatches(batch))
        p_leaves, treedef = tree_flatten(params)
        grads = [a.to(p.dtype) for a, p in zip(acc_g, p_leaves)]
        return tree_unflatten(treedef, grads), acc_m

    def overlap_grads_and_metrics(params, batch, cp, taps=None):
        """The backward with bucket hooks on the LAST microbatch only; the
        earlier ones accumulate here and ride in as the carry. Returns the
        metrics and the boundaries (waited: the reduced grads or taps)."""
        carry, acc_m, last = None, None, batch
        if accum_steps > 1:
            mbs = microbatches(batch)
            acc_g, acc_m = accumulate(params, mbs[:-1])
            carry = tree_unflatten(tree_flatten(params)[1], acc_g)
            last = mbs[-1]
        bnd = overlap_boundaries(cp, params, taps=taps, carry=carry,
                                 accum_steps=accum_steps, mean=True,
                                 pack=pack, reduction=reduction,
                                 reduce_dtype=wire if taps is not None
                                 else torch.float32)
        _, metrics = value_and_grad(bnd.params, last, bnd.leaves)
        last_issue.update(order=tuple(bnd.issued),
                          in_backward=len(bnd.issued),
                          hooks_seen=dict(bnd.hooks_seen),
                          leaves=len(bnd.leaves))
        if acc_m is not None:
            metrics = {k: acc_m[k] + metrics[k] / accum_steps
                       for k in acc_m}
        return metrics, bnd

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
        the stacked metrics on the data line's fallback VCI (not a bucket
        stream)."""
        line = data_line()
        keys = sorted(metrics)
        stacked = torch.stack([metrics[k].float() for k in keys])
        dist.all_reduce(stacked, group=line.group)
        stacked = stacked / line.size
        return {k: stacked[i] for i, k in enumerate(keys)}

    def data_sum(x):
        """The global-norm ``psum``: one all_reduce of a scalar on the
        data line."""
        dist.all_reduce(x, group=data_line().group)
        return x

    def comm_plan(tree):
        # Persistent plan: BucketPlan + CommWorld + contexts + pack tables
        # cached on (treedef, shapes, knobs); the runtime is per step.
        return get_comm_plan(tree, num_streams=num_streams,
                             align=bucket_align, pack=pack,
                             num_vcis=num_vcis, vci_policy=vci_policy,
                             progress=progress, join_every=join_every,
                             token_impl=token_impl, schedule=schedule,
                             persistent=persistent_plan, mesh=mesh)

    masks: Dict[str, Any] = {"plan": None}    # this rank's decay masks
    # the overlap hooks' record of the last step: the bucket issue order,
    # how many were issued inside the backward, the leaf gradients seen
    # at each issue (empty under the post schedule)
    last_issue: Dict[str, Any] = {}

    def zero1_update(state: TrainState, cp, rt, shards, metrics,
                     order=None):
        """Sharded AdamW on this rank's shards, then the updated params
        gathered back on each bucket's VCI and written into the params."""
        layout = ShardLayout(cp.plan, cp.data_size)
        if masks["plan"] is not cp.plan:
            masks["plan"], masks["shards"] = cp.plan, shard_decay_masks(
                cp.plan, layout.axis_size, data_line().index,
                device=state.step.device)
        lr = torch.as_tensor(lr_fn(state.step), dtype=torch.float32,
                             device=state.step.device)
        new_shards, new_opt, om = sharded_adamw_update(
            shards, state.opt, lr=lr, layout=layout,
            decay_masks=masks["shards"], psum=data_sum,
            max_grad_norm=max_grad_norm, bucket_order=order)
        new_params = all_gather_shards(rt, new_shards, cp, wire_dtype=wire,
                                       order=order)
        with torch.no_grad():
            for p, q in zip(tree_flatten(state.params)[0],
                            tree_flatten(new_params)[0]):
                p.copy_(q)
        metrics = dict(metrics) | om | {"lr": lr}
        return TrainState(state.params, new_opt, state.step + 1), metrics

    def inner_step(state: TrainState, batch):
        grads, metrics = grads_and_metrics(state.params, batch)
        cp = comm_plan(grads)
        grads = reduce_gradients(cp.runtime(), grads, cp, mean=True,
                                 staging=staging, pack=pack,
                                 reduction=reduction)
        return apply_update(state, grads, data_mean(metrics))

    def inner_step_overlap(state: TrainState, batch):
        # the reduces live inside the backward: wait() hands back the
        # already-reduced mean gradients, with no post pass
        cp = comm_plan(state.params)
        metrics, bnd = overlap_grads_and_metrics(state.params, batch, cp)
        return apply_update(state, bnd.wait(), data_mean(metrics))

    def inner_step_zero1(state: TrainState, batch):
        grads, metrics = grads_and_metrics(state.params, batch)
        cp = comm_plan(grads)
        rt = cp.runtime()
        # 1) scatter: each rank receives (and owns) 1/N of every bucket
        shards, _ = reduce_gradients(
            rt, grads, cp, mean=True, staging=staging, pack=pack,
            reduction="reduce_scatter", output="shards", reduce_dtype=wire)
        del grads
        # 2) sharded AdamW, 3) the updated params gathered per bucket
        return zero1_update(state, cp, rt, shards, data_mean(metrics))

    def inner_step_zero1_overlap(state: TrainState, batch):
        # each bucket's reduce_scatter is issued by the backward's hooks;
        # the shard updates and param gathers then run in ready order
        cp = comm_plan(state.params)
        rt = cp.runtime()
        layout = ShardLayout(cp.plan, cp.data_size)
        taps = [torch.zeros((s,), dtype=torch.float32,
                            device=state.step.device)
                for s in layout.shard_sizes]
        metrics, bnd = overlap_grads_and_metrics(state.params, batch, cp,
                                                 taps=taps)
        return zero1_update(state, cp, rt, bnd.wait(), data_mean(metrics),
                            order=cp.ready_order)

    def sharder() -> Sharder:
        n = dist.get_world_size() if dist.is_initialized() else 1
        if built["shard"] is None or built["shard"].size != n:
            built["shard"] = data_sharder(cfg, mesh)
            built["model"] = Model(cfg, built["shard"])
        return built["shard"]

    def gspmd_step(state: TrainState, batch):
        shard = sharder()
        shard.reset_tally()
        paths = [p for p, _ in tree_flatten_with_paths(state.params)]
        for path, leaf in zip(paths, tree_flatten(state.params)[0]):
            if tuple(leaf.shape) != shard.local_shape(path):
                raise ValueError(
                    f"{'/'.join(path)}: {tuple(leaf.shape)} is not this "
                    f"rank's slice {shard.local_shape(path)}; build the "
                    f"state with train_state_init(comm='gspmd') on the same "
                    f"{shard.size} ranks and mesh")
        grads, metrics = grads_and_metrics(state.params, _microbatch_rows(
            batch, state.step.device, shard.n, shard.data_rank, accum_steps))
        sharded = None
        if shard.size > 1:
            # the gradients of the leaves sliced over data came
            # reduce-scattered out of the backward (or, for the experts'
            # tables, summed by the all_to_all's); those whole over data
            # are summed over the data line here, one all-reduce a dtype,
            # and the metrics' shares summed to the global values
            grads = _sum_replicated(
                grads, [shard.sharded_dim(p) is not None for p in paths],
                shard)
            sharded = [shard.split_key(p) for p in paths]
            keys = [k for k in sorted(metrics) if k != "tokens"]
            shares = shard.data_sum_(torch.stack([metrics[k].float()
                                                  for k in keys]))
            metrics = dict(metrics) | {k: shares[i]
                                       for i, k in enumerate(keys)}
        lr = torch.as_tensor(lr_fn(state.step), dtype=torch.float32,
                             device=state.step.device)
        new_p, new_opt, om = adamw_update(
            grads, state.opt, state.params, lr=lr,
            max_grad_norm=max_grad_norm, sharded=sharded,
            psum=shard.norm_sum_)
        comm_tally.clear()
        comm_tally.update(shard.tally)
        metrics = dict(metrics) | om | {"lr": lr}
        return TrainState(new_p, new_opt, state.step + 1), metrics

    comm_tally: Dict[str, int] = {}
    if comm == "gspmd":
        gspmd_step.comm_tally = comm_tally
        gspmd_step.sharder = sharder
        return gspmd_step

    inner = {("replicated", "post"): inner_step,
             ("replicated", "overlap"): inner_step_overlap,
             ("zero1", "post"): inner_step_zero1,
             ("zero1", "overlap"): inner_step_zero1_overlap}[
                 (optimizer, schedule)]

    def step(state: TrainState, batch):
        if not dist.is_initialized():
            raise RuntimeError(
                "comm='vci' trains over torch.distributed's default group; "
                "initialise it first (one rank is a legal group)")
        return inner(state, _rank_slice(batch, state.step.device,
                                        data_line()))

    step.last_issue = last_issue
    return step


def _sum_replicated(grads, sharded, shard: Sharder):
    """The gradients of the leaves that every data rank holds whole (or
    sliced over model only), summed over the data line (one all-reduce of
    their concatenation a dtype); the leaves sliced over data pass
    through."""
    leaves, treedef = tree_flatten(grads)
    by_dtype: Dict[torch.dtype, list] = {}
    for i, (g, s) in enumerate(zip(leaves, sharded)):
        if not s:
            by_dtype.setdefault(g.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = shard.data_sum_(torch.cat([leaves[i].reshape(-1)
                                          for i in idx]))
        for i, part in zip(idx, flat.split([leaves[i].numel()
                                            for i in idx])):
            leaves[i] = part.view_as(leaves[i])
    return tree_unflatten(treedef, leaves)
