"""Mixture-of-Experts FFN: top-k router + sort-based capacity dispatch.

Port of ``repro.models.moe``, on one device, under the manual-TP serve
path (``comm``, see :func:`_moe_experts_comm`), or on the ``(data,
model)`` ranks of a ``comm="gspmd"`` training step or the serve engine's
GSPMD route (``shard``, see :func:`_experts_shard`).
Per batch row (group) the token->expert assignments are sorted by expert;
each assignment's rank within its expert decides whether it fits the
capacity ``C`` (GShard/Switch dropping). The row moves are two launches of
:func:`repro_torch.kernels.moe_gather.row_gather` a layer:

* *dispatch* — token rows into the capacity buffer ``(E, B*C, d)``, empty
  slots zero (the reference's ``take_along_axis`` of the tokens and its
  scatter into the ``(E*C+1, d)`` buffer, ``moe.py:62,66``, in one gather;
  given ``comb`` as the inverse table, a large dispatch reads each token
  row once for its K slots);
* *combine* — expert outputs back to ``(B, S, K)`` token order, dropped
  assignments zero (``moe.py:135,140``); the gate-weighted sum over ``K``
  replaces the reference's scatter-add.

Both moves carry their table's inverse, so their backwards need no
scatter: the dispatch's is a gather-sum of each token's K slot gradients
over ``comb``, the combine's a gather of each slot's assignment gradient
over ``asg`` (:func:`dispatch_tables`).

The buffer is expert-major, so the expert FFNs are plain ``bmm`` calls on
the ``(E, d, ff)`` weights without a transpose. Aux losses: Switch-style
load balance and the router z-loss, as in the reference.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe_gather import row_gather
from repro_torch.models.layers import act_fn, gated_ffn


def capacity(tokens_per_group: int, num_experts: int, cf: float,
             top_k: int) -> int:
    c = int(math.ceil(tokens_per_group * top_k * cf / num_experts))
    return max(4, c)


def dispatch_tables(eidx: torch.Tensor, num_experts: int, cap: int,
                    assignments: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor,
                               Optional[torch.Tensor]]:
    """Routing tables of the two row moves, built on ``eidx``'s device.

    eidx: (B, S, K) expert of each assignment. Returns ``disp`` (E*B*C,)
    int32 — the token row ``b*S + s`` each capacity slot ``(e, b, c)``
    takes, -1 where the slot stays empty —, ``comb`` (B*S*K,) int32 —
    the capacity slot ``e*B*C + b*C + c`` each assignment reads back, -1
    where it was dropped — and ``asg`` (E*B*C,) int32, ``comb``'s inverse
    — the assignment ``b*S*K + j`` that reads each slot back, -1 where
    none does (``None`` unless ``assignments``: only the combine's
    backward reads it). ``comb >= 0`` is the kept set; ``comb`` is also
    ``disp``'s inverse (a token's K slots)."""
    B, S, K = eidx.shape
    E, C = num_experts, cap
    dev = eidx.device
    eid = eidx.reshape(B, S * K)
    order = torch.argsort(eid, dim=1, stable=True)                  # (B,SK)
    eids = torch.gather(eid, 1, order)
    # one-hot by comparison: F.one_hot may check its input on the host
    onehot = (eids[..., None] == torch.arange(E, device=dev)).int()  # (B,SK,E)
    rank = torch.gather(onehot.cumsum(1) - 1, 2, eids[..., None])[..., 0]
    keep = rank < C
    grp = torch.arange(B, device=dev)[:, None]
    slot = eids * (B * C) + grp * C + rank
    tok = grp * S + order // K
    # dropped assignments all land on one extra slot, cut off below (the
    # reference's drop row); the kept slots are unique
    disp = torch.full((E * B * C + 1,), -1, dtype=torch.int32, device=dev)
    disp.scatter_(0, torch.where(keep, slot, E * B * C).reshape(-1),
                  tok.to(torch.int32).reshape(-1))
    comb = torch.empty((B, S * K), dtype=torch.int32, device=dev)
    comb.scatter_(1, order, torch.where(keep, slot, -1).to(torch.int32))
    if not assignments:
        return disp[:-1], comb.reshape(-1), None
    asg = torch.full((E * B * C + 1,), -1, dtype=torch.int32, device=dev)
    asg.scatter_(0, torch.where(keep, slot, E * B * C).reshape(-1),
                 (grp * (S * K) + order).to(torch.int32).reshape(-1))
    return disp[:-1], comb.reshape(-1), asg[:-1]


def moe_ffn(cfg: ModelConfig, x, p, shard=None, *, inference: bool = False,
            comm=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (y, aux). One group per batch row.

    ``comm`` (a :class:`repro_torch.serve.comm.ServeComm`) selects the
    manual-TP serve path: activations are replicated over the TP axis,
    expert tables arrive expert-parallel (E over the axis) or ff-TP
    sharded, and the combine collective rides the ``moe`` VCI stream.

    ``shard`` (a :class:`repro_torch.dist.sharding.Sharder` on a mesh of
    N data ranks, with or without a model axis): each rank routes its own
    batch rows (a group is one row, so routing and dropping are the
    reference's) and the experts run where the table puts them
    (:func:`_experts_shard`). The aux losses are the global batch's:
    ``me`` and ``ce`` are token means over every data rank's rows (summed
    over the data line, ``me`` with its gradient) before their product,
    and each rank returns its share of each term, ``load_balance / N`` and
    its rows' part of the z-loss mean, so that the shares sum to the
    global values over the data line (the model ranks of a line hold the
    same rows, and the same values)."""
    if shard is not None and comm is not None:
        raise ValueError("moe_ffn takes shard or comm, not both")
    m = cfg.moe
    B, S, d = x.shape
    E, K = m.num_experts, m.top_k
    cf = m.capacity_factor_eval if inference else m.capacity_factor
    C = min(capacity(S, E, cf, K), S)  # C=S is provably drop-free

    logits = (x @ p["router"].to(x.dtype)).float()                 # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort breaks ties by the lower expert index, as
    # jax.lax.top_k does (torch.topk promises no order among equals)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = top[..., :K], idx[..., :K]                       # (B,S,K)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # asg serves only the combine's backward: serving builds no such table
    train = comm is None and torch.is_grad_enabled() and (
        x.requires_grad
        or any(p[k].requires_grad for k in ("w_gate", "w_up", "w_down")))
    disp, comb, asg = dispatch_tables(eidx, E, C, assignments=train)
    if comm is not None:
        out = _moe_experts_comm(cfg, x.reshape(B * S, d), disp, comb, p,
                                comm)
    elif shard is not None and shard.size > 1:
        out = _experts_shard(cfg, x.reshape(B * S, d), disp, comb, p, shard)
    else:
        # comb is disp's inverse: a large dispatch reads each token row once
        buf = row_gather(x.reshape(B * S, d), disp, comb).view(E, B * C, d)
        out = _experts(cfg, buf, p)                                # (E,BC,d)

    # combine: gather each assignment's expert output (a zero row where it
    # was dropped) and sum over K. For top_k = 2 (every MoE config here)
    # this equals the reference's scatter-add bit for bit: 0+a+b = a+b in
    # either order. ys keeps the activation dtype, as there. asg, comb's
    # inverse, makes the backward a gather (each slot read by one
    # assignment)
    ys = row_gather(out.view(E * B * C, d), comb, asg).view(B, S, K, d)
    gate = torch.where(comb.view(B, S, K) >= 0, gates, 0.0)
    y = (ys * gate[..., None].to(ys.dtype)).sum(2)

    routed = eidx[..., None] == torch.arange(E, device=x.device)   # (B,S,K,E)
    z = torch.logsumexp(logits, dim=-1) ** 2
    if shard is not None and shard.n > 1:
        # the global batch's token means, and this rank's share of each term
        tokens = B * S * shard.n
        me = shard.data_sum(probs.sum(dim=(0, 1))) / tokens
        ce = shard.data_sum_(routed.sum(2).float().sum(dim=(0, 1))) / tokens
        load_balance = E * torch.sum(me * ce / K) / shard.n
        z_loss = z.sum() / tokens
    else:
        me = probs.mean(dim=(0, 1))                                # (E,)
        ce = routed.sum(2).float().mean(dim=(0, 1))                # fraction
        load_balance = E * torch.sum(me * ce / K)
        z_loss = torch.mean(z)
    aux = {"load_balance": load_balance, "router_z": z_loss}
    if shard is not None:
        y = shard.hidden(y)

    if m.dense_residual:
        rc = comm
        if shard is not None and shard.model_dim(
                ("layers", "moe", "residual", "w_gate")) is not None:
            rc = shard.tp
        y = y + gated_ffn(cfg, x if rc is None else rc.copy(x),
                          p["residual"], comm=rc)
    return y, aux


def _experts(cfg: ModelConfig, buf, p):
    """The expert FFNs on an expert-major buffer ``(e, rows, d)``."""
    a = act_fn(cfg.hidden_act)
    h = a(torch.bmm(buf, p["w_gate"].to(buf.dtype))) \
        * torch.bmm(buf, p["w_up"].to(buf.dtype))                  # (e,rows,ff)
    return torch.bmm(h, p["w_down"].to(h.dtype))                   # (e,rows,d)


def _experts_shard(cfg: ModelConfig, xf, disp, comb, p, shard):
    """Expert FFNs on a ``(data, model)`` mesh: ``(E, B*C, d)`` of this
    rank's rows, the reference's cases in its order
    (``repro/models/moe.py:73-126``):

    * ``moe_dispatch`` with E dividing the model axis (experts over
      ``model``): the tables are gathered whole (their model slices with a
      reduce-scatter backward: each model rank computes its own experts'
      gradients), each model rank dispatches and runs only its experts'
      slots of its data rank's rows, and the outputs are all-gathered over
      the model line in expert order;
    * E dividing the data axes (expert parallelism): each data rank holds
      ``E/N`` experts (the table's E dim over data, never gathered), the
      dispatch buffer goes to the experts' owners by an all_to_all over
      the data line, each rank runs its own experts on every rank's rows,
      and the outputs come back the same way;
    * otherwise every rank runs every expert on its own rows (the FSDP
      fallback: the tables' d_model dim over data, gathered by the
      block's ``materialize``).

    With a model axis the expert ff dim is tensor-parallel in the last two
    cases (column ``w_gate`` / ``w_up``, row ``w_down``): the buffer
    enters through the model line's ``copy`` and the expert outputs are
    summed over it. The row gathers move the rows on the card either
    way."""
    E = cfg.moe.num_experts
    tp = shard.tp
    tp_n = 1 if tp is None else tp.size
    at = ("layers", "moe")
    rows = disp.shape[0] // E                # B*C slots an expert
    if "moe_dispatch" in cfg.opts and tp_n > 1 and E % tp_n == 0:
        w = {k: p[k] for k in ("w_gate", "w_up", "w_down")}
        if shard.expert_parallel(at + ("w_gate",)):
            w = {k: shard.gather_experts(v) for k, v in w.items()}
        w = shard.model_whole(w, at, summed=True)
        e_loc = E // tp_n
        lo, hi = tp.rank() * e_loc * rows, (tp.rank() + 1) * e_loc * rows
        inv = torch.where((comb >= lo) & (comb < hi), comb - lo, -1).to(
            torch.int32)
        buf = row_gather(tp.copy(xf), disp[lo:hi], inv).view(e_loc, rows, -1)
        w = {k: v[tp.rank() * e_loc:(tp.rank() + 1) * e_loc]
             for k, v in w.items()}
        return tp.all_gather(_experts(cfg, buf, w), "moe", gather_axis=0)
    # comb is disp's inverse: a large dispatch reads each token row once
    buf = row_gather(xf, disp, comb).view(E, rows, -1)
    ep = shard.expert_parallel(at + ("w_gate",))
    if ep:
        buf = shard.all_to_all(buf, to_experts=True)   # (E/N, N*B*C, d)
    ff_tp = tp is not None and shard.model_dim(at + ("w_gate",)) is not None
    if ff_tp:
        buf = tp.copy(buf)
    out = _experts(cfg, buf, p)
    if ff_tp:
        out = tp.psum(out, "moe")
    if ep:
        out = shard.all_to_all(out, to_experts=False)  # (E, B*C, d)
    return out


def _moe_experts_comm(cfg: ModelConfig, xf, disp, comb, p, comm):
    """Expert FFNs under the manual-TP serve path: ``(E, B*C, d)``.

    The token rows ``xf`` are replicated over the TP axis, so the GShard
    dispatch all_to_all degenerates to a local gather: expert-parallel
    (``w_gate`` holds ``E/tp`` experts), the rank dispatches only the slots
    of its own experts — one contiguous range of ``disp``, as the
    reference's ``dynamic_slice`` takes it — computes them, and the
    outputs of every rank are all-gathered on the ``moe`` VCI stream in
    expert order. When the expert count does not divide the axis the
    tables arrive ff-TP sharded instead, every rank runs every expert on a
    slice of its hidden width, and the combine is the partial-sum
    all-reduce, same stream."""
    E = cfg.moe.num_experts
    e_loc = p["w_gate"].shape[0]             # local expert count (E or E/tp)
    rows = disp.shape[0] // E                # B*C slots an expert
    if e_loc == E:
        buf = row_gather(xf, disp, comb).view(E, rows, -1)
        return comm.psum(_experts(cfg, buf, p), "moe")
    lo = comm.rank() * e_loc * rows
    hi = lo + e_loc * rows
    # the local slots' inverse: this rank's part of comb, rebased
    inv = torch.where((comb >= lo) & (comb < hi), comb - lo, -1).to(
        torch.int32)
    buf = row_gather(xf, disp[lo:hi], inv).view(e_loc, rows, -1)
    return comm.all_gather(_experts(cfg, buf, p), "moe", gather_axis=0)
