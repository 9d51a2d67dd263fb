"""AdamW with dtype-configurable moments and global-norm clipping (port of
the replicated half of ``repro.optim.adamw``).

The math is the reference's: float32 arithmetic, b2 = 0.95, decoupled
weight decay on matrices only (``ndim >= 2``), each result cast back to
its tensor's dtype. Unlike the reference's pure function, the update is
done IN PLACE on the params and the moments (the returned trees hold the
same tensors), so a full-width step does not hold a second copy of the
params and moments. The sharded ZeRO-1 layout is ROADMAP.md Queue 1
item 7.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.tree import tree_flatten, tree_leaves, tree_map


class AdamWState(NamedTuple):
    m: Any
    v: Any
    count: torch.Tensor   # int32 scalar


def adamw_init(params, moment_dtype=torch.float32) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
    dev = tree_leaves(params)[0].device
    return AdamWState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                      count=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, summed leaf
    by leaf in the reference's leaf order."""
    leaves = tree_leaves(tree)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for l in leaves:
        total = total + torch.sum(torch.square(l.float()))
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(
    grads,
    state: AdamWState,
    params,
    *,
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    max_grad_norm: Optional[float] = 1.0,
) -> Tuple[Any, AdamWState, dict]:
    """One AdamW step. Writes the new params and moments into ``params``,
    ``state.m`` and ``state.v`` and returns them with the new count."""
    if max_grad_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
    else:
        gnorm = global_norm(grads)
    count = state.count + 1
    cf = count.float()
    c1 = 1.0 - torch.tensor(b1, dtype=torch.float32, device=cf.device) ** cf
    c2 = 1.0 - torch.tensor(b2, dtype=torch.float32, device=cf.device) ** cf
    lr = torch.as_tensor(lr, dtype=torch.float32, device=cf.device)

    flat_g, treedef = tree_flatten(grads)
    flat_m, m_def = tree_flatten(state.m)
    flat_v, v_def = tree_flatten(state.v)
    flat_p, p_def = tree_flatten(params)
    if not treedef == m_def == v_def == p_def:
        raise ValueError("grads, moments and params differ in structure")
    for g, m, v, p in zip(flat_g, flat_m, flat_v, flat_p):
        gf = g.float()
        mf = m.float() * b1 + gf * (1 - b1)
        vf = v.float() * b2 + torch.square(gf) * (1 - b2)
        step = (mf / c1) / (torch.sqrt(vf / c2) + eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            step = step + weight_decay * p.float()
        p.copy_(p.float() - lr * step)
        m.copy_(mf)
        v.copy_(vf)
    return params, AdamWState(state.m, state.v, count), {"grad_norm": gnorm}
