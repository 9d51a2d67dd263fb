"""Tensor parallelism's collectives on one line of the mesh, with autograd.

The ``comm="gspmd"`` step on a ``data x model`` mesh computes Megatron
tensor parallelism over the ``model`` axis (the reference leaves it to
XLA). Four collectives carry it, each an autograd function on this rank's
model line (the line's fallback VCI: one communicator for every purpose,
the paper's baseline against the serve path's per-purpose VCIs):

* ``copy`` — identity forward, all-reduce backward: at each
  column-parallel entry (the partial input gradients of the model ranks'
  column slices are summed);
* ``psum`` — all-reduce forward, identity backward: at the row-parallel
  outputs and the vocab-parallel lookup;
* ``all_gather`` — all-gather forward, slice backward: the vocab-sliced
  logits, and the leaves that are sliced over ``model`` but used whole
  (every model rank then computes the same thing, so each holds the whole
  gradient and keeps its slice of it);
* ``gather_sum`` — all-gather forward, reduce-scatter backward: a tensor
  used whole where each model rank computes a different part of its
  gradient (the MoE's experts over ``model``; a tensor-parallel Mamba2
  block's ``in_proj`` and its conv output).

:class:`LineComm` exposes them through the small interface the model
code calls on :class:`repro_torch.serve.comm.ServeComm` (``psum``,
``all_gather``, ``rank``, ``copy``), so the serve sites and the training
sites are one code path.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.core.collectives import _all_gather, _reduce_scatter


def line_gather(x: torch.Tensor, dim: int, n: int, group) -> torch.Tensor:
    """``x``'s slices of every rank of ``group`` (``n`` ranks) joined
    along ``dim`` in rank order, laid out as the whole tensor is."""
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xm.shape[0],) + tuple(xm.shape[1:]),
                      dtype=xm.dtype, device=xm.device)
    _all_gather(out.view(-1), xm.view(-1), group=group)
    return out.movedim(0, dim).contiguous()


def line_scatter(g: torch.Tensor, dim: int, n: int, group) -> torch.Tensor:
    """``g`` summed over ``group``; this rank's ``1/n`` slice along
    ``dim``."""
    gm = g.movedim(dim, 0).contiguous()
    out = torch.empty((gm.shape[0] // n,) + tuple(gm.shape[1:]),
                      dtype=gm.dtype, device=gm.device)
    _reduce_scatter(out.view(-1), gm.view(-1), group=group)
    return out.movedim(0, dim)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm: "LineComm"):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm._all_reduce(g), None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm: "LineComm"):
        return comm._all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, comm: "LineComm", summed: bool):
        ctx.dim, ctx.comm, ctx.summed = dim, comm, summed
        return comm._gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        c, dim = ctx.comm, ctx.dim
        if ctx.summed:
            c._count("reduce_scatter")
            return line_scatter(g, dim, c.size, c.group), None, None, None
        size = g.shape[dim] // c.size
        return g.narrow(dim, c.index * size, size), None, None, None


class LineComm:
    """The collectives of a model line of a ``(data, model)`` mesh:
    ``size`` ranks, this rank at ``index``, on ``group`` (``None``: the
    default group). ``tally`` (shared with the owner) counts each
    collective under ``<line>_<kind>`` (``line`` the line's name,
    ``model`` by default; ``world`` for every rank of the mesh)."""

    def __init__(self, group, size: int, index: int,
                 tally: Optional[Dict[str, int]] = None,
                 line: str = "model"):
        self.group, self.size, self.index = group, size, index
        self.tally = {} if tally is None else tally
        self.line = line

    def _count(self, kind: str) -> None:
        key = f"{self.line}_{kind}"
        self.tally[key] = self.tally.get(key, 0) + 1

    def _all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous().clone()
        dist.all_reduce(x, group=self.group)
        self._count("all_reduce")
        return x

    def _gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        self._count("all_gather")
        return line_gather(x, dim, self.size, self.group)

    # -- the model code's interface (ServeComm's) --------------------------
    def rank(self) -> int:
        return self.index

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """Identity; the backward sums the gradient over the line."""
        return _Copy.apply(x, self)

    def psum(self, x: torch.Tensor, purpose: str = "") -> torch.Tensor:
        """Sum over the line; the backward passes the gradient through."""
        return _Sum.apply(x, self)

    def all_gather(self, x: torch.Tensor, purpose: str = "",
                   gather_axis: int = -1) -> torch.Tensor:
        """The line's slices joined along ``gather_axis``; the backward
        keeps this rank's slice of the gradient."""
        return _Gather.apply(x, gather_axis % x.dim(), self, False)

    def gather_sum(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The line's slices joined along ``dim``; the backward
        reduce-scatters the gradient (each rank computed a part of it)."""
        return _Gather.apply(x, dim % x.dim(), self, True)
