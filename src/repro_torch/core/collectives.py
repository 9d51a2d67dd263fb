"""Stream-tagged collectives: the VCI-aware communication runtime (§4.3).

Port of ``repro.core.collectives`` onto ``torch.distributed``. Every
operation is issued on a :class:`~repro_torch.core.comm.CommContext`; the
runtime

1. *enters* the context's VCI stream — waits on the stream's last
   operation (:meth:`ProgressEngine.enter`),
2. issues the collective asynchronously on the VCI's process group,
3. *completes* — records the returned ``Work`` as the stream's last
   operation, and under ``hybrid`` progress runs a global round every K
   issues.

Each VCI index is its own process group over all ranks of the data group:
its own communicator and, on NCCL, its own CUDA stream, so operations on
different VCIs may run concurrently. VCI 0, the fallback, is the default
(WORLD) group. The groups are created once per process, in VCI-index
order, by every rank (``new_group`` is collective), the first time a
runtime issues an operation.

An operation returns a :class:`Request`; its value may be read only after
:meth:`CommRuntime.wait`. The data group is ``torch.distributed``'s default
group (the reference's ``axis``): collectives over a sub-axis of a larger
mesh come with the tensor-parallel slices.
"""

from __future__ import annotations

import atexit
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.core.comm import CommContext, CommWorld
from repro_torch.core.progress import Pending, ProgressEngine


@dataclass(frozen=True)
class Request:
    """Nonblocking-operation handle (MPI_Request analogue): the result
    tensor, valid once ``op`` has been waited on."""

    value: torch.Tensor
    ctx: CommContext
    op: Pending


# the names of torch >= 2.13 where they exist, the older ones before
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)
_all_gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)

# Process groups of VCIs 1..K-1 for the current default group. Process
# groups are process-wide in torch.distributed, so this registry is too; it
# is rebuilt when the default group changes (destroy + init).
_GROUPS: Dict[str, Any] = {"world": None, "groups": []}


def release_groups() -> None:
    """Drop the registry's process groups, so that the last reference goes
    now and their destructors join the groups' worker threads (the
    destructors run without the GIL). Run at exit, before the interpreter
    finalizes: a gloo worker that releases a finished collective's tensors
    takes the GIL, and one that asks for it once the interpreter is
    finalizing is ended by ``pthread_exit``, whose unwind through a
    ``noexcept`` frame calls ``std::terminate``."""
    _GROUPS["world"], _GROUPS["groups"] = None, []


atexit.register(release_groups)


def vci_group(index: int, num_vcis: int):
    """The process group of VCI ``index`` (``None`` = the default group for
    the fallback VCI 0). Creates every missing group ``1..num_vcis-1``, in
    index order, on first use."""
    if not dist.is_initialized():
        raise RuntimeError("the VCI runtime needs torch.distributed "
                           "initialised (a data group of size >= 1)")
    world = dist.group.WORLD
    if _GROUPS["world"] is not world:
        _GROUPS["world"], _GROUPS["groups"] = world, []
    groups: List[Any] = _GROUPS["groups"]
    ranks = list(range(dist.get_world_size()))
    while len(groups) < num_vcis - 1:
        groups.append(dist.new_group(ranks=ranks))
    return None if index == 0 else groups[index - 1]


def _later(item: str) -> NotImplementedError:
    return NotImplementedError(
        f"CommRuntime.{item} is not ported yet: the paper benchmarks "
        f"(sendrecv/get/put/accumulate) are ROADMAP.md Queue 1 item 6, "
        f"all_to_all comes with MoE (item 9)")


class CommRuntime:
    """Eager communication runtime bound to a CommWorld's contexts."""

    def __init__(self, world: Optional[CommWorld] = None, *,
                 progress: str = "hybrid", join_every: int = 8,
                 token_impl: str = "barrier"):
        self.world = world or CommWorld()
        self.engine = ProgressEngine(mode=progress, join_every=join_every,
                                     token_impl=token_impl)

    @property
    def size(self) -> int:
        """Ranks in the data group."""
        return dist.get_world_size()

    # -- plumbing ------------------------------------------------------
    def _issue(self, ctx: CommContext, value: torch.Tensor, op) -> Request:
        vci = ctx.vci.index
        group = vci_group(vci, self.world.pool.num_vcis)
        self.engine.enter(vci)
        pending = Pending(op(group))
        self.engine.complete(vci, pending)
        return Request(value, ctx, pending)

    def wait(self, req: Request) -> torch.Tensor:
        """MPI_Wait: the operation's result, ordered after it completes."""
        req.op.wait()
        return req.value

    # -- collectives -----------------------------------------------------
    def all_reduce(self, x: torch.Tensor, ctx: CommContext) -> Request:
        """Sum over the data group, IN PLACE on ``x``."""
        return self._issue(ctx, x, lambda g: dist.all_reduce(
            x, group=g, async_op=True))

    def reduce_scatter(self, x: torch.Tensor, ctx: CommContext, *,
                       out: Optional[torch.Tensor] = None) -> Request:
        """Sum over the data group; this rank gets its contiguous
        ``1/size`` slice of the flat ``x`` (tiled, as ``psum_scatter``),
        in ``out`` when given."""
        n = self.size
        if x.numel() % n:
            raise ValueError(f"reduce_scatter of {x.numel()} elements over "
                             f"{n} ranks")
        if out is None:
            out = torch.empty(x.numel() // n, dtype=x.dtype, device=x.device)
        return self._issue(ctx, out, lambda g: _reduce_scatter(
            out, x.reshape(-1), group=g, async_op=True))

    def all_gather(self, x: torch.Tensor, ctx: CommContext, *,
                   out: Optional[torch.Tensor] = None) -> Request:
        """Concatenate every rank's flat ``x`` in rank order (tiled), into
        ``out`` when given."""
        if out is None:
            out = torch.empty(x.numel() * self.size, dtype=x.dtype,
                              device=x.device)
        return self._issue(ctx, out, lambda g: _all_gather(
            out, x.reshape(-1), group=g, async_op=True))

    def sendrecv(self, *a, **kw):
        raise _later("sendrecv")

    def isend_recv(self, *a, **kw):
        raise _later("isend_recv")

    def all_to_all(self, *a, **kw):
        raise _later("all_to_all")

    def get(self, *a, **kw):
        raise _later("get")

    def put(self, *a, **kw):
        raise _later("put")

    def accumulate(self, *a, **kw):
        raise _later("accumulate")

    # -- synchronization ------------------------------------------------
    def barrier(self) -> None:
        """MPI_Barrier-ish: order what follows after ALL streams (global
        progress), counted as the reference counts it."""
        self.engine.global_round()
        self.engine.drain()
