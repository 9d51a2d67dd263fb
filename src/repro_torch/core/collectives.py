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

A runtime given a :class:`RankMesh` (the ranks as a row-major ``(data,
model)`` grid, the reference's ``Mesh(devs.reshape(n // tp, tp), ("data",
"model"))``, or ``(pod, data, model)``, whose data lines span ``pod x
data``) also issues over one axis of it (the reference's ``axis=``):
for each VCI index there is one group per line of the grid along that
axis, VCI 0 included, and each rank keeps the group of its own line.

An operation returns a :class:`Request`; its value may be read only after
:meth:`CommRuntime.wait` (``sendrecv`` waits itself, as MPI_Sendrecv).
Without ``axis`` the group is the runtime's data group:
``torch.distributed``'s default group, or, for a runtime made with
``data_axis="data"`` on a mesh with a model axis, this rank's data line
(the training path's buckets, which reduce over the data ranks only).

The point-to-point and window half (``sendrecv``/``isend_recv``,
``get``/``put``: ``lax.ppermute`` as one ``batch_isend_irecv``;
``accumulate``: an all-reduce; ``flush``) follows the reference's ordering
rules: get/put are chained on the stream only on an ``ordered`` window,
an accumulate only without the ``accumulate_ordering="none"`` hint; an
un-chained issue is still recorded on its stream and counted.

Ranks that share a card (NCCL refuses two ranks on one device) issue
these collectives on CUDA tensors through gloo; a collective gloo refuses
raises.
"""

from __future__ import annotations

import atexit
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.comm import CommContext, CommWorld
from repro_torch.core.progress import Pending, ProgressEngine


@dataclass(frozen=True)
class Request:
    """Nonblocking-operation handle (MPI_Request analogue): the result
    tensor, valid once ``op`` has been waited on and ``finish`` (a
    re-layout) has run on it."""

    value: torch.Tensor
    ctx: CommContext
    op: Pending
    finish: Optional[Callable[[], torch.Tensor]] = None


class RankMesh:
    """The ranks of the default group as a row-major grid: ``RankMesh(data,
    model)`` (the reference's ``("data", "model")`` mesh) or
    ``RankMesh(pod, data, model)`` (its ``("pod", "data", "model")``
    mesh). Every axis but ``model`` is data-parallel, so the data line of
    a rank is the ``pod x data`` ranks that share its model coordinate, as
    the reference's ``data_axes`` is ``("pod", "data")``: rank ``r`` sits
    at ``(r // model, r % model)`` of its ``(data line, model line)``, and
    ``2 x 1 x 2`` has the lines of ``2 x 2``."""

    def __init__(self, *dims: int):
        if len(dims) not in (2, 3):
            raise ValueError(f"a RankMesh is (data, model) or (pod, data, "
                             f"model), got {dims}")
        if min(dims) < 1:
            raise ValueError(f"mesh axes must be >= 1, got {dims}")
        self.dims = tuple(int(d) for d in dims)
        self.axis_names = (("pod",) if len(dims) == 3 else ()) + \
            ("data", "model")
        self.pod = self.dims[0] if len(dims) == 3 else 1
        self.data, self.model = self.dims[-2:]

    def __eq__(self, other) -> bool:
        return isinstance(other, RankMesh) and other.dims == self.dims

    def __hash__(self) -> int:
        return hash(self.dims)

    def __repr__(self) -> str:
        return f"RankMesh{self.dims}"

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return self.pod * self.data * self.model

    @property
    def data_size(self) -> int:
        """Ranks on a data line: ``pod x data``."""
        return self.pod * self.data

    def coords(self, rank: int) -> Tuple[int, int]:
        """``(index on the data line, index on the model line)``."""
        return divmod(rank, self.model)

    def lines(self, axis: str) -> List[List[int]]:
        """Every line of the grid along ``axis`` (``"data"``: the ``pod x
        data`` ranks of one model coordinate), as ascending rank lists
        (group rank = index along the line), in one order for all
        ranks."""
        if axis == "model":
            return [[d * self.model + m for m in range(self.model)]
                    for d in range(self.data_size)]
        if axis == "data":
            return [[d * self.model + m for d in range(self.data_size)]
                    for m in range(self.model)]
        raise ValueError(f"axis {axis!r} not in ('data', 'model')")


# the names of torch >= 2.13 where they exist, the older ones before
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)
_all_gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)

# Process groups of VCIs 1..K-1 for the current default group, and of
# VCIs 0..K-1 along each mesh axis ("axes": (data, model, axis) -> this
# rank's group of each VCI). Process groups are process-wide in
# torch.distributed, so this registry is too; it is rebuilt when the
# default group changes (destroy + init).
_GROUPS: Dict[str, Any] = {"world": None, "groups": [], "axes": {}}


def release_groups() -> None:
    """Drop the registry's process groups, so that the last reference goes
    now and their destructors join the groups' worker threads (the
    destructors run without the GIL). Run at exit, before the interpreter
    finalizes: a gloo worker that releases a finished collective's tensors
    takes the GIL, and one that asks for it once the interpreter is
    finalizing is ended by ``pthread_exit``, whose unwind through a
    ``noexcept`` frame calls ``std::terminate``."""
    _GROUPS["world"], _GROUPS["groups"], _GROUPS["axes"] = None, [], {}


atexit.register(release_groups)


def _registry() -> Dict[str, Any]:
    if not dist.is_initialized():
        raise RuntimeError("the VCI runtime needs torch.distributed "
                           "initialised (a data group of size >= 1)")
    world = dist.group.WORLD
    if _GROUPS["world"] is not world:
        _GROUPS["world"], _GROUPS["groups"], _GROUPS["axes"] = world, [], {}
    return _GROUPS


def vci_group(index: int, num_vcis: int, axis: Optional[str] = None,
              mesh: Optional[RankMesh] = None):
    """The process group of VCI ``index``. Without ``axis``: over every
    rank, ``None`` (the default group) for the fallback VCI 0; creates
    every missing group ``1..num_vcis-1``, in index order, on first use.
    With ``axis``: this rank's line of ``mesh`` along it; creates the
    missing groups of VCIs ``0..index``, one a line, in VCI then line
    order (every rank creates every line's group: ``new_group`` is
    collective, so every rank must ask in the same order)."""
    reg = _registry()
    if axis is None:
        groups: List[Any] = reg["groups"]
        ranks = list(range(dist.get_world_size()))
        while len(groups) < num_vcis - 1:
            groups.append(dist.new_group(ranks=ranks))
        return None if index == 0 else groups[index - 1]
    if mesh is None or mesh.size != dist.get_world_size():
        raise ValueError(f"axis {axis!r} needs a RankMesh over the "
                         f"{dist.get_world_size()} ranks, got {mesh}")
    mine = reg["axes"].setdefault((mesh.data_size, mesh.model, axis),
                                   [])
    rank = dist.get_rank()
    if not 0 <= index < num_vcis:
        raise ValueError(f"VCI {index} outside a pool of {num_vcis}")
    while len(mine) <= index:
        for line in mesh.lines(axis):
            g = dist.new_group(ranks=line)
            if rank in line:
                mine.append(g)
    return mine[index]


def _cuda_backend(group) -> str:
    """The backend ``group`` runs CUDA tensors on (``"gloo"`` for a gloo
    group, ``"nccl"`` for ``"cpu:gloo,cuda:nccl"``)."""
    for part in str(dist.get_backend(group)).split(","):
        dev, _, name = part.rpartition(":")
        if dev in ("", "cuda"):
            return name
    return ""


class CommRuntime:
    """Eager communication runtime bound to a CommWorld's contexts; with a
    :class:`RankMesh`, collectives may also run over one of its axes."""

    def __init__(self, world: Optional[CommWorld] = None, *,
                 progress: str = "hybrid", join_every: int = 8,
                 token_impl: str = "barrier",
                 mesh: Optional[RankMesh] = None,
                 data_axis: Optional[str] = None):
        self.world = world or CommWorld()
        self.mesh = mesh
        if data_axis is not None and mesh is None:
            raise ValueError(f"data_axis={data_axis!r} needs a RankMesh")
        self.data_axis = data_axis
        self.engine = ProgressEngine(mode=progress, join_every=join_every,
                                     token_impl=token_impl)

    @property
    def size(self) -> int:
        """Ranks in the data group."""
        if self.data_axis is not None:
            return self.mesh.shape[self.data_axis]
        return dist.get_world_size()

    def axis_size(self, axis: Optional[str] = None) -> int:
        """Ranks in a group along ``axis`` (``None``: the data group)."""
        return self.size if axis is None else self.mesh.shape[axis]

    # -- plumbing ------------------------------------------------------
    def _issue(self, ctx: CommContext, src: torch.Tensor,
               value: torch.Tensor, op, axis: Optional[str] = None,
               finish=None, *, chain: bool = True) -> Request:
        """Issue ``op`` (reading ``src``, its result in ``value``) on the
        context's VCI stream."""
        vci = ctx.vci.index
        group = vci_group(vci, self.world.pool.num_vcis,
                          axis or self.data_axis, self.mesh)
        if chain:
            self.engine.enter(vci)
        pending = Pending(op(group))
        self.engine.complete(vci, pending, chained=chain, reads=(src,),
                             writes=(value,))
        return Request(value, ctx, pending, finish)

    def _axis_rank(self, axis: Optional[str]) -> int:
        """This rank's index in its group along ``axis``."""
        rank = dist.get_rank()
        axis = axis or self.data_axis
        if axis is None:
            return rank
        return self.mesh.coords(rank)[0 if axis == "data" else 1]

    def _permute(self, x: torch.Tensor, ctx: CommContext,
                 perm: Sequence[Tuple[int, int]], axis: Optional[str],
                 chain: bool = True) -> Request:
        """``lax.ppermute``: every ``(src, dst)`` of ``perm`` (indices
        along ``axis``) ships src's ``x`` to dst; a rank that no pair
        sends to receives zeros. One ``batch_isend_irecv`` on the
        context's VCI group; a pair ``(r, r)`` is a local copy."""
        n = self.axis_size(axis)
        perm = [(int(a), int(b)) for a, b in perm]
        srcs, dsts = [a for a, _ in perm], [b for _, b in perm]
        if len(set(srcs)) < len(srcs) or len(set(dsts)) < len(dsts) or \
                not all(0 <= i < n for i in srcs + dsts):
            raise ValueError(f"perm {perm} is not a partial permutation of "
                             f"range({n})")
        me = self._axis_rank(axis)
        if x.is_cuda and _cuda_backend(vci_group(
                ctx.vci.index, self.world.pool.num_vcis,
                axis or self.data_axis, self.mesh)) == "gloo":
            raise RuntimeError(
                "gloo sends no CUDA tensor point to point (its TCP "
                "transport writes the device pointer and aborts the rank); "
                "run the p2p and window ops on NCCL, a card a rank, or on "
                "CPU tensors")
        x = x.contiguous()
        out = torch.zeros_like(x)
        to = next((b for a, b in perm if a == me), None)
        frm = next((a for a, b in perm if b == me), None)

        def op(group):
            def peer(i):
                return i if group is None else dist.get_global_rank(group, i)
            ops = []
            if to is not None and to != me:
                ops.append(dist.P2POp(dist.isend, x, peer(to), group=group))
            if frm is not None and frm != me:
                ops.append(dist.P2POp(dist.irecv, out, peer(frm),
                                      group=group))
            if to == me:
                out.copy_(x)
            return dist.batch_isend_irecv(ops) if ops else None

        return self._issue(ctx, x, out, op, axis, chain=chain)

    def wait(self, req: Request) -> torch.Tensor:
        """MPI_Wait: the operation's result, ordered after it completes."""
        req.op.wait()
        return req.value if req.finish is None else req.finish()

    # -- collectives -----------------------------------------------------
    def all_reduce(self, x: torch.Tensor, ctx: CommContext, *,
                   axis: Optional[str] = None) -> Request:
        """Sum over the group along ``axis``, IN PLACE on ``x``."""
        return self._issue(ctx, x, x, lambda g: dist.all_reduce(
            x, group=g, async_op=True), axis)

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
        return self._issue(ctx, x, out, lambda g: _reduce_scatter(
            out, x.reshape(-1), group=g, async_op=True))

    def all_gather(self, x: torch.Tensor, ctx: CommContext, *,
                   out: Optional[torch.Tensor] = None,
                   axis: Optional[str] = None) -> Request:
        """Concatenate every rank's flat ``x`` in rank order along
        ``axis`` (tiled), into ``out`` when given."""
        if out is None:
            out = torch.empty(x.numel() * self.axis_size(axis),
                              dtype=x.dtype, device=x.device)
        flat = x.reshape(-1)
        return self._issue(ctx, x, out, lambda g: _all_gather(
            out, flat, group=g, async_op=True), axis)

    def all_to_all(self, x: torch.Tensor, ctx: CommContext, *,
                   split_axis: int, concat_axis: int,
                   axis: Optional[str] = None) -> Request:
        """``lax.all_to_all(tiled=True)``: ``x`` splits into ``n`` equal
        blocks along ``split_axis``; block ``j`` goes to rank ``j`` of the
        group along ``axis``, and the blocks received are concatenated in
        source-rank order along ``concat_axis``."""
        n = self.axis_size(axis)
        split_axis %= x.dim()
        concat_axis %= x.dim()
        if x.shape[split_axis] % n:
            raise ValueError(f"all_to_all splits dim {split_axis} of "
                             f"{tuple(x.shape)} over {n} ranks")
        send = x.movedim(split_axis, 0).contiguous()
        recv = torch.empty_like(send)

        def blocks():
            parts = recv.view((n, -1) + tuple(send.shape[1:]))
            return torch.cat([p.movedim(0, split_axis) for p in parts],
                             dim=concat_axis)

        return self._issue(ctx, send, recv,
                           lambda g: dist.all_to_all_single(
                               recv, send, group=g, async_op=True),
                           axis, blocks)

    # -- two-sided (communicator) ops ------------------------------------
    def isend_recv(self, x: torch.Tensor, ctx: CommContext, *,
                   perm: Sequence[Tuple[int, int]],
                   axis: Optional[str] = None) -> Request:
        """Pairwise exchange (an Isend/Irecv pair) along ``axis``: each
        ``(src, dst)`` of ``perm`` ships src's ``x`` to dst; a rank no pair
        sends to receives zeros (``lax.ppermute``)."""
        return self._permute(x, ctx, perm, axis)

    def sendrecv(self, x: torch.Tensor, ctx: CommContext, *,
                 perm: Sequence[Tuple[int, int]],
                 axis: Optional[str] = None) -> torch.Tensor:
        """:meth:`isend_recv`, waited: the received tensor."""
        return self.wait(self.isend_recv(x, ctx, perm=perm, axis=axis))

    # -- one-sided (window) ops ------------------------------------------
    def get(self, x: torch.Tensor, ctx: CommContext, *,
            perm: Sequence[Tuple[int, int]],
            axis: Optional[str] = None) -> Request:
        """MPI_Get analogue: fetch the owner's ``x`` (each ``(src, dst)``
        ships src's ``x`` to dst). Get/Put carry no matching order, so a
        window that is not ``ordered`` issues them un-chained."""
        if ctx.kind != "rma":
            raise ValueError("get() requires an rma context (window)")
        return self._permute(x, ctx, perm, axis, chain=ctx.ordered)

    def put(self, x: torch.Tensor, ctx: CommContext, *,
            perm: Sequence[Tuple[int, int]],
            axis: Optional[str] = None) -> Request:
        """MPI_Put analogue: the same exchange as :meth:`get`."""
        if ctx.kind != "rma":
            raise ValueError("put() requires an rma context (window)")
        return self._permute(x, ctx, perm, axis, chain=ctx.ordered)

    def accumulate(self, x: torch.Tensor, ctx: CommContext, *,
                   axis: Optional[str] = None) -> Request:
        """MPI_Accumulate analogue: the sum over the group along ``axis``,
        into a copy of ``x``. By default (``"rar"``) accumulates are
        chained on the window's stream (MPI-3.1's program order for
        same-source accumulates, §2.2); with ``accumulate_ordering="none"``
        (the §6.3 hint) each is issued without waiting on the stream, and
        still recorded on it."""
        if ctx.kind != "rma":
            raise ValueError("accumulate() requires an rma context (window)")
        buf = x.clone()
        return self._issue(ctx, x, buf, lambda g: dist.all_reduce(
            buf, group=g, async_op=True), axis,
            chain=ctx.accumulate_ordering != "none")

    # -- synchronization ------------------------------------------------
    def flush(self, ctx: CommContext) -> None:
        """MPI_Win_flush: wait on the window's stream (its VCI's last
        operation, and those joined to it). Other streams are not waited
        on, so under ``per_vci`` progress this is as starvation-prone as
        the paper warns (Fig. 9); ``hybrid`` progress's rounds wait on
        every stream. Not counted as an issue, as in the reference."""
        self.engine.enter(ctx.vci.index)

    def barrier(self) -> None:
        """MPI_Barrier-ish: order what follows after ALL streams (global
        progress), counted as the reference counts it."""
        self.engine.global_round()
        self.engine.drain()
