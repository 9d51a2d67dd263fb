"""Communication contexts — the MPI communicator / window analogue (§2).

A :class:`CommContext` is the *user-visible* handle through which an
application exposes logical communication parallelism, exactly as MPI-3.1
users do with communicators (point-to-point) and windows (RMA):

* two operations on **different** contexts are unordered — the library may
  map them to different VCIs and run them in parallel;
* two operations on the **same** context are FIFO-ordered (MPI's
  nonovertaking rule) — they share the context's VCI and are chained on its
  ordering token;
* a context created with ``vci=``-pinning is the **user-visible endpoint**
  mode: the user addresses the underlying interface directly, bypassing the
  library's mapping. This is the upper bound the paper compares against.

Matching semantics preserved from the standard (§2.1):

* ``kind="p2p"``: receive-side wildcards (``MPI_ANY_SOURCE``) force all
  receives of a communicator through one stream — contexts therefore default
  to ``ordered=True``; ``allow_wildcards=False`` is the MPI-4.0
  ``mpi_assert_no_any_source``-style hint that lets per-*rank* sub-streams
  exist (modelled here as permission to split one context into per-peer
  sub-contexts via :meth:`CommWorld.split`).
* ``kind="rma"``: Put/Get have no matching order; Accumulate is ordered by
  default with ``accumulate_ordering="none"`` available as a relaxation
  (§6.3) — see :meth:`repro.core.collectives.CommRuntime.accumulate`.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.core.vci import VCI, VCIPool


@dataclass(frozen=True)
class CommContext:
    name: str
    vci: VCI
    kind: str = "p2p"                 # "p2p" (communicator) | "rma" (window)
    ordered: bool = True              # FIFO stream (nonovertaking rule)
    accumulate_ordering: str = "rar"  # "rar" (default) | "none" (hint)
    pinned: bool = False              # user-visible-endpoint mode

    def __post_init__(self):
        assert self.kind in ("p2p", "rma")
        assert self.accumulate_ordering in ("rar", "none")


class CommWorld:
    """Host-side registry: context creation/freeing against the VCI pool.

    Mirrors MPI_Comm_create / MPI_Win_create mapping contexts to VCIs at
    creation time (paper §4.2). Built once; the traced step consumes the
    resulting contexts through a :class:`~repro.core.collectives.CommRuntime`.
    """

    def __init__(self, num_vcis: int = 8, policy: str = "fcfs"):
        self.pool = VCIPool(num_vcis=num_vcis, policy=policy)
        self._contexts: Dict[str, CommContext] = {}
        self._uid = itertools.count()
        # COMM_WORLD itself: the fallback VCI's resident context.
        self.world = self._register(
            CommContext("WORLD", VCI(VCIPool.FALLBACK), kind="p2p"))

    # ------------------------------------------------------------------
    def _register(self, ctx: CommContext) -> CommContext:
        self._contexts[ctx.name] = ctx
        return ctx

    def create(
        self,
        name: Optional[str] = None,
        *,
        kind: str = "p2p",
        hint: Optional[str] = None,
        accumulate_ordering: str = "rar",
        vci: Optional[int] = None,
    ) -> CommContext:
        """Create a communicator/window; the library maps it to a VCI.

        ``vci=`` pins the interface explicitly (user-visible endpoints).
        ``hint`` feeds the pool's ``hinted`` policy (§5.2 suggestion).
        """
        name = name or f"ctx{next(self._uid)}"
        if name in self._contexts:
            raise KeyError(f"context {name!r} exists")
        if vci is not None:
            if not (0 <= vci < self.pool.num_vcis):
                raise ValueError(f"vci {vci} outside pool of {self.pool.num_vcis}")
            ctx = CommContext(name, VCI(vci), kind=kind, pinned=True,
                              accumulate_ordering=accumulate_ordering)
            return self._register(ctx)
        v = self.pool.acquire(name, hint=hint)
        return self._register(CommContext(
            name, v, kind=kind, accumulate_ordering=accumulate_ordering))

    def free(self, ctx: CommContext) -> None:
        """MPI_Comm_free / MPI_Win_free: return the VCI to the pool."""
        del self._contexts[ctx.name]
        if not ctx.pinned and ctx.name != "WORLD":
            self.pool.release(ctx.name)

    def split(self, ctx: CommContext, n: int, *, hint: Optional[str] = None
              ) -> List[CommContext]:
        """Split a context into n independent sub-contexts (e.g. per peer,
        legal only under a no-wildcard assertion for p2p)."""
        return [self.create(f"{ctx.name}.{i}", kind=ctx.kind, hint=hint,
                            accumulate_ordering=ctx.accumulate_ordering)
                for i in range(n)]

    # ------------------------------------------------------------------
    def get(self, name: str) -> CommContext:
        return self._contexts[name]

    @property
    def stats(self):
        return self.pool.stats
