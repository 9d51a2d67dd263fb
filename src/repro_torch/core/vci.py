"""Virtual Communication Interfaces (paper §4.2).

A VCI is an abstract, library-internal representation of an independent
communication stream. On the paper's hardware a VCI binds to a NIC context
(OFI endpoint / UCP worker + QP); on TPU/XLA a VCI is an independently
schedulable chain of collective ops — operations on the same VCI are
FIFO-ordered through an *ordering token* (see ``repro.core.progress``),
operations on different VCIs carry no mutual dependency, so XLA may execute
them concurrently and overlap them with compute.

The pool semantics follow the paper exactly:

* the pool holds ``num_vcis`` interfaces (hardware contexts are limited —
  e.g. 160 on Intel OPA; ICI collective channels are bounded by scheduler
  resources);
* every new :class:`~repro.core.comm.CommContext` (communicator/window
  analogue) acquires a VCI at creation time;
* when the pool is exhausted the context falls back to the **fallback VCI**
  (the one owned by COMM_WORLD in the paper) — contexts sharing a VCI share
  its ordering token and therefore serialize, which is precisely the
  "mismatch in expected mapping" effect of Fig. 17;
* freeing a context returns its VCI to the pool.

Assignment policies:

* ``fcfs``        — the paper's first-come-first-served pool.
* ``round_robin`` — CRI-style cycling (Patinyasakdikul et al., compared in
                    §8.2); never exhausts, but may co-locate hot contexts.
* ``hash``        — stateless ``hash(ctx_name) % num_vcis``.
* ``hinted``      — the paper's §5.2 suggestion: the user hints which
                    contexts need dedicated VCIs; hinted contexts get
                    dedicated interfaces first, unhinted ones share the
                    fallback.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

POLICIES = ("fcfs", "round_robin", "hash", "hinted")


@dataclass(frozen=True)
class VCI:
    """One virtual communication interface."""

    index: int

    @property
    def name(self) -> str:
        return f"vci{self.index}"


@dataclass
class VCIStats:
    """Pool accounting.

    ``fallback_hits`` counts only *genuine* fallback events — pool
    exhaustion or an explicit ``hint="shared"`` — not every assignment that
    happens to land on VCI 0 (a ``hash`` policy mapping a context to index 0
    is a normal assignment, not a degradation). ``per_vci_contexts`` tracks
    LIVE contexts: releases decrement it, so ``max_contexts_per_vci``
    reflects the current worst-case sharing, which is what the
    mapping-mismatch benchmark correlates with serialization.
    """

    acquires: int = 0
    fallback_hits: int = 0
    releases: int = 0
    per_vci_contexts: Dict[int, int] = field(default_factory=dict)

    def record(self, idx: int, fallback: bool) -> None:
        self.acquires += 1
        self.fallback_hits += int(fallback)
        self.per_vci_contexts[idx] = self.per_vci_contexts.get(idx, 0) + 1

    def record_release(self, idx: int) -> None:
        self.releases += 1
        live = self.per_vci_contexts.get(idx, 0) - 1
        if live > 0:
            self.per_vci_contexts[idx] = live
        else:
            self.per_vci_contexts.pop(idx, None)

    @property
    def max_contexts_per_vci(self) -> int:
        return max(self.per_vci_contexts.values(), default=0)


class VCIPool:
    """Pool of VCIs inside a single process (paper §4.2, "VCI pool design")."""

    FALLBACK = 0  # the COMM_WORLD VCI

    def __init__(self, num_vcis: int = 8, policy: str = "fcfs"):
        if num_vcis < 1:
            raise ValueError("need at least the fallback VCI")
        if policy not in POLICIES:
            raise ValueError(f"policy {policy!r} not in {POLICIES}")
        self.num_vcis = num_vcis
        self.policy = policy
        self.stats = VCIStats()
        # VCI 0 is the fallback (assigned to COMM_WORLD); it is never free.
        self._free: List[int] = list(range(num_vcis - 1, 0, -1))
        self._assignment: Dict[str, int] = {}
        self._rr_next = 1 if num_vcis > 1 else 0

    # ------------------------------------------------------------------
    def acquire(self, ctx_name: str, hint: Optional[str] = None) -> VCI:
        """Assign a VCI to a newly created context.

        ``hint`` mirrors the paper's proposed info hints: ``"dedicated"``
        requests an exclusive interface (hinted policy), ``"shared"``
        deliberately takes the fallback.
        """
        if ctx_name in self._assignment:
            raise KeyError(f"context {ctx_name!r} already holds a VCI")
        idx, fallback = self._select(ctx_name, hint)
        self._assignment[ctx_name] = idx
        self.stats.record(idx, fallback=fallback)
        return VCI(idx)

    def release(self, ctx_name: str) -> None:
        idx = self._assignment.pop(ctx_name)
        self.stats.record_release(idx)
        if idx != self.FALLBACK and self.policy in ("fcfs", "hinted"):
            self._free.append(idx)

    def lookup(self, ctx_name: str) -> Optional[VCI]:
        idx = self._assignment.get(ctx_name)
        return None if idx is None else VCI(idx)

    @property
    def active(self) -> int:
        return len(self._assignment)

    # ------------------------------------------------------------------
    def _select(self, ctx_name: str, hint: Optional[str]) -> Tuple[int, bool]:
        """Returns ``(index, fallback)``.

        ``fallback`` is True only on a genuine fallback event: explicit
        ``hint="shared"`` or pool exhaustion. A ``hash`` assignment that
        happens to land on index 0 — or a ``hinted``-policy context that
        never asked for a dedicated interface — is a normal assignment and
        must not inflate ``fallback_hits`` (that miscount skewed the
        mapping-mismatch benchmark's exhaustion curve).
        """
        if hint == "shared":
            return self.FALLBACK, True
        if self.num_vcis == 1:
            # only the fallback exists: every assignment shares COMM_WORLD's
            # stream — a genuine (permanent) exhaustion, for EVERY policy
            return self.FALLBACK, True
        if self.policy == "fcfs":
            if self._free:
                return self._free.pop(), False
            return self.FALLBACK, True
        if self.policy == "round_robin":
            idx = self._rr_next
            self._rr_next += 1
            if self._rr_next >= self.num_vcis:
                self._rr_next = 1
            return idx, False
        if self.policy == "hash":
            h = int.from_bytes(
                hashlib.blake2s(ctx_name.encode()).digest()[:4], "little")
            return h % self.num_vcis, False
        if self.policy == "hinted":
            if hint == "dedicated" and self._free:
                return self._free.pop(), False
            if hint == "dedicated":
                return self.FALLBACK, True  # exhausted, same as fcfs
            # unhinted contexts share the fallback by design, not exhaustion
            return self.FALLBACK, False
        raise AssertionError(self.policy)
