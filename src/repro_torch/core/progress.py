"""Ordering and progress models (paper §4.1, §4.3) on ``torch.distributed``.

Port of ``repro.core.progress``. The reference orders the collectives of a
traced step with *ordering tokens* threaded through
``optimization_barrier``; an eager PyTorch step issues each collective
asynchronously and gets back a ``Work`` handle, so here the "token" of a
stream is the ``Work`` of the last operation issued on it, and chaining an
operation on a token means waiting on that ``Work`` before issuing:

* ``global``   — ONE stream key (:data:`GLOBAL_STREAM`) guards every
                 operation: each issue waits on the previous one, whatever
                 its VCI. Nothing overlaps (the global critical section).
* ``per_vci``  — one key per VCI: an issue waits only on the last operation
                 of its own VCI; different VCIs run concurrently.
* ``hybrid``   — per-VCI keys plus a *global progress round* (wait on every
                 stream's last operation) every ``join_every`` issues.

What a wait costs depends on the backend: NCCL's ``Work.wait()`` makes the
current CUDA stream wait on the collective's stream and returns at once
(no host block, so the step never calls ``torch.cuda.synchronize()``);
gloo's blocks the host until the operation is done.

``issued`` and ``joins`` count exactly as the reference's do, so the
conformance tests compare them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

PROGRESS_MODES = ("global", "per_vci", "hybrid")
TOKEN_IMPLS = ("barrier", "data")

GLOBAL_STREAM = -1  # stream key used by the `global` mode


class Pending:
    """One issued operation's ``torch.distributed`` ``Work``, or a list of
    waitables (the ``Work`` of one batch of point-to-point transfers; a
    stream's earlier last operation and an un-chained one), or ``None``
    for an operation that moved nothing; waited on at most once: gloo's
    ``wait()`` copies the result into the output tensor each time it is
    called, so a second wait would undo in-place work done on the result
    after the first (e.g. the mean's division)."""

    __slots__ = ("work",)

    def __init__(self, work: Any):
        self.work = work

    def wait(self) -> None:
        if self.work is not None:
            for w in (self.work if isinstance(self.work, list)
                      else [self.work]):
                w.wait()
            self.work = None


@dataclass
class ProgressEngine:
    """Per-step bookkeeping of the last operation on each stream.

    ``token_impl`` is accepted for the reference's signature: ``"barrier"``
    and ``"data"`` differ only in how XLA is kept from eliding the
    dependency, which an eager step does not need, so both map to the same
    ``Work`` waits here.
    """

    mode: str = "hybrid"
    join_every: int = 8
    token_impl: str = "barrier"
    _last: Dict[int, Any] = field(default_factory=dict)
    _issued_since_join: int = 0
    issued: int = 0
    joins: int = 0

    def __post_init__(self):
        if self.mode not in PROGRESS_MODES:
            raise ValueError(f"mode {self.mode!r} not in {PROGRESS_MODES}")
        if self.token_impl not in TOKEN_IMPLS:
            raise ValueError(f"token_impl {self.token_impl!r} not in "
                             f"{TOKEN_IMPLS}")

    def _key(self, vci_index: int) -> int:
        return GLOBAL_STREAM if self.mode == "global" else vci_index

    def enter(self, vci_index: int) -> None:
        """Order the next issue on this stream after its last operation
        (lock acquisition)."""
        last = self._last.get(self._key(vci_index))
        if last is not None:
            last.wait()

    def complete(self, vci_index: int, op: Pending, *,
                 chained: bool = True) -> None:
        """Record ``op`` as the stream's last operation (lock release). An
        op issued without :meth:`enter` (``chained=False``) joins the
        stream's earlier last operation instead of replacing it, as the
        reference's token after an un-chained op depends on both."""
        key = self._key(vci_index)
        last = self._last.get(key)
        self._last[key] = op if chained or last is None else \
            Pending([last, op])
        self.issued += 1
        self._issued_since_join += 1
        if self.mode == "hybrid" and self._issued_since_join >= self.join_every:
            self.global_round()

    def global_round(self) -> None:
        """Wait on every live stream's last operation (the hybrid
        global-progress round)."""
        for k in sorted(self._last):
            self._last[k].wait()
        self._issued_since_join = 0
        self.joins += 1

    def drain(self) -> None:
        """Order what follows after ALL outstanding streams (step end). A
        round, counted as the reference counts its drain."""
        if self._last:
            self.global_round()
