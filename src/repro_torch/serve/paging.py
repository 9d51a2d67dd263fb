"""Page allocator for the paged KV cache (serve engine).

Port of ``repro.serve.paging``. State (:class:`PageState`) is two small
int32 tensors:

* ``table`` — ``(B, max_pages)``: slot b's logical page ``p`` lives in pool
  page ``table[b, p]``; ``-1`` means unmapped (reads/writes through an
  unmapped entry are routed to the reserved trash page);
* ``owner`` — ``(num_pages,)``: the slot owning each pool page, ``-1`` free,
  ``OWNER_RESERVED`` never allocatable.

Pool page 0 is the TRASH page. Allocation picks the LOWEST free pool ids,
so the realised mapping is deterministic and equal to the reference's for
the same sequence of calls (the conformance tests pin that).

The operations update the state IN PLACE and return it (plus an ``ok``
flag as a Python bool) where the reference returns new arrays. The engine
keeps this state on the host — it is tiny integer bookkeeping, and the
host needs ``ok`` anyway — and copies the table to the device cache after
each change.

Capacity is the CALLER's contract: the engine reserves worst-case page
spans, so allocation never runs out. On a shortfall the ids that could not
be found are dropped (the reference pads them with ``num_pages`` and lets
the out-of-bounds scatter drop them; PyTorch raises on an out-of-bounds
index, so the port masks them explicitly), the table keeps those entries
unmapped, and ``ok`` is False.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple, Union

import torch

OWNER_FREE = -1
OWNER_RESERVED = -2
TRASH_PAGE = 0


class PageState(NamedTuple):
    """Allocator state; both fields are small int32 tensors."""

    table: torch.Tensor   # (B, max_pages) int32 — pool page id or -1
    owner: torch.Tensor   # (num_pages,) int32 — owning slot, -1 free, -2 reserved


def page_state_init(num_pages: int, batch: int, max_pages: int,
                    device="cpu") -> PageState:
    """Fresh state: everything unmapped, page 0 reserved as trash."""
    if num_pages < 2:
        raise ValueError(f"need >= 2 pages (1 is the trash page), got "
                         f"{num_pages}")
    table = torch.full((batch, max_pages), -1, dtype=torch.int32,
                       device=device)
    owner = torch.full((num_pages,), OWNER_FREE, dtype=torch.int32,
                       device=device)
    owner[TRASH_PAGE] = OWNER_RESERVED
    return PageState(table, owner)


def pages_free(state: PageState) -> int:
    """Allocatable pages remaining."""
    return int((state.owner == OWNER_FREE).sum())


def pages_used(state: PageState) -> int:
    """Pages currently owned by some slot (trash excluded)."""
    return int((state.owner >= 0).sum())


def _take_free(owner: torch.Tensor, n: int) -> Tuple[torch.Tensor, bool]:
    """(ids: (n,) int32, ok). ``ids`` are the lowest free pool pages, padded
    with ``-1`` where fewer than ``n`` are free."""
    free = torch.nonzero(owner == OWNER_FREE).flatten()[:n]
    ids = torch.full((n,), -1, dtype=torch.int32, device=owner.device)
    ids[:free.numel()] = free.to(torch.int32)
    return ids, free.numel() >= n


def _as_index(x: Union[int, Sequence[int], torch.Tensor], device):
    return torch.as_tensor(x, dtype=torch.long, device=device)


def alloc_slot_pages(state: PageState, slot: int, logical
                     ) -> Tuple[PageState, bool]:
    """Map ``len(logical)`` fresh pool pages at ``slot``'s logical indices.

    Returns (state, ok). Used for the initial-prefill and admission-prefill
    ranges. Contract (as in the reference): every ``logical`` entry must
    currently be UNMAPPED for ``slot``.
    """
    logical = _as_index(logical, state.table.device)
    ids, ok = _take_free(state.owner, logical.numel())
    got = ids >= 0
    state.owner[ids[got].long()] = int(slot)
    state.table[int(slot), logical] = ids
    return state, ok


def alloc_step_pages(state: PageState, slots, logical: int
                     ) -> Tuple[PageState, bool]:
    """One page per slot in ``slots`` at the SAME logical index — the decode
    page-boundary allocation (the shared write cursor crosses into logical
    page ``cur // page_size`` for every live slot at once). Same
    unmapped-entry contract as :func:`alloc_slot_pages`."""
    slots = _as_index(slots, state.table.device)
    ids, ok = _take_free(state.owner, slots.numel())
    got = ids >= 0
    state.owner[ids[got].long()] = slots[got].to(torch.int32)
    state.table[slots, int(logical)] = ids
    return state, ok


def free_slot_pages(state: PageState, slot: int) -> PageState:
    """Reclaim every page ``slot`` owns and clear its table row — the
    instant a request finishes, its pages return to the pool."""
    state.owner[state.owner == int(slot)] = OWNER_FREE
    state.table[int(slot)] = -1
    return state


def pages_for_span(start: int, end: int, page_size: int) -> int:
    """Pages covering token positions ``[start, end)`` — the engine's
    reservation unit (worst-case span of one slot)."""
    if end <= start:
        return 0
    return (end - 1) // page_size - start // page_size + 1
