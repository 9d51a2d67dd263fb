"""Serving (PyTorch port): the continuous-batching engine, the page
allocator of the paged KV cache, and the tensor-parallel comm plan."""

from repro_torch.serve.comm import PURPOSES, ServeComm, ServeCommPlan
from repro_torch.serve.engine import (
    Request,
    ServeEngine,
    greedy_sample,
    make_prefill,
    make_serve_step,
    select_tokens,
)
from repro_torch.serve.paging import (
    PageState,
    alloc_slot_pages,
    alloc_step_pages,
    free_slot_pages,
    page_state_init,
    pages_for_span,
)

__all__ = [
    "PURPOSES", "PageState", "Request", "ServeComm", "ServeCommPlan",
    "ServeEngine", "alloc_slot_pages",
    "alloc_step_pages", "free_slot_pages", "greedy_sample", "make_prefill",
    "make_serve_step", "page_state_init", "pages_for_span", "select_tokens",
]
