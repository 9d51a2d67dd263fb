"""Serving (PyTorch port): the continuous-batching engine and the page
allocator of the paged KV cache."""

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
    "PageState", "Request", "ServeEngine", "alloc_slot_pages",
    "alloc_step_pages", "free_slot_pages", "greedy_sample", "make_prefill",
    "make_serve_step", "page_state_init", "pages_for_span", "select_tokens",
]
