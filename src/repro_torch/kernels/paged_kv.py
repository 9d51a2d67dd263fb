"""Paged KV-cache page gather: hand-written CUDA kernel + plain version.

Port of ``repro.kernels.paged_kv``. The paged serve cache keeps K/V in a
pool of fixed-size pages ``(NP, PS, KV, hd)`` per layer with a per-slot
page table; decode attention needs each slot's pages in sequence order.

* :func:`paged_gather` — the entry point the model calls. A CUDA tensor
  goes to the ``sm_90a`` kernel in ``csrc/paged_gather.cu`` (which replaces
  ``paged_gather_pallas``); a CPU tensor goes to :func:`paged_gather_plain`.
  There is no fallback: a CUDA call launches the kernel or raises.
* :func:`paged_gather_plain` — one ``index_select`` of the clipped ids and
  an unmapped-page mask (``paged_gather_take`` in the reference); the CPU
  path, and what the kernel is held against on the card. A
  ``float8_e4m3fn`` pool (a ``kv_fp8`` cache) is gathered through its
  ``uint8`` view: the op moves bytes, and the view needs no fp8 kernel of
  ``index_select`` or ``where`` on either device.
"""

from __future__ import annotations

import torch

_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16,
                  torch.float8_e4m3fn)


def paged_gather_plain(pool: torch.Tensor, table: torch.Tensor
                       ) -> torch.Tensor:
    """pool: (NP, PS, KV, hd); table: (B, MAXP) int pool page ids (< 0
    unmapped). Returns (B, MAXP*PS, KV, hd): ids clipped to [0, NP-1], then
    pages whose table entry is negative zero-filled."""
    if pool.dtype == torch.float8_e4m3fn:   # zero bytes are +0.0 there
        return paged_gather_plain(pool.view(torch.uint8), table).view(
            pool.dtype)
    b, maxp = table.shape
    ps = pool.shape[1]
    ids = table.long().clamp(0, pool.shape[0] - 1).reshape(-1)
    pages = pool.index_select(0, ids).reshape((b, maxp) + pool.shape[1:])
    mapped = (table >= 0).reshape(b, maxp, 1, 1, 1)
    pages = torch.where(mapped, pages, torch.zeros((), dtype=pool.dtype,
                                                   device=pool.device))
    return pages.reshape((b, maxp * ps) + pool.shape[2:])


def _check_cuda_args(pool: torch.Tensor, table: torch.Tensor) -> int:
    """Validate the kernel's inputs; returns the bytes of one page."""
    if not table.is_cuda or table.device != pool.device:
        raise ValueError(f"table must be on {pool.device}, got {table.device}")
    if pool.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"paged_gather kernel takes {_KERNEL_DTYPES}, got "
                        f"{pool.dtype}")
    if table.dtype != torch.int32:
        raise TypeError(f"table must be int32, got {table.dtype}")
    if pool.dim() != 4 or table.dim() != 2 or pool.shape[0] < 1:
        raise ValueError(f"pool must be (NP>=1,PS,KV,hd) and table (B,MAXP), "
                         f"got {tuple(pool.shape)} and {tuple(table.shape)}")
    if not (pool.is_contiguous() and table.is_contiguous()):
        raise ValueError("pool and table must be contiguous")
    page_bytes = pool.numel() // pool.shape[0] * pool.element_size()
    if page_bytes % 16 or pool.data_ptr() % 16:
        raise ValueError(f"a page must be a multiple of 16 bytes at a 16-byte "
                         f"aligned address (page_bytes={page_bytes})")
    return page_bytes


def paged_gather(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Gather each slot's pages into sequence order (see the module doc).

    On a CUDA tensor this launches the hand-written kernel on the current
    stream and adds one to ``paged_gather.launches``; on a CPU tensor it
    runs :func:`paged_gather_plain` and counts nothing."""
    if pool.device.type == "cpu":
        return paged_gather_plain(pool, table)
    if not pool.is_cuda:
        raise ValueError(f"paged_gather: unsupported device {pool.device}")
    from repro_torch.kernels._build import load
    page_bytes = _check_cuda_args(pool, table)
    b, maxp = table.shape
    out = torch.empty((b, maxp * pool.shape[1]) + tuple(pool.shape[2:]),
                      dtype=pool.dtype, device=pool.device)
    if out.numel() == 0:
        return out
    launch = load("paged_gather")
    with torch.cuda.device(pool.device):
        err = launch(pool.data_ptr(), table.data_ptr(), out.data_ptr(),
                     b * maxp, pool.shape[0], page_bytes,
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_gather kernel launch failed: CUDA error "
                           f"{err}")
    paged_gather.launches += 1
    return out


paged_gather.launches = 0
