"""Table-driven row gather: hand-written CUDA kernel + plain version.

Port of ``repro.kernels.moe_gather``. The MoE layer moves token rows into
expert-capacity buffers and expert outputs back to tokens by routing tables
(:mod:`repro_torch.models.moe`); each move is ``out[i] = src[idx[i]]`` with
a zero row where ``idx[i] < 0``.

* :func:`row_gather` — the entry point the model calls. A CUDA tensor goes
  to the ``sm_90a`` kernel in ``csrc/row_gather.cu`` (which replaces
  ``row_gather_pallas``); a CPU tensor goes to :func:`row_gather_plain`.
  There is no fallback: a CUDA call launches the kernel or raises. Given
  ``inv``, the inverse table of ``idx`` (``(T*K,)`` int32: the K output
  rows each source row goes to, -1 where there is none), the kernel reads
  each source row once and stores it to its slots (the MoE dispatch, where
  ``inv`` is ``dispatch_tables``' ``comb``) when that spares at least
  ``_READ_ONCE_MIN_BYTES`` of reads; otherwise, and without ``inv``, each
  output row reads its source row. Both routes give the same bits when
  ``inv`` is ``idx``'s exact inverse; the kernel cannot check that, and
  with any other table the read-once route's output is undefined (a slot
  no entry names keeps whatever memory held, a slot named for a negative
  ``idx`` is written twice), though it never writes outside ``out``.
* :func:`row_gather_plain` — one ``index_select`` of the clamped ids and a
  zero-fill of the empty rows (``row_gather_ref`` in the reference); the
  CPU path, and what the kernel is held against on the card.

The kernel has no backward: a CUDA tensor that requires grad is refused
(the backward, a scatter-add, comes with the MoE training slice).
"""

from __future__ import annotations

from typing import Optional

import torch

_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# The read-once route spares (K-1) reads of each source row. Below this many
# bytes spared the gather's second reads come from the L2 cache (50 MB on
# an H100) and its blocks, one read and one store each, finish sooner than
# the read-once blocks' one read and K stores (PERF.md §6, row 4).
_READ_ONCE_MIN_BYTES = 16 << 20


def row_gather_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src: (T, d); idx: (M,) int row ids (< 0 empty). Returns (M, d): ids
    clamped to [0, T-1], then rows whose id is negative zero-filled."""
    rows = src.index_select(0, idx.long().clamp(0, src.shape[0] - 1))
    return torch.where((idx >= 0)[:, None], rows,
                       torch.zeros((), dtype=src.dtype, device=src.device))


def _check_cuda_args(src: torch.Tensor, idx: torch.Tensor) -> int:
    """Validate the kernel's inputs; returns the bytes of one row."""
    if src.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"row_gather kernel takes {_KERNEL_DTYPES}, got "
                        f"{src.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if src.dim() != 2 or idx.dim() != 1 or src.shape[0] < 1:
        raise ValueError(f"src must be (T>=1, d) and idx (M,), got "
                         f"{tuple(src.shape)} and {tuple(idx.shape)}")
    if not (src.is_contiguous() and idx.is_contiguous()):
        raise ValueError("src and idx must be contiguous")
    row_bytes = src.shape[1] * src.element_size()
    if row_bytes % 16 or src.data_ptr() % 16:
        raise ValueError(f"a row must be a multiple of 16 bytes at a 16-byte "
                         f"aligned address (row_bytes={row_bytes})")
    if src.requires_grad:
        raise NotImplementedError(
            "row_gather's CUDA kernel has no backward; gradients through the "
            "MoE row moves come with the MoE training slice (ROADMAP.md "
            "Queue 1 item 15)")
    if not (src.is_cuda and idx.device == src.device):
        raise ValueError(f"src and idx must be on one CUDA device, got "
                         f"{src.device} and {idx.device}")
    return row_bytes


def _check_inv(src: torch.Tensor, inv: torch.Tensor) -> int:
    """Validate the inverse table; returns K, the slots a source row has."""
    if inv.dtype != torch.int32:
        raise TypeError(f"inv must be int32, got {inv.dtype}")
    if inv.device != src.device:
        raise ValueError(f"inv must be on {src.device}, got {inv.device}")
    t = src.shape[0]
    if inv.dim() != 1 or inv.numel() < t or inv.numel() % t:
        raise ValueError(f"inv must be (T*K,) with T={t} and K >= 1, got "
                         f"length {tuple(inv.shape)}")
    if not inv.is_contiguous():
        raise ValueError("inv must be contiguous")
    return inv.numel() // t


def _read_once(src: torch.Tensor, k_slots: int) -> bool:
    """Whether a launch given an inverse table takes the read-once route."""
    spared = (k_slots - 1) * src.shape[0] * src.shape[1] * src.element_size()
    return spared >= _READ_ONCE_MIN_BYTES


def row_gather(src: torch.Tensor, idx: torch.Tensor,
               inv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[i] = src[idx[i]]``, zeros where ``idx[i] < 0`` (see the module
    doc). On a CUDA tensor this launches the hand-written kernel on the
    current stream and adds one to ``row_gather.launches``; on a CPU tensor
    it runs :func:`row_gather_plain` and counts nothing. ``inv`` (optional,
    see the module doc) must be ``idx``'s exact inverse, else the output
    is undefined; the CPU route ignores it. A launch on the read-once
    route also adds one to ``row_gather.read_once_launches``."""
    if src.device.type == "cpu":
        return row_gather_plain(src, idx)
    if not src.is_cuda:
        raise ValueError(f"row_gather: unsupported device {src.device}")
    from repro_torch.kernels._build import load
    row_bytes = _check_cuda_args(src, idx)
    k_slots = 0 if inv is None else _check_inv(src, inv)
    if inv is not None and not _read_once(src, k_slots):
        inv = None
    out = torch.empty((idx.shape[0], src.shape[1]), dtype=src.dtype,
                      device=src.device)
    if out.numel() == 0:
        return out
    launch = load("row_gather")
    with torch.cuda.device(src.device):
        err = launch(src.data_ptr(), idx.data_ptr(),
                     None if inv is None else inv.data_ptr(), out.data_ptr(),
                     idx.shape[0], src.shape[0], k_slots, row_bytes,
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"row_gather kernel launch failed: CUDA error "
                           f"{err}")
    row_gather.launches += 1
    if inv is not None:
        row_gather.read_once_launches += 1
    return out


row_gather.launches = 0
row_gather.read_once_launches = 0
