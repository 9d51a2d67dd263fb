"""Table-driven row gather: hand-written CUDA kernel + plain version.

Port of ``repro.kernels.moe_gather``. The MoE layer moves token rows into
expert-capacity buffers and expert outputs back to tokens by routing tables
(:mod:`repro_torch.models.moe`); each move is ``out[i] = src[idx[i]]`` with
a zero row where ``idx[i] < 0``.

* :func:`row_gather` — the entry point the model calls. A CUDA tensor goes
  to the ``sm_90a`` kernel in ``csrc/row_gather.cu`` (which replaces
  ``row_gather_pallas``); a CPU tensor goes to :func:`row_gather_plain`.
  There is no fallback: a CUDA call launches the kernel or raises.
* :func:`row_gather_plain` — one ``index_select`` of the clamped ids and a
  zero-fill of the empty rows (``row_gather_ref`` in the reference); the
  CPU path, and what the kernel is held against on the card.

The kernel has no backward: a CUDA tensor that requires grad is refused
(the backward, a scatter-add, comes with the MoE training slice).
"""

from __future__ import annotations

import torch

_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


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


def row_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i] = src[idx[i]]``, zeros where ``idx[i] < 0`` (see the module
    doc). On a CUDA tensor this launches the hand-written kernel on the
    current stream and adds one to ``row_gather.launches``; on a CPU tensor
    it runs :func:`row_gather_plain` and counts nothing."""
    if src.device.type == "cpu":
        return row_gather_plain(src, idx)
    if not src.is_cuda:
        raise ValueError(f"row_gather: unsupported device {src.device}")
    from repro_torch.kernels._build import load
    row_bytes = _check_cuda_args(src, idx)
    out = torch.empty((idx.shape[0], src.shape[1]), dtype=src.dtype,
                      device=src.device)
    if out.numel() == 0:
        return out
    launch = load("row_gather")
    with torch.cuda.device(src.device):
        err = launch(src.data_ptr(), idx.data_ptr(), out.data_ptr(),
                     idx.shape[0], src.shape[0], row_bytes,
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"row_gather kernel launch failed: CUDA error "
                           f"{err}")
    row_gather.launches += 1
    return out


row_gather.launches = 0
