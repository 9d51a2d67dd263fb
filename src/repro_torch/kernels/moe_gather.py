"""Table-driven row gather and its backward: hand-written CUDA kernels +
plain versions.

Port of ``repro.kernels.moe_gather``. The MoE layer moves token rows into
expert-capacity buffers and expert outputs back to tokens by routing tables
(:mod:`repro_torch.models.moe`); each move is ``out[i] = src[idx[i]]`` with
a zero row where ``idx[i] < 0``.

* :func:`row_gather` — the entry point the model calls: the dispatcher op
  ``repro_torch::row_gather`` (``torch.library.custom_op``, with a fake
  for meta tensors and its autograd registered). A CUDA tensor goes to the
  ``sm_90a`` kernel in ``csrc/row_gather.cu`` (which replaces
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
* Its backward, given ``inv``: :func:`row_gather_sum` of the output
  gradient over ``inv``, each source row the sum of its K output rows'
  gradients (the gather-sum kernel, or at K = 1 the gather kernel itself;
  no atomics). Without ``inv`` the backward is the plain scatter-add on a
  CPU tensor and raises on a CUDA tensor. The TPU kernel has no backward:
  the reference differentiates its XLA gathers.
* :func:`row_gather_plain` — one ``index_select`` of the clamped ids and a
  zero-fill of the empty rows (``row_gather_ref`` in the reference); the
  CPU path, and what the kernel is held against on the card.
* :func:`row_gather_sum_plain` — the gather-sum as a gather of the ``T*K``
  rows summed over K in f32.
"""

from __future__ import annotations

from typing import Optional

import torch

# in the order of the gather-sum kernel's dtype codes
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


def _gather(src: torch.Tensor, idx: torch.Tensor,
            inv: Optional[torch.Tensor]) -> torch.Tensor:
    """The forward of :func:`row_gather` on ``src``'s device: the plain
    version on the CPU, the kernel (counted) on a CUDA tensor."""
    if src.device.type == "cpu":
        return row_gather_plain(src, idx)
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


def row_gather_sum_plain(src: torch.Tensor, inv: torch.Tensor, k: int
                         ) -> torch.Tensor:
    """src: (M, d); inv: (T*K,) int row ids (< 0 empty). Returns (T, d):
    ``out[t] = sum_k src[inv[t*K + k]]`` over the entries >= 0 (ids past
    M-1 clamped, as :func:`row_gather_plain` does), summed in f32 and
    rounded once to ``src``'s dtype."""
    t = inv.shape[0] // k
    return row_gather_plain(src, inv).view(t, k, src.shape[1]).float() \
        .sum(1).to(src.dtype)


def row_gather_sum(src: torch.Tensor, inv: torch.Tensor, k: int
                   ) -> torch.Tensor:
    """The gather-sum of :func:`row_gather_sum_plain`: the backward of
    ``row_gather(x, idx, inv)`` given the output gradient ``src``, when
    ``inv`` (``(T*K,)``) is ``idx``'s exact inverse. On a CUDA tensor it
    launches the gather-sum kernel (counted in ``row_gather_sum.launches``)
    or, at ``k == 1``, the gather kernel on ``inv`` (a copy; counted in
    ``row_gather.launches``); on a CPU tensor the plain version."""
    if inv.dim() != 1 or k < 1 or inv.shape[0] % k:
        raise ValueError(f"inv must be (T*K,) with K={k}, got "
                         f"{tuple(inv.shape)}")
    if k == 1:
        return _gather(src, inv, None)
    if src.device.type == "cpu":
        return row_gather_sum_plain(src, inv, k)
    from repro_torch.kernels._build import load
    row_bytes = _check_cuda_args(src, inv)
    out = torch.empty((inv.shape[0] // k, src.shape[1]), dtype=src.dtype,
                      device=src.device)
    if out.numel() == 0:
        return out
    launch = load("row_gather_sum")
    with torch.cuda.device(src.device):
        err = launch(src.data_ptr(), inv.data_ptr(), out.data_ptr(),
                     out.shape[0], src.shape[0], k, row_bytes,
                     _KERNEL_DTYPES.index(src.dtype),
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"row_gather_sum kernel launch failed: CUDA "
                           f"error {err}")
    row_gather_sum.launches += 1
    return out


def _scatter_add_plain(grad: torch.Tensor, idx: torch.Tensor, rows: int
                       ) -> torch.Tensor:
    """The backward of :func:`row_gather_plain` without an inverse table:
    each output row's gradient added into its (clamped) source row, empty
    rows adding nothing. CPU tensors only: the card has no route for it."""
    if grad.device.type != "cpu":
        raise NotImplementedError(
            "row_gather's backward on a CUDA tensor needs the inverse table "
            "of idx (inv=); without it the gradient would be a scatter-add, "
            "which has no kernel here")
    ids = idx.long().clamp(0, rows - 1)
    g = torch.where((idx >= 0)[:, None], grad,
                    torch.zeros((), dtype=grad.dtype))
    return torch.zeros((rows, grad.shape[1]), dtype=grad.dtype).index_add_(
        0, ids, g)


@torch.library.custom_op("repro_torch::row_gather", mutates_args=())
def row_gather_op(src: torch.Tensor, idx: torch.Tensor,
                  inv: Optional[torch.Tensor]) -> torch.Tensor:
    """:func:`row_gather` as one dispatcher op with its autograd."""
    return _gather(src, idx, inv)


@row_gather_op.register_fake
def _row_gather_fake(src, idx, inv):
    return src.new_empty((idx.shape[0], src.shape[1]))


def _row_gather_setup(ctx, inputs, output):
    src, idx, inv = inputs
    ctx.save_for_backward(idx, inv)
    ctx.rows = src.shape[0]


def _row_gather_backward(ctx, grad):
    idx, inv = ctx.saved_tensors
    grad = grad.contiguous()
    if inv is None:
        return _scatter_add_plain(grad, idx, ctx.rows), None, None
    return row_gather_sum(grad, inv, inv.shape[0] // ctx.rows), None, None


row_gather_op.register_autograd(_row_gather_backward,
                                setup_context=_row_gather_setup)


def row_gather(src: torch.Tensor, idx: torch.Tensor,
               inv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[i] = src[idx[i]]``, zeros where ``idx[i] < 0`` (see the module
    doc). On a CUDA tensor this launches the hand-written kernel on the
    current stream and adds one to ``row_gather.launches``; on a CPU tensor
    it runs :func:`row_gather_plain` and counts nothing. ``inv`` (optional,
    see the module doc) must be ``idx``'s exact inverse, else the output
    and the gradient are undefined; the CPU forward ignores it, the
    backward on both devices sums over it. A launch on the read-once route
    also adds one to ``row_gather.read_once_launches``. Differentiable in
    ``src``."""
    if src.device.type not in ("cpu", "cuda"):
        raise ValueError(f"row_gather: unsupported device {src.device}")
    return row_gather_op(src, idx, inv)


row_gather.launches = 0
row_gather.read_once_launches = 0
row_gather_sum.launches = 0
