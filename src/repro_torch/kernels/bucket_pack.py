"""Gradient-bucket pack/unpack: hand-written CUDA kernel + plain version.

Port of ``repro.kernels.bucket_pack``. The ``pack="pallas"`` gradient path
lays every gradient leaf into one flat, tile-aligned f32 *arena*
(:func:`arena_from_leaves`), packs each bucket's send buffer from it with a
table-driven tile gather, and after the reduction unpacks the reduced
buckets back into arena layout with the same gather and other tables.

* :func:`bucket_pack` / :func:`bucket_unpack` — the entry points. A CUDA
  tensor goes to the ``sm_90a`` kernel in ``csrc/bucket_pack.cu`` (which
  replaces ``bucket_pack_pallas`` and ``bucket_unpack_pallas``); a CPU
  tensor goes to the plain version. There is no fallback: a CUDA call
  launches the kernel or raises. Launches are counted on
  ``bucket_pack.launches`` and ``bucket_unpack.launches``.
* :func:`bucket_pack_plain` / :func:`bucket_unpack_plain` — one row
  ``index_select`` over the ``(n_tiles, tile)`` view plus a lane mask
  (``bucket_pack_gather`` in the reference); the CPU path, and what the
  kernel is held against on the card.
* :func:`build_tile_tables`, :func:`arena_layout` — the host-side numpy
  tables, equal to the reference's (``build_tile_tables`` is vectorised:
  at full olmo-1b width it covers ~1.15 M tiles).

Layout contract: segments sit at TILE-aligned offsets in both the source
and the destination, so destination tile ``t`` is source tile ``block[t]``
with lanes ``>= valid[t]`` zeroed.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

TILE = 8 * 128
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def build_tile_tables(src_off, dst_off, sizes, padded_size: int,
                      tile: int = TILE) -> Tuple[np.ndarray, np.ndarray]:
    """Per-destination-tile (source block index, valid count), both
    ``int32[padded_size // tile]``. ``src_off``/``dst_off`` must be
    tile-aligned. Tiles no segment covers get block 0, valid 0."""
    if padded_size % tile:
        raise ValueError(f"padded_size {padded_size} is not a multiple of "
                         f"tile {tile}")
    src_off = np.asarray(src_off, np.int64).reshape(-1)
    dst_off = np.asarray(dst_off, np.int64).reshape(-1)
    sizes = np.asarray(sizes, np.int64).reshape(-1)
    if (src_off % tile).any() or (dst_off % tile).any():
        raise ValueError("segments must be tile-aligned")
    n_tiles = padded_size // tile
    block = np.zeros((n_tiles,), np.int32)
    valid = np.zeros((n_tiles,), np.int32)
    order = np.argsort(dst_off)
    counts = (-(-sizes // tile))[order]          # tiles of each segment
    seg = np.repeat(order, counts)               # segment of each tile
    k = np.arange(seg.size) - np.repeat(np.cumsum(counts) - counts, counts)
    t = dst_off[seg] // tile + k
    block[t] = src_off[seg] // tile + k
    valid[t] = np.minimum(tile, sizes[seg] - k * tile)
    return block, valid


def arena_layout(sizes: Sequence[int], tile: int = TILE
                 ) -> Tuple[np.ndarray, int]:
    """Each leaf (by flat ``sizes``) at the next tile-aligned offset.
    Returns (offsets: int64[n], total arena size)."""
    offs = np.zeros((len(sizes),), np.int64)
    cur = 0
    for i, sz in enumerate(sizes):
        offs[i] = cur
        cur += -(-int(sz) // tile) * tile
    return offs, max(int(cur), tile)


def arena_from_leaves(leaves, tile: int = TILE, dtype=None
                      ) -> Tuple[torch.Tensor, np.ndarray]:
    """Lay leaves into a tile-aligned flat arena (zeros between segments);
    returns (arena, offsets). One copy per leaf into a buffer allocated
    once, cast to ``dtype`` when given."""
    leaves = list(leaves)
    offs, total = arena_layout([l.numel() for l in leaves], tile)
    dev = leaves[0].device if leaves else torch.device("cpu")
    dt = dtype if dtype is not None else (leaves[0].dtype if leaves
                                          else torch.float32)
    arena = torch.empty((total,), dtype=dt, device=dev)
    end = 0
    for leaf, off in zip(leaves, offs.tolist()):
        n = leaf.numel()
        arena[off:off + n].copy_(leaf.reshape(-1))
        end = off + -(-n // tile) * tile
        arena[off + n:end].zero_()
    arena[end:].zero_()
    return arena, offs


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def bucket_pack_plain(src: torch.Tensor, block: torch.Tensor,
                      valid: torch.Tensor, padded_size: int, *,
                      tile: int = TILE) -> torch.Tensor:
    """One row gather of the source's tiles plus a tail mask: out tile
    ``t`` = ``src`` tile ``block[t]``, lanes ``>= valid[t]`` zeroed."""
    _check_sizes(src, padded_size, tile)
    tiles = src.reshape(-1, tile).index_select(0, block.long())
    lane = torch.arange(tile, device=src.device)[None, :]
    tiles = torch.where(lane < valid.long()[:, None], tiles,
                        torch.zeros((), dtype=src.dtype, device=src.device))
    return tiles.reshape(padded_size)


def bucket_unpack_plain(packed: torch.Tensor, block: torch.Tensor,
                        valid: torch.Tensor, out_size: int, *,
                        tile: int = TILE) -> torch.Tensor:
    """Plain unpack: the same gather with the unpack tables."""
    return bucket_pack_plain(packed, block, valid, out_size, tile=tile)


# ---------------------------------------------------------------------------
# the kernel's wrappers
# ---------------------------------------------------------------------------

def _check_sizes(src: torch.Tensor, padded_size: int, tile: int) -> None:
    if src.dim() != 1:
        raise ValueError(f"source must be flat, got {tuple(src.shape)}")
    if padded_size % tile or src.numel() % tile:
        raise ValueError(f"padded_size {padded_size} and source size "
                         f"{src.numel()} must be multiples of tile {tile}")


def _check_cuda_args(src, block, valid, padded_size, tile, out):
    _check_sizes(src, padded_size, tile)
    if src.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"bucket pack kernel takes {_KERNEL_DTYPES}, got "
                        f"{src.dtype}")
    for name, t in (("block", block), ("valid", valid)):
        if t.device != src.device:
            raise ValueError(f"{name} must be on {src.device}, got "
                             f"{t.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.shape != (padded_size // tile,):
            raise ValueError(f"{name} must have {padded_size // tile} "
                             f"entries, got {tuple(t.shape)}")
    if out is not None and (out.device != src.device or out.dtype != src.dtype
                            or out.shape != (padded_size,)):
        raise ValueError(f"out must be ({padded_size},) {src.dtype} on "
                         f"{src.device}")
    for name, t in (("source", src), ("block", block), ("valid", valid),
                    ("out", out)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (tile * src.element_size()) % 16:
        raise ValueError(f"a tile must be a multiple of 16 bytes, got "
                         f"{tile} x {src.element_size()}")
    for name, t in (("source", src), ("out", out)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must start at a 16-byte aligned "
                             f"address")


def _gather(fn, src, block, valid, padded_size, tile, out):
    """Launch the tile-gather kernel (shared by pack and unpack)."""
    if src.device.type == "cpu":
        res = bucket_pack_plain(src, block, valid, padded_size, tile=tile)
        if out is None:
            return res
        return out.copy_(res)
    if not src.is_cuda:
        raise ValueError(f"{fn.__name__}: unsupported device {src.device}")
    from repro_torch.kernels._build import load
    _check_cuda_args(src, block, valid, padded_size, tile, out)
    if out is None:
        out = torch.empty((padded_size,), dtype=src.dtype, device=src.device)
    launch = load("bucket_pack")
    with torch.cuda.device(src.device):
        err = launch(src.data_ptr(), block.data_ptr(), valid.data_ptr(),
                     out.data_ptr(), padded_size // tile,
                     src.numel() // tile, tile * src.element_size(),
                     src.element_size(),
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: CUDA error "
                           f"{err}")
    fn.launches += 1
    return out


def bucket_pack(src: torch.Tensor, block: torch.Tensor, valid: torch.Tensor,
                padded_size: int, *, tile: int = TILE,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pack one bucket's ``(padded_size,)`` send buffer from the flat
    tile-aligned arena ``src`` (tables from :func:`build_tile_tables`),
    into ``out`` when given (e.g. a slice of one buffer holding every
    bucket). On a CUDA tensor this launches the kernel on the current
    stream and adds one to ``bucket_pack.launches``; on a CPU tensor it
    runs :func:`bucket_pack_plain` and counts nothing."""
    return _gather(bucket_pack, src, block, valid, padded_size, tile, out)


def bucket_unpack(packed: torch.Tensor, block: torch.Tensor,
                  valid: torch.Tensor, out_size: int, *, tile: int = TILE,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse direction: gather the reduced buckets' tiles (``packed``,
    all buckets back to back) into arena layout. The same kernel with the
    unpack tables; counted on ``bucket_unpack.launches``."""
    return _gather(bucket_unpack, packed, block, valid, out_size, tile, out)


bucket_pack.launches = 0
bucket_unpack.launches = 0
