"""Checkpointing: per-leaf .npy files + a JSON manifest (port of
``repro.checkpoint.io``, file format and all).

Layout:
    <dir>/step_<N>/manifest.json       tree structure + dtypes + metadata
    <dir>/step_<N>/leaf_<i>.npy        one file per pytree leaf

Leaves are numbered in ``jax.tree_util`` order and each manifest entry's
``path`` is the reference's: NamedTuple field names, dict keys and ``[i]``
for list and tuple entries, joined by ``/`` (:func:`repro_torch.tree.
tree_flatten_with_paths`). So a checkpoint of the reference's
``TrainState`` loads into the port's and back.

bfloat16 leaves are written as the reference's ``np.save`` writes an
``ml_dtypes`` bfloat16 array: raw 2-byte elements under the ``'<V2'``
descr, with ``"dtype": "bfloat16"`` in the manifest; they are read back
through a ``uint16`` view, so nothing here needs ``ml_dtypes``. (The
reference cannot read its own bfloat16 leaves back: ``np.load`` gives
``'<V2'`` bytes, which its ``astype`` refuses.)

Sharded train states are stored as the global arrays the reference
stores: :func:`save_state` gathers each FSDP slice (``comm="gspmd"``) and
each ZeRO-1 bucket shard into its whole leaf, leaf by leaf, and rank 0
writes it; :func:`load_state` reads back each rank's part of every leaf.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.collectives import _all_gather
from repro_torch.device import resolve_device
from repro_torch.tree import tree_flatten_with_paths, tree_map_with_paths

_SEP = "/"
_BF16_DESCR = "<V2"


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def _write_leaf(path: str, leaf) -> Tuple[str, list]:
    """One leaf (a tensor or an array) as ``.npy``; returns its manifest
    dtype and shape."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            with open(path, "wb") as f:
                np.lib.format.write_array_header_1_0(f, {
                    "descr": _BF16_DESCR, "fortran_order": False,
                    "shape": tuple(t.shape)})
                t.view(torch.int16).numpy().tofile(f)
            return "bfloat16", list(t.shape)
        leaf = t.numpy()
    arr = np.asarray(leaf)
    np.save(path, arr)
    return str(arr.dtype), list(arr.shape)


def _read_leaf(path: str, dtype: str, index=None) -> torch.Tensor:
    """A leaf file as a CPU tensor (``index``: the part to read, from a
    memory map); ``'<V2'`` bytes are bfloat16."""
    arr = np.load(path, mmap_mode="r")
    if index is not None:
        arr = arr[index]
    if dtype == "bfloat16" or arr.dtype.kind == "V":
        return torch.from_numpy(np.array(arr).view(np.uint16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


class _Writer:
    """Writes the leaves of one step's directory and then its manifest."""

    def __init__(self, directory: str, step: int, metadata):
        self.out = _step_dir(directory, step)
        os.makedirs(self.out, exist_ok=True)
        self.manifest = {"step": step, "metadata": metadata or {},
                         "leaves": []}

    def leaf(self, path: str, leaf) -> None:
        fname = f"leaf_{len(self.manifest['leaves']):05d}.npy"
        dtype, shape = _write_leaf(os.path.join(self.out, fname), leaf)
        self.manifest["leaves"].append({"path": path, "file": fname,
                                        "dtype": dtype, "shape": shape})

    def close(self) -> str:
        with open(os.path.join(self.out, "manifest.json"), "w") as f:
            json.dump(self.manifest, f, indent=1)
        return self.out


def _paths(tree) -> Tuple[list, list]:
    flat = tree_flatten_with_paths(tree)
    return [_SEP.join(p) for p, _ in flat], [v for _, v in flat]


def save_checkpoint(directory: str, step: int, tree: Any,
                    metadata: Optional[dict] = None) -> str:
    """Write ``tree`` (tensors or arrays, whole) as ``step``'s checkpoint."""
    w = _Writer(directory, step, metadata)
    for p, leaf in zip(*_paths(tree)):
        w.leaf(p, leaf)
    return w.close()


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := re.match(r"step_(\d+)$", d))]
    return max(steps) if steps else None


def _manifest(directory: str, step: int, paths: Sequence[str]
              ) -> Tuple[str, Dict[str, dict]]:
    """The step's directory and its entries by path; raises the reference's
    error when the trees differ."""
    src = _step_dir(directory, step)
    with open(os.path.join(src, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    if set(paths) != set(by_path):
        missing = set(paths) - set(by_path)
        extra = set(by_path) - set(paths)
        raise ValueError(
            f"checkpoint tree mismatch: missing={missing} extra={extra}")
    return src, by_path


def _check_shape(p: str, entry: dict, shape: Sequence[int]) -> None:
    if tuple(entry["shape"]) != tuple(shape):
        raise ValueError(f"shape mismatch at {p}: {tuple(entry['shape'])} "
                         f"vs {tuple(shape)}")


def load_checkpoint(directory: str, step: int, like: Any,
                    device=None) -> Any:
    """Restore into the structure of ``like`` (values ignored): each leaf in
    the dtype and on the device of ``like``'s (tensors), or in its stored
    dtype on ``device`` (the card unless ``"cpu"`` is asked for) where
    ``like`` has no tensor there (an array, a shape struct)."""
    paths, like_leaves = _paths(like)
    src, by_path = _manifest(directory, step, paths)
    for p, lk in zip(paths, like_leaves):
        _check_shape(p, by_path[p], lk.shape)

    dev = None

    def restore(path, lk):
        nonlocal dev
        e = by_path[_SEP.join(path)]
        t = _read_leaf(os.path.join(src, e["file"]), e["dtype"])
        if isinstance(lk, torch.Tensor):
            return t.to(device=lk.device, dtype=lk.dtype)
        if dev is None:
            dev = resolve_device(device)
        return t.to(dev)

    return tree_map_with_paths(restore, like)


# ---------------------------------------------------------------------------
# train states whose leaves are split over the data ranks
# ---------------------------------------------------------------------------

def _split(path: Tuple[str, ...], opt, shard, world: int
           ) -> Optional[Tuple[int, int]]:
    """``(dim, n)``: the dim of the train-state leaf at ``path`` that is
    split over ``n`` ranks, or ``None`` where every rank holds it whole.
    FSDP (``shard`` over more than one rank) splits params and AdamW
    moments by the rule table; ZeRO-1 splits each bucket's m / v / master
    along its only dim over the default group."""
    from repro_torch.optim.adamw import ShardedAdamWState
    if path[0] == "opt" and isinstance(opt, ShardedAdamWState):
        if path[1] in ("m", "v", "master") and world > 1:
            return 0, world
        return None
    if shard is None or shard.n == 1:
        return None
    if path[0] == "params":
        dim = shard.sharded_dim(path[1:])
    elif path[0] == "opt" and path[1] in ("m", "v"):
        dim = shard.sharded_dim(path[2:])
    else:
        return None
    return None if dim is None else (dim, shard.n)


def _split_leaves(state, shard) -> Iterator[Tuple[str, Any, Any]]:
    world = dist.get_world_size() if dist.is_initialized() else 1
    for path, leaf in tree_flatten_with_paths(state):
        yield _SEP.join(path), leaf, _split(path, state.opt, shard, world)


@torch.no_grad()
def _gather(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    tm = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * tm.shape[0],) + tuple(tm.shape[1:]),
                      dtype=tm.dtype, device=tm.device)
    _all_gather(out.view(-1), tm.view(-1))
    return out.movedim(0, dim)


def save_state(directory: str, step: int, state, *, shard=None,
               metadata: Optional[dict] = None) -> Optional[str]:
    """Write a ``TrainState`` as the reference stores it: every leaf whole.
    Collective over the default group when it has more than one rank:
    every rank calls it, each split leaf is gathered in turn (FSDP slices
    with ``shard``, the step's :class:`~repro_torch.dist.sharding.Sharder`;
    ZeRO-1 bucket shards), rank 0 writes, and all ranks leave together.
    Returns the step's directory on rank 0, else ``None``."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    w = _Writer(directory, step, metadata) if rank == 0 else None
    for p, leaf, split in _split_leaves(state, shard):
        if split is not None:
            leaf = _gather(leaf, *split)
        if w is not None:
            w.leaf(p, leaf)
    out = w.close() if w is not None else None
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
    return out


def load_state(directory: str, step: int, like, *, shard=None):
    """Restore a ``TrainState`` into ``like`` (this rank's state: its
    structure, dtypes, devices and slice shapes): every rank reads its own
    part of each whole leaf. The reference's mismatch errors are raised
    against the whole leaves' shapes."""
    flat = list(_split_leaves(like, shard))
    src, by_path = _manifest(directory, step, [p for p, _, _ in flat])
    rank = dist.get_rank() if dist.is_initialized() else 0
    leaves = {}
    for p, lk, split in flat:
        shape = list(lk.shape)
        index = None
        if split is not None:
            dim, n = split
            size = shape[dim]
            shape[dim] *= n
            index = (slice(None),) * dim + (
                slice(rank * size, (rank + 1) * size),)
        e = by_path[p]
        _check_shape(p, e, shape)
        t = _read_leaf(os.path.join(src, e["file"]), e["dtype"], index)
        leaves[p] = t.to(device=lk.device, dtype=lk.dtype)
    return tree_map_with_paths(lambda path, _: leaves[_SEP.join(path)], like)
