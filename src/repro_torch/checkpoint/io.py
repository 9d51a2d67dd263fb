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
stores: :func:`save_state` gathers each ``comm="gspmd"`` slice (over the
data line and over the model line of a ``(data, model)`` mesh) and each
ZeRO-1 bucket shard (over the data line) into its whole leaf, leaf by
leaf, and rank 0 writes it; :func:`load_state` reads back each rank's
part of every leaf. So a state saved on one mesh restores on any other.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.dist.tp import line_gather
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

def _split(path: Tuple[str, ...], opt, shard, line) -> Optional[tuple]:
    """How the train-state leaf at ``path`` is split, or ``None`` where
    every rank holds it whole: ``("shard", leaf path)`` for a
    ``comm="gspmd"`` param or AdamW moment, sliced by the rule table on
    ``shard``'s mesh; ``("line",)`` for a ZeRO-1 bucket's m / v / master,
    split along its only dim over ``line`` (a
    :class:`repro_torch.train.trainer.DataLine`)."""
    from repro_torch.optim.adamw import ShardedAdamWState
    if path[0] == "opt" and isinstance(opt, ShardedAdamWState):
        if path[1] in ("m", "v", "master") and line.size > 1:
            return ("line",)
        return None
    if shard is None or shard.size == 1:
        return None
    if path[0] == "params":
        p = path[1:]
    elif path[0] == "opt" and path[1] in ("m", "v"):
        p = path[2:]
    else:
        return None
    return None if shard.split_key(p) is None else ("shard", p)


def _split_leaves(state, shard, mesh) -> Iterator[Tuple[str, Any, Any, Any]]:
    from repro_torch.train.trainer import DataLine
    line = DataLine(mesh)
    for path, leaf in tree_flatten_with_paths(state):
        yield (_SEP.join(path), leaf,
               _split(path, state.opt, shard, line), line)


def save_state(directory: str, step: int, state, *, shard=None,
               metadata: Optional[dict] = None, mesh=None) -> Optional[str]:
    """Write a ``TrainState`` as the reference stores it: every leaf whole.
    Collective over the default group when it has more than one rank:
    every rank calls it, each split leaf is gathered in turn (slices with
    ``shard``, the step's :class:`~repro_torch.dist.sharding.Sharder`;
    ZeRO-1 bucket shards over the data line of ``mesh``, the step's, by
    default every rank a data rank), rank 0 writes, and all ranks leave
    together. Returns the step's directory on rank 0, else ``None``."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    w = _Writer(directory, step, metadata) if rank == 0 else None
    for p, leaf, split, line in _split_leaves(state, shard, mesh):
        if split is not None:
            with torch.no_grad():
                leaf = (line_gather(leaf, 0, line.size, line.group)
                        if split[0] == "line"
                        else shard.gather_leaf(split[1], leaf))
        if w is not None:
            w.leaf(p, leaf)
    out = w.close() if w is not None else None
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
    return out


def load_state(directory: str, step: int, like, *, shard=None, mesh=None):
    """Restore a ``TrainState`` into ``like`` (this rank's state: its
    structure, dtypes, devices and slice shapes; ``shard`` and ``mesh`` as
    :func:`save_state` takes them): every rank reads its own part of each
    whole leaf. The reference's mismatch errors are raised against the
    whole leaves' shapes."""
    flat = list(_split_leaves(like, shard, mesh))
    src, by_path = _manifest(directory, step, [p for p, _, _, _ in flat])
    leaves = {}
    for p, lk, split, line in flat:
        shape = list(lk.shape)
        index = None
        if split is not None and split[0] == "line":
            size = shape[0]
            shape[0] *= line.size
            index = (slice(line.index * size, (line.index + 1) * size),)
        elif split is not None:
            shape = list(shard.global_shape(split[1]))
            index = shard.leaf_index(split[1], len(shape))
        e = by_path[p]
        _check_shape(p, e, shape)
        t = _read_leaf(os.path.join(src, e["file"]), e["dtype"], index)
        leaves[p] = t.to(device=lk.device, dtype=lk.dtype)
    return tree_map_with_paths(lambda path, _: leaves[_SEP.join(path)], like)
