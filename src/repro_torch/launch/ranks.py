"""Process groups for the port's entry points: a spawned world of ranks on
this host, or a group of one in this process.

The backend follows the layout (:func:`join_ranks`): gloo on the CPU,
NCCL with a card a rank, gloo when ranks share a card (NCCL refuses two
ranks on one device), with CUDA tensors. The ranks of :func:`spawn_ranks`
join through a ``FileStore`` in a temporary directory (no network), as
``launch/train.py`` and ``launch/serve.py`` spawn theirs. Gloo sends no
CUDA tensor point to point (the runtime raises on one), so a program whose
ranks share a card copies what it exchanges to the host and back itself,
through a :class:`HostStaging` that counts the copies.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
from typing import Callable, Iterator, Optional, Tuple

import torch
import torch.distributed as dist


def join_ranks(rank: int, world: int, device_type: str,
               store_path: Optional[str] = None
               ) -> Tuple[torch.device, str, str]:
    """Join the default group as ``rank`` of ``world`` (a ``FileStore`` at
    ``store_path``, else ``torchrun``'s environment) on the backend the
    layout asks for: gloo on the CPU, NCCL with a card a rank of this
    host, gloo when ranks share a card. Returns (device, backend, why)."""
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    device, backend, why = torch.device("cpu"), "gloo", "CPU ranks"
    if device_type == "cuda":
        cards = torch.cuda.device_count()
        device = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(device)
        if cards >= local_ranks:
            backend, why = "nccl", f"{local_ranks} rank(s), a card each"
        else:
            why = (f"{local_ranks} ranks share {cards} card(s); NCCL "
                   f"refuses two ranks on one device")
    store = None if store_path is None else dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)
    return device, backend, why


def rank_threads(parent_threads: int, world: int) -> int:
    """Intra-op threads of each of ``world`` CPU ranks that a process on
    ``parent_threads`` starts: an equal share of the parent's, at least
    one. A spawned process starts on PyTorch's default (every core), so the
    parent passes its count: a CLI run keeps the machine's cores, a parent
    pinned to one thread (a test) keeps its ranks on one each."""
    return max(1, parent_threads // world)


def _spawned(rank: int, fn: Callable, world: int, device_type: str,
             store_path: str, threads: int, args: tuple) -> None:
    """One spawned rank: join, run ``fn(device, *args)``, leave together
    (``threads``: the parent's intra-op threads)."""
    if device_type == "cpu":
        torch.set_num_threads(rank_threads(threads, world))
    device, _, _ = join_ranks(rank, world, device_type, store_path)
    try:
        fn(device, *args)
        # no rank tears its gloo pairs down while a peer still sends
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, device: torch.device,
                *args) -> None:
    """Run ``fn(device, *args)`` on ``world`` spawned ranks of this host
    (``fn`` must be importable: a module's top-level function); raises if
    a rank fails."""
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    try:
        torch.multiprocessing.start_processes(
            _spawned, args=(fn, world, device.type,
                            os.path.join(tmp, "store"),
                            torch.get_num_threads(), args),
            nprocs=world, start_method="spawn")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


@contextlib.contextmanager
def local_group(device: torch.device) -> Iterator[None]:
    """A data group of one rank in this process (the train step's VCI
    buckets need a group), torn down on exit; a group that is already
    initialised is used as it is."""
    if dist.is_initialized():
        yield
        return
    tmp = tempfile.mkdtemp(prefix="repro_torch_group_")
    try:
        join_ranks(0, 1, device.type, os.path.join(tmp, "store"))
        try:
            yield
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


class HostStaging:
    """Host copies around the exchanges of a gloo group on the card: ``out``
    before an exchange, ``back`` after it, each counted in ``copies``. On
    the CPU, or under NCCL, both return the tensor as it is."""

    def __init__(self, device: torch.device):
        self.device = device
        self.on = device.type == "cuda" and dist.get_backend() == "gloo"
        self.copies = 0

    def out(self, x: torch.Tensor) -> torch.Tensor:
        if not self.on:
            return x
        self.copies += 1
        return x.cpu()

    def back(self, x: torch.Tensor) -> torch.Tensor:
        if not self.on:
            return x
        self.copies += 1
        return x.to(self.device)
