"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Return the device an entry point runs on.

    ``None`` means the card: ``cuda`` when CUDA is available, otherwise a
    ``RuntimeError`` — the port never falls back to the CPU on its own. A
    caller that wants the CPU (the conformance tests) passes
    ``device="cpu"``. An explicit CUDA device is checked as well. The
    ``meta`` device (shapes and dtypes, no memory: the dry-run,
    :mod:`repro_torch.launch.dryrun`) is taken when it is named.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain CPU path")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def torch_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    """Config dtype name (``"bfloat16"``, ``"float32"``) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt
