"""Carry a params tree given as numpy arrays into the port's tensors.

The conformance tests make the reference's params in JAX, turn them into a
nested dict of numpy arrays, and hand that to :func:`params_from_numpy` —
``repro_torch`` itself never sees JAX. The layouts already agree (stacked
``(L, in, out)``, used as ``x @ W``), so this copies and never transposes.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import torch_dtype


def tensor_from_numpy(a, device, dtype=None) -> torch.Tensor:
    """One array -> a tensor on ``device`` that owns its memory.

    numpy has no bfloat16; ``np.asarray`` of a JAX bf16 array carries the
    ``ml_dtypes`` bfloat16 dtype, which ``torch.from_numpy`` rejects, and
    may be read-only. Such arrays go over bit for bit through a ``uint16``
    view; every array is copied."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    if dtype is not None:
        t = t.to(torch_dtype(dtype))
    return t.to(device)


def params_from_numpy(tree: Any, device, dtype: Optional[Any] = None) -> Any:
    """Nested dict of numpy arrays -> the same tree of tensors on
    ``device`` (cast to ``dtype`` when given)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    return tensor_from_numpy(tree, device, dtype)
