"""Architecture registry.

``get_config("<arch-id>")`` resolves the 10 assigned architectures (by their
public ids, e.g. ``gemma-2b``) plus variant suffixes:

* ``<id>-smoke``    — reduced same-family config for CPU smoke tests
* ``<id>-swa<W>``   — sliding-window variant (used by full-attention archs
                      for the ``long_500k`` decode shape)
"""

from __future__ import annotations

import importlib
import re
from typing import Dict, List

from repro_torch.configs.base import (
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    flops_per_token,
    human,
)

_ARCH_MODULES = {
    "gemma-2b": "gemma_2b",
    "yi-9b": "yi_9b",
    "command-r-35b": "command_r_35b",
    "zamba2-7b": "zamba2_7b",
    "mamba2-780m": "mamba2_780m",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "mixtral-8x22b": "mixtral_8x22b",
    "olmo-1b": "olmo_1b",
    "arctic-480b": "arctic_480b",
    "musicgen-large": "musicgen_large",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)

# Archs whose base attention is already sub-quadratic-compatible at 500k:
# pure SSM (no attention at all) or natively sliding-window. Every other
# arch (incl. the zamba2 hybrid's shared attention block) runs long_500k
# through the -swa4096 variant.
SUBQUADRATIC_AT_500K = {"mamba2-780m", "mixtral-8x22b"}

_SWA_RE = re.compile(r"^(?P<base>.+?)-swa(?P<win>\d+)$")


def get_config(arch: str) -> ModelConfig:
    smoke = arch.endswith("-smoke")
    if smoke:
        arch = arch[: -len("-smoke")]
    m = _SWA_RE.match(arch)
    window = None
    if m and m.group("base") in _ARCH_MODULES:
        arch, window = m.group("base"), int(m.group("win"))
    if arch not in _ARCH_MODULES:
        raise KeyError(
            f"unknown arch {arch!r}; known: {', '.join(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    cfg: ModelConfig = mod.CONFIG
    if window is not None:
        cfg = cfg.with_sliding_window(window)
    if smoke:
        cfg = cfg.smoke()
    return cfg


def config_for_shape(arch: str, shape: str) -> ModelConfig:
    """Resolve the config actually used for an (arch x input-shape) pair.

    ``long_500k`` requires sub-quadratic attention. SSM/hybrid/SWA archs run
    as-is; full-attention archs run their sliding-window variant (the
    "dense archs only if you implement a sliding-window variant" clause).
    """
    cfg = get_config(arch)
    if shape == "long_500k" and arch in _ARCH_MODULES:
        if arch not in SUBQUADRATIC_AT_500K and cfg.family != "ssm":
            cfg = cfg.with_sliding_window(4096)
    return cfg


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


__all__ = [
    "ARCH_IDS",
    "INPUT_SHAPES",
    "InputShape",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "SUBQUADRATIC_AT_500K",
    "all_configs",
    "config_for_shape",
    "flops_per_token",
    "get_config",
    "human",
]
