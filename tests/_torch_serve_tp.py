"""What the tensor-parallel serve tests share: a case's reference and port
configs (``tests/test_torch_serve_tp.py`` and
``tests/test_torch_serve_tp_specs.py``).
"""

import dataclasses

import _torch_cpu  # noqa: F401  (one intra-op thread: see its docstring)
from repro.configs import get_config as jax_get_config
from repro_torch.configs import get_config


def case_cfgs(case):
    """``arch:num_experts`` (0: the arch's own) -> (reference config, port
    config)."""
    arch, experts = case.split(":")
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    if int(experts):
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, num_experts=int(experts)))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=int(experts)))
    return jcfg, cfg
