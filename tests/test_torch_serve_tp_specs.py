"""The tensor-parallel serve contract in one process, against the
reference: every leaf's sharded dim (``serve_param_specs``) and
``serve_tp_validate``'s refusals with the reference's messages.
"""

import dataclasses

import jax
import pytest
from jax.sharding import PartitionSpec

import _torch_cpu  # noqa: F401  (one intra-op thread: see its docstring)
from _torch_serve_tp import case_cfgs
from repro.configs import all_configs as jax_all_configs
from repro.configs import get_config as jax_get_config
from repro.models import transformer as jtf
from repro.serve import comm as jcomm
from repro_torch.configs import get_config
from repro_torch.models import transformer as ttf
from repro_torch.serve import comm as tcomm


def _ref_dims(spec_tree):
    """The reference's PartitionSpec tree -> the dim naming 'model'."""
    def dim(p):
        return next((i for i, a in enumerate(p) if a == "model"), None)
    return jax.tree_util.tree_map(dim, spec_tree,
                                  is_leaf=lambda x: isinstance(
                                      x, PartitionSpec))


@pytest.mark.parametrize("case,tp", [
    ("olmo-1b-smoke:0", 2), ("mixtral-8x22b-smoke:0", 2),
    ("mixtral-8x22b-smoke:3", 2), ("olmo-1b-smoke:0", 4),
    ("mixtral-8x22b-smoke:0", 4), ("mixtral-8x22b-smoke:3", 4),
    ("arctic-480b-smoke:0", 2), ("yi-9b-smoke:0", 2)])
def test_param_specs_equal_reference(case, tp):
    """Every leaf's sharded dim equals the reference's PartitionSpec: the
    dense, expert-parallel and ff-TP smoke trees (tp 4 with num_kv_heads
    widened to 4), untied lm_head and the arctic dense residual."""
    jcfg, cfg = case_cfgs(case)
    if tp == 4:
        jcfg = dataclasses.replace(jcfg, num_kv_heads=4)
        cfg = dataclasses.replace(cfg, num_kv_heads=4)
    jparams = jax.eval_shape(lambda: jtf.init_params(
        jcfg, jax.random.PRNGKey(0)))
    want = _ref_dims(jcomm.serve_param_specs(jcfg, jparams, tp))
    params = ttf.init_params(cfg, 0, device="cpu")
    got = tcomm.serve_param_specs(cfg, params, tp)
    assert got == want


@pytest.mark.parametrize("arch", sorted(jax_all_configs()) + [
    a + "-smoke" for a in sorted(jax_all_configs())])
def test_tp_validate_equals_reference(arch):
    """``serve_tp_validate`` raises, or not, with the reference's message,
    for every registered config (and its smoke variant) at tp 2, 4, 8."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    for tp in (2, 4, 8):
        msgs = []
        for fn, c in ((jcomm.serve_tp_validate, jcfg),
                      (tcomm.serve_tp_validate, cfg)):
            try:
                fn(c, tp)
                msgs.append(None)
            except ValueError as e:
                msgs.append(str(e))
        assert msgs[0] == msgs[1], (arch, tp, msgs)
