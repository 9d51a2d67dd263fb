"""The tensor-parallel layouts in one process and on gloo ranks:
``shard_params`` against ``init_params(shard=)`` and the whole tree,
``decode_kv_expand`` against the JAX model, and ``CommRuntime.all_to_all``
on 4 spawned ranks against numpy.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (one intra-op thread: see its docstring)
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import synthetic_batch as jax_synthetic_batch
from repro.models import transformer as jtf
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import transformer as ttf
from repro_torch.serve import comm as tcomm
from repro_torch.tree import tree_flatten

from test_torch_ranks import run_ranks


def test_shard_params_cuts_by_the_specs():
    """``shard_params`` and ``init_params(shard=param_sharder(...))`` give
    the same rank shards, and the shards put back together along the spec
    dims give the full tree."""
    cfg = get_config("mixtral-8x22b-smoke")
    full = ttf.init_params(cfg, 0, device="cpu")
    specs = tcomm.serve_param_specs(cfg, full, 2)
    shards = [tcomm.shard_params(cfg, full, 2, i) for i in range(2)]
    made = [ttf.init_params(cfg, 0, device="cpu",
                            shard=tcomm.param_sharder(cfg, 2, i))
            for i in range(2)]
    f = tree_flatten(full)[0]
    s_leaves = [tree_flatten(t)[0] for t in shards]
    m_leaves = [tree_flatten(t)[0] for t in made]
    dims = _dims_in_order(specs)
    assert len(dims) == len(f)
    for i, (leaf, dim) in enumerate(zip(f, dims)):
        for r in range(2):
            assert torch.equal(s_leaves[r][i], m_leaves[r][i])
        if dim is None:
            assert all(torch.equal(s[i], leaf) for s in s_leaves)
        else:
            assert torch.equal(torch.cat([s[i] for s in s_leaves], dim),
                               leaf)


def _dims_in_order(tree):
    if isinstance(tree, dict):
        return [d for k in sorted(tree) for d in _dims_in_order(tree[k])]
    return [tree]


@functools.lru_cache(maxsize=None)
def _expand_run(e):
    """Prefill + 10 decode steps of yi-9b-smoke (8 query heads) at
    ``decode_kv_expand=e`` through the port and the JAX model, held
    against each other (cache shape and heads, logits and K within 1e-5
    in f32); returns the port's logits. Each ``e`` runs once a module."""
    base = dataclasses.replace(jax_get_config("yi-9b-smoke"), num_heads=8)
    tbase = dataclasses.replace(get_config("yi-9b-smoke"), num_heads=8)
    S = 20
    jparams = jtf.init_params(base, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    toks = np.asarray(jax_synthetic_batch(base, 2, S, seed=2)["tokens"])
    jcfg = dataclasses.replace(base, decode_kv_expand=e)
    cfg = dataclasses.replace(tbase, decode_kv_expand=e)
    jmodel, model = jtf.Model(jcfg), ttf.Model(cfg)
    jcache = jtf.init_cache(jcfg, 2, S + 1, dtype=jnp.float32)
    cache = ttf.init_cache(cfg, 2, S + 1, dtype=torch.float32,
                           device="cpu")
    assert cache.kv.k.shape == jcache.kv.k.shape
    assert cache.kv.k.shape[3] == cfg.num_kv_heads * e
    _, _, jcache = jmodel.forward(jparams,
                                  {"tokens": jnp.asarray(toks[:, :10])},
                                  cache=jcache)
    with torch.inference_mode():
        _, _, cache = model.forward(
            params, {"tokens": torch.from_numpy(toks[:, :10])},
            cache=cache)
        jl, tl = [], []
        for t in range(10, S):
            lg, jcache = jmodel.decode_step(
                jparams, jnp.asarray(toks[:, t: t + 1]), jcache)
            jl.append(np.asarray(lg))
            lg, cache = model.decode_step(
                params, torch.from_numpy(toks[:, t: t + 1]), cache)
            tl.append(lg.numpy())
    got, want = np.concatenate(tl, 1), np.concatenate(jl, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(cache.kv.k),
                               np.asarray(jcache.kv.k), rtol=1e-5,
                               atol=1e-5)
    return got


@pytest.mark.parametrize("expand", [1, 2, 4])
def test_decode_kv_expand_equals_reference(expand):
    """``decode_kv_expand`` stores each KV head ``e`` times, a pure layout
    change: the cache holds ``KV * e`` heads, and prefill + 10 decode
    steps give the JAX model's logits at the same ``e`` (f32, 1e-5), and
    those at ``e = 1`` (yi-9b-smoke with 8 query heads, so that 4 x 2 KV
    heads still divide them; the reference's
    ``test_decode_kv_expand_numerics``)."""
    outs = {e: _expand_run(e) for e in sorted({1, expand})}
    np.testing.assert_allclose(outs[expand], outs[1], rtol=1e-5, atol=1e-5)


def test_all_to_all_on_gloo_ranks(tmp_path):
    """``CommRuntime.all_to_all`` on 4 gloo ranks, along the data group and
    both axes of a 2 x 2 mesh, against numpy."""
    r = run_ranks("all_to_all", tmp_path, 4)
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(np.load(tmp_path / "out_all_to_all.npz")["ok"]) == 1
