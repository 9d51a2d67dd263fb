"""The port's sharding rule table (``repro_torch.dist.sharding``) against
the reference's (``repro.dist.sharding``).

``param_specs`` must equal the reference's spec for spec, path for path,
for every arch (smoke and full width, shapes only: the port builds its tree
on the meta device, the reference with ``jax.eval_shape``) on the meshes
``tests/test_sharding.py`` uses and on the 1-D data meshes the port trains
on; likewise ``zero1_opt_specs`` of a ZeRO-1 state, ``batch_axes``,
``data_axes`` and ``dp_entry``. The Sharder's slices tile each leaf, its
gather restores it, and a model axis cuts each leaf along both of its
dims.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import _torch_cpu  # noqa: F401  (one intra-op thread: see its docstring)
from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.dist import sharding as jsh
from repro.models.transformer import init_params as jax_init_params
from repro.optim.adamw import sharded_adamw_init as jax_sharded_adamw_init
from repro.train.trainer import _zero1_plan as jax_zero1_plan
from repro_torch.configs import get_config
from repro_torch.core.collectives import RankMesh
from repro_torch.dist import sharding as tsh
from repro_torch.models.transformer import init_params
from repro_torch.optim.adamw import sharded_adamw_init
from repro_torch.train.trainer import _zero1_plan
from repro_torch.tree import tree_flatten_with_paths


def fake_mesh(shape_dict):
    return SimpleNamespace(axis_names=tuple(shape_dict),
                           shape=dict(shape_dict),
                           size=int(np.prod(list(shape_dict.values()))))


MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "data4": {"data": 4},
    "data2": {"data": 2},
}
ARCHS = [a + s for a in ARCH_IDS for s in ("", "-smoke")]


def _ref_specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    def key(k):
        for a in ("key", "idx", "name"):
            if hasattr(k, a):
                return str(getattr(k, a))
        return str(k)
    return {"/".join(key(k) for k in p): tuple(s) for p, s in flat}


def _port_specs(tree):
    return {"/".join(p).replace("[", "").replace("]", ""): s
            for p, s in tree_flatten_with_paths(tree, is_leaf=tsh.is_spec)}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, mesh_name):
    mesh = fake_mesh(MESHES[mesh_name])
    want = _ref_specs(jsh.param_specs(jax_get_config(arch), mesh))
    got = _port_specs(tsh.param_specs(get_config(arch), mesh))
    assert got == want


def test_param_specs_on_a_rank_mesh_and_none():
    """A RankMesh (the port's mesh: no ``axis_names``, a ``shape`` dict)
    gives the duck-typed mesh's specs; ``None`` shards nothing."""
    cfg = get_config("olmo-1b")
    assert tsh.param_specs(cfg, RankMesh(4, 1)) == \
        tsh.param_specs(cfg, fake_mesh({"data": 4, "model": 1}))
    assert all(all(e is None for e in s) for s in
               _port_specs(tsh.param_specs(cfg, None)).values())


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16", "data4"])
def test_zero1_opt_specs_equal_reference(mesh_name):
    """The spec tree of a ZeRO-1 state: each bucket's m / v / master over
    the data axes, the count replicated."""
    mesh = fake_mesh(MESHES[mesh_name])
    jcfg, cfg = jax_get_config("olmo-1b-smoke"), get_config("olmo-1b-smoke")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    jopt = jax_sharded_adamw_init(jparams, jax_zero1_plan(
        jparams, num_streams=4, align=1024, pack="xla"))
    params = init_params(cfg, 0, device="cpu")
    opt = sharded_adamw_init(params, _zero1_plan(
        params, num_streams=4, align=1024, pack="xla"))
    want = _ref_specs(jsh.zero1_opt_specs(mesh, jopt))
    got = _port_specs(tsh.zero1_opt_specs(mesh, opt))
    assert got == want and len(got) == 3 * len(opt.m) + 1


@pytest.mark.parametrize("mesh_name", list(MESHES) + [None])
def test_batch_and_data_axes_equal_reference(mesh_name):
    mesh = None if mesh_name is None else fake_mesh(MESHES[mesh_name])
    assert tsh.batch_axes(mesh) == jsh.batch_axes(mesh)
    assert tsh.data_axes(mesh) == jsh.data_axes(mesh)
    dp = tsh.batch_axes(mesh)
    assert tsh.dp_entry(dp) == jsh.dp_entry(dp)


@pytest.mark.parametrize("arch", ["olmo-1b-smoke", "mixtral-8x22b-smoke",
                                  "zamba2-7b-smoke", "musicgen-large-smoke",
                                  "phi-3-vision-4.2b-smoke"])
@pytest.mark.parametrize("n", [2, 4])
def test_rank_slices_tile_each_leaf(arch, n):
    """Every rank's slice has the rule table's local shape, and the slices
    of all ranks, in rank order along the sharded dim, are the leaf."""
    cfg = get_config(arch)
    params = init_params(cfg, 0, device="cpu")
    mesh = fake_mesh({"data": n})
    specs = _port_specs(tsh.param_specs(cfg, mesh))
    shards = [tsh.Sharder(mesh, cfg, rank=r) for r in range(n)]
    sliced = 0
    for path, leaf in tree_flatten_with_paths(params):
        dim = next((i for i, e in enumerate(specs["/".join(path)])
                    if e == "data"), None)
        assert shards[0].sharded_dim(path) == dim
        parts = [s.shard_leaf(path, leaf) for s in shards]
        for s, part in zip(shards, parts):
            assert tuple(part.shape) == s.local_shape(path)
        if dim is None:
            assert all(p is leaf for p in parts)
            continue
        sliced += 1
        assert torch.equal(torch.cat(parts, dim), leaf)
    assert sliced > 0


def test_a_model_axis_is_refused_naming_item_14():
    """Once refused: the Sharder takes a model axis. Each rank of a
    ``data x model`` mesh (row-major, ``RankMesh.coords``) cuts its slice
    along both of a leaf's dims, and the four slices tile the leaf; over
    live ranks a mesh that is not a ``RankMesh`` is refused. What still
    raised naming item 14, a ``kv_fp8`` cache, stores fp8."""
    cfg = get_config("olmo-1b-smoke")
    params = init_params(cfg, 0, device="cpu")
    mesh = RankMesh(2, 2)
    shards = [tsh.Sharder(mesh, cfg, rank=r) for r in range(4)]
    both = 0
    for path, leaf in tree_flatten_with_paths(params):
        parts = [s.shard_leaf(path, leaf) for s in shards]
        for s, part in zip(shards, parts):
            assert tuple(part.shape) == s.local_shape(path)
        d, m = shards[0].sharded_dim(path), shards[0].model_dim(path)
        if d is None or m is None:
            continue
        both += 1
        rows = [torch.cat(parts[2 * i:2 * i + 2], m) for i in range(2)]
        assert torch.equal(torch.cat(rows, d), leaf), path
        assert shards[0].split_key(path) == "both"
    assert both > 0
    with pytest.raises(ValueError):   # no group of 8 ranks here
        tsh.Sharder(fake_mesh({"data": 2, "model": 4}), cfg)
    from repro_torch.models.transformer import init_cache
    c = init_cache(cfg.with_opts("kv_fp8"), 1, 8, device="cpu")
    assert c.kv.k.dtype == torch.float8_e4m3fn


def test_one_rank_sharder_is_the_identity():
    """No mesh (or one data rank): no slice, no gather, no collective."""
    cfg = get_config("olmo-1b-smoke")
    shard = tsh.Sharder(None, cfg)
    params = init_params(cfg, 0, device="cpu")
    assert shard.n == 1
    assert shard.materialize(params["embed"], ("embed",)) is params["embed"]
    for path, leaf in tree_flatten_with_paths(params):
        assert shard.shard_leaf(path, leaf) is leaf
        assert shard.sharded_dim(path) is None
    x = torch.ones(3)
    assert shard.data_sum(x) is x and shard.hidden(x) is x
    assert all(v == 0 for v in shard.tally.values())
