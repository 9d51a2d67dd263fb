"""The port's launch and input helpers against the JAX reference's, on the
CPU: ``repro_torch.launch.{mesh,roofline,inputs,dryrun,report}`` and the
data helpers ``synthetic_batches``, ``batch_spec``, ``batch_shardings``
and ``place_batch``.

* ``analytic_flops`` and ``analytic_hbm_bytes`` (copied unchanged) equal
  the reference's exactly for every arch x input shape, with no option,
  ``kv_fp8`` and ``decode_cache``; ``CollectiveOp.link_bytes`` equals the
  reference's for every op kind;
* ``batch_spec`` equals the reference's shapes and dtypes; the batch
  stream equals the reference's;
* each rank's param slices on the production meshes (``32x8``,
  ``2x32x8``) have the shapes the reference's ``param_specs`` gives on a
  stand-in mesh of the same shape (no 256 host devices);
* one dry-run pair of each kind (olmo-1b ``decode_32k`` and ``train_4k``)
  writes an ``ok`` row with no card, on the meta device, and ``report``
  prints the reference's table from the rows.
"""

import dataclasses
import json
import math
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (one intra-op thread: see its docstring)
from repro.configs import config_for_shape as jax_config_for_shape
from repro.data.pipeline import batch_spec as jax_batch_spec
from repro.data.pipeline import synthetic_batches as jax_synthetic_batches
from repro.dist.sharding import param_specs as jax_param_specs
from repro.launch import roofline as jroof
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, config_for_shape
from repro_torch.core.collectives import RankMesh
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import dryrun, inputs, mesh as tmesh, report
from repro_torch.launch import roofline as troof
from repro_torch.launch.train import _world_size, build_mesh
from repro_torch.tree import tree_flatten_with_paths

OPTS = ((), ("kv_fp8",), ("decode_cache",))


def _pair_cfgs(arch, shape, opts):
    """The same config in both packages: the shape's config with ``opts``
    (``decode_cache`` also expands the stored KV heads as the dry-run does
    at model 8)."""
    cfg = dryrun.shaped_config(arch, shape, opts, tp=8)
    jcfg = jax_config_for_shape(arch, shape)
    if opts:
        jcfg = jcfg.with_opts(*opts)
    return cfg, dataclasses.replace(jcfg,
                                    decode_kv_expand=cfg.decode_kv_expand)


@pytest.mark.parametrize("opts", OPTS, ids=lambda o: "+".join(o) or "none")
def test_analytic_flops_and_bytes_equal_reference(opts):
    for arch in ARCH_IDS:
        for shape in INPUT_SHAPES:
            cfg, jcfg = _pair_cfgs(arch, shape, opts)
            sh, jsh = INPUT_SHAPES[shape], jroof.InputShape(
                **dataclasses.asdict(INPUT_SHAPES[shape]))
            assert troof.analytic_flops(cfg, sh) == \
                jroof.analytic_flops(jcfg, jsh), (arch, shape, opts)
            assert troof.analytic_hbm_bytes(cfg, sh) == \
                jroof.analytic_hbm_bytes(jcfg, jsh), (arch, shape, opts)


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
def test_link_bytes_equal_reference(kind):
    for n, payload, mult in ((1, 64, 1), (8, 4096, 3), (32, 1 << 20, 2),
                             (64, 12345, 1)):
        want = jroof.CollectiveOp(kind, payload, n, "c", mult).link_bytes
        got = troof.CollectiveOp(kind, payload, n, multiplier=mult)
        assert got.link_bytes == want
        bw = troof.IB_BW if got.crosses_nodes else troof.NVLINK_BW
        assert got.seconds == want / bw


def test_batch_spec_and_stream_equal_reference():
    for arch in ARCH_IDS:
        for shape in INPUT_SHAPES:
            cfg = config_for_shape(arch, shape)
            jcfg = jax_config_for_shape(arch, shape)
            got = tpipe.batch_spec(cfg, INPUT_SHAPES[shape])
            want = jax_batch_spec(jcfg, jroof.InputShape(
                **dataclasses.asdict(INPUT_SHAPES[shape])))
            assert list(got) == list(want), (arch, shape)
            for k, (shp, dt) in got.items():
                assert shp == want[k].shape, (arch, shape, k)
                assert str(dt).replace("torch.", "") == str(
                    jnp.dtype(want[k].dtype)), (arch, shape, k)
    cfg = config_for_shape("olmo-1b", "train_4k").smoke()
    mine = tpipe.synthetic_batches(cfg, 2, 8, seed=4)
    ref = jax_synthetic_batches(cfg, 2, 8, seed=4)
    for _ in range(3):
        a, b = next(mine), next(ref)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_batch_shardings_and_place_batch_split_rows_over_the_data_line():
    cfg = config_for_shape("phi-3-vision-4.2b", "train_4k")
    for m, lead, parts in ((RankMesh(32, 8), "data", 32),
                           (RankMesh(2, 32, 8), ("pod", "data"), 64)):
        split = tpipe.batch_shardings(cfg, INPUT_SHAPES["train_4k"], m)
        assert split["image_embeds"].spec == (lead, None, None)
        assert split["tokens"].parts == parts
    # batch 1 (long_500k) does not split: every rank holds the row
    split = tpipe.batch_shardings(cfg, INPUT_SHAPES["long_500k"],
                                  RankMesh(32, 8))
    assert split["tokens"].spec == (None, None)
    small = cfg.smoke()
    batch = tpipe.synthetic_batch(small, 8, small.num_patches + 4)
    mesh = RankMesh(2, 2, 2)
    split = tpipe.batch_shardings(small, INPUT_SHAPES["train_4k"], mesh)
    for rank in range(mesh.size):
        got = tpipe.place_batch(batch, split, rank=rank, device="cpu")
        d = mesh.coords(rank)[0]
        for k, v in batch.items():
            np.testing.assert_array_equal(got[k].numpy(),
                                          v[2 * d:2 * d + 2])


def _ref_slice_shape(spec, shape, mesh_shape):
    out = list(shape)
    for i, e in enumerate(spec):
        for ax in (e if isinstance(e, tuple) else (e,)):
            if ax is not None:
                out[i] //= mesh_shape[ax]
    return tuple(out)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["32x8", "2x32x8"])
def test_rank_slices_on_production_meshes_equal_reference_specs(multi_pod):
    m = tmesh.make_production_mesh(multi_pod=multi_pod)
    assert tmesh.mesh_name(m) == ("2x32x8" if multi_pod else "32x8")
    assert m.size == (512 if multi_pod else 256)
    stand_in = SimpleNamespace(axis_names=m.axis_names, shape=m.shape,
                               size=m.size)
    from repro.configs import get_config as jax_get_config
    from repro.models.transformer import init_params as jax_init_params
    import jax
    for arch in ARCH_IDS:
        jcfg = jax_get_config(arch)
        specs = dict(tree_flatten_with_paths(
            jax_param_specs(jcfg, stand_in),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
        shapes = dict(tree_flatten_with_paths(jax.eval_shape(
            lambda k: jax_init_params(jcfg, k),
            jax.ShapeDtypeStruct((2,), jnp.uint32))))
        got = inputs.param_slice_shapes(config_for_shape(arch, "train_4k"),
                                        m, rank=m.size - 1)
        assert set(got) == set(shapes), arch
        for p, want in shapes.items():
            assert got[p] == _ref_slice_shape(specs[p], want.shape,
                                              m.shape), (arch, p)


def test_meshes_and_pod_axis_without_spawning():
    assert build_mesh("2x1x2") == RankMesh(2, 1, 2)
    assert build_mesh("2x1x2").lines("data") == RankMesh(2, 2).lines("data")
    assert _world_size("2x1x2") == 4 and _world_size("none") == 1
    assert tmesh.make_host_mesh(4, 2) == RankMesh(4, 2)
    # the model line inside one node of 8 cards, the data line across
    assert tmesh.make_production_mesh().lines("model")[0] == list(range(8))
    assert dryrun._crosses_nodes(tmesh.make_production_mesh(), "data")
    assert not dryrun._crosses_nodes(tmesh.make_production_mesh(), "model")


def test_dryrun_pairs_and_report_without_a_card(tmp_path, capsys):
    out = tmp_path / "rows"
    for shape in ("decode_32k", "train_4k"):
        with pytest.raises(SystemExit) as done:
            dryrun.main(["--arch", "olmo-1b", "--shape", shape, "--out",
                         str(out)])
        assert done.value.code == 0
    printed = capsys.readouterr().out
    assert printed.count("[ok] ") == 2 and "done; failures=0" in printed
    rows = {r["shape"]: r for r in report.load(str(out))}
    cfg = config_for_shape("olmo-1b", "decode_32k")
    m = tmesh.make_production_mesh()
    for shape, row in rows.items():
        assert row["status"] == "ok" and row["mesh"] == "32x8"
        assert row["chips"] == 256
        sh = INPUT_SHAPES[shape]
        assert row["flops_total"] == troof.analytic_flops(cfg, sh)["total"]
        assert math.isclose(row["t_compute_s"], row["flops_total"] /
                            (256 * troof.PEAK_FLOPS))
        assert row["dominant"] in ("compute", "memory", "collective")
        assert row["memory_per_chip"]["argument_bytes"] == \
            inputs.argument_bytes(cfg, sh, m)["total"]
        lines = row["collectives"]["_by_line"]
        assert lines["model"]["all-reduce"]["count"] > 0
        assert lines["data"]["all-gather"]["count"] > 0
        assert row["link_bytes_per_chip"] > 0
    # decode: olmo-1b's 16 KV heads divide 8, so the cache layout is the
    # reference's; training reduce-scatters every gathered leaf's gradient
    assert rows["decode_32k"]["cache_layout"]["differs"] == []
    train = rows["train_4k"]["collectives"]["_by_line"]["data"]
    assert train["reduce-scatter"]["count"] > 0
    report.main(["--dir", str(out)])
    table = capsys.readouterr().out
    assert "2 ok / 0 failed" in table
    assert "| olmo-1b | train_4k | 32x8 |" in table
    assert "| model | all-reduce |" in table
    json.dumps(rows)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_slices_on_production_meshes_equal_reference_specs(arch):
    """Every decode and prefill cache of ``arch`` on ``32x8`` and
    ``2x32x8``, on the meta device: the port's layout
    (``gspmd_cache_layout``) gives the reference's ``cache_shardings``
    spec of every leaf (``reference_cache_specs``: KV heads over model,
    else the sequence over model, and a batch too small for the data line
    the sequence over every axis; an SSM state's conv channels and SSD
    heads over model), and a rank's cache has the slice shape that spec
    gives, its KV cache, conv tail and SSD state alike."""
    from repro_torch.models.transformer import init_cache
    for multi_pod in (False, True):
        m = tmesh.make_production_mesh(multi_pod=multi_pod)
        for shape, sh in INPUT_SHAPES.items():
            if sh.kind == "train":
                continue
            cfg = config_for_shape(arch, shape)
            lay = inputs.cache_layout(cfg, sh, m)
            assert lay["differs"] == [], (shape, lay)
            ref = inputs.reference_cache_specs(cfg, sh, m)
            whole = init_cache(cfg, sh.global_batch, sh.seq_len,
                               device="meta")
            leaves = {"kv": lambda c: c.kv.k, "conv": lambda c: c.ssm.conv,
                      "ssd": lambda c: c.ssm.ssd}
            assert set(ref) <= set(leaves) and ref, (shape, ref)
            for rank in (0, m.size - 1):
                got = inputs.cache_struct(cfg, sh, m, rank=rank)
                for leaf, spec in ref.items():
                    want = _ref_slice_shape(spec, leaves[leaf](whole).shape,
                                            m.shape)
                    assert tuple(leaves[leaf](got).shape) == want, (
                        shape, multi_pod, rank, leaf, spec)


def test_dryrun_gemma_decode_row_splits_the_sequence(tmp_path, capsys):
    """gemma-2b's one KV head divides no model axis: its ``decode_32k``
    row lays the cache out as the reference does (the sequence over
    model), so ``cache_layout`` differs nowhere, and the decode step
    gathers the slices' partial attention over the model line."""
    out = tmp_path / "rows"
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "gemma-2b", "--shape", "decode_32k", "--out",
                     str(out)])
    assert done.value.code == 0
    (row,) = report.load(str(out))
    assert row["status"] == "ok"
    assert row["cache_layout"]["differs"] == []
    assert row["cache_layout"]["port"]["kv"] == \
        "P(None, 'data', 'model', None, None)"
    gathers = row["collectives"]["_by_line"]["model"]["all-gather"]
    assert gathers["count"] >= config_for_shape("gemma-2b",
                                                "decode_32k").num_layers
    assert not torch.distributed.is_initialized()
