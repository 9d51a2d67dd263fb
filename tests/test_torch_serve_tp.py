"""The tensor-parallel serve path on VCI streams (``repro_torch.serve.comm``,
``ServeEngine(mesh=, comm_plan=)``) against the reference.

The port of ``tests/_multidev_checks.py::
check_serve_streams_match_single_stream``: the manual-TP engine on spawned
gloo ranks (``tests/test_torch_ranks.py serve_tp``) must give exactly the
tokens of the JAX single-device ``ServeEngine`` on the same bridged
params, for a dense tied-embedding arch (olmo-1b-smoke), an
expert-parallel MoE (mixtral-8x22b-smoke: 4 experts, 2 a rank) and an
ff-TP MoE (the same with 3 experts, which do not divide tp 2), on a data 2
x model 2 mesh (4 ranks) and a data 1 x model 2 mesh (2 ranks), at
num_vcis 1 (every context on the fallback VCI) and 8, contiguous (batch 4)
and paged (batch 2, 11 pages of 8: admission under the mesh). Beside it,
in one process: ``serve_param_specs`` and ``serve_tp_validate`` against
the reference's, and ``decode_kv_expand`` against the JAX model.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.configs import all_configs as jax_all_configs
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import synthetic_batch as jax_synthetic_batch
from repro.models import transformer as jtf
from repro.serve import comm as jcomm
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import transformer as ttf
from repro_torch.serve import comm as tcomm
from repro_torch.tree import tree_flatten

from test_torch_ranks import run_ranks

# arch:num_experts (0 = the arch's own)
CASES = ("olmo-1b-smoke:0", "mixtral-8x22b-smoke:0", "mixtral-8x22b-smoke:3")
MESHES = {"data2xmodel2": 4, "data1xmodel2": 2}
LAYOUTS = ("contiguous", "paged")
TP = 2


def _cfgs(case):
    arch, experts = case.split(":")
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    if int(experts):
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, num_experts=int(experts)))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=int(experts)))
    return jcfg, cfg


def _requests(vocab):
    rng = np.random.default_rng(7)
    return [JaxRequest(prompt=rng.integers(0, vocab, (plen,),
                                           dtype=np.int32),
                       max_new_tokens=5) for plen in (5, 9, 3, 7)]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The JAX single-device tokens and cache bytes of every case, then
    each mesh's ranks spawned once over every case; returns
    ``(reference, {mesh: [rank outputs]})``."""
    ref, inputs = {}, {"cases": np.asarray(CASES)}
    for case in CASES:
        jcfg, cfg = _cfgs(case)
        jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
        solo = JaxEngine(jcfg, jparams, batch_size=4, max_len=48)
        reqs = _requests(jcfg.vocab_size)
        solo.generate(reqs)
        ref[case] = dict(tokens=[np.asarray(r.generated) for r in reqs],
                         bytes=solo.cache_bytes_resident, cfg=cfg)
        leaves = tree_flatten(params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), "cpu"))[0]
        inputs[f"{case}/n_leaves"] = len(leaves)
        for i, leaf in enumerate(leaves):
            inputs[f"{case}/p{i}"] = leaf.numpy()
    outs = {}
    for mesh, n in MESHES.items():
        d = tmp_path_factory.mktemp(mesh)
        np.savez(d / "in.npz", **inputs)
        r = run_ranks("serve_tp", d, n, timeout=600)
        assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-4000:])
        outs[mesh] = [dict(np.load(d / f"out_{k}.npz")) for k in range(n)]
    return ref, outs


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("num_vcis", [1, 8])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_tokens_equal_jax_single_device(served, mesh, case, num_vcis,
                                           layout):
    """Every rank's tokens equal the JAX single-device engine's; the plan
    realised the expected VCI mapping; a paged pool leaks no page and
    admits under the mesh; every forward call issued one ``tp_attn`` and
    one FFN collective a layer (``tp_mlp``, or ``moe`` for an MoE) and two
    on ``sample`` (embedding sum, logits gather), and a contiguous cache
    sharded over data one token gather a call."""
    ref, outs = served
    want = ref[case]
    cfg = want["cfg"]
    key = f"{case}/{layout}/{num_vcis}"
    n_data = MESHES[mesh] // TP
    for rank, out in enumerate(outs[mesh]):
        for i, tok in enumerate(want["tokens"]):
            np.testing.assert_array_equal(
                out[f"{key}/tokens{i}"], tok,
                err_msg=f"{mesh} rank {rank} {key} request {i}")
        vcis = set(out[f"{key}/vcis"].tolist())
        if num_vcis == 1:
            assert vcis == {0} and int(out[f"{key}/fallback_hits"]) == 4
        else:
            assert len(vcis) == 4 and int(out[f"{key}/fallback_hits"]) == 0
        calls = int(out[f"{key}/calls"])
        ffn = "moe" if cfg.moe is not None else "tp_mlp"
        counts = {k.rsplit("/", 1)[1]: int(v) for k, v in out.items()
                  if k.startswith(f"{key}/count/")}
        gathers = calls if (layout == "contiguous" and n_data > 1) else 0
        want_counts = {"tp_attn": cfg.num_layers * calls,
                       ffn: cfg.num_layers * calls, "sample": 2 * calls}
        if gathers:
            want_counts["tokens"] = gathers
        assert counts == want_counts, (rank, counts, want_counts)
        if layout == "paged":
            owner = out[f"{key}/owner"]
            assert (owner[1:] == -1).all(), f"pages leaked: {owner}"
            assert int(out[f"{key}/admit"]) == 1
            assert int(out[f"{key}/bytes"]) < want["bytes"]
        else:
            assert int(out[f"{key}/admit"]) == 0


@pytest.mark.parametrize("case", CASES)
def test_tp_caches_hold_the_local_heads_and_rows(served, case):
    """A rank's contiguous cache holds 1/tp of the KV heads and, on the
    data-2 mesh, half the batch rows: its bytes (4-byte cursors aside)
    are the solo cache's / tp / data."""
    ref, outs = served
    solo = ref[case]["bytes"] - 8
    for mesh, n in MESHES.items():
        for out in outs[mesh]:
            got = int(out[f"{case}/contiguous/8/bytes"]) - 8
            assert got * TP * (n // TP) == solo, (mesh, got, solo)


def test_smoke_archs_are_refused_at_tp_4():
    """The smoke archs have 2 KV heads: tp 4 is refused, as there."""
    for arch in ("olmo-1b-smoke", "mixtral-8x22b-smoke"):
        with pytest.raises(ValueError, match="num_kv_heads 2 % tp"):
            tcomm.serve_tp_validate(get_config(arch), 4)


# ---------------------------------------------------------------------------
# in one process: specs, the TP contract, decode_kv_expand
# ---------------------------------------------------------------------------

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
    jcfg, cfg = _cfgs(case)
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


@pytest.mark.parametrize("expand", [1, 2, 4])
def test_decode_kv_expand_equals_reference(expand):
    """``decode_kv_expand`` stores each KV head ``e`` times, a pure layout
    change: the cache holds ``KV * e`` heads, and prefill + 10 decode
    steps give the JAX model's logits at the same ``e`` (f32, 1e-5), and
    those at ``e = 1`` (yi-9b-smoke with 8 query heads, so that 4 x 2 KV
    heads still divide them; the reference's
    ``test_decode_kv_expand_numerics``)."""
    base = dataclasses.replace(jax_get_config("yi-9b-smoke"), num_heads=8)
    tbase = dataclasses.replace(get_config("yi-9b-smoke"), num_heads=8)
    S = 20
    jparams = jtf.init_params(base, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    toks = np.asarray(jax_synthetic_batch(base, 2, S, seed=2)["tokens"])
    outs = {}
    for e in sorted({1, expand}):
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
        outs[e] = got
    np.testing.assert_allclose(outs[expand], outs[1], rtol=1e-5, atol=1e-5)


def test_all_to_all_on_gloo_ranks(tmp_path):
    """``CommRuntime.all_to_all`` on 4 gloo ranks, along the data group and
    both axes of a 2 x 2 mesh, against numpy."""
    r = run_ranks("all_to_all", tmp_path, 4)
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(np.load(tmp_path / "out_all_to_all.npz")["ok"]) == 1
