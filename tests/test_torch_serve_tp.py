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
and paged (batch 2, 11 pages of 8: admission under the mesh).
``serve_param_specs`` and ``serve_tp_validate`` against the reference's
are ``tests/test_torch_serve_tp_specs.py``; ``shard_params``,
``decode_kv_expand`` and the all-to-all on gloo ranks are
``tests/test_torch_serve_tp_layout.py``.
"""

import jax
import numpy as np
import pytest

import _torch_cpu  # noqa: F401  (one intra-op thread: see its docstring)
from _torch_serve_tp import case_cfgs
from repro.models import transformer as jtf
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.serve import comm as tcomm
from repro_torch.tree import tree_flatten

from test_torch_ranks import run_ranks

# arch:num_experts (0 = the arch's own)
CASES = ("olmo-1b-smoke:0", "mixtral-8x22b-smoke:0", "mixtral-8x22b-smoke:3")
MESHES = {"data2xmodel2": 4, "data1xmodel2": 2}
LAYOUTS = ("contiguous", "paged")
TP = 2


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
        jcfg, cfg = case_cfgs(case)
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
