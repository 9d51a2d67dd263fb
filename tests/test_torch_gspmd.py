"""The port's ``comm="gspmd"`` train step (FSDP over the data ranks)
against the reference's single-device ``comm="gspmd"`` step on the whole
batch.

Same params (the reference's ``init_params`` through the rank files, in
leaf order), same numpy batches, float32 smoke configs on the CPU. The
port runs on 1, 2 and 4 spawned gloo ranks (``tests/test_torch_ranks.py
gspmd``), each rank holding its slice of every leaf the rule table shards
over data; the reference runs ``make_train_step(comm="gspmd")`` with
``mesh=None``. Two steps of every case: the dense, MoE (the load balance
of the global batch), SSM, VLM (ranks holding different counts of
``PAD_LABEL``) and audio smoke archs, and the dense arch with two
microbatches.

Tolerances are ``tests/test_torch_train.py``'s (its module doc): metrics
rtol 1e-5, params by its rules, the VLM's with its noise rule. The ranks'
metrics must be equal, and each rank must hold ``1/N`` of the sliced
leaves' params and moments plus the replicated leaves, to the byte.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (warms torch.exp: see its docstring)
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import PAD_LABEL
from repro.data.pipeline import synthetic_batch as jax_synthetic_batch
from repro.train.trainer import make_train_step as jax_make_train_step
from repro.train.trainer import train_state_init as jax_train_state_init
from repro_torch.configs import get_config
from repro_torch.core.collectives import RankMesh
from repro_torch.dist.sharding import (Sharder, is_spec, param_shapes,
                                      param_specs)
from repro_torch.tree import tree_flatten_with_paths

from test_torch_ranks import run_ranks
from test_torch_train import METRIC_RTOL, _assert_params_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, BATCH = 2, 8
KEYS = ("loss", "ce", "grad_norm", "tokens", "load_balance", "router_z",
        "lr")
# case -> (arch, seq, accum)
CASES = {
    "olmo": ("olmo-1b-smoke", 32, 1),
    "olmo_accum2": ("olmo-1b-smoke", 32, 2),
    "mixtral": ("mixtral-8x22b-smoke", 32, 1),
    "mamba2": ("mamba2-780m-smoke", 40, 1),
    "phi3v": ("phi-3-vision-4.2b-smoke", 32, 1),
    "musicgen": ("musicgen-large-smoke", 16, 1),
}
RANKS = (1, 2, 4)


def _batches(jcfg, seq):
    out = []
    for i in range(STEPS):
        b = dict(jax_synthetic_batch(jcfg, BATCH, seq, seed=3, step=i))
        if jcfg.modality == "vlm":
            # ranks hold different counts of PAD labels
            labels = b["labels"].copy()
            labels[1, -4:] = PAD_LABEL
            labels[BATCH - 1, jcfg.num_patches:jcfg.num_patches + 3] = \
                PAD_LABEL
            b["labels"] = labels
        out.append(b)
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Each case's inputs (for the rank files) and the reference's metrics
    a step, params and second moments after the steps."""
    out = {}
    for case, (arch, seq, accum) in CASES.items():
        jcfg = jax_get_config(arch)
        state = jax_train_state_init(jcfg, jax.random.PRNGKey(0))
        leaves = [np.asarray(l) for l in
                  jax.tree_util.tree_leaves(state.params)]
        batches = _batches(jcfg, seq)
        inputs = dict(arch=arch, accum=accum, steps=STEPS,
                      n_leaves=len(leaves),
                      **{f"p{i}": l for i, l in enumerate(leaves)})
        for i, b in enumerate(batches):
            inputs.update({f"{k}{i}": np.asarray(v) for k, v in b.items()})
        step = jax.jit(jax_make_train_step(jcfg, comm="gspmd",
                                           accum_steps=accum))
        metrics = []
        for b in batches:
            state, m = step(state, b)
            metrics.append([float(m[k]) for k in KEYS])
        out[case] = SimpleNamespace(
            inputs=inputs, metrics=np.asarray(metrics),
            params=[np.asarray(l) for l in
                    jax.tree_util.tree_leaves(state.params)],
            v=[np.asarray(l) for l in jax.tree_util.tree_leaves(state.opt.v)])
    return out


@pytest.fixture(scope="module", params=RANKS, ids=lambda n: f"{n}ranks")
def ranks(request, reference, tmp_path_factory):
    """Every case on ``n`` spawned gloo ranks: ``(n, directory)``."""
    n = request.param
    d = tmp_path_factory.mktemp(f"gspmd{n}")
    for case, ref in reference.items():
        np.savez(d / f"gspmd_{case}.npz", **ref.inputs)
    r = run_ranks("gspmd", d, n=n, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    return n, d


def _out(d, case, rank):
    return np.load(d / f"gspmd_out_{case}_r{rank}.npz")


@pytest.mark.parametrize("case", list(CASES))
def test_gspmd_step_matches_reference_gspmd_step(reference, ranks, case):
    """Metrics each step and params after two steps against the
    reference's single-device step on the global batch."""
    n, d = ranks
    ref, out = reference[case], _out(d, case, 0)
    for i in range(STEPS):
        for j, k in enumerate(KEYS):
            np.testing.assert_allclose(out["metrics"][i, j],
                                       ref.metrics[i, j], rtol=METRIC_RTOL,
                                       err_msg=f"{case} {n} ranks step {i} "
                                               f"{k}")
    if CASES[case][0].startswith("mixtral"):
        assert (out["metrics"][:, KEYS.index("load_balance")] > 0).all()
    _assert_params_close([out[f"p{i}"] for i in range(len(ref.params))],
                         ref.params, f"{case} {n} ranks", steps=STEPS,
                         ref_v=ref.v if case == "phi3v" else None)


def test_fsdp_equals_one_rank_with_the_ranks_rows_as_microbatches(
        reference, ranks):
    """FSDP over N ranks and one rank taking the same rows as N
    microbatches do the same sums in nearly the same order (each layer's
    N row-block gradients summed once), so every param element agrees
    within 1e-6 after two steps, where the reference tolerances let one
    in 10^4 go past that: a check that the ranks compute the one-rank
    step itself, and not something merely close to it."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.train.trainer import make_train_step, train_state_init
    from repro_torch.models.transformer import init_params
    from repro_torch.tree import tree_flatten, tree_unflatten
    n, d = ranks
    inputs, out = reference["olmo"].inputs, _out(d, "olmo", 0)
    cfg = get_config(CASES["olmo"][0])
    treedef = tree_flatten(init_params(cfg, 0, device="meta"))[1]
    params = tree_unflatten(treedef, [
        params_from_numpy(inputs[f"p{i}"], "cpu")
        for i in range(int(inputs["n_leaves"]))])
    state = train_state_init(cfg, params=params, comm="gspmd")
    step = make_train_step(cfg, accum_steps=n)
    for i in range(STEPS):
        state, m = step(state, {k: inputs[f"{k}{i}"]
                                for k in ("tokens", "labels")})
        np.testing.assert_allclose(out["metrics"][i, 0], float(m["loss"]),
                                   rtol=1e-6)
    for i, t in enumerate(tree_flatten(state.params)[0]):
        np.testing.assert_allclose(out[f"p{i}"], t.numpy(), rtol=0,
                                   atol=1e-6, err_msg=f"leaf {i}")


def _expected_bytes(cfg, n):
    """(params, moments) bytes of one rank: ``1/n`` of each leaf the rule
    table shards over data, the whole of the rest."""
    mesh = SimpleNamespace(axis_names=("data",), shape={"data": n})
    specs = dict(tree_flatten_with_paths(param_specs(cfg, mesh),
                                         is_leaf=is_spec))
    p = m = 0
    mdt = torch.empty((), dtype=getattr(torch, cfg.optimizer_dtype))
    for path, leaf in tree_flatten_with_paths(param_shapes(cfg)):
        split = n if any(e == "data" for e in specs[path]) else 1
        p += leaf.numel() * leaf.element_size() // split
        m += 2 * leaf.numel() * mdt.element_size() // split
    return p, m


@pytest.mark.parametrize("case", ["olmo", "mixtral", "mamba2", "phi3v",
                                  "musicgen"])
def test_gspmd_ranks_agree_and_hold_their_slices(ranks, case):
    """Every rank's metrics equal rank 0's (they are the global batch's);
    each rank holds its slice of the sliced leaves' params and moments and
    the whole replicated leaves, to the byte."""
    n, d = ranks
    cfg = get_config(CASES[case][0])
    want_p, want_m = _expected_bytes(cfg, n)
    for r in range(n):
        out = _out(d, case, r)
        np.testing.assert_array_equal(out["metrics"],
                                      _out(d, case, 0)["metrics"])
        assert int(out["param_bytes"]) == want_p, (r, case)
        assert int(out["moment_bytes"]) == want_m, (r, case)
    if n > 1:
        full = sum(l.numel() * l.element_size() for _, l in
                   tree_flatten_with_paths(param_shapes(cfg)))
        assert want_p < full


def test_gspmd_collectives_a_step(ranks):
    """The dense smoke arch (remat "none", tied embeddings, no norm params):
    every leaf is sliced, so a step gathers each layer's leaves once and
    the table twice (the embedding and the tied head), and reduce-scatters
    each gather's gradient once; it all-reduces the token count, the
    metrics' shares and the clip's sum of squares (no replicated leaf)."""
    n, d = ranks
    cfg = get_config("olmo-1b-smoke")
    shard = Sharder(None, cfg)
    per_layer = sum(1 for p, _ in tree_flatten_with_paths(
        shard.specs, is_leaf=is_spec) if p[0] == "layers")
    tally = _out(d, "olmo", 0)["tally"]
    if n == 1:
        assert (tally == 0).all()
        return
    gathers = per_layer * cfg.num_layers + 2
    for t in tally:
        assert tuple(t) == (gathers, gathers, 3), t


def test_mixtral_expert_tables_are_not_gathered(ranks):
    """mixtral-8x22b-smoke on a data-only mesh: its 4 experts divide 2 and
    4 ranks, so each rank holds its experts' tables whole and runs them on
    every rank's rows (the dispatch and the combine exchanged over the
    ranks, forward and backward: 4 all_to_alls a layer) instead of
    gathering the tables: a step's gathers receive the bytes of the other
    leaves the table slices over data and none of the experts', and the
    step still equals the reference's
    (``test_gspmd_step_matches_reference[mixtral]``)."""
    n, d = ranks
    cfg = get_config(CASES["mixtral"][0])
    out = _out(d, "mixtral", 0)
    if n == 1:
        assert int(out["gather_bytes"]) == 0
        return
    cut = Sharder(RankMesh(n, 1), cfg, rank=0)
    experts = others = 0
    for path, leaf in tree_flatten_with_paths(param_shapes(cfg)):
        if cut.sharded_dim(path) is None:
            continue
        size = leaf.numel() * leaf.element_size()
        if cut.expert_parallel(path):
            experts += size
        else:
            others += size
    assert experts > 0
    assert int(out["gather_bytes"]) == others, (out["gather_bytes"], others)
    assert int(out["all_to_all"]) == 4 * cfg.num_layers


@pytest.mark.parametrize("n", [2, 4])
def test_materialize_backward_equals_whole_leaf_autograd(tmp_path, n):
    """The reduce-scatter backward of the FSDP gather gives each rank its
    slice of autograd's gradient of the summed per-rank losses through the
    whole leaves."""
    r = run_ranks("gather_grad", tmp_path, n=n)
    assert r.returncode == 0, r.stdout + r.stderr
    for rank in range(n):
        assert float(np.load(tmp_path / f"gather_grad_r{rank}.npy")) < 2e-6


@pytest.mark.parametrize("knob", [dict(optimizer="zero1"),
                                  dict(schedule="overlap")])
def test_gspmd_keeps_the_references_refusals(knob):
    """ZeRO-1 and the overlap schedule are the VCI mode's: with gspmd the
    port refuses them as the reference does, with its message."""
    with pytest.raises(ValueError) as ref:
        jax_make_train_step(jax_get_config("olmo-1b-smoke"), comm="gspmd",
                            **knob)
    from repro_torch.train.trainer import make_train_step
    with pytest.raises(ValueError) as got:
        make_train_step(get_config("olmo-1b-smoke"), comm="gspmd", **knob)
    assert str(got.value) == str(ref.value)


def test_a_model_axis_raises_naming_item_14():
    """Once refused: the Sharder takes a model axis (training on a
    ``data x model`` mesh is ``tests/test_torch_model_axis.py``); a rank
    cuts its slices along both of a leaf's dims. The launcher's pod axis
    and a ``kv_fp8`` cache, the last refusals that named ROADMAP.md Queue
    1 item 14, are taken too: a 3-D ``--mesh`` cuts like the 2-D mesh of
    its data line (``2x2x2`` as ``4x2``: specs over ``("pod", "data")``),
    and the cache stores fp8. A 4-D ``--mesh`` still raises."""
    from repro_torch.launch.train import build_mesh
    from repro_torch.models.transformer import init_cache
    cfg = get_config("olmo-1b-smoke")
    cut = Sharder(RankMesh(2, 2), cfg, rank=3)
    path = ("layers", "attn", "wq")
    assert cut.sharded_dim(path) == 1 and cut.model_dim(path) == 2
    assert cut.local_shape(path) == (cfg.num_layers, cfg.d_model // 2,
                                     cfg.q_dim // 2)
    pod, flat = build_mesh("2x2x2"), build_mesh("4x2")
    for r in range(8):
        a, b = Sharder(pod, cfg, rank=r), Sharder(flat, cfg, rank=r)
        assert a.specs["layers"]["attn"]["wq"] == \
            (None, ("pod", "data"), "model")
        assert (a.data_rank, a.model_rank) == (b.data_rank, b.model_rank)
        assert a.local_shape(path) == b.local_shape(path)
        assert a.leaf_index(path, 3) == b.leaf_index(path, 3)
    assert pod.lines("data") == flat.lines("data")
    assert pod.lines("model") == flat.lines("model")
    with pytest.raises(ValueError, match="PxDxM"):
        build_mesh("2x2x2x2")
    c = init_cache(cfg.with_opts("kv_fp8"), 1, 8, device="cpu")
    assert c.kv.k.dtype == torch.float8_e4m3fn


def _cli(*extra, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
           "cpu", "--arch", "olmo-1b-smoke", "--steps", "2", "--batch", "4",
           "--seq", "32", "--log-every", "1", *extra]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                       env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


@pytest.mark.parametrize("mesh", ["none", "2"])
def test_cli_trains_with_the_default_comm(mesh):
    """``--comm`` defaults to gspmd, as in the reference: one rank in this
    process, or FSDP over two spawned ranks; the two print the same loss
    lines."""
    out = _cli("--mesh", mesh)
    assert "comm=gspmd" in out
    steps = [ln.split()[:4] for ln in out.splitlines()
             if ln.startswith("step ")]
    assert len(steps) == 2 and all(np.isfinite(float(s[3])) for s in steps)
    assert [s[3] for s in steps] == ["6.2922", "6.2704"], out
