"""The port's ``comm="gspmd"`` train step (FSDP over the data ranks)
against the reference's single-device ``comm="gspmd"`` step on the whole
batch, the dense and MoE cases: ``tests/_torch_gspmd.py`` (its module doc)
holds the cases, their reference and their worlds of 1, 2 and 4 spawned
gloo ranks; ``tests/test_torch_gspmd_families.py`` holds the SSM, VLM and
audio cases. Beside them: the refusals the reference makes too, and the
Sharder's model and pod axes.
"""

import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (one intra-op thread: see its docstring)
from _torch_gspmd import (CASES as ALL, STEPS, check_slices, check_step,
                          fixtures, rank_out)
from repro.configs import get_config as jax_get_config
from repro.train.trainer import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.core.collectives import RankMesh
from repro_torch.dist.sharding import Sharder, is_spec, param_shapes
from repro_torch.tree import tree_flatten_with_paths

CASES = ["olmo", "olmo_accum2", "mixtral"]
reference, ranks = fixtures(CASES)


@pytest.mark.parametrize("case", CASES)
def test_gspmd_step_matches_reference_gspmd_step(reference, ranks, case):
    """Metrics each step and params after two steps against the
    reference's single-device step on the global batch."""
    check_step(reference, ranks, case)


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
    inputs, out = reference["olmo"].inputs, rank_out(d, "olmo", 0)
    cfg = get_config(ALL["olmo"][0])
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


@pytest.mark.parametrize("case", ["olmo", "mixtral"])
def test_gspmd_ranks_agree_and_hold_their_slices(ranks, case):
    """Every rank's metrics equal rank 0's (they are the global batch's);
    each rank holds its slice of the sliced leaves' params and moments and
    the whole replicated leaves, to the byte."""
    check_slices(ranks, case)


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
    tally = rank_out(d, "olmo", 0)["tally"]
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
    cfg = get_config(ALL["mixtral"][0])
    out = rank_out(d, "mixtral", 0)
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
