"""The port's checkpoints (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint.io``): the same files, both ways.

* A reference checkpoint of an f32 smoke ``TrainState`` (after a step, so
  the moments are not zero) and of a bf16 one load into the port's state
  bit for bit; the port's files of the same trees are byte for byte the
  reference's, manifest included.
* A port checkpoint of an f32 state loads in the reference bit for bit.
* The reference cannot restore its own bf16 leaf (``np.load`` gives
  ``'<V2'`` bytes, which its ``astype`` refuses); the port restores it.
* Replicated (VCI), ZeRO-1 and FSDP (``comm="gspmd"``) states saved on 2
  spawned gloo ranks load on 1, 2 and 4 ranks, save again to the same
  bytes, and step on: on the same 2 ranks the resumed step equals the
  uninterrupted one bit for bit, on 1 and 4 within ``tests/
  _torch_train.py``'s rules (another sum order of the gradients).
* The tree and shape mismatch errors are the reference's.
* The CLI's resume is ``tests/test_torch_checkpoint_cli.py``'s.
"""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (one intra-op thread: see its docstring)
from _torch_train import assert_params_close
from repro.checkpoint.io import load_checkpoint as jax_load_checkpoint
from repro.checkpoint.io import save_checkpoint as jax_save_checkpoint
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import synthetic_batch as jax_synthetic_batch
from repro.train.trainer import make_train_step as jax_make_train_step
from repro.train.trainer import train_state_init as jax_train_state_init
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                    load_state, save_checkpoint, save_state)
from repro_torch.configs import get_config
from repro_torch.train.trainer import make_train_step, train_state_init
from repro_torch.tree import tree_flatten, tree_flatten_with_paths

from test_torch_ranks import run_ranks

ARCH = "olmo-1b-smoke"


def _jax_state(dtype="float32"):
    """The reference's state after one gspmd step (moments nonzero)."""
    jcfg = jax_get_config(ARCH)
    if dtype != "float32":
        import dataclasses
        jcfg = dataclasses.replace(jcfg, param_dtype=dtype)
    state = jax_train_state_init(jcfg, jax.random.PRNGKey(0))
    step = jax.jit(jax_make_train_step(jcfg, comm="gspmd"))
    state, _ = step(state, jax_synthetic_batch(jcfg, 4, 32, seed=0))
    return jcfg, state


def _port_like(dtype="float32"):
    import dataclasses
    cfg = dataclasses.replace(get_config(ARCH), param_dtype=dtype)
    return train_state_init(cfg, 0, device="cpu", comm="gspmd")


def _bits(x):
    """The raw bits of an array or tensor, flat, as ints of its width."""
    if isinstance(x, torch.Tensor):
        t = x.detach().reshape(-1)
        return t.view({2: torch.int16, 4: torch.int32}[
            t.element_size()]).numpy()
    a = np.asarray(x).reshape(-1)
    return a.view({2: np.int16, 4: np.int32}[a.itemsize])


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_loads_into_the_port_bit_for_bit(tmp_path,
                                                              dtype):
    """Every leaf of the reference's TrainState, at its path, with its
    bits; the port writes the same files from the restored state."""
    _, jstate = _jax_state(dtype)
    jax_save_checkpoint(str(tmp_path / "ref"), 1, jstate,
                        metadata={"arch": ARCH})
    like = _port_like(dtype)
    state = load_checkpoint(str(tmp_path / "ref"), 1, like)
    got = tree_flatten_with_paths(state)
    want = jax.tree_util.tree_flatten_with_path(jstate)[0]
    assert len(got) == len(want)
    for (path, t), (_, w) in zip(got, want):
        assert t.dtype == dict(tree_flatten_with_paths(like))[path].dtype
        np.testing.assert_array_equal(_bits(t), _bits(w), err_msg=path)
    if dtype == "bfloat16":
        assert state.params["embed"]["tok"].dtype == torch.bfloat16
    save_checkpoint(str(tmp_path / "port"), 1, state,
                    metadata={"arch": ARCH})
    _same_files(tmp_path / "ref" / "step_00000001",
                tmp_path / "port" / "step_00000001")


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    """An f32 port state after a gspmd step, written by the port, read by
    the reference into its own state's structure, bit for bit."""
    cfg = get_config(ARCH)
    jcfg, jstate = _jax_state()
    state = train_state_init(cfg, params=params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate.params), "cpu"),
        comm="gspmd")
    state, _ = make_train_step(cfg)(state, jax_synthetic_batch(
        jcfg, 4, 32, seed=1))
    save_checkpoint(str(tmp_path), 2, state)
    back = jax_load_checkpoint(str(tmp_path), 2, jstate)
    for (path, t), w in zip(tree_flatten_with_paths(state),
                            jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(_bits(t), _bits(w), err_msg=path)


def test_reference_cannot_restore_its_own_bf16_leaf(tmp_path):
    """A fact about the reference (ROADMAP.md Queue 3): its
    ``load_checkpoint`` raises on the bf16 leaf its ``save_checkpoint``
    wrote; the port reads the same file back bit for bit."""
    leaf = jnp.asarray(np.random.default_rng(0).normal(size=(2, 3)),
                       jnp.bfloat16)
    jax_save_checkpoint(str(tmp_path), 1, {"w": leaf})
    with open(tmp_path / "step_00000001" / "leaf_00000.npy", "rb") as f:
        assert b"'descr': '<V2'" in f.read(128)
    with pytest.raises(ValueError, match="No cast function"):
        jax_load_checkpoint(str(tmp_path), 1, {"w": leaf})
    got = load_checkpoint(str(tmp_path), 1,
                          {"w": torch.empty(2, 3, dtype=torch.bfloat16)})
    np.testing.assert_array_equal(_bits(got["w"]), _bits(leaf))


@pytest.mark.parametrize("case", ["missing", "extra", "shape"])
def test_mismatches_raise_as_the_reference_does(tmp_path, case):
    """The reference's messages for a tree or a shape that differs from the
    checkpoint's, from the same files."""
    tree = {"a": np.ones((2, 3), np.float32), "b": np.zeros(4, np.int32)}
    jax_save_checkpoint(str(tmp_path), 3, tree)
    if case == "missing":
        like = {"a": tree["a"]}
    elif case == "extra":
        like = dict(tree, c=np.ones(1, np.float32))
    else:
        like = {"a": np.ones((3, 2), np.float32), "b": tree["b"]}
    with pytest.raises(ValueError) as ref:
        jax_load_checkpoint(str(tmp_path), 3, like)
    with pytest.raises(ValueError) as got:
        load_checkpoint(str(tmp_path), 3,
                        {k: torch.from_numpy(v) for k, v in like.items()})
    assert str(got.value) == str(ref.value)


def test_resume_equals_an_uninterrupted_run(tmp_path):
    """One rank, gspmd: two steps, against one step, a save, a load into a
    fresh state (the saved bits) and a second step: the same bits. On
    ``_torch_cpu``'s one intra-op thread: threaded, this CPU build of
    PyTorch sums some gradients (the embedding's) in another order from
    one run to the next, so two runs of one step differ in their last
    bits."""
    assert torch.get_num_threads() == 1
    cfg = get_config(ARCH)
    batches = [jax_synthetic_batch(jax_get_config(ARCH), 4, 32, seed=0,
                                   step=i) for i in range(2)]
    step = make_train_step(cfg)
    full = train_state_init(cfg, 0, device="cpu", comm="gspmd")
    for b in batches:
        full, _ = step(full, b)
    state, _ = step(train_state_init(cfg, 0, device="cpu", comm="gspmd"),
                    batches[0])
    save_state(str(tmp_path), 1, state)
    assert latest_step(str(tmp_path)) == 1
    back = load_state(str(tmp_path), 1,
                      train_state_init(cfg, 5, device="cpu", comm="gspmd"))
    for (path, a), (_, b) in zip(tree_flatten_with_paths(back),
                                 tree_flatten_with_paths(state)):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    back, _ = make_train_step(cfg)(back, batches[1])
    for (path, a), (_, b) in zip(tree_flatten_with_paths(back),
                                 tree_flatten_with_paths(full)):
        assert torch.equal(a, b), path


@pytest.fixture(scope="module")
def saved_on_two_ranks(tmp_path_factory):
    """ckpt.npz (the reference's params, three batches) and each layout's
    step-1 and step-2 checkpoints from 2 ranks."""
    d = tmp_path_factory.mktemp("ckpt")
    jcfg = jax_get_config(ARCH)
    state = jax_train_state_init(jcfg, jax.random.PRNGKey(0))
    leaves = [np.asarray(l) for l in jax.tree_util.tree_leaves(state.params)]
    inputs = dict(arch=ARCH, n_leaves=len(leaves),
                  **{f"p{i}": l for i, l in enumerate(leaves)})
    for i in range(2):
        b = jax_synthetic_batch(jcfg, 4, 32, seed=2, step=i)
        inputs.update({f"{k}{i}": v for k, v in b.items()})
    np.savez(d / "ckpt.npz", **inputs)
    r = run_ranks("ckpt_save", d, n=2)
    assert r.returncode == 0, r.stdout + r.stderr
    return d


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda n: f"{n}ranks")
def loaded(request, saved_on_two_ranks):
    d, n = saved_on_two_ranks, request.param
    r = run_ranks("ckpt_load", d, n=n)
    assert r.returncode == 0, r.stdout + r.stderr
    return d, n


@pytest.mark.parametrize("layout", ["vci", "zero1", "gspmd"])
def test_states_round_trip_across_rank_counts(loaded, layout):
    """Saved on 2 ranks, restored on n and saved again: the same files (the
    restored state equals the saved one); the step after the resume equals
    the uninterrupted step 2 bit for bit on the same 2 ranks, and within
    the train tests' rules on 1 and 4."""
    d, n = loaded
    _same_files(d / f"save_{layout}" / "step_00000001",
                d / f"resave_{layout}_{n}" / "step_00000001")
    like = train_state_init(get_config(ARCH), 0, device="cpu", comm="gspmd")
    full = load_checkpoint(str(d / f"full_{layout}"), 2, like) \
        if layout != "zero1" else None
    if n == 2:
        _same_files(d / f"full_{layout}" / "step_00000002",
                    d / f"resume_{layout}_{n}" / "step_00000002")
    elif full is not None:
        resumed = load_checkpoint(str(d / f"resume_{layout}_{n}"), 2, like)
        assert_params_close(tree_flatten(resumed.params)[0],
                            tree_flatten(full.params)[0],
                            f"{layout} on {n}", steps=1)
    else:
        # ZeRO-1's buckets: the f32 masters, by the same rules
        a = np.load(d / "full_zero1" / "step_00000002" / "leaf_00000.npy")
        b = np.load(d / f"resume_zero1_{n}" / "step_00000002" /
                    "leaf_00000.npy")
        assert_params_close([b], [a], f"zero1 on {n}", steps=1)
