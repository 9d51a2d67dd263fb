"""The port's replicated AdamW (``optim/adamw.py::adamw_update``) against
the JAX reference's, through its leaf slices.

``adamw_update`` walks each leaf in slices of ``_UPDATE_CHUNK`` elements
and applies the global-norm clip inside each slice. Here that constant is
7, so every leaf but the smallest splits into several slices, the last one
short. Three steps on the same seeded numpy gradients must give: the same
bits as whole-leaf slices (``_UPDATE_CHUNK`` above every leaf's size); the
reference's params, moments and grad norm within rtol 1e-6 / atol 1e-7 in
f32, and within one rounding of the stored dtype in bf16 (2^-8 relative,
what a last-bit difference of the f32 math can move across a boundary);
and the update written into the very tensors passed in.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (one intra-op thread: see its docstring)
from repro.optim import adamw as jadamw
from repro_torch.optim import adamw as tadamw
from repro_torch.tree import tree_flatten

# leaf shapes: matrices (decayed) and vectors (not), one under a slice
_SHAPES = {"w": (5, 9), "b": (23,), "t": (3, 4, 5), "s": (6,)}
_DTYPES = {"float32": (torch.float32, jnp.float32),
           "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _tree(rng, scale):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in _SHAPES.items()}


def _run(params_np, grads_np, dtype, moment_dtype, max_grad_norm):
    """3 steps of the port's update; returns params, state and norms, and
    checks that every step wrote into the tensors it was given."""
    params = {k: torch.from_numpy(v.copy()).to(dtype)
              for k, v in params_np.items()}
    state = tadamw.adamw_init(params, moment_dtype)
    ptrs = [t.data_ptr() for t in tree_flatten((params, state.m,
                                                state.v))[0]]
    norms = []
    for g_np in grads_np:
        grads = {k: torch.from_numpy(v.copy()).to(dtype)
                 for k, v in g_np.items()}
        new_p, new_state, m = tadamw.adamw_update(
            grads, state, params, lr=1e-2, max_grad_norm=max_grad_norm)
        assert [t.data_ptr() for t in tree_flatten(
            (new_p, new_state.m, new_state.v))[0]] == ptrs
        for name in ("m", "v"):
            for k in _SHAPES:
                assert getattr(new_state, name)[k] is \
                    getattr(state, name)[k]
        assert all(new_p[k] is params[k] for k in _SHAPES)
        state = new_state
        norms.append(float(m["grad_norm"]))
    return params, state, norms


@pytest.mark.parametrize("max_grad_norm", [0.5, None])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sliced_update_matches_reference(monkeypatch, dtype, max_grad_norm):
    tdt, jdt = _DTYPES[dtype]
    rng = np.random.default_rng(7)
    params_np = _tree(rng, 1.0)
    # gradients with a global norm of about 3, so a 0.5 clip scales them
    grads_np = [_tree(rng, 0.3) for _ in range(3)]

    monkeypatch.setattr(tadamw, "_UPDATE_CHUNK", 1 << 20)
    whole = _run(params_np, grads_np, tdt, tdt, max_grad_norm)
    monkeypatch.setattr(tadamw, "_UPDATE_CHUNK", 7)
    params, state, norms = _run(params_np, grads_np, tdt, tdt,
                                max_grad_norm)
    for k in _SHAPES:
        assert torch.equal(params[k], whole[0][k]), k
        assert torch.equal(state.m[k], whole[1].m[k]), k
        assert torch.equal(state.v[k], whole[1].v[k]), k
    assert norms == whole[2]

    jparams = {k: jnp.asarray(v, jdt) for k, v in params_np.items()}
    jstate = jadamw.adamw_init(jparams, jdt)
    jnorms = []
    for g_np in grads_np:
        grads = {k: jnp.asarray(v, jdt) for k, v in g_np.items()}
        jparams, jstate, jm = jadamw.adamw_update(
            grads, jstate, jparams, lr=jnp.float32(1e-2),
            max_grad_norm=max_grad_norm)
        jnorms.append(float(jm["grad_norm"]))
    np.testing.assert_allclose(norms, jnorms, rtol=1e-6)
    if max_grad_norm is not None:
        assert min(norms) > max_grad_norm  # the clip scaled every step
    tol = dict(rtol=1e-6, atol=1e-7) if dtype == "float32" \
        else dict(rtol=2 ** -8, atol=1e-7)
    for name, got, want in (("params", params, jparams),
                            ("m", state.m, jstate.m),
                            ("v", state.v, jstate.v)):
        for k in _SHAPES:
            np.testing.assert_allclose(
                got[k].float().numpy(), np.asarray(want[k], np.float32),
                err_msg=f"{dtype} {name}[{k}]", **tol)
    assert int(state.count) == int(jstate.count) == 3
