"""The port's flash attention (the dispatcher op with its autograd, on the
CPU) against the JAX reference.

Inputs are made with numpy from a seed and fed to both sides. The plain
forward is held against the model's ``repro.models.attention.attention``
where ``start`` masks pad rows, and its log-sum-exp against numpy. The
recompute backward is held against ``jax.vjp`` of
``repro.kernels.ref.attention_ref`` and against torch autograd of the plain
forward (f32: 1e-5, the same math summed in another order). A windowed
olmo-1b-smoke is held against the JAX model at ``_torch_train.py``'s
tolerances. The forward against the Pallas kernel in interpret mode is
``tests/test_torch_flash_attention.py``'s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (one intra-op thread: see its docstring)
from _torch_flash import model_layout, qkv, to_numpy
from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.train.losses import total_loss as jax_total_loss
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.transformer import Model
from repro_torch.train.losses import total_loss
from repro_torch.tree import tree_flatten, tree_unflatten

ATOL = 1e-5


# ---------------------------------------------------------------------------
# (2) start: the model's attention with pad rows, and the Function on CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 5])
def test_start_matches_model_attention(window):
    """Rows with no valid key (q < start) included: the reference's uniform
    softmax over all keys."""
    jcfg = dataclasses.replace(jax_get_config("olmo-1b-smoke"),
                               sliding_window=window)
    q, k, v = qkv(4, 3, 4, 2, 20, 20, 16)
    start = np.asarray([0, 7, 19], np.int32)
    want = jattn.attention(jcfg, *(jnp.asarray(x.transpose(0, 2, 1, 3))
                                   for x in (q, k, v)),
                           start=jnp.asarray(start))
    tq, tk, tv = (model_layout(x) for x in (q, k, v))
    got, _ = fa.flash_attention_fwd_plain(tq, tk, tv, window=window,
                                          start=torch.from_numpy(start))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=ATOL, rtol=0)
    n0 = fa.flash_attention.launches
    through = fa.flash_attention(tq, tk, tv, window=window,
                                 start=torch.from_numpy(start))
    assert torch.equal(through, got)
    assert fa.flash_attention.launches == n0   # the CPU launches nothing


# ---------------------------------------------------------------------------
# (3) lse against numpy
# ---------------------------------------------------------------------------

def _np_lse(q, k, *, causal, window, start):
    """float64 log-sum-exp of the masked, scaled logits; masked = f32 -1e30."""
    b, h, sq, hd = q.shape
    rep = h // k.shape[1]
    kk = np.repeat(k, rep, axis=1).astype(np.float64)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), kk) / np.sqrt(hd)
    qp, kp = np.arange(sq)[:, None], np.arange(k.shape[2])[None, :]
    mask = np.ones((b, 1, sq, k.shape[2]), bool)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    if start is not None:
        mask &= kp >= start[:, None, None, None]
    s = np.where(mask, s, np.float64(np.float32(fa.NEG_INF)))
    m = s.max(-1)
    return m + np.log(np.exp(s - m[..., None]).sum(-1))


@pytest.mark.parametrize("causal,sq,sk,window,start", [
    (True, 24, 24, None, None),
    (True, 24, 24, 6, [0, 9]),          # pad rows: lse = -1e30
    (False, 16, 40, 12, [3, 0]),
    (False, 40, 16, 8, None),           # rows past skv + window - 1: empty
])
def test_lse_matches_numpy(causal, sq, sk, window, start):
    q, k, v = qkv(6, 2, 4, 2, sq, sk, 32)
    st = None if start is None else np.asarray(start, np.int32)
    _, lse = fa.flash_attention_fwd_plain(
        *(model_layout(x) for x in (q, k, v)), causal=causal, window=window,
        start=None if st is None else torch.from_numpy(st))
    want = _np_lse(q, k, causal=causal, window=window, start=st)
    np.testing.assert_allclose(lse.numpy().astype(np.float64), want,
                               atol=ATOL, rtol=1e-6)


# ---------------------------------------------------------------------------
# (4) the recompute backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,sq,sk,h,kv,window", [
    (True, 32, 32, 4, 2, 8),
    (True, 24, 24, 4, 1, None),
    (False, 20, 28, 4, 2, 6),
    (False, 24, 8, 2, 2, 4),            # rows with no valid key
])
def test_backward_matches_jax_vjp_and_autograd(causal, sq, sk, h, kv,
                                               window):
    q, k, v = qkv(7, 2, h, kv, sq, sk, 16)
    do = np.random.default_rng(8).normal(size=q.shape).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b_, c: jref.attention_ref(
        a, b_, c, causal=causal, window=window),
        *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))

    tq, tk, tv = (model_layout(x).requires_grad_() for x in (q, k, v))
    tdo = model_layout(do)
    o, lse = fa.flash_attention_fwd_plain(tq, tk, tv, causal=causal,
                                          window=window)
    np.testing.assert_allclose(to_numpy(o.transpose(1, 2)), np.asarray(out),
                               atol=ATOL, rtol=0)
    auto = torch.autograd.grad(o, (tq, tk, tv), tdo)
    with torch.no_grad():
        got = fa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo,
                                           causal=causal, window=window)
    through = torch.autograd.grad(
        fa.flash_attention(tq, tk, tv, causal=causal, window=window),
        (tq, tk, tv), tdo)
    for name, g, a, t, j in zip("qkv", got, auto, through, jgrads):
        assert g.shape == a.shape, name
        np.testing.assert_allclose(to_numpy(g.transpose(1, 2)), np.asarray(j),
                                   atol=ATOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(to_numpy(g), to_numpy(a), atol=ATOL, rtol=0,
                                   err_msg=name)
        assert torch.equal(t, g), name


def test_backward_refuses_start():
    tq, tk, tv = (model_layout(x).requires_grad_()
                  for x in qkv(9, 1, 2, 2, 8, 8, 16))
    o = fa.flash_attention(tq, tk, tv, start=torch.tensor([2],
                                                          dtype=torch.int32))
    with pytest.raises(ValueError, match="start"):
        o.sum().backward()
    with pytest.raises(ValueError, match="start"):
        fa.flash_attention_bwd_plain(tq, tk, tv, o, None, o,
                                     start=torch.tensor([2]))


# ---------------------------------------------------------------------------
# the wrapper's refusals (metadata only, so they run here) and devices
# ---------------------------------------------------------------------------

def test_kernel_argument_checks():
    q, k, v = (model_layout(x) for x in qkv(10, 1, 4, 2, 8, 8, 64))
    fa._check_cuda_args(q, k, v, None, None)              # accepted
    with pytest.raises(TypeError, match="dtype"):
        fa._check_cuda_args(q.double(), k.double(), v.double(), None, None)
    with pytest.raises(TypeError, match="dtype"):
        fa._check_cuda_args(q, k.bfloat16(), v, None, None)
    with pytest.raises(ValueError, match="head_dim"):
        fa._check_cuda_args(q[..., :32].contiguous(), k[..., :32].contiguous(),
                            v[..., :32].contiguous(), None, None)
    wide = torch.zeros(1, 8, 4, 128)
    with pytest.raises(ValueError, match="contiguous last dim"):
        fa._check_cuda_args(wide[..., ::2], k, v, None, None)
    with pytest.raises(ValueError, match="must be on"):
        fa._check_cuda_args(q, k.to("meta"), v, None, None)
    with pytest.raises(ValueError, match="window"):
        fa._check_cuda_args(q, k, v, None, 0)
    with pytest.raises(ValueError, match="start"):
        fa._check_cuda_args(q, k, v, torch.zeros(2, dtype=torch.int32), None)
    with pytest.raises(ValueError, match="fit"):
        fa._check_cuda_args(torch.zeros(1, 8, 3, 64), k, v, None, None)


def test_kernel_argument_checks_take_every_kernel_head_dim():
    """96 and 112 (phi-3-vision, zamba2-7b) pass the check beside 64, 128
    and 256; 32 is still refused."""
    for hd in (64, 96, 112, 128, 256):
        q, k, v = (model_layout(x) for x in qkv(12, 1, 4, 2, 8, 8, hd))
        fa._check_cuda_args(q.bfloat16(), k.bfloat16(), v.bfloat16(), None,
                            None)
    q, k, v = (model_layout(x) for x in qkv(12, 1, 4, 2, 8, 8, 32))
    with pytest.raises(ValueError, match="head_dim"):
        fa._check_cuda_args(q, k, v, None, None)


def test_non_cpu_tensor_never_reaches_the_plain_forward():
    """A tensor that is neither on the CPU nor on a card raises in the
    forward; the dispatcher op gives a meta tensor its registered fake
    (shapes only, no arithmetic) and never the plain forward."""
    q, k, v = (torch.empty(1, 8, 2, 64, device="meta") for _ in range(3))
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention_fwd(q, k, v)
    o, lse = fa.flash_fwd(q, k, v, None, True, None)
    assert (o.device.type, o.shape, o.dtype) == ("meta", q.shape, q.dtype)
    assert (lse.shape, lse.dtype) == ((1, 2, 8), torch.float32)
    assert fa.flash_attention(q, k, v).device.type == "meta"


def test_inference_mode_runs_through_the_function():
    q, k, v = (model_layout(x) for x in qkv(11, 1, 2, 2, 8, 8, 16))
    with torch.inference_mode():
        got = fa.flash_attention(q, k, v)
    assert torch.equal(got, fa.flash_attention_fwd_plain(q, k, v)[0])


# ---------------------------------------------------------------------------
# (5) a windowed olmo-1b-smoke against the JAX model
# ---------------------------------------------------------------------------

def test_windowed_model_logits_and_grads_match_reference():
    """olmo-1b-smoke with sliding_window=8 at seq 32: forward logits
    (1e-4, as ``test_torch_models.py``), loss (rtol 1e-5) and gradients
    (``_torch_train.py``'s parameter rule) equal to JAX's."""
    jcfg = dataclasses.replace(jax_get_config("olmo-1b-smoke"),
                               sliding_window=8)
    cfg = dataclasses.replace(get_config("olmo-1b-smoke"), sliding_window=8)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(12)
    tokens = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)

    def jloss(p):
        logits, aux, _ = jtf.Model(jcfg).forward(p, {"tokens": tokens})
        return jax_total_loss(jcfg, logits, jnp.asarray(labels), aux)[0], \
            logits
    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)

    leaves, treedef = tree_flatten(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu"))
    leaves = [x.requires_grad_() for x in leaves]
    logits, aux, _ = Model(cfg).forward(tree_unflatten(treedef, leaves),
                                        {"tokens": torch.from_numpy(tokens)})
    loss, _ = total_loss(cfg, logits, torch.from_numpy(labels), aux)
    grads = torch.autograd.grad(loss, leaves)

    np.testing.assert_allclose(to_numpy(logits), np.asarray(jlogits), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    off = total = 0
    for g, w in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        g, w = to_numpy(g), np.asarray(w, np.float32)
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=1e-4)
        off += int((np.abs(g - w) > 1e-6 + 2e-5 * np.abs(w)).sum())
        total += w.size
    assert off <= total * 1e-4, f"{off} of {total} gradient elements off"
