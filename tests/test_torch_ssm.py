"""The port's SSM serve slice (mamba2) against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and fed to both sides; params come
from the reference's ``init_params`` through ``repro_torch.bridge``. All in
float32 (``x``/``B``/``C`` also in bf16 for the intra-chunk step, upcast by
both sides).

* ``ssd_chunk_plain`` (the CPU path of the SSD kernel) against
  ``ssd_chunk_pallas`` in interpret mode and ``ssd_chunk_batched_ref``, in
  their ``(b*h, nc, c, ...)`` layout with ``B``/``C`` repeated over heads:
  within 1e-5 (the same f32 products, summed in another order).
* ``ssd_chunked`` against ``repro.models.ssm.ssd_chunked`` (with and
  without an initial state, with and without padding to a chunk multiple)
  and ``repro.kernels.ops.ssd_chunked``: within 1e-5 — the inter-chunk
  loop sums in another order than ``lax.associative_scan``.
* ``ssd_decode_step``, ``mamba2_forward`` (with its conv tail state) and
  ``mamba2_decode`` on bridged params: within 1e-5.
* ``Model.forward`` and prefill + decode logits of mamba2-780m-smoke
  within 1e-4 (differences accumulate over the layers).
* The serve engine's greedy tokens equal the JAX engine's exactly, with
  equal ``cache_bytes_resident``.

The CUDA kernel is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``; the backward and SSM
training by ``tests/test_torch_ssm_train.py`` and ``test_torch_train.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (warms torch.exp: see its docstring)
from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jops
from repro.kernels.ref import ssd_chunk_batched_ref
from repro.kernels.ssd_scan import ssd_chunk_pallas
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro.serve import engine as jengine
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels import ssd_scan
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
from repro_torch.serve import engine as tengine
from repro_torch.train.trainer import make_train_step

ARCH = "mamba2-780m-smoke"
ATOL = 1e-5      # one SSD scan or one Mamba2 block in f32
ATOL_MODEL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=atol)


def _ssd_inputs(seed, b, s, h, p, g, n, dtype=np.float32):
    """x, dt, A, B, C as numpy: dt = softplus-range steps, A < 0."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(dtype)
    dt = rng.uniform(1e-3, 0.1, size=(b, s, h)).astype(np.float32)
    A = -rng.uniform(1.0, 16.0, size=(h,)).astype(np.float32)
    B = rng.normal(size=(b, s, g, n)).astype(dtype)
    C = rng.normal(size=(b, s, g, n)).astype(dtype)
    return x, dt, A, B, C


def _cum(dt, A, chunk):
    b, s, h = dt.shape
    return (dt * A).reshape(b, s // chunk, chunk, h).cumsum(2).reshape(
        b, s, h).astype(np.float32)


# ---------------------------------------------------------------------------
# the intra-chunk step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [1, 2])
def test_ssd_chunk_plain_matches_reference(g, dtype):
    b, s, h, p, n, chunk = 2, 64, 4, 8, 16, 32
    np_dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    x, dt, A, B, C = _ssd_inputs(g, b, s, h, p, g, n, np_dt)
    cum = _cum(dt, A, chunk)
    before = ssd_scan.ssd_chunk.launches
    y, st = ssd_scan.ssd_chunk(*(tensor_from_numpy(a, "cpu")
                                 for a in (x, dt, cum, B, C)), chunk)
    assert ssd_scan.ssd_chunk.launches == before   # CPU: no kernel
    assert y.dtype == st.dtype == torch.float32
    assert y.shape == (b, s, h, p) and st.shape == (b, s // chunk, h, n, p)

    # the Pallas layout: (b*h, nc, c, ...), B/C repeated over the heads
    nc, rep = s // chunk, h // g

    def flat(a):  # (b, s, h, ...) -> (b*h, nc, c, ...)
        a = jnp.asarray(a).reshape((b, nc, chunk, h) + a.shape[3:])
        a = jnp.moveaxis(a, 3, 1)
        return a.reshape((b * h, nc, chunk) + a.shape[4:])

    Bh, Ch = (np.repeat(a, rep, axis=2) for a in (B, C))
    args = (flat(x), flat(dt), flat(cum), flat(Bh), flat(Ch))

    def unflat(yk, sk):
        yk = np.asarray(yk).reshape(b, h, s, p).transpose(0, 2, 1, 3)
        sk = np.asarray(sk).reshape(b, h, nc, n, p).transpose(0, 2, 1, 3, 4)
        return yk, sk

    for yk, sk in (unflat(*ssd_chunk_pallas(*args, interpret=True)),
                   unflat(*ssd_chunk_batched_ref(*args))):
        _close(y, yk)
        _close(st, sk)


@pytest.mark.parametrize("case", ["dtype", "dt_dtype", "shape", "chunk",
                                  "groups", "d_state", "strided",
                                  "requires_grad", "device"])
def test_ssd_chunk_kernel_refusals(case):
    """What the CUDA kernel cannot take is refused before a launch (checked
    here on CPU tensors; a CPU tensor itself never reaches the kernel)."""
    b, s, h, p, g, n = 1, 8, 2, 4, 1, 4
    x, dt, cum = torch.zeros(b, s, h, p), torch.zeros(b, s, h), \
        torch.zeros(b, s, h)
    B, C = torch.zeros(b, s, g, n), torch.zeros(b, s, g, n)
    chunk, err, match = 4, ValueError, None
    if case == "dtype":
        x, B, C = x.double(), B.double(), C.double()
        err, match = TypeError, "one dtype"
    elif case == "dt_dtype":
        dt, err, match = dt.bfloat16(), TypeError, "float32"
    elif case == "shape":
        cum, match = torch.zeros(b, s, h + 1), "do not fit"
    elif case == "chunk":
        chunk, match = 3, "multiple of chunk"
    elif case == "groups":
        B, C, match = torch.zeros(b, s, 3, n), torch.zeros(b, s, 3, n), \
            "multiple of g"
    elif case == "d_state":
        B, C, match = torch.zeros(b, s, g, 300), torch.zeros(b, s, g, 300), \
            "d_state"
    elif case == "strided":
        x, match = torch.zeros(b, s, h, 2 * p)[..., ::2], "contiguous"
    elif case == "requires_grad":
        # a tensor that requires grad goes in (the op's backward is the
        # backward kernel); the backward refuses an output gradient it
        # cannot take
        x.requires_grad_()
        assert ssd_scan._check_cuda_args(x, dt, cum, B, C, chunk)[0] == b
        with pytest.raises(ValueError, match="dy"):
            ssd_scan._check_bwd_args(x, dt, cum, B, C, x.detach().double(),
                                     None, chunk)
        err, match = ValueError, "d_state <= 128"
        B, C = torch.zeros(b, s, g, 200), torch.zeros(b, s, g, 200)
        with pytest.raises(err, match=match):
            ssd_scan._check_bwd_args(x, dt, cum, B, C, torch.zeros(b, s, h, p),
                                     None, chunk)
        return
    else:
        dt, match = torch.zeros(b, s, h, device="meta"), "must be on"
    with pytest.raises(err, match=match):
        ssd_scan._check_cuda_args(x, dt, cum, B, C, chunk)


def test_ssd_chunk_refuses_other_devices():
    t = torch.zeros(1, 4, 2, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ssd_scan.ssd_chunk(t, t[..., 0], t[..., 0], t[:, :, :1], t[:, :, :1],
                           4)


# ---------------------------------------------------------------------------
# the blocked scan and the decode step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [64, 50])          # 50: padded to 64
@pytest.mark.parametrize("initial", [False, True])
@pytest.mark.parametrize("g", [1, 2])
def test_ssd_chunked_matches_model_reference(s, initial, g):
    b, h, p, n, chunk = 2, 4, 8, 16, 16
    x, dt, A, B, C = _ssd_inputs(7, b, s, h, p, g, n)
    init = (np.random.default_rng(8).normal(size=(b, h, n, p))
            .astype(np.float32) if initial else None)
    y, fs = tssm.ssd_chunked(_t(x), _t(dt), _t(A), _t(B), _t(C), chunk=chunk,
                             initial_state=None if init is None else _t(init))
    wy, wfs = jssm.ssd_chunked(
        jnp.asarray(x), jnp.asarray(dt), jnp.asarray(A), jnp.asarray(B),
        jnp.asarray(C), chunk=chunk,
        initial_state=None if init is None else jnp.asarray(init))
    assert y.shape == (b, s, h, p) and fs.dtype == torch.float32
    _close(y, wy)
    _close(fs, wfs)


def test_ssd_chunked_matches_pallas_wrapper():
    """``kernels/ops.py::ssd_chunked`` (the Pallas kernel in interpret mode
    + an associative scan) takes no initial state and s % chunk == 0."""
    b, s, h, p, g, n, chunk = 2, 96, 4, 8, 2, 16, 32
    x, dt, A, B, C = _ssd_inputs(9, b, s, h, p, g, n)
    y, fs = tssm.ssd_chunked(_t(x), _t(dt), _t(A), _t(B), _t(C), chunk=chunk)
    wy, wfs = jops.ssd_chunked(jnp.asarray(x), jnp.asarray(dt),
                               jnp.asarray(A), jnp.asarray(B),
                               jnp.asarray(C), chunk=chunk, interpret=True)
    _close(y, wy)
    _close(fs, wfs)


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_decode_step_matches_reference(g):
    rng = np.random.default_rng(10 + g)
    b, h, p, n = 3, 4, 8, 16
    state = rng.normal(size=(b, h, n, p)).astype(np.float32)
    x = rng.normal(size=(b, h, p)).astype(np.float32)
    dt = rng.uniform(1e-3, 0.1, size=(b, h)).astype(np.float32)
    A = -rng.uniform(1.0, 16.0, size=(h,)).astype(np.float32)
    B = rng.normal(size=(b, g, n)).astype(np.float32)
    C = rng.normal(size=(b, g, n)).astype(np.float32)
    y, ns = tssm.ssd_decode_step(*(_t(a) for a in (state, x, dt, A, B, C)))
    wy, wns = jssm.ssd_decode_step(*(jnp.asarray(a)
                                     for a in (state, x, dt, A, B, C)))
    _close(y, wy)
    _close(ns, wns)


# ---------------------------------------------------------------------------
# the Mamba2 block, on bridged params
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba():
    jcfg = jax_get_config(ARCH)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    return get_config(ARCH), jcfg, tparams, jparams


def _layer0(tree):
    if isinstance(tree, dict):
        return {k: _layer0(v) for k, v in tree.items()}
    return tree[0]


@pytest.mark.parametrize("s,initial", [(50, False), (50, True), (3, False)])
def test_mamba2_forward_matches_reference(mamba, s, initial):
    """s = 50 pads to 64 (chunk 32, two chunks); s = 3 is one chunk, padded,
    and exactly the conv tail."""
    cfg, jcfg, tparams, jparams = mamba
    tp, jp = _layer0(tparams["layers"]["ssm"]), _layer0(jparams["layers"]["ssm"])
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    st0 = jssm.SSMState.init(jcfg, 2)
    if initial:
        st0 = st0._replace(ssd=jnp.asarray(rng.normal(
            size=st0.ssd.shape).astype(np.float32)))
    init = (tssm.SSMState(_t(st0.conv), _t(st0.ssd)) if initial else None)
    y, st = tssm.mamba2_forward(cfg, _t(x), tp, initial=init)
    wy, wst = jssm.mamba2_forward(jcfg, jnp.asarray(x), jp,
                                  initial=st0 if initial else None)
    _close(y, wy)
    _close(st.ssd, wst.ssd)
    assert st.conv.shape == wst.conv.shape
    _close(st.conv, wst.conv)


@pytest.mark.parametrize("s", [1, 2])
def test_mamba2_forward_short_prompt_is_causal(mamba, s):
    """A prompt shorter than the conv tail (width - 1 = 3). The reference's
    ``_causal_conv`` pads with ``xbc[:, :width-1]``, which has only ``s``
    rows then, so its conv is not causal for such prompts (ROADMAP.md Queue
    3); the port pads ``width - 1`` rows. Held instead to the reference on
    an 8-token sequence whose first ``s`` tokens are these: a causal block's
    first ``s`` outputs do not depend on what follows."""
    cfg, jcfg, tparams, jparams = mamba
    tp, jp = _layer0(tparams["layers"]["ssm"]), _layer0(jparams["layers"]["ssm"])
    x = np.random.default_rng(20 + s).normal(
        size=(2, 8, cfg.d_model)).astype(np.float32)
    y, st = tssm.mamba2_forward(cfg, _t(x[:, :s]), tp)
    wy, _ = jssm.mamba2_forward(jcfg, jnp.asarray(x), jp)
    _close(y, np.asarray(wy)[:, :s])
    zxbcdt = _t(x[:, :s]) @ tp["in_proj"]
    raw = tssm._split_proj(cfg, zxbcdt)[1]
    assert st.conv.shape == (2, 3, raw.shape[-1])
    assert torch.equal(st.conv[:, 3 - s:], raw)
    assert not st.conv[:, : 3 - s].any()


def test_mamba2_decode_matches_reference(mamba):
    cfg, jcfg, tparams, jparams = mamba
    tp, jp = _layer0(tparams["layers"]["ssm"]), _layer0(jparams["layers"]["ssm"])
    rng = np.random.default_rng(12)
    st0 = jssm.SSMState.init(jcfg, 3)
    conv = rng.normal(size=st0.conv.shape).astype(np.float32)
    ssd = rng.normal(size=st0.ssd.shape).astype(np.float32)
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    y, st = tssm.mamba2_decode(cfg, _t(x), tp,
                               tssm.SSMState(_t(conv), _t(ssd)))
    wy, wst = jssm.mamba2_decode(jcfg, jnp.asarray(x), jp,
                                 jssm.SSMState(jnp.asarray(conv),
                                               jnp.asarray(ssd)))
    _close(y, wy)
    _close(st.ssd, wst.ssd)
    _close(st.conv, wst.conv)


def test_ssm_params_match_reference_layout(mamba):
    """``init_params`` makes the reference's tree: same keys, shapes and
    dtypes (the numbers differ: another generator)."""
    cfg, jcfg, tparams, _ = mamba
    for c in (cfg, dataclasses.replace(cfg, param_dtype="bfloat16")):
        mine = ttf.init_params(c, 0, device="cpu")
        jc = dataclasses.replace(jcfg, param_dtype=c.param_dtype)
        want = jax.eval_shape(lambda: jtf.init_params(jc, jax.random.PRNGKey(0)))
        flat_w = {jax.tree_util.keystr(k): v for k, v in
                  jax.tree_util.tree_flatten_with_path(want)[0]}
        flat_m = {jax.tree_util.keystr(k): v for k, v in
                  jax.tree_util.tree_flatten_with_path(mine)[0]}
        assert flat_m.keys() == flat_w.keys()
        for k, v in flat_w.items():
            assert tuple(flat_m[k].shape) == v.shape, k
            assert str(flat_m[k].dtype).replace("torch.", "") == \
                str(v.dtype), k
    sp = mine["layers"]["ssm"]
    # softplus(dt_bias) spans [1e-3, 1e-1]; A = -exp(A_log) spans [-16, -1]
    dt = torch.nn.functional.softplus(sp["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001
    assert torch.allclose(sp["A_log"][:, -1].exp(), torch.tensor(16.0))


# ---------------------------------------------------------------------------
# the model and the engine
# ---------------------------------------------------------------------------

def test_model_forward_logits_match_reference(mamba):
    cfg, jcfg, tparams, jparams = mamba
    tokens = np.random.default_rng(13).integers(0, cfg.vocab_size, (2, 40),
                                                dtype=np.int32)
    logits, aux, cache = ttf.Model(cfg).forward(tparams,
                                                {"tokens": _t(tokens)})
    want, _, _ = jtf.Model(jcfg).forward(jparams,
                                         {"tokens": jnp.asarray(tokens)})
    assert aux == {} and cache is None
    _close(logits, want, atol=ATOL_MODEL)


def test_prefill_and_decode_logits_match_reference(mamba):
    """Prefill 40 tokens (two chunks, padded) into a cache, then 3 decode
    steps fed the same tokens on both sides; the caches agree too."""
    cfg, jcfg, tparams, jparams = mamba
    rng = np.random.default_rng(14)
    b, s = 2, 40
    tokens = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
    feeds = rng.integers(0, cfg.vocab_size, (3, b, 1), dtype=np.int32)
    model, jmodel = ttf.Model(cfg), jtf.Model(jcfg)
    cache = ttf.init_cache(cfg, b, 64, dtype=torch.float32, device="cpu")
    jcache = jtf.init_cache(jcfg, b, 64, dtype=jnp.float32)
    with torch.inference_mode():
        out, _, cache = model.forward(tparams, {"tokens": _t(tokens)},
                                      cache=cache)
        wout, _, jcache = jmodel.forward(jparams,
                                         {"tokens": jnp.asarray(tokens)},
                                         cache=jcache)
        _close(out, wout, atol=ATOL_MODEL)
        for f in feeds:
            out, cache = model.decode_step(tparams, _t(f), cache)
            wout, jcache = jmodel.decode_step(jparams, jnp.asarray(f), jcache)
            _close(out, wout, atol=ATOL_MODEL)
    assert cache.length == int(jcache.length) == s + 3
    assert cache.kv is None and jcache.kv is None
    _close(cache.ssm.ssd, jcache.ssm.ssd, atol=ATOL_MODEL)
    _close(cache.ssm.conv, jcache.ssm.conv, atol=ATOL_MODEL)


def test_cache_bytes_match_reference(mamba):
    cfg, jcfg, _, _ = mamba
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        mine = ttf.init_cache(cfg, 3, 128, dtype=dtype, device="cpu")
        want = jtf.init_cache(jcfg, 3, 128, dtype=jdtype)
        assert mine.nbytes() == sum(
            leaf.size * leaf.dtype.itemsize
            for leaf in jax.tree_util.tree_leaves(want))
        assert mine.ssm.conv.dtype == dtype
        assert mine.ssm.ssd.dtype == torch.float32


def test_bf16_cache_conv_tail_and_tokens_match_reference(mamba):
    """f32 params with a bf16 cache: after prefill the conv tail is in the
    activations' dtype (f32) and equals the reference's, as the reference
    re-types it (``repro/models/ssm.py:205-210``); the grouped engine's
    greedy tokens and ``cache_bytes_resident`` equal the JAX engine's."""
    cfg, jcfg, tparams, jparams = mamba
    rng = np.random.default_rng(16)
    tokens = rng.integers(0, cfg.vocab_size, (2, 7), dtype=np.int32)
    cache = ttf.init_cache(cfg, 2, 32, dtype=torch.bfloat16, device="cpu")
    jcache = jtf.init_cache(jcfg, 2, 32, dtype=jnp.bfloat16)
    with torch.inference_mode():
        _, _, cache = ttf.Model(cfg).forward(tparams, {"tokens": _t(tokens)},
                                             cache=cache)
    _, _, jcache = jtf.Model(jcfg).forward(
        jparams, {"tokens": jnp.asarray(tokens)}, cache=jcache)
    assert jcache.ssm.conv.dtype == jnp.float32
    assert cache.ssm.conv.dtype == torch.float32
    _close(cache.ssm.conv, jcache.ssm.conv)

    reqs = [dict(prompt=rng.integers(0, 512, (p,), dtype=np.int32),
                 max_new_tokens=n) for p, n in ((6, 8), (6, 5), (3, 6))]
    kw = dict(batch_size=2, max_len=32)
    jeng = jengine.ServeEngine(jcfg, jparams, cache_dtype=jnp.bfloat16, **kw)
    want = [r.generated for r in jeng.generate(
        [jengine.Request(**r) for r in reqs])]
    teng = tengine.ServeEngine(cfg, tparams, device="cpu",
                               cache_dtype=torch.bfloat16, **kw)
    done = teng.generate([tengine.Request(**r) for r in reqs])
    for i, (r, w) in enumerate(zip(done, want)):
        np.testing.assert_array_equal(r.generated, w, err_msg=f"request {i}")
    assert teng.cache_bytes_resident == jeng.cache_bytes_resident


def test_start_offsets_are_refused(mamba):
    cfg, _, tparams, _ = mamba
    tokens = torch.zeros((2, 4), dtype=torch.int32)
    start = torch.zeros(2, dtype=torch.int32)
    model = ttf.Model(cfg)
    with pytest.raises(NotImplementedError, match="pad mask"):
        model.forward(tparams, {"tokens": tokens}, start=start)
    cache = ttf.init_cache(cfg, 2, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="attention masking"):
        model.decode_step(tparams, tokens[:, :1], cache, start=start)
    with pytest.raises(NotImplementedError, match="attention arch"):
        ttf.init_paged_cache(cfg, 2, 8, page_size=4, num_pages=5,
                             device="cpu")


def _requests(kind):
    """Mixed prompt lengths: three groups (lengths 5, 9, 40), the 9-token
    group split over two batches of 2; ``stop``: a stop token that some
    rows sample."""
    rng = np.random.default_rng(15)
    spec = [(9, 6), (5, 4), (9, 7), (40, 5), (9, 6), (5, 3)]
    reqs = [dict(prompt=rng.integers(0, 512, (p,), dtype=np.int32),
                 max_new_tokens=n) for p, n in spec]
    if kind == "stop":
        for r in reqs:
            r["stop_token"] = 29
    return reqs


@pytest.mark.parametrize("kind", ["mixed", "stop"])
def test_ssm_engine_tokens_match_reference(mamba, kind):
    cfg, jcfg, tparams, jparams = mamba
    reqs = _requests(kind)
    kw = dict(batch_size=2, max_len=64, paged=True, page_size=8)
    jeng = jengine.ServeEngine(jcfg, jparams, **kw)
    want = [r.generated for r in jeng.generate(
        [jengine.Request(**r) for r in reqs])]
    teng = tengine.ServeEngine(cfg, tparams, device="cpu", **kw)
    assert not teng._paged and not jeng._paged   # SSM: grouped contiguous
    done = teng.generate([tengine.Request(**r) for r in reqs])
    for i, (r, w) in enumerate(zip(done, want)):
        np.testing.assert_array_equal(r.generated, w,
                                      err_msg=f"request {i} ({kind})")
    assert teng.cache_bytes_resident == jeng.cache_bytes_resident
    if kind == "stop":
        assert any(len(w) < r["max_new_tokens"] for w, r in zip(want, reqs))


def test_ssm_training_and_other_families_are_refused():
    # SSM training, once refused here (item 12b), now builds; the serve
    # engine still refuses a VLM
    make_train_step(get_config(ARCH), comm="vci")
    vlm = get_config("phi-3-vision-4.2b-smoke")
    with pytest.raises(NotImplementedError, match="does not serve a VLM"):
        tengine.ServeEngine(vlm, ttf.init_params(vlm, 0, device="cpu"),
                            batch_size=2, max_len=64, device="cpu")
    # audio, once refused beside it (item 13c), trains too
    make_train_step(get_config("musicgen-large-smoke"), comm="vci")


def test_cli_serves_ssm_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--arch", ARCH, "--vary-prompts", "--paged",
          "--requests", "4", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "arch=mamba2-780m-smoke" in out
    assert "grouped equal-length contiguous path" in out
    assert "4 requests, 16 new tokens" in out
