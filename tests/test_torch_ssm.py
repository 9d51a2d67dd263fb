"""The port's SSM serve slice (mamba2) against the JAX reference, on the CPU:
the Mamba2 block, the model and the serve engine (the SSD step is
``tests/test_torch_ssm_ssd.py``'s).

Inputs are made with numpy from a seed and fed to both sides; params come
from the reference's ``init_params`` through ``repro_torch.bridge``. All in
float32.

* ``mamba2_forward`` (with its conv tail state) and ``mamba2_decode`` on
  bridged params: within 1e-5.
* ``Model.forward`` and prefill + decode logits of mamba2-780m-smoke
  within 1e-4 (differences accumulate over the layers).
* The serve engine's greedy tokens equal the JAX engine's exactly, with
  equal ``cache_bytes_resident``.

The CUDA kernel is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``; the backward and SSM
training by ``tests/test_torch_ssm_train.py`` and
``test_torch_train_families.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (one intra-op thread: see its docstring)
from _torch_ssm import ATOL_MODEL, close, tensor
from repro.configs import get_config as jax_get_config
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro.serve import engine as jengine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
from repro_torch.serve import engine as tengine
from repro_torch.train.trainer import make_train_step

ARCH = "mamba2-780m-smoke"


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
    init = (tssm.SSMState(tensor(st0.conv), tensor(st0.ssd)) if initial else None)
    y, st = tssm.mamba2_forward(cfg, tensor(x), tp, initial=init)
    wy, wst = jssm.mamba2_forward(jcfg, jnp.asarray(x), jp,
                                  initial=st0 if initial else None)
    close(y, wy)
    close(st.ssd, wst.ssd)
    assert st.conv.shape == wst.conv.shape
    close(st.conv, wst.conv)


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
    y, st = tssm.mamba2_forward(cfg, tensor(x[:, :s]), tp)
    wy, _ = jssm.mamba2_forward(jcfg, jnp.asarray(x), jp)
    close(y, np.asarray(wy)[:, :s])
    zxbcdt = tensor(x[:, :s]) @ tp["in_proj"]
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
    y, st = tssm.mamba2_decode(cfg, tensor(x), tp,
                               tssm.SSMState(tensor(conv), tensor(ssd)))
    wy, wst = jssm.mamba2_decode(jcfg, jnp.asarray(x), jp,
                                 jssm.SSMState(jnp.asarray(conv),
                                               jnp.asarray(ssd)))
    close(y, wy)
    close(st.ssd, wst.ssd)
    close(st.conv, wst.conv)


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
                                                {"tokens": tensor(tokens)})
    want, _, _ = jtf.Model(jcfg).forward(jparams,
                                         {"tokens": jnp.asarray(tokens)})
    assert aux == {} and cache is None
    close(logits, want, atol=ATOL_MODEL)


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
        out, _, cache = model.forward(tparams, {"tokens": tensor(tokens)},
                                      cache=cache)
        wout, _, jcache = jmodel.forward(jparams,
                                         {"tokens": jnp.asarray(tokens)},
                                         cache=jcache)
        close(out, wout, atol=ATOL_MODEL)
        for f in feeds:
            out, cache = model.decode_step(tparams, tensor(f), cache)
            wout, jcache = jmodel.decode_step(jparams, jnp.asarray(f), jcache)
            close(out, wout, atol=ATOL_MODEL)
    assert cache.length == int(jcache.length) == s + 3
    assert cache.kv is None and jcache.kv is None
    close(cache.ssm.ssd, jcache.ssm.ssd, atol=ATOL_MODEL)
    close(cache.ssm.conv, jcache.ssm.conv, atol=ATOL_MODEL)


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
        _, _, cache = ttf.Model(cfg).forward(tparams, {"tokens": tensor(tokens)},
                                             cache=cache)
    _, _, jcache = jtf.Model(jcfg).forward(
        jparams, {"tokens": jnp.asarray(tokens)}, cache=jcache)
    assert jcache.ssm.conv.dtype == jnp.float32
    assert cache.ssm.conv.dtype == torch.float32
    close(cache.ssm.conv, jcache.ssm.conv)

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
