"""The port's layers, attention and dense model against the JAX reference.

Inputs are made with numpy from a seed and fed to both sides; params come
from the reference's ``init_params`` through ``repro_torch.bridge``. All in
float32 on the CPU. Tolerances: 1e-5 for single layers (the same f32 math,
summed in another order); 1e-4 for whole-model logits, where those
differences accumulate over the layers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (one intra-op thread: see its docstring)
from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_norms_match():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    scale = rng.normal(size=(32,)).astype(np.float32)
    bias = rng.normal(size=(32,)).astype(np.float32)
    _close(tlayers.rms_norm(_t(x), _t(scale)),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    _close(tlayers.layer_norm(_t(x), _t(scale), _t(bias)),
           jlayers.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                              jnp.asarray(bias)))
    _close(tlayers.layer_norm(_t(x)), jlayers.layer_norm(jnp.asarray(x)))


@pytest.mark.parametrize("batched_pos", [False, True])
def test_apply_rope_matches(batched_pos):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, 3, 16)).astype(np.float32)
    pos = (rng.integers(0, 50, (2, 6)) if batched_pos
           else np.arange(6)).astype(np.int32)
    _close(tlayers.apply_rope(_t(x), _t(pos), 10_000.0),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0))


@pytest.mark.parametrize("arch", ["olmo-1b-smoke", "gemma-2b-smoke"])
def test_gated_ffn_matches(arch):  # olmo: SwiGLU, gemma: GeGLU (tanh gelu)
    cfg = get_config(arch)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, cfg.d_model)).astype(np.float32)
    p = {k: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("w_gate", (cfg.d_model, cfg.d_ff)),
                      ("w_up", (cfg.d_model, cfg.d_ff)),
                      ("w_down", (cfg.d_ff, cfg.d_model)))}
    got = tlayers.gated_ffn(cfg, _t(x), {k: _t(v) for k, v in p.items()})
    want = jlayers.gated_ffn(jax_get_config(arch), jnp.asarray(x),
                             {k: jnp.asarray(v) for k, v in p.items()})
    _close(got, want)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _qkv(rng, b, sq, skv, h, kv, hd):
    return (rng.normal(size=(b, sq, h, hd)).astype(np.float32),
            rng.normal(size=(b, skv, kv, hd)).astype(np.float32),
            rng.normal(size=(b, skv, kv, hd)).astype(np.float32))


@pytest.mark.parametrize("arch,window", [("olmo-1b-smoke", None),
                                         ("gemma-2b-smoke", None),
                                         ("gemma-2b-smoke", 4)])
def test_attention_with_start_matches(arch, window):
    cfg = dataclasses.replace(get_config(arch), sliding_window=window)
    jcfg = dataclasses.replace(jax_get_config(arch), sliding_window=window)
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 3, 7, 7, cfg.num_heads, cfg.num_kv_heads, 8)
    start = np.asarray([0, 2, 6], np.int32)
    got = tattn.attention(cfg, _t(q), _t(k), _t(v), start=_t(start))
    want = jattn.attention(jcfg, jnp.asarray(q), jnp.asarray(k),
                           jnp.asarray(v), start=jnp.asarray(start))
    _close(got, want)


def test_decode_attention_with_start_matches():
    """Includes a row whose valid range is empty: uniform softmax, no NaN."""
    cfg, jcfg = get_config("gemma-2b-smoke"), jax_get_config("gemma-2b-smoke")
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, 3, 1, 12, cfg.num_heads, cfg.num_kv_heads, 8)
    start = np.asarray([0, 4, 11], np.int32)
    for length in (5, 12, 3):
        got = tattn.decode_attention(cfg, _t(q),
                                     tattn.KVCache(_t(k), _t(v), length),
                                     start=_t(start))
        want = jattn.decode_attention(
            jcfg, jnp.asarray(q),
            jattn.KVCache(jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(length, jnp.int32)),
            start=jnp.asarray(start))
        assert np.isfinite(got.numpy()).all()
        _close(got, want)


def _paged_state(rng, b=3, np_=9, ps=4, kv=2, hd=8, maxp=4):
    pool_k = rng.normal(size=(np_, ps, kv, hd)).astype(np.float32)
    pool_v = rng.normal(size=(np_, ps, kv, hd)).astype(np.float32)
    table = np.full((b, maxp), -1, np.int32)
    ids = rng.permutation(np_ - 1)[: b * 2] + 1
    table[0, :2] = ids[:2]        # slot 0: pages 0-1
    table[1, 1:3] = ids[2:4]      # slot 1: pad prefix on page 0 (unmapped)
    table[2, 0:2] = ids[4:6]
    return pool_k, pool_v, table


def _jlayer(pk, pv, table, length, ps):
    return jattn.PagedKVLayer(jnp.asarray(pk), jnp.asarray(pv),
                              jnp.asarray(table),
                              jnp.asarray(length, jnp.int32), ps)


def test_paged_update_and_prefill_match():
    """In-place paged writes equal the reference's functional ones on every
    page but the trash page 0 (its duplicate writes have no defined
    winner, and it is never read)."""
    rng = np.random.default_rng(5)
    pk, pv, table = _paged_state(rng)
    kn = rng.normal(size=(3, 1, 2, 8)).astype(np.float32)
    vn = rng.normal(size=(3, 1, 2, 8)).astype(np.float32)
    for length in (2, 5):
        got = tattn.paged_update_decode(
            tattn.PagedKVLayer(_t(pk), _t(pv), _t(table), length, 4),
            _t(kn), _t(vn))
        want = jattn.paged_update_decode(_jlayer(pk, pv, table, length, 4),
                                         jnp.asarray(kn), jnp.asarray(vn))
        assert got.length == int(want.length) == length + 1
        _close(got.k[1:], want.k[1:], atol=0)
        _close(got.v[1:], want.v[1:], atol=0)

    kp = rng.normal(size=(3, 7, 2, 8)).astype(np.float32)
    vp = rng.normal(size=(3, 7, 2, 8)).astype(np.float32)
    got = tattn.paged_prefill_update(
        tattn.PagedKVLayer(_t(pk), _t(pv), _t(table), 0, 4), _t(kp), _t(vp))
    want = jattn.paged_prefill_update(_jlayer(pk, pv, table, 0, 4),
                                      jnp.asarray(kp), jnp.asarray(vp))
    assert got.length == int(want.length) == 7
    _close(got.k[1:], want.k[1:], atol=0)
    _close(got.v[1:], want.v[1:], atol=0)


def test_paged_splice_and_decode_attention_match():
    rng = np.random.default_rng(6)
    pk, pv, table = _paged_state(rng)
    L = 2
    ck = np.stack([pk, pk * 2]).astype(np.float32)
    cv = np.stack([pv, pv * 2]).astype(np.float32)
    rows_k = rng.normal(size=(L, 6, 2, 8)).astype(np.float32)
    rows_v = rng.normal(size=(L, 6, 2, 8)).astype(np.float32)
    got = tattn.paged_splice(
        tattn.PagedKVCache(_t(ck), _t(cv), _t(table), 8, 4), 1, 1,
        _t(rows_k), _t(rows_v))
    want = jattn.paged_splice(
        jattn.PagedKVCache(jnp.asarray(ck), jnp.asarray(cv),
                           jnp.asarray(table), jnp.asarray(8, jnp.int32), 4),
        1, 1, jnp.asarray(rows_k), jnp.asarray(rows_v))
    _close(got.k[:, 1:], want.k[:, 1:], atol=0)
    _close(got.v[:, 1:], want.v[:, 1:], atol=0)

    cfg, jcfg = get_config("gemma-2b-smoke"), jax_get_config("gemma-2b-smoke")
    q = rng.normal(size=(3, 1, cfg.num_heads, 8)).astype(np.float32)
    start = np.asarray([1, 5, 0], np.int32)
    for length in (3, 8):
        o = tattn.paged_decode_attention(
            cfg, _t(q), tattn.PagedKVLayer(_t(pk), _t(pv), _t(table),
                                           length, 4), start=_t(start))
        w = jattn.paged_decode_attention(
            jcfg, jnp.asarray(q), _jlayer(pk, pv, table, length, 4),
            start=jnp.asarray(start))
        _close(o, w)


def test_unported_cache_layouts_raise():
    """The ring cache, the hybrid family and KV heads stored per TP rank
    (``decode_kv_expand``) are ported (``tests/test_torch_ring.py``,
    ``tests/test_torch_hybrid.py``, ``tests/test_torch_serve_tp.py``), and
    so is fp8 cache storage, once refused here (``tests/
    test_torch_kv_fp8.py``): a bf16 cache stores ``float8_e4m3fn``. A VLM
    has no paged layout, as in the reference."""
    cfg = get_config("gemma-2b-smoke")
    c = ttf.init_cache(cfg.with_opts("kv_fp8"), 1, 128, device="cpu")
    assert c.kv.k.dtype == c.kv.v.dtype == torch.float8_e4m3fn
    with pytest.raises(NotImplementedError, match="modality='vlm'"):
        ttf.init_paged_cache(get_config("phi-3-vision-4.2b-smoke"), 1, 128,
                             page_size=16, num_pages=9, device="cpu")


# ---------------------------------------------------------------------------
# the model: forward (prefill) and decode_step logits on bridged params
# ---------------------------------------------------------------------------

def _bridged(arch):
    jcfg = jax_get_config(arch)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    return get_config(arch), jcfg, tparams, jparams


def _close_aux(got, want):
    """MoE router losses summed over the layers (rtol 1e-5); the dense port
    returns none where the reference returns zeros."""
    if not got:
        assert all(float(v) == 0.0 for v in want.values())
        return
    assert set(got) == set(want) == {"load_balance", "router_z"}
    for k in want:
        _close(got[k].detach(), want[k], atol=0, rtol=1e-5)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ["olmo-1b-smoke", "gemma-2b-smoke",
                                  "mixtral-8x22b-smoke", "arctic-480b-smoke",
                                  "command-r-35b-smoke"])
def test_model_prefill_and_decode_logits_match(arch, paged):
    """MoE archs route the pad rows of the ragged prefill like real rows,
    and the training forward (no cache) uses the training capacity."""
    cfg, jcfg, tparams, jparams = _bridged(arch)
    rng = np.random.default_rng(7)
    b, s, max_len, ps = 3, 9, 16, 4
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    start = np.asarray([0, 3, 5], np.int32)
    tmodel, jmodel = ttf.Model(cfg), jtf.Model(jcfg)

    logits_t, aux_t, _ = tmodel.forward(tparams, {"tokens": _t(tokens)})
    logits_j, aux_j, _ = jmodel.forward(jparams,
                                        {"tokens": jnp.asarray(tokens)})
    _close(logits_t.detach(), logits_j, atol=1e-4, rtol=1e-4)
    _close_aux(aux_t, aux_j)

    if paged:
        table = np.arange(1, 1 + b * (max_len // ps), dtype=np.int32
                          ).reshape(b, max_len // ps)
        tcache = ttf.init_paged_cache(cfg, b, max_len, page_size=ps,
                                      num_pages=1 + table.size,
                                      dtype=torch.float32, device="cpu")
        tcache.kv.table.copy_(_t(table))
        jcache = jtf.init_paged_cache(jcfg, b, max_len, page_size=ps,
                                      num_pages=1 + table.size,
                                      dtype=jnp.float32)
        jcache = jtf.DecodeCache(
            jattn.PagedKVCache(jcache.kv.k, jcache.kv.v, jnp.asarray(table),
                               jcache.kv.length, ps), None, jcache.length)
    else:
        tcache = ttf.init_cache(cfg, b, max_len, dtype=torch.float32,
                                device="cpu")
        jcache = jtf.init_cache(jcfg, b, max_len, dtype=jnp.float32)
    lt, aux_t, tcache = tmodel.forward(tparams, {"tokens": _t(tokens)},
                                       cache=tcache, start=_t(start))
    lj, aux_j, jcache = jmodel.forward(jparams,
                                       {"tokens": jnp.asarray(tokens)},
                                       cache=jcache, start=jnp.asarray(start))
    _close(lt, lj, atol=1e-4, rtol=1e-4)
    _close_aux(aux_t, aux_j)
    nxt = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
    for _ in range(3):
        lt, tcache = tmodel.decode_step(tparams, _t(nxt), tcache,
                                        start=_t(start))
        lj, jcache = jmodel.decode_step(jparams, jnp.asarray(nxt), jcache,
                                        start=jnp.asarray(start))
        _close(lt, lj, atol=1e-4, rtol=1e-4)
        nxt = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    assert tcache.length == int(jcache.length) == s + 3
