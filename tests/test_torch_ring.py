"""The port's ring KV cache (sliding-window decode past the window) and the
flash-decode combine against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and fed to both sides; params come
from the reference's ``init_params`` through ``repro_torch.bridge``. All in
float32.

* ``kv_cache_shape`` / ``init_cache``: ``(B, W, KV, hd)`` and the ring
  flag where the window is shorter than ``max_len``, as the reference's.
* ``cache_update_decode`` and ``decode_attention`` over a ring that wraps,
  step by step: caches equal, outputs within 1e-5.
* ``_prefill_cache``: equal to the reference's for prompts shorter than,
  equal to, twice and not a multiple of the window.
* ``partial_attention`` + ``combine_partials``: within 2e-5 of JAX's and of
  ``decode_attention`` over 4 shards, in one process and on 4 gloo ranks
  through ``CommRuntime.all_gather`` (``tests/test_torch_ranks.py``).
* Model prefill past the window + decode logits within 1e-4, and the
  grouped engine's greedy tokens and ``cache_bytes_resident`` equal to the
  JAX engine's, on ``mixtral-8x22b-smoke`` and ``olmo-1b-swa4096-smoke``
  (window 64) at ``max_len`` 160.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (warms torch.exp: see its docstring)
from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.serve import engine as jengine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.serve import engine as tengine

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_ranks import run_ranks  # noqa: E402

ATOL = 1e-5
ATOL_MODEL = 1e-4
ATOL_COMBINE = 2e-5
ARCHS = ("mixtral-8x22b-smoke", "olmo-1b-swa4096-smoke")   # window 64


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=atol)


def _kv(rng, b, s, kv, hd):
    return (rng.normal(size=(b, s, kv, hd)).astype(np.float32)
            for _ in range(2))


# ---------------------------------------------------------------------------
# the ring cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("max_len", [64, 160])
def test_ring_cache_shape_matches_reference(arch, max_len):
    """A window of 64 below ``max_len`` 160 makes a ring of 64 slots; at
    ``max_len`` 64 the cache is contiguous."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    cache = ttf.init_cache(cfg, 2, max_len, dtype=torch.float32,
                           device="cpu")
    want = jtf.init_cache(jcfg, 2, max_len, dtype=jnp.float32)
    assert tuple(cache.kv.k.shape) == want.kv.k.shape
    assert cache.kv.ring == want.kv.ring == (max_len > 64)
    assert tattn.kv_cache_shape(cfg, 2, max_len)[1] == min(max_len, 64)
    assert cache.nbytes() == sum(leaf.size * leaf.dtype.itemsize for leaf
                                 in jax.tree_util.tree_leaves(want))


def test_ring_decode_matches_reference_across_the_wrap():
    """A ring of 8 slots filled to 5, then 12 single-token updates: the
    writes wrap at 8 and 16; after each, the cache equals the reference's
    and the attention agrees within 1e-5."""
    cfg, jcfg = get_config(ARCHS[1]), jax_get_config(ARCHS[1])
    rng = np.random.default_rng(0)
    b, w, kv, hd, h = 2, 8, cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
    k0, v0 = _kv(rng, b, w, kv, hd)
    cache = tattn.KVCache(_t(k0), _t(v0), 5, ring=True)
    jcache = jattn.KVCache(jnp.asarray(k0), jnp.asarray(v0),
                           jnp.asarray(5, jnp.int32), ring=True)
    for _ in range(12):
        kn, vn = _kv(rng, b, 1, kv, hd)
        q = rng.normal(size=(b, 1, h, hd)).astype(np.float32)
        cache = tattn.cache_update_decode(cache, _t(kn), _t(vn))
        jcache = jattn.cache_update_decode(jcache, jnp.asarray(kn),
                                           jnp.asarray(vn))
        assert cache.length == int(jcache.length) and cache.ring
        assert np.array_equal(cache.k.numpy(), np.asarray(jcache.k))
        assert np.array_equal(cache.v.numpy(), np.asarray(jcache.v))
        _close(tattn.decode_attention(cfg, _t(q), cache),
               jattn.decode_attention(jcfg, jnp.asarray(q), jcache))
    assert cache.length == 17
    with pytest.raises(ValueError, match="ring"):
        tattn.decode_attention(cfg, _t(q), cache,
                               start=torch.zeros(b, dtype=torch.int32))


@pytest.mark.parametrize("s", [5, 8, 16, 21])
def test_ring_prefill_matches_reference(s):
    """``_prefill_cache`` into a ring of 8: s < W writes ``[0, s)``; s == W
    and s == 2W need no roll; s = 21 keeps positions 13..20, rolled by 5.
    Equal to the reference's, bit for bit."""
    rng = np.random.default_rng(s)
    b, w, kv, hd = 2, 8, 2, 16
    k0, v0 = _kv(rng, b, w, kv, hd)
    kn, vn = _kv(rng, b, s, kv, hd)
    got = ttf._prefill_cache(tattn.KVCache(_t(k0), _t(v0), 0, ring=True),
                             _t(kn), _t(vn))
    want = jtf._prefill_cache(jattn.KVCache(
        jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(0, jnp.int32),
        ring=True), jnp.asarray(kn), jnp.asarray(vn))
    assert got.length == int(want.length) == s and got.ring
    assert np.array_equal(got.k.numpy(), np.asarray(want.k))
    assert np.array_equal(got.v.numpy(), np.asarray(want.v))
    if s > w:   # slot i holds the newest position congruent to i mod W
        for i in range(w):
            p = max(p for p in range(s) if p % w == i)
            assert np.array_equal(got.k[:, i].numpy(), kn[:, p])


# ---------------------------------------------------------------------------
# the flash-decode combine
# ---------------------------------------------------------------------------

def test_partial_attention_and_combine_match_reference():
    """Each of 4 shards of a 64-slot cache against JAX's
    ``partial_attention`` (a shard with no valid key included), their
    combination against JAX's ``combine_partials`` and against
    ``decode_attention`` over the whole cache (first 50 slots valid)."""
    cfg, jcfg = get_config("yi-9b-smoke"), jax_get_config("yi-9b-smoke")
    rng = np.random.default_rng(1)
    b, s, n = 2, 64, 4
    kv, hd, h = cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
    q = rng.normal(size=(b, 1, h, hd)).astype(np.float32)
    kc, vc = _kv(rng, b, s, kv, hd)
    length = 40
    parts, jparts = [], []
    for r in range(n):
        sl = slice(r * s // n, (r + 1) * s // n)
        valid = np.arange(s)[sl] < length
        parts.append(tattn.partial_attention(_t(q), _t(kc[:, sl]),
                                             _t(vc[:, sl]), _t(valid)))
        jparts.append(jattn.partial_attention(
            jnp.asarray(q), jnp.asarray(kc[:, sl]), jnp.asarray(vc[:, sl]),
            jnp.asarray(valid)))
        for got, want in zip(parts[-1], jparts[-1]):
            assert tuple(got.shape) == want.shape
            _close(got, want, atol=ATOL_COMBINE)
    outs, ms, ls = (torch.stack(t) for t in zip(*parts))
    got = tattn.combine_partials(outs, ms, ls)
    want = jattn.combine_partials(*(jnp.stack(t) for t in zip(*jparts)))
    _close(got, want, atol=ATOL_COMBINE)
    full = tattn.decode_attention(cfg, _t(q), tattn.KVCache(
        _t(kc), _t(vc), length))
    _close(got, full, atol=ATOL_COMBINE)


def test_combine_on_gloo_ranks(tmp_path):
    r = run_ranks("seqshard", tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    out = np.load(tmp_path / "out_seqshard.npz")
    assert (out["err"] <= ATOL_COMBINE).all() and int(out["vci"]) > 0


# ---------------------------------------------------------------------------
# the model and the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def bridged(request):
    jcfg = jax_get_config(request.param)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    return get_config(request.param), jcfg, tparams, jparams


def test_ring_prefill_and_decode_logits_match_reference(bridged):
    """Prefill 80 tokens (past the window of 64) into a ring at ``max_len``
    160, then 4 decode steps fed the same tokens on both sides: logits
    within 1e-4, caches too."""
    cfg, jcfg, tparams, jparams = bridged
    rng = np.random.default_rng(2)
    b, s = 2, 80
    tokens = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
    feeds = rng.integers(0, cfg.vocab_size, (4, b, 1), dtype=np.int32)
    model, jmodel = ttf.Model(cfg), jtf.Model(jcfg)
    cache = ttf.init_cache(cfg, b, 160, dtype=torch.float32, device="cpu")
    jcache = jtf.init_cache(jcfg, b, 160, dtype=jnp.float32)
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
    assert cache.kv.ring and cache.kv.length == int(jcache.kv.length) == s + 4
    _close(cache.kv.k, jcache.kv.k, atol=ATOL_MODEL)
    _close(cache.kv.v, jcache.kv.v, atol=ATOL_MODEL)


def test_ring_engine_tokens_match_reference(bridged):
    """Prompts of 80 and 40 tokens (two groups; the 80-token group past the
    window at prefill, the 40-token group past it in decode), 32 new tokens
    each, at ``max_len`` 160: the grouped engine's greedy tokens and
    ``cache_bytes_resident`` equal the JAX engine's; ``paged`` is turned
    off for the ring."""
    cfg, jcfg, tparams, jparams = bridged
    rng = np.random.default_rng(3)
    reqs = [dict(prompt=rng.integers(0, cfg.vocab_size, (p,), dtype=np.int32),
                 max_new_tokens=32) for p in (80, 40, 80)]
    kw = dict(batch_size=2, max_len=160, paged=True, page_size=8)
    jeng = jengine.ServeEngine(jcfg, jparams, **kw)
    want = [r.generated for r in jeng.generate(
        [jengine.Request(**r) for r in reqs])]
    teng = tengine.ServeEngine(cfg, tparams, device="cpu", **kw)
    assert teng._ring and not teng._paged and not jeng._paged
    done = teng.generate([tengine.Request(**r) for r in reqs])
    for i, (r, w) in enumerate(zip(done, want)):
        np.testing.assert_array_equal(r.generated, w, err_msg=f"request {i}")
    assert teng.cache_bytes_resident == jeng.cache_bytes_resident
    assert teng.decode_steps == 2 * 31
