"""``kv_fp8`` cache storage against the JAX reference, on the CPU.

Under ``cfg.with_opts("kv_fp8")`` a bf16 cache stores ``float8_e4m3fn``
(the conv tail of an SSM or hybrid cache too, until a prefill re-types
it), every write casts to the cache's dtype and every read upcasts to the
query's. Same params (the reference's ``init_params`` through
``repro_torch.bridge``), same numpy prompts, float32 smoke configs:

* the port's cache cast and the reference's over all 65,536 bf16
  patterns: byte for byte up to 464; above it the reference gives NaN and
  the port saturates to +-448 (it clamps before torch's cast, whose
  overflow differs between torch builds: ROADMAP.md Queue 3);
* each family and layout prefilled and decoded 8 steps by the model:
  every cache leaf's dtype after init, prefill and decode equal to the
  reference's, the fp8 K/V bytes equal bit for bit (but for neighbouring
  codes where the two frameworks' f32 K or V straddle an fp8 rounding
  midpoint: at most one element in 10^4, see :func:`_assert_fp8_equal`),
  the f32 leaves (an
  SSM's state, computed in f32 by each framework) within 1e-4, and the
  greedy tokens equal;
* ``ServeEngine(cache_dtype=bfloat16)``'s tokens and
  ``cache_bytes_resident`` equal to the reference engine's, paged and
  contiguous and on the grouped SSM path;
* the reference's yi-9b-smoke rule: top-1 agreement with an f32 cache
  above 0.85, every logit finite.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (one intra-op thread: see its docstring)
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import synthetic_batch
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.serve import engine as jengine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.serve import engine as tengine

F8 = torch.float8_e4m3fn
STEPS = 8
ATOL = 1e-4


def _bytes(x) -> np.ndarray:
    """A cache leaf's bytes (a JAX array or a tensor), as uint8."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().reshape(-1)
    return np.asarray(x).view(np.uint8).reshape(-1)


def _dtype(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(x.dtype)


# ---------------------------------------------------------------------------
# the cast
# ---------------------------------------------------------------------------

def test_bf16_to_fp8_cast_matches_below_464_and_saturates_above():
    """The port's cache cast (``to_cache_dtype``, a clamp to +-448 then
    torch's cast) against the reference's ``astype``."""
    bits = np.arange(65536, dtype=np.uint16)
    ref = np.asarray(jnp.asarray(bits.view(ml_dtypes.bfloat16)).astype(
        jnp.float8_e4m3fn)).view(np.uint8)
    x = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    got = tattn.to_cache_dtype(x, F8).view(torch.uint8).numpy()
    mag = np.abs(bits.view(ml_dtypes.bfloat16).astype(np.float32))
    below = np.isfinite(mag) & (mag <= 464)   # 464 ties to even: 448
    np.testing.assert_array_equal(got[below], ref[below])
    # past e4m3's range: the reference's NaN beside the port's +-448
    for v in (466.0, -466.0, np.inf, -np.inf, 1e30):
        i = int(np.asarray(v, ml_dtypes.bfloat16).view(np.uint16))
        assert np.isnan(ref[i:i + 1].view(ml_dtypes.float8_e4m3fn).astype(
            np.float32)[0]), v
        assert float(tattn.to_cache_dtype(x[i:i + 1], F8).float()) == \
            np.sign(v) * 448.0, v
    # and no finite value past 464 stays finite in the reference
    past = np.isfinite(mag) & (mag > 464)
    assert past.any() and (ref[past] & 0x7f == 0x7f).all()


# ---------------------------------------------------------------------------
# the caches, family by family
# ---------------------------------------------------------------------------

# case -> (arch, layout, batch, prompt length, max_len)
CASES = {
    "yi9b": ("yi-9b-smoke", "contiguous", 2, 12, 24),
    "olmo_contiguous": ("olmo-1b-smoke", "contiguous", 2, 12, 24),
    "olmo_paged": ("olmo-1b-smoke", "paged", 2, 12, 24),
    # a window of 64 below max_len 160, a prompt past it: the ring
    "mixtral_ring": ("mixtral-8x22b-smoke", "contiguous", 2, 72, 160),
    "zamba2": ("zamba2-7b-smoke", "contiguous", 2, 12, 24),
    "mamba2": ("mamba2-780m-smoke", "contiguous", 2, 12, 24),
    "phi3v": ("phi-3-vision-4.2b-smoke", "contiguous", 2, 16 + 8, 40),
    "musicgen": ("musicgen-large-smoke", "contiguous", 2, 8, 24),
}
PAGE = 4


def _leaves(cache):
    """``{name: leaf}`` of a decode cache (either framework's)."""
    out = {}
    if cache.kv is not None:
        out["k"], out["v"] = cache.kv.k, cache.kv.v
    if cache.ssm is not None:
        out["conv"], out["ssd"] = cache.ssm.conv, cache.ssm.ssd
    return out


def _assert_caches_equal(got, want, what):
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w), what
    for k in w:
        assert _dtype(g[k]) == _dtype(w[k]), (what, k, g[k].dtype,
                                              w[k].dtype)
        assert tuple(g[k].shape) == tuple(w[k].shape), (what, k)
        if _dtype(w[k]) == "float8_e4m3fn":
            _assert_fp8_equal(_bytes(g[k]), _bytes(w[k]), f"{what} {k}")
        else:
            np.testing.assert_allclose(
                g[k].float().numpy(), np.asarray(w[k], np.float32),
                atol=ATOL, rtol=ATOL, err_msg=f"{what} {k}")


def _assert_fp8_equal(got: np.ndarray, want: np.ndarray, what: str):
    """fp8 bytes equal, but for at most one in 10^4 elements one code
    apart: an f32 K or V that the two frameworks computed a few f32 ulps
    apart rounds to two neighbouring fp8 values where the two straddle a
    rounding midpoint (phi-3-vision-4.2b-smoke's prefill: 0.010743417 in
    the port and 0.01074176 in the reference around the midpoint
    0.0107421875; 11,074 of its 20,480 f32 K elements differ, by at most
    3.6e-6, and one lands apart)."""
    off = np.nonzero(got != want)[0]
    assert off.size <= got.size // 10_000, (what, off.size, got.size)
    # the same sign, neighbouring magnitudes
    assert ((got[off] ^ want[off]) < 0x80).all(), what
    step = np.abs(got[off].astype(np.int16) - want[off].astype(np.int16))
    assert (step == 1).all(), (what, step)


def _caches(cfg, jcfg, b, max_len, paged):
    if not paged:
        return (ttf.init_cache(cfg, b, max_len, device="cpu"),
                jtf.init_cache(jcfg, b, max_len, dtype=jnp.bfloat16))
    maxp = -(-max_len // PAGE)
    pages = 1 + b * maxp
    table = np.arange(1, pages, dtype=np.int32).reshape(b, maxp)
    cache = ttf.init_paged_cache(cfg, b, max_len, page_size=PAGE,
                                 num_pages=pages, device="cpu")
    cache.kv.table.copy_(torch.from_numpy(table))
    jc = jtf.init_paged_cache(jcfg, b, max_len, page_size=PAGE,
                              num_pages=pages, dtype=jnp.bfloat16)
    jc = jc._replace(kv=jattn.PagedKVCache(jc.kv.k, jc.kv.v,
                                           jnp.asarray(table), jc.kv.length,
                                           PAGE))
    return cache, jc


@pytest.mark.parametrize("case", list(CASES))
def test_fp8_caches_and_tokens_match_reference(case):
    arch, layout, b, seq, max_len = CASES[case]
    cfg = get_config(arch).with_opts("kv_fp8")
    jcfg = jax_get_config(arch).with_opts("kv_fp8")
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    batch = synthetic_batch(jcfg, b, seq, seed=5)
    batch.pop("labels")
    cache, jcache = _caches(cfg, jcfg, b, max_len, layout == "paged")
    _assert_caches_equal(cache, jcache, f"{case} init")
    if cfg.num_heads and cfg.family != "ssm":
        assert cache.kv.k.dtype == F8
    if cfg.ssm is not None:     # the reference's quirk: the conv tail too
        assert cache.ssm.conv.dtype == F8
    model, jmodel = ttf.Model(cfg), jtf.Model(jcfg)
    jfwd, jstep = jax.jit(jmodel.forward), jax.jit(jmodel.decode_step)
    with torch.inference_mode():
        logits, _, cache = model.forward(
            tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
            cache=cache)
    jlogits, _, jcache = jfwd(jparams, {k: jnp.asarray(v)
                                        for k, v in batch.items()},
                              cache=jcache)
    _assert_caches_equal(cache, jcache, f"{case} prefill")
    tok = torch.argmax(logits[..., -1:, :], -1).to(torch.int32)
    jtok = jnp.argmax(jlogits[..., -1:, :], -1).astype(jnp.int32)
    toks, jtoks = [tok.numpy()], [np.asarray(jtok)]
    for _ in range(STEPS):
        with torch.inference_mode():
            logits, cache = model.decode_step(tparams, tok, cache)
        jlogits, jcache = jstep(jparams, jtok, jcache)
        tok = torch.argmax(logits, -1).to(torch.int32)
        jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
        toks.append(tok.numpy())
        jtoks.append(np.asarray(jtok))
    np.testing.assert_array_equal(np.concatenate(toks, -1),
                                  np.concatenate(jtoks, -1), err_msg=case)
    _assert_caches_equal(cache, jcache, f"{case} decode")
    assert int(cache.length) == int(jcache.length)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,paged", [("olmo-1b-smoke", False),
                                        ("olmo-1b-smoke", True),
                                        ("mamba2-780m-smoke", False)])
def test_engine_tokens_and_resident_bytes_match_reference(arch, paged):
    """Mixed prompt lengths and a recycled slot (olmo), equal-length
    groups (mamba2: the conv tail typed fp8 at init counts 1 byte)."""
    cfg = get_config(arch).with_opts("kv_fp8")
    jcfg = jax_get_config(arch).with_opts("kv_fp8")
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    rng = np.random.default_rng(9)
    lens = (5, 9, 4, 7, 6) if cfg.family != "ssm" else (6, 6, 4)
    reqs = [dict(prompt=rng.integers(0, 512, (p,), dtype=np.int32),
                 max_new_tokens=n) for p, n in zip(lens, (3, 6, 8, 2, 5))]
    kw = dict(batch_size=2, max_len=32, paged=paged, page_size=8,
              num_pages=9)
    jeng = jengine.ServeEngine(jcfg, jparams, cache_dtype=jnp.bfloat16, **kw)
    want = [r.generated for r in jeng.generate(
        [jengine.Request(**r) for r in reqs])]
    teng = tengine.ServeEngine(cfg, tparams, device="cpu",
                               cache_dtype=torch.bfloat16, **kw)
    done = teng.generate([tengine.Request(**r) for r in reqs])
    for i, (r, w) in enumerate(zip(done, want)):
        np.testing.assert_array_equal(r.generated, w, err_msg=f"request {i}")
    assert teng.cache_bytes_resident == jeng.cache_bytes_resident
    bf16 = tengine.ServeEngine(get_config(arch), tparams, device="cpu",
                               cache_dtype=torch.bfloat16, **kw)
    bf16.generate([tengine.Request(**r) for r in reqs])
    assert teng.cache_bytes_resident < bf16.cache_bytes_resident


def test_paged_splice_and_gather_keep_fp8_bytes():
    """The admission splice writes fp8 rows bit for bit, and the paged
    gather's plain version moves fp8 pages as bytes."""
    cfg = get_config("olmo-1b-smoke").with_opts("kv_fp8")
    cache = ttf.init_paged_cache(cfg, 2, 16, page_size=4, num_pages=9,
                                 device="cpu")
    cache.kv.table.copy_(torch.arange(1, 9, dtype=torch.int32).view(2, 4))
    rows = torch.randn(cfg.num_layers, 6, cfg.num_kv_heads,
                       cfg.head_dim).to(F8)
    tattn.paged_splice(cache.kv, 1, 3, rows, rows)
    got = tattn.paged_gather(cache.kv.k[0], cache.kv.table)
    assert got.dtype == F8
    np.testing.assert_array_equal(_bytes(got[1, 3:9]), _bytes(rows[0]))
    assert not _bytes(got[0]).any() and not _bytes(got[1, :3]).any()


def test_yi9b_agreement_with_an_f32_cache():
    """The reference's ``test_kv_fp8_cache`` rule on the port: one token a
    step through an fp8 cache agrees with an f32 cache's top-1 above
    0.85, every logit finite."""
    base = get_config("yi-9b-smoke")
    cfg8 = base.with_opts("kv_fp8")
    s = 24
    params = ttf.init_params(base, 0, device="cpu")
    toks = torch.from_numpy(synthetic_batch(jax_get_config("yi-9b-smoke"),
                                            2, s, seed=2)["tokens"])
    outs = {}
    for name, cfg, dt in (("f32", base, torch.float32),
                          ("fp8", cfg8, torch.bfloat16)):
        model = ttf.Model(cfg)
        cache = ttf.init_cache(cfg, 2, s + 1, dtype=dt, device="cpu")
        lgs = []
        with torch.inference_mode():
            for t in range(s):
                lg, cache = model.decode_step(params, toks[:, t:t + 1],
                                              cache)
                lgs.append(lg)
        outs[name] = torch.cat(lgs, 1).float().numpy()
    assert np.isfinite(outs["fp8"]).all()
    agree = (outs["f32"].argmax(-1) == outs["fp8"].argmax(-1)).mean()
    assert agree > 0.85, agree


def test_ssm_decode_from_a_fresh_narrow_cache_matches_reference():
    """Decode with no prefill from a fresh bf16 cache (f32 activations):
    the conv window is the reference's concatenate, promoted to f32 (it
    once cast the new column to the tail's bf16 first, 2.7e-3 off in the
    first step's logits); the tail stays bf16."""
    arch = "mamba2-780m-smoke"
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    toks = np.random.default_rng(3).integers(0, 512, (2, 3), dtype=np.int32)
    cache = ttf.init_cache(cfg, 2, 8, dtype=torch.bfloat16, device="cpu")
    jcache = jtf.init_cache(jcfg, 2, 8, dtype=jnp.bfloat16)
    model, jstep = ttf.Model(cfg), jax.jit(jtf.Model(jcfg).decode_step)
    for t in range(3):
        with torch.inference_mode():
            lg, cache = model.decode_step(
                tparams, torch.from_numpy(toks[:, t:t + 1]), cache)
        jlg, jcache = jstep(jparams, jnp.asarray(toks[:, t:t + 1]), jcache)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=ATOL,
                                   rtol=ATOL, err_msg=f"step {t}")
        assert cache.ssm.conv.dtype == torch.bfloat16
