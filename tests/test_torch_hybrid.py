"""The port's hybrid family (zamba2: Mamba2 groups with one shared-weight
attention block) against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and fed to both sides; params come
from the reference's ``init_params`` through ``repro_torch.bridge``. All in
float32. Three configurations:

* ``zamba2-7b-smoke`` — 2 layers, one group of 2 and its attention site,
  no remainder;
* the same at 5 layers — two groups and one remainder layer;
* ``zamba2-7b-swa4096-smoke`` — window 64, so the sites' KV cache is a
  ring at ``max_len`` 160.

For each: ``init_params``'s tree equals the reference's; ``forward``
logits within 1e-4; prefill + decode logits, the SSM and KV caches within
1e-4; the grouped engine's greedy tokens and ``cache_bytes_resident``
equal to the JAX engine's. ``start`` offsets stay refused; the serve CLI
serves the smoke arch. Hybrid training is held against the reference in
``tests/test_torch_train_families.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (one intra-op thread: see its docstring)
from repro.configs import get_config as jax_get_config
from repro.models import transformer as jtf
from repro.serve import engine as jengine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import transformer as ttf
from repro_torch.serve import engine as tengine
from repro_torch.train.trainer import make_train_step

ARCH = "zamba2-7b-smoke"
ATOL_MODEL = 1e-4
# name -> (arch, num_layers or None, max_len)
CASES = {"smoke": (ARCH, None, 96),
         "5 layers": (ARCH, 5, 96),
         "swa ring": ("zamba2-7b-swa4096-smoke", None, 160)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL_MODEL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=atol)


@pytest.fixture(scope="module", params=list(CASES))
def zamba(request):
    arch, layers, max_len = CASES[request.param]
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    return cfg, jcfg, tparams, jparams, max_len


def test_params_match_reference_layout(zamba):
    """``init_params`` makes the reference's tree: the layer stack of
    Mamba2 blocks plus ONE unstacked ``shared_attn`` block; same keys,
    shapes and dtypes (the numbers differ: another generator)."""
    cfg, jcfg, _, _, _ = zamba
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
    assert mine["shared_attn"]["attn"]["wq"].shape == (
        cfg.d_model, cfg.q_dim)


def test_forward_logits_match_reference(zamba):
    cfg, jcfg, tparams, jparams, _ = zamba
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 40),
                                               dtype=np.int32)
    logits, aux, cache = ttf.Model(cfg).forward(tparams,
                                                {"tokens": _t(tokens)})
    want, _, _ = jtf.Model(jcfg).forward(jparams,
                                         {"tokens": jnp.asarray(tokens)})
    assert aux == {} and cache is None
    _close(logits, want)


def test_prefill_and_decode_logits_and_caches_match_reference(zamba):
    """Prefill 80 tokens (past the ring's window of 64), then 4 decode
    steps fed the same tokens on both sides; the SSM state, the conv tail
    and every site's KV cache agree too."""
    cfg, jcfg, tparams, jparams, max_len = zamba
    rng = np.random.default_rng(2)
    b, s = 2, 80
    tokens = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
    feeds = rng.integers(0, cfg.vocab_size, (4, b, 1), dtype=np.int32)
    model, jmodel = ttf.Model(cfg), jtf.Model(jcfg)
    cache = ttf.init_cache(cfg, b, max_len, dtype=torch.float32,
                           device="cpu")
    jcache = jtf.init_cache(jcfg, b, max_len, dtype=jnp.float32)
    with torch.inference_mode():
        out, _, cache = model.forward(tparams, {"tokens": _t(tokens)},
                                      cache=cache)
        wout, _, jcache = jmodel.forward(jparams,
                                         {"tokens": jnp.asarray(tokens)},
                                         cache=jcache)
        _close(out, wout)
        for f in feeds:
            out, cache = model.decode_step(tparams, _t(f), cache)
            wout, jcache = jmodel.decode_step(jparams, jnp.asarray(f), jcache)
            _close(out, wout)
    n_sites = cfg.num_layers // cfg.hybrid_attn_every
    assert cache.length == int(jcache.length) == s + 4
    assert cache.kv.length == int(jcache.kv.length) == s + 4
    assert cache.kv.ring == jcache.kv.ring == (max_len > 96)
    assert tuple(cache.kv.k.shape) == jcache.kv.k.shape
    assert cache.kv.k.shape[0] == n_sites
    for got, want in ((cache.kv.k, jcache.kv.k), (cache.kv.v, jcache.kv.v),
                      (cache.ssm.ssd, jcache.ssm.ssd),
                      (cache.ssm.conv, jcache.ssm.conv)):
        _close(got, want)


def test_cache_bytes_match_reference(zamba):
    cfg, jcfg, _, _, max_len = zamba
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        mine = ttf.init_cache(cfg, 3, max_len, dtype=dtype, device="cpu")
        want = jtf.init_cache(jcfg, 3, max_len, dtype=jdtype)
        assert mine.nbytes() == sum(
            leaf.size * leaf.dtype.itemsize
            for leaf in jax.tree_util.tree_leaves(want))
        assert mine.ssm.conv.dtype == mine.kv.k.dtype == dtype


def test_engine_tokens_match_reference(zamba):
    """Three prompt lengths (3+ tokens: the reference's conv is not causal
    below 3, ROADMAP.md Queue 3), one group split over two batches; 32 new
    tokens, past the ring's window for the 40-token prompts."""
    cfg, jcfg, tparams, jparams, max_len = zamba
    rng = np.random.default_rng(3)
    spec = [(40, 32), (9, 6), (40, 32), (5, 4), (40, 8)]
    reqs = [dict(prompt=rng.integers(0, cfg.vocab_size, (p,), dtype=np.int32),
                 max_new_tokens=n) for p, n in spec]
    kw = dict(batch_size=2, max_len=max_len, paged=True, page_size=8)
    jeng = jengine.ServeEngine(jcfg, jparams, **kw)
    want = [r.generated for r in jeng.generate(
        [jengine.Request(**r) for r in reqs])]
    teng = tengine.ServeEngine(cfg, tparams, device="cpu", **kw)
    assert not teng._paged and not jeng._paged   # hybrid: grouped
    done = teng.generate([tengine.Request(**r) for r in reqs])
    for i, (r, w) in enumerate(zip(done, want)):
        np.testing.assert_array_equal(r.generated, w, err_msg=f"request {i}")
    assert teng.cache_bytes_resident == jeng.cache_bytes_resident


def test_training_and_start_offsets_are_refused():
    cfg = get_config(ARCH)
    # hybrid training, once refused here (item 12b), now builds; start
    # offsets stay refused
    make_train_step(cfg, comm="vci")
    params = ttf.init_params(cfg, 0, device="cpu")
    tokens = torch.zeros((2, 4), dtype=torch.int32)
    start = torch.zeros(2, dtype=torch.int32)
    model = ttf.Model(cfg)
    with pytest.raises(NotImplementedError, match="pad mask"):
        model.forward(params, {"tokens": tokens}, start=start)
    cache = ttf.init_cache(cfg, 2, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="attention masking"):
        model.decode_step(params, tokens[:, :1], cache, start=start)
    with pytest.raises(NotImplementedError, match="attention arch"):
        ttf.init_paged_cache(cfg, 2, 8, page_size=4, num_pages=5,
                             device="cpu")
    # VLM and audio, once refused beside the hybrid (item 13c), now train
    for arch in ("phi-3-vision-4.2b-smoke", "musicgen-large-smoke"):
        make_train_step(get_config(arch), comm="vci")


def test_cli_serves_hybrid_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--arch", ARCH, "--paged", "--requests", "4",
          "--max-new", "4"])
    out = capsys.readouterr().out
    assert "arch=zamba2-7b-smoke" in out
    assert "not used for family='hybrid'" in out
    assert "4 requests, 16 new tokens" in out
