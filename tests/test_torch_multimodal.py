"""The port's VLM (phi-3-vision) and audio (musicgen) families against the
JAX reference, on the CPU.

Inputs are made with numpy from a seed (the synthetic batches of both
packages, which must be equal bit for bit) and fed to both sides; params
come from the reference's ``init_params`` through ``repro_torch.bridge``.
All in float32, for ``phi-3-vision-4.2b-smoke`` (16 patches of 1,024 put
before the text) and ``musicgen-large-smoke`` (4 codebooks, layernorm
with biases, GQA 4/2):

* ``init_params``'s tree equals the reference's (``img_proj``; the audio
  ``(K, V, d)`` embeddings and ``(K, d, V)`` heads);
* ``Model.forward`` logits within 1e-4 (audio ``(B, K, S, V)``);
* prefill into a cache + 4 decode steps fed the same tokens: logits and
  caches within 1e-4, the VLM cache holding its image positions;
* VLM: ``make_prefill`` on an ``image_embeds`` batch, then
  ``make_serve_step``, gives the JAX functions' greedy tokens;
* audio: the grouped ``ServeEngine``'s tokens and ``cache_bytes_resident``
  equal the JAX engine's on two prompt lengths, with a ``stop_token`` that
  both ignore.

What stays refused: the engine for a VLM (the reference's ``Request``
carries no image), and training for both families (ROADMAP.md Queue 1
item 13c).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (one intra-op thread: see its docstring)
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import synthetic_batch as jax_synthetic_batch
from repro.models import transformer as jtf
from repro.serve import engine as jengine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.models import transformer as ttf
from repro_torch.serve import engine as tengine
from repro_torch.train.trainer import make_train_step

VLM, AUDIO = "phi-3-vision-4.2b-smoke", "musicgen-large-smoke"
ATOL_MODEL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL_MODEL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=atol)


def _batches(cfg, jcfg, b, s, seed):
    """The same synthetic batch as numpy (checked equal), as tensors for
    the port and as arrays for JAX (``labels`` dropped: serving)."""
    mine = synthetic_batch(cfg, b, s, seed=seed)
    want = jax_synthetic_batch(jcfg, b, s, seed=seed)
    assert mine.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(mine[k], want[k])
    keys = [k for k in want if k != "labels"]
    return ({k: _t(mine[k]) for k in keys},
            {k: jnp.asarray(want[k]) for k in keys})


@functools.lru_cache(maxsize=None)
def _bridge(arch, key=0):
    """(cfg, jax cfg, port params, JAX params) from ``PRNGKey(key)``."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(key))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    return cfg, jcfg, tparams, jparams


@pytest.fixture(params=[VLM, AUDIO])
def bridged(request):
    return _bridge(request.param)


def test_params_match_reference_layout(bridged):
    """Same keys, shapes and dtypes as the reference's tree, in f32 and
    bf16 (the numbers differ: another generator)."""
    cfg, jcfg, _, _ = bridged
    for c in (cfg, dataclasses.replace(cfg, param_dtype="bfloat16")):
        mine = ttf.init_params(c, 0, device="cpu")
        jc = dataclasses.replace(jcfg, param_dtype=c.param_dtype)
        want = jax.eval_shape(
            lambda: jtf.init_params(jc, jax.random.PRNGKey(0)))
        flat_w = {jax.tree_util.keystr(k): v for k, v in
                  jax.tree_util.tree_flatten_with_path(want)[0]}
        flat_m = {jax.tree_util.keystr(k): v for k, v in
                  jax.tree_util.tree_flatten_with_path(mine)[0]}
        assert flat_m.keys() == flat_w.keys()
        for k, v in flat_w.items():
            assert tuple(flat_m[k].shape) == v.shape, k
            assert str(flat_m[k].dtype).replace("torch.", "") == \
                str(v.dtype), k
    if cfg.modality == "audio":
        k, v, d = cfg.num_codebooks, cfg.vocab_size, cfg.d_model
        assert mine["embed"]["tok"].shape == (k, v, d)
        assert mine["lm_head"]["w"].shape == (k, d, v)
    else:
        assert mine["img_proj"]["w"].shape == (ttf.IMG_EMBED_DIM, cfg.d_model)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
@pytest.mark.parametrize("seed,step", [(0, 0), (3, 5)])
def test_synthetic_batch_is_the_references(arch, seed, step):
    cfg = get_config(arch)
    mine = synthetic_batch(cfg, 3, 24, seed=seed, step=step)
    want = jax_synthetic_batch(jax_get_config(arch), 3, 24, seed=seed,
                               step=step)
    assert mine.keys() == want.keys()
    for k, w in want.items():
        assert mine[k].dtype == w.dtype and mine[k].shape == w.shape, k
        np.testing.assert_array_equal(mine[k], w, err_msg=k)
    if arch == VLM:
        p = cfg.num_patches
        assert mine["tokens"].shape == (3, 24 - p)
        assert mine["image_embeds"].shape == (3, p, ttf.IMG_EMBED_DIM)
        assert (mine["labels"][:, :p] == -1).all()
    else:
        assert mine["tokens"].shape == (3, cfg.num_codebooks, 24)


def test_forward_logits_match_reference(bridged):
    cfg, jcfg, tparams, jparams = bridged
    batch, jbatch = _batches(cfg, jcfg, 2, 40, seed=1)
    logits, aux, cache = ttf.Model(cfg).forward(tparams, batch)
    want, _, _ = jtf.Model(jcfg).forward(jparams, jbatch)
    assert aux == {} and cache is None
    shape = ((2, cfg.num_codebooks, 40, cfg.vocab_size)
             if cfg.modality == "audio" else (2, 40, cfg.vocab_size))
    assert tuple(logits.shape) == want.shape == shape
    _close(logits, want)


def test_prefill_and_decode_logits_and_caches_match_reference(bridged):
    """Prefill 40 positions (VLM: 16 patches + 24 text tokens), then 4
    decode steps fed the same tokens on both sides (audio: one token a
    codebook); the cache's length counts the image positions."""
    cfg, jcfg, tparams, jparams = bridged
    b, s, max_len = 2, 40, 48
    batch, jbatch = _batches(cfg, jcfg, b, s, seed=2)
    shape = ((b, cfg.num_codebooks, 1) if cfg.modality == "audio"
             else (b, 1))
    feeds = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                              (4,) + shape, dtype=np.int32)
    model, jmodel = ttf.Model(cfg), jtf.Model(jcfg)
    cache = ttf.init_cache(cfg, b, max_len, dtype=torch.float32,
                           device="cpu")
    jcache = jtf.init_cache(jcfg, b, max_len, dtype=jnp.float32)
    with torch.inference_mode():
        out, _, cache = model.forward(tparams, batch, cache=cache)
        wout, _, jcache = jmodel.forward(jparams, jbatch, cache=jcache)
        _close(out, wout)
        assert cache.length == int(jcache.length) == s
        for f in feeds:
            out, cache = model.decode_step(tparams, _t(f), cache)
            wout, jcache = jmodel.decode_step(jparams, jnp.asarray(f), jcache)
            assert tuple(out.shape) == wout.shape
            _close(out, wout)
    assert cache.length == cache.kv.length == int(jcache.length) == s + 4
    assert tuple(cache.kv.k.shape) == jcache.kv.k.shape
    _close(cache.kv.k, jcache.kv.k)
    _close(cache.kv.v, jcache.kv.v)
    assert cache.nbytes() == sum(leaf.size * leaf.dtype.itemsize for leaf in
                                 jax.tree_util.tree_leaves(jcache))


def test_vlm_prefill_and_serve_step_tokens_match_reference():
    """The VLM's serving path, as the reference runs it: ``make_prefill``
    on a batch with ``image_embeds`` into an f32 cache, then 8 greedy
    ``make_serve_step`` steps; the same tokens a step."""
    cfg, jcfg, tparams, jparams = _bridge(VLM, key=1)
    b, s, steps = 3, 40, 8
    batch, jbatch = _batches(cfg, jcfg, b, s, seed=4)
    prefill, step = tengine.make_prefill(cfg), tengine.make_serve_step(cfg)
    jprefill = jax.jit(jengine.make_prefill(jcfg))
    jstep = jax.jit(jengine.make_serve_step(jcfg))
    cache = ttf.init_cache(cfg, b, s + steps, dtype=torch.float32,
                           device="cpu")
    jcache = jtf.init_cache(jcfg, b, s + steps, dtype=jnp.float32)
    with torch.inference_mode():
        nxt, cache = prefill(tparams, batch, cache)
        jnxt, jcache = jprefill(jparams, jbatch, jcache)
        got, want = [nxt.numpy()], [np.asarray(jnxt)]
        for _ in range(steps):
            nxt, cache = step(tparams, nxt, cache)
            jnxt, jcache = jstep(jparams, jnxt, jcache)
            got.append(nxt.numpy())
            want.append(np.asarray(jnxt))
    assert got[0].shape == (b, 1) and got[0].dtype == np.int32
    np.testing.assert_array_equal(np.concatenate(got, 1),
                                  np.concatenate(want, 1))
    assert cache.length == int(jcache.length) == s + steps


def _audio_requests(stop=None):
    """Two prompt lengths (7 and 12 frames of 4 codebooks), the 7-frame
    group split over two batches of 2."""
    rng = np.random.default_rng(5)
    spec = [(12, 6), (7, 4), (12, 5), (7, 3), (7, 6)]
    return [dict(prompt=rng.integers(0, 512, (4, p), dtype=np.int32),
                 max_new_tokens=n, stop_token=stop) for p, n in spec]


def test_audio_engine_tokens_match_reference():
    """The grouped engine's greedy tokens equal the JAX engine's, ``(K,
    max_new_tokens)`` a request; a ``stop_token`` that the rows sample is
    ignored on both sides, as audio has no stop tokens there; equal
    ``cache_bytes_resident``."""
    cfg, jcfg, tparams, jparams = _bridge(AUDIO)
    kw = dict(batch_size=2, max_len=32, paged=True, page_size=8)
    jeng = jengine.ServeEngine(jcfg, jparams, **kw)
    free = [r.generated for r in jeng.generate(
        [jengine.Request(**r) for r in _audio_requests()])]
    stop = int(free[0][0, 1])
    want = [r.generated for r in jeng.generate(
        [jengine.Request(**r) for r in _audio_requests(stop)])]
    teng = tengine.ServeEngine(cfg, tparams, device="cpu", **kw)
    assert not teng._paged and not jeng._paged   # audio: grouped
    done = teng.generate([tengine.Request(**r) for r in
                          _audio_requests(stop)])
    for i, (r, w, f) in enumerate(zip(done, want, free)):
        n = _audio_requests()[i]["max_new_tokens"]
        assert r.generated.shape == (cfg.num_codebooks, n), i
        np.testing.assert_array_equal(r.generated, w, err_msg=f"request {i}")
        np.testing.assert_array_equal(w, f, err_msg=f"request {i}")
    assert teng.cache_bytes_resident == jeng.cache_bytes_resident
    assert teng.decode_steps == 5 + 3 + 5


def test_audio_engine_checks_prompt_shapes():
    cfg = get_config(AUDIO)
    params = ttf.init_params(cfg, 0, device="cpu")
    eng = tengine.ServeEngine(cfg, params, batch_size=2, max_len=32,
                              device="cpu")
    for prompt in (np.zeros((5,), np.int32), np.zeros((3, 5), np.int32)):
        with pytest.raises(ValueError, match=r"\(4, S\) codebook tokens"):
            eng.generate([tengine.Request(prompt=prompt)])


def test_select_tokens_takes_codebook_logits():
    """(B, K, 1, V) logits: greedy rows take the argmax a codebook, as the
    reference's ``select_tokens``; tempered rows sample a token a codebook
    from the generator."""
    logits = np.random.default_rng(6).normal(size=(3, 4, 1, 50)).astype(
        np.float32)
    want = np.asarray(jengine.select_tokens(jnp.asarray(logits)))
    np.testing.assert_array_equal(tengine.select_tokens(_t(logits)).numpy(),
                                  want)
    gen = torch.Generator().manual_seed(0)
    got = tengine.select_tokens(_t(logits), _t(np.array([0.0, 1.0, 0.0])),
                                gen).numpy()
    assert got.shape == (3, 4, 1) and got.dtype == np.int32
    np.testing.assert_array_equal(got[[0, 2]], want[[0, 2]])
    assert ((got >= 0) & (got < 50)).all()


def test_vlm_engine_is_refused():
    """The reference's ``Request`` carries no image, so its engine cannot
    serve a VLM (``KeyError: 'image_embeds'``); the port's refuses one by
    name, pointing at ``make_prefill`` + ``make_serve_step``; the CLI
    too, before it makes any params."""
    from repro_torch.launch.serve import main
    cfg = get_config(VLM)
    params = ttf.init_params(cfg, 0, device="cpu")
    with pytest.raises(NotImplementedError, match="make_prefill"):
        tengine.ServeEngine(cfg, params, batch_size=2, max_len=64,
                            device="cpu")
    with pytest.raises(NotImplementedError, match="carries no image"):
        main(["--device", "cpu", "--arch", VLM])
    with pytest.raises(NotImplementedError, match="text attention arch"):
        ttf.init_paged_cache(cfg, 2, 64, page_size=8, num_pages=17,
                             device="cpu")


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_training_is_refused(arch, tmp_path, monkeypatch):
    """Once refused (ROADMAP item 13c); now both train (the steps are held
    against the reference in ``tests/test_torch_train_families.py``). Here: the
    bucket plan holds every leaf whole (the VLM's ``img_proj.w``, audio's
    ``(K,V,d)`` embeddings and ``(K,d,V)`` heads); a rank's slice and each
    microbatch take the same rows of every batch key (``image_embeds``
    too); and a step of 2 microbatches gives the one-batch step's loss and
    grad norm within 1e-5."""
    import torch.distributed as dist
    from repro_torch.core.bucketing import plan_buckets
    from repro_torch.train import trainer
    from repro_torch.tree import tree_flatten, tree_map
    cfg = get_config(arch)
    params = ttf.init_params(cfg, 0, device="cpu")
    leaves = tree_flatten(params)[0]
    plan = plan_buckets(params, 4, slot_align=1024)
    slots = sorted((sl.index, sl.shape) for b in plan.buckets
                   for sl in b.slots)
    assert slots == [(i, tuple(t.shape)) for i, t in enumerate(leaves)]
    if arch == VLM:
        assert params["img_proj"]["w"].shape == (ttf.IMG_EMBED_DIM,
                                                 cfg.d_model)
    else:
        k, v, d = cfg.num_codebooks, cfg.vocab_size, cfg.d_model
        assert params["embed"]["tok"].shape == (k, v, d)
        assert params["lm_head"]["w"].shape == (k, d, v)
    seq = cfg.num_patches + 24 if arch == VLM else 24
    batch = synthetic_batch(cfg, 4, seq, seed=0)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    got = trainer._rank_slice(batch, "cpu")
    monkeypatch.undo()
    assert set(got) == set(batch)
    for key, v in batch.items():
        assert torch.equal(got[key], torch.as_tensor(v[2:]))
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        runs = []
        for accum in (1, 2):
            state = trainer.train_state_init(cfg, params=tree_map(
                torch.clone, params))
            step = make_train_step(cfg, comm="vci", accum_steps=accum,
                                   num_streams=2, num_vcis=2)
            _, m = step(state, batch)
            runs.append((float(m["loss"]), float(m["grad_norm"])))
    finally:
        dist.destroy_process_group()
    assert all(np.isfinite(runs[0]))
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-5)


def test_cli_serves_audio_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--arch", AUDIO, "--paged", "--vary-prompts",
          "--requests", "4", "--max-new", "4", "--prompt-len", "8",
          "--stop", "3"])
    out = capsys.readouterr().out
    assert "arch=musicgen-large-smoke" in out
    assert "not used for family='audio'" in out
    assert "4 requests, 16 new tokens" in out
    assert "req0: first tokens [[" in out
