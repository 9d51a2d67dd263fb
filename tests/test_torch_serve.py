"""The port's serve path against the JAX reference, on the CPU.

The page allocator must produce the reference's tables exactly; the
``ServeEngine`` must produce the reference engine's greedy tokens exactly,
on the same params (carried over with ``repro_torch.bridge``), in both
cache layouts, with mixed prompt lengths and slot recycling.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import cli_env  # one intra-op thread: see its docstring
from repro.configs import get_config as jax_get_config
from repro.models.transformer import init_params as jax_init_params
from repro.serve import engine as jengine
from repro.serve import paging as jpaging
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.serve import engine as tengine
from repro_torch.serve import paging as tpaging

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "olmo-1b-smoke"


def test_paging_tables_match_reference():
    """Same sequence of alloc / step-alloc / free (incl. a shortfall) ->
    the same ``table`` and ``owner`` as ``repro.serve.paging``."""
    js = jpaging.page_state_init(7, 3, 4)
    ts = tpaging.page_state_init(7, 3, 4)
    ops = [("slot", 1, [0, 1]), ("slot", 0, [2]), ("step", [0, 1], 3),
           ("free", 1, None), ("slot", 2, [0, 1, 2]), ("step", [0, 2], 3),
           ("free", 0, None), ("slot", 1, [0, 1, 2, 3])]
    for kind, who, logical in ops:
        if kind == "slot":
            js, jok = jpaging.alloc_slot_pages(
                js, jnp.asarray(who, jnp.int32),
                jnp.asarray(logical, jnp.int32))
            ts, tok = tpaging.alloc_slot_pages(ts, who, logical)
            assert tok == bool(jok)
        elif kind == "step":
            js, jok = jpaging.alloc_step_pages(
                js, jnp.asarray(who, jnp.int32), jnp.asarray(logical))
            ts, tok = tpaging.alloc_step_pages(ts, who, logical)
            assert tok == bool(jok)
        else:
            js = jpaging.free_slot_pages(js, jnp.asarray(who, jnp.int32))
            ts = tpaging.free_slot_pages(ts, who)
        np.testing.assert_array_equal(ts.table.numpy(), np.asarray(js.table))
        np.testing.assert_array_equal(ts.owner.numpy(), np.asarray(js.owner))
        assert tpaging.pages_free(ts) == int(jpaging.pages_free(js))
        assert tpaging.pages_used(ts) == int(jpaging.pages_used(js))
    assert not tok  # the last allocation ran short, as in the reference


@pytest.fixture(scope="module")
def olmo():
    jcfg = jax_get_config(ARCH)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    return get_config(ARCH), jcfg, tparams, jparams


def _requests(kind):
    """The mixed-length and the recycling request sets of the reference's
    paged engine tests."""
    if kind == "mixed":
        rng = np.random.default_rng(3)
        spec = [(plen, 6) for plen in (3, 11, 7)]
        batch = 3
    else:
        rng = np.random.default_rng(11)
        spec = [(5, 3), (9, 6), (4, 8), (7, 2), (6, 5)]
        batch = 2
    reqs = [dict(prompt=rng.integers(0, 512, (p,), dtype=np.int32),
                 max_new_tokens=n) for p, n in spec]
    return reqs, batch


_JAX_RUNS = {}


def _jax_run(olmo, kind, paged):
    """Reference tokens and resident bytes (memoised: one JAX run each)."""
    key = (kind, paged)
    if key not in _JAX_RUNS:
        _, jcfg, _, jparams = olmo
        reqs, batch = _requests(kind)
        eng = jengine.ServeEngine(jcfg, jparams, batch_size=batch, max_len=64,
                                  paged=paged, page_size=8, num_pages=13)
        done = eng.generate([jengine.Request(**r) for r in reqs])
        _JAX_RUNS[key] = ([r.generated for r in done],
                          eng.cache_bytes_resident)
    return _JAX_RUNS[key]


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("kind", ["mixed", "recycling"])
def test_engine_tokens_match_reference(olmo, kind, paged):
    cfg, _, tparams, _ = olmo
    want, want_bytes = _jax_run(olmo, kind, paged)
    reqs, batch = _requests(kind)
    eng = tengine.ServeEngine(cfg, tparams, batch_size=batch, max_len=64,
                              device="cpu", paged=paged, page_size=8,
                              num_pages=13)
    done = eng.generate([tengine.Request(**r) for r in reqs])
    for i, (r, w) in enumerate(zip(done, want)):
        np.testing.assert_array_equal(r.generated, w,
                                      err_msg=f"request {i} ({kind})")
    assert eng.cache_bytes_resident == want_bytes
    if paged:  # every page back in the pool after the drain
        owner = eng._pages.owner.numpy()
        assert owner[0] == tpaging.OWNER_RESERVED
        assert (owner[1:] == tpaging.OWNER_FREE).all(), owner


def test_temperature_rows(olmo):
    """Sampled rows give valid ids; temperature-0 rows equal greedy, both in
    ``select_tokens`` and through the engine."""
    gen = torch.Generator().manual_seed(0)
    logits = torch.zeros((3, 1, 16))
    logits[:, 0, 5] = 4.0
    toks = tengine.select_tokens(logits, torch.tensor([0.0, 1.0, 0.0]), gen)
    assert toks.shape == (3, 1)
    assert int(toks[0, 0]) == 5 and int(toks[2, 0]) == 5
    assert ((toks >= 0) & (toks < 16)).all()

    cfg, _, tparams, _ = olmo
    prompt = np.arange(6, dtype=np.int32)

    def run(temperature, **kw):
        eng = tengine.ServeEngine(cfg, tparams, batch_size=2, max_len=32,
                                  device="cpu", temperature=temperature,
                                  seed=1, **kw)
        reqs = [tengine.Request(prompt=prompt.copy(), max_new_tokens=5,
                                temperature=t) for t in (0.0, 1.0)]
        return eng.generate(reqs)

    greedy = run(0.0)[0].generated
    for paged in (False, True):
        tzero, hot = run(0.7, paged=paged, page_size=8)
        np.testing.assert_array_equal(tzero.generated, greedy)
        assert hot.generated.shape == (5,)
        assert ((hot.generated >= 0) & (hot.generated < cfg.vocab_size)).all()


def _cli(*args):
    env = cli_env()
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *args], capture_output=True, text=True, cwd=REPO,
                          env=env, timeout=300)


def test_cli_paged_cpu():
    r = _cli("--device", "cpu", "--paged", "--vary-prompts")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "paged cache: page_size=16 num_pages=65" in r.stdout
    assert "8 requests, 256 new tokens" in r.stdout


def test_cuda_is_the_default_device(olmo, monkeypatch):
    """No ``device=`` and no CUDA: the entry points raise, never run on the
    CPU on their own."""
    cfg, _, tparams, _ = olmo
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tengine.ServeEngine(cfg, tparams, batch_size=1, max_len=16)
    from repro_torch.models.transformer import init_params
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, 0)


def test_unported_serve_options_raise(olmo):
    """The tensor-parallel path is ported (``tests/test_torch_serve_tp.py``),
    and so is a mesh without a comm plan (the reference's GSPMD route,
    ``tests/test_torch_model_axis.py``) for every family: the last
    refusal that named ROADMAP.md Queue 1 item 14 is gone, and the route
    refuses only a mesh that is not a ``RankMesh`` (and, over live ranks,
    a world of another size). The reference's refusals hold: ``num_vcis``
    without a model axis, a comm plan without a mesh, and a TP degree the
    arch cannot split."""
    cfg, _, tparams, _ = olmo
    from repro_torch.configs import get_config
    from repro_torch.core.collectives import RankMesh
    from repro_torch.serve.comm import ServeCommPlan
    with pytest.raises(ValueError, match="default group of 2 ranks"):
        tengine.make_serve_step(get_config("mamba2-780m-smoke"),
                                mesh=RankMesh(1, 2))
    with pytest.raises(ValueError, match="needs a RankMesh"):
        tengine.make_serve_step(get_config("mamba2-780m-smoke"),
                                mesh=object())
    with pytest.raises(ValueError, match="'model' axis >1"):
        tengine.ServeEngine(cfg, tparams, batch_size=1, max_len=16,
                            device="cpu", num_vcis=4)
    with pytest.raises(ValueError, match="RankMesh"):
        tengine.ServeEngine(cfg, tparams, batch_size=1, max_len=16,
                            device="cpu", comm_plan=ServeCommPlan())
    from repro_torch.launch.serve import main
    with pytest.raises(ValueError, match="num_kv_heads 2 % tp"):
        main(["--tp", "4", "--device", "cpu"])
