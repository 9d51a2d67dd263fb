"""The port's VCI train step against the JAX reference.

Same params (the reference's ``init_params`` through
``repro_torch.bridge``), same numpy batches (``synthetic_batch``), float32
smoke configs on the CPU.

Tolerances. Loss and grad norm: rtol 1e-5, as the reference's own
conformance checks (``tests/_multidev_checks.py``). Params: the reference
checks hold two XLA programs to rtol 2e-5 / atol 1e-6; here two frameworks
sum the gradients in different orders, and AdamW divides each moment by
its own square root, so an element whose gradient is at the level of that
summation noise (≈1e-7 of the gradient norm) takes an update anywhere in
``±lr`` (lr = 3e-4). Every element must lie within rtol 2e-5 / atol 1e-4
(a third of one step's lr), and at most one element in 10^4 may lie
outside the reference's rtol 2e-5 / atol 1e-6. The VLM's step alone
has an element off by more than lr/3: a token embedding element whose
gradients (≈6e-8) differ by ≈1e-7 between the frameworks, 1.3e-4 apart
after 3 steps. For that case only, given the reference's second moments,
the elements whose gradient stayed nonzero but within ten times that noise
(≈1e-6 of the leaf's largest gradient here) — the root mean square of
their gradients over the steps, from AdamW's ``v``, above 0 and under
1e-5 of their leaf's largest — are held only to the second rule's count
and to ``steps × lr`` (what AdamW can move an element, beside its decay);
an element the reference's gradient never reached (a PAD or unseen-token
row) stays under the first rule. Where a config keeps its
AdamW moments in bf16 (arctic-480b), that noise also moves a moment across
a bf16 rounding boundary here and there: each step then reads a moment
off by one bf16 ulp (2^-8 relative), which moves that step's update by up
to ``2^-8 * lr``; the second rule's atol carries that once a step (1e-6 +
3 × 2^-8 × 3e-4 after 3 steps; with f32 moments arctic's step has 111
elements outside 1e-6 in 4,590,848, with bf16 moments 489, and 15 outside
the carried atol). The hybrid's step needs the same rule for another kind
of element: one whose gradient, at the first step that reaches it, is
nonzero but within the noise (under 1e-5 of its leaf's largest that step).
AdamW's first update of an element is about ``lr`` times the sign of that
gradient, whatever its size, so the two frameworks may move it in opposite
directions. At seq 96 one token embedding element of zamba2-7b-smoke (3
layers) first gets 8.0e-8 from the reference and -1.3e-8 from the port
(1e-6 of that row's largest), and ends 1.33e-4 apart after 3 steps while
the two steps' gradients agree within 3e-6 of each leaf's largest. Those
elements are found from the reference's first moments after each step
(the gradient of step t is ``(m_t - 0.9 m_(t-1)) / 0.1``, exact where
``m_(t-1)`` is 0) and held as the VLM's noise elements are.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

import _torch_cpu  # noqa: F401  (warms torch.exp: see its docstring)

from repro.compat import set_mesh
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import synthetic_batch as jax_synthetic_batch
from repro.optim import schedule as jax_schedule
from repro.train.trainer import make_train_step as jax_make_train_step
from repro.train.trainer import train_state_init as jax_train_state_init
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.launch import train as train_cli
from repro_torch.models.layers import maybe_bf16_grads
from repro_torch.models.transformer import Model
from repro_torch.optim import schedule
from repro_torch.train.losses import total_loss
from repro_torch.train.trainer import make_train_step, train_state_init
from repro_torch.tree import tree_flatten, tree_unflatten

from test_torch_ranks import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC_RTOL = 1e-5


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A one-rank gloo data group in this process."""
    store = tmp_path_factory.mktemp("store") / "store"
    dist.init_process_group("gloo", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def _first_noise(ref_m, i):
    """Leaf ``i``'s elements whose reference gradient, at the first step
    that reached them, was nonzero and under 1e-5 of the leaf's largest
    (see the module doc); ``ref_m``: the reference's first moments after
    each step."""
    seen = first = prev = 0
    for m in ref_m:
        m = np.asarray(m[i], np.float32)
        grad = (m - 0.9 * prev) / 0.1
        new = (grad != 0) & ~np.asarray(seen, bool)
        first = first | (new & (np.abs(grad) < 1e-5 * np.abs(grad).max()))
        seen, prev = seen | (grad != 0), m
    return np.asarray(first, bool)


def _assert_params_close(got_leaves, want_leaves, what, bf16_steps=0,
                         ref_v=None, steps=3, ref_m=None):
    """The module doc's rules; ``bf16_steps``: the AdamW steps taken with
    bf16 moments (0 for f32 moments); ``ref_v`` (the VLM's case only): the
    reference's second moments after ``steps`` steps, which single out the
    elements whose nonzero gradient stayed at the noise level; ``ref_m``
    (the hybrid's case only): its first moments after each step, which
    single out the elements first reached by a gradient at that level."""
    atol = 1e-6 + bf16_steps * 2 ** -8 * 3e-4
    off = total = 0
    for i, (g, w) in enumerate(zip(got_leaves, want_leaves)):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        noise = np.zeros(w.shape, bool)
        if ref_v is not None:
            rms = np.sqrt(np.asarray(ref_v[i], np.float32))
            noise = (rms > 0) & (rms < 1e-5 * rms.max())
        if ref_m is not None:
            noise = noise | _first_noise(ref_m, i)
        if noise.any():
            assert (np.abs(g - w)[noise] <= steps * 3e-4 * (1 + 1e-6)).all(), what
        np.testing.assert_allclose(g[~noise], w[~noise], rtol=2e-5,
                                   atol=1e-4, err_msg=what)
        off += int((np.abs(g - w) > atol + 2e-5 * np.abs(w)).sum())
        total += w.size
    assert off <= total * 1e-4, f"{what}: {off} of {total} elements off"


def test_synthetic_batch_equals_reference():
    for arch in ("olmo-1b-smoke", "gemma-2b-smoke"):
        for seed, step in ((0, 0), (3, 5)):
            got = synthetic_batch(get_config(arch), 4, 16, seed=seed,
                                  step=step)
            want = jax_synthetic_batch(jax_get_config(arch), 4, 16,
                                       seed=seed, step=step)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(got[k], want[k])


def test_lr_schedules_equal_reference():
    for step in (0, 3, 19, 20, 21, 57, 99, 150):
        kw = dict(peak=3e-4, warmup_steps=20)
        np.testing.assert_allclose(
            float(schedule.linear_warmup(step, **kw)),
            float(jax_schedule.linear_warmup(step, **kw)), rtol=1e-6)
        np.testing.assert_allclose(
            float(schedule.cosine_schedule(step, total_steps=100, **kw)),
            float(jax_schedule.cosine_schedule(step, total_steps=100, **kw)),
            rtol=1e-6)


# arch, sequence length, which of the module doc's noise rules applies
# ("rms": the VLM's, "first": the hybrid's), the depth (None: the smoke
# arch's): the dense text archs, the MoE archs (mixtral's smoke window is
# 64, so seq 96 trains past it; arctic has a dense residual FFN beside its
# experts), the SSM and the hybrid at seq 96 (three chunks of 32), the
# hybrid at 3 layers (one group of two blocks and its attention site, then
# one remainder block: the shape of zamba2-7b's 81 = 13 x 6 + 3), the VLM
# (16 patches + 32 text tokens) and audio (4 codebooks)
_STEP_CASES = [
    pytest.param("olmo-1b-smoke", 32, False, None, id="olmo-1b-smoke"),
    pytest.param("gemma-2b-smoke", 32, False, None, id="gemma-2b-smoke"),
    pytest.param("command-r-35b-smoke", 32, False, None,
                 id="command-r-35b-smoke"),
    pytest.param("mixtral-8x22b-smoke", 96, False, None,
                 id="mixtral-8x22b-smoke-seq96"),
    pytest.param("arctic-480b-smoke", 32, False, None,
                 id="arctic-480b-smoke"),
    pytest.param("mamba2-780m-smoke", 96, False, None,
                 id="mamba2-780m-smoke-seq96"),
    pytest.param("zamba2-7b-smoke", 96, "first", 3,
                 id="zamba2-7b-smoke-3l"),
    pytest.param("phi-3-vision-4.2b-smoke", 48, "rms", None,
                 id="phi-3-vision-4.2b-smoke"),
    pytest.param("musicgen-large-smoke", 32, False, None,
                 id="musicgen-large-smoke"),
]


@pytest.mark.parametrize("arch,seq,noise_rule,layers", _STEP_CASES)
def test_vci_step_matches_reference_vci_step(one_rank, arch, seq,
                                             noise_rule, layers):
    """3 steps of the port's pack="pallas" VCI step on a one-rank group
    against the reference's on a one-device mesh: the MoE archs through the
    row gather's backward and the aux losses, the SSM and hybrid archs
    through the SSD step's backward, the VLM's labels over image + text,
    audio's loss over the K codebook heads."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    if layers is not None:
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
        cfg = dataclasses.replace(cfg, num_layers=layers)
    knobs = dict(comm="vci", pack="pallas", num_streams=4, num_vcis=4)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jstate = jax_train_state_init(jcfg, jax.random.PRNGKey(0))
    jstep = jax.jit(jax_make_train_step(jcfg, mesh=mesh, token_impl="data",
                                        **knobs))
    state = train_state_init(cfg, params=params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate.params), "cpu"))
    step = make_train_step(cfg, **knobs)
    ref_m = []
    with set_mesh(mesh):
        for i in range(3):
            batch = jax_synthetic_batch(jcfg, 4, seq, seed=i)
            jstate, jm = jstep(jstate, batch)
            ref_m.append([np.asarray(t) for t in
                          jax.tree_util.tree_leaves(jstate.opt.m)])
            state, m = step(state, batch)
            for k in ("loss", "ce", "grad_norm", "tokens", "lr",
                      "load_balance", "router_z"):
                np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                           rtol=METRIC_RTOL,
                                           err_msg=f"{arch} step {i} {k}")
            assert (float(m["load_balance"]) > 0) == (cfg.moe is not None)
    assert int(state.step) == 3 and int(state.opt.count) == 3
    _assert_params_close(tree_flatten(state.params)[0],
                         jax.tree_util.tree_leaves(jstate.params), arch,
                         bf16_steps=3 if cfg.optimizer_dtype == "bfloat16"
                         else 0,
                         ref_v=jax.tree_util.tree_leaves(jstate.opt.v)
                         if noise_rule == "rms" else None,
                         ref_m=ref_m if noise_rule == "first" else None)


def test_microbatch_accumulation_matches_reference(one_rank):
    """accum_steps=2: the port's Python loop over microbatches against the
    reference's lax.scan, one step, pack="xla", reduce_scatter."""
    arch = "olmo-1b-smoke"
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    knobs = dict(comm="vci", accum_steps=2, reduction="reduce_scatter",
                 num_streams=3, num_vcis=4)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jstate = jax_train_state_init(jcfg, jax.random.PRNGKey(1))
    state = train_state_init(cfg, params=params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate.params), "cpu"))
    batch = jax_synthetic_batch(jcfg, 4, 32, seed=5)
    with set_mesh(mesh):
        jstate, jm = jax.jit(jax_make_train_step(
            jcfg, mesh=mesh, token_impl="data", **knobs))(jstate, batch)
    state, m = make_train_step(cfg, **knobs)(state, batch)
    for k in ("loss", "grad_norm", "tokens"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                   rtol=METRIC_RTOL, err_msg=k)
    _assert_params_close(tree_flatten(state.params)[0],
                         jax.tree_util.tree_leaves(jstate.params), "accum")


def test_4_ranks_match_reference_gspmd_step(tmp_path):
    """One step over 4 spawned gloo ranks (each on its quarter of the
    batch), per progress mode, against the reference's single-device
    comm="gspmd" step on the whole batch (the analogue of
    check_vci_train_step_matches_gspmd)."""
    arch, n = "olmo-1b-smoke", 4
    jcfg = jax_get_config(arch)
    batch = jax_synthetic_batch(jcfg, 2 * n, 32, seed=1)
    state = jax_train_state_init(jcfg, jax.random.PRNGKey(0))
    leaves = [np.asarray(l) for l in jax.tree_util.tree_leaves(state.params)]
    np.savez(tmp_path / "in.npz", arch=arch, n_leaves=len(leaves),
             tokens=batch["tokens"], labels=batch["labels"],
             **{f"p{i}": l for i, l in enumerate(leaves)})
    ref_state, ref_m = jax.jit(jax_make_train_step(jcfg, comm="gspmd"))(
        state, batch)
    r = run_ranks("train", tmp_path, n=n)
    assert r.returncode == 0, r.stdout + r.stderr
    want = jax.tree_util.tree_leaves(ref_state.params)
    for progress in ("hybrid", "per_vci", "global"):
        out = np.load(tmp_path / f"out_{progress}.npz")
        np.testing.assert_allclose(float(out["loss"]), float(ref_m["loss"]),
                                   rtol=METRIC_RTOL, err_msg=progress)
        np.testing.assert_allclose(float(out["grad_norm"]),
                                   float(ref_m["grad_norm"]),
                                   rtol=METRIC_RTOL, err_msg=progress)
        _assert_params_close([out[f"p{i}"] for i in range(len(want))], want,
                             progress)


def _grads(cfg, params, batch):
    leaves, treedef = tree_flatten(params)
    leaves = [l.detach().requires_grad_() for l in leaves]
    logits, aux, _ = Model(cfg).forward(tree_unflatten(treedef, leaves),
                                        batch)
    loss, _ = total_loss(cfg, logits, batch["labels"], aux)
    return loss, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", ["olmo-1b-smoke", "gemma-2b-smoke",
                                  "mamba2-780m-smoke", "zamba2-7b-smoke"])
def test_remat_gives_the_same_grads(arch):
    """remat="block" (each block recomputed in the backward) changes no
    number: the recomputation is the same float32 program. The SSM and
    hybrid archs (48 tokens: two chunks of 32, the second padded) also
    under "dots" (the matmul and SSD step outputs kept)."""
    cfg = get_config(arch)
    state = train_state_init(cfg, 0, device="cpu")
    ssm = cfg.family in ("ssm", "hybrid")
    batch = {k: torch.from_numpy(v) for k, v in
             synthetic_batch(cfg, 2, 48 if ssm else 16, seed=0).items()}
    loss0, g0 = _grads(cfg, state.params, batch)
    for remat in ("block", "dots") if ssm else ("block",):
        loss1, g1 = _grads(dataclasses.replace(cfg, remat=remat),
                           state.params, batch)
        assert torch.equal(loss0, loss1), remat
        for a, b in zip(g0, g1):
            assert torch.equal(a, b), remat


def _saved_bytes(cfg, params, batch, monkeypatch):
    """Bytes the forward keeps for the backward: what reaches the autograd
    saved-tensor hooks (each storage once), plus, under ``remat="dots"``,
    the matmul outputs that the selective checkpoint's own store keeps."""
    import repro_torch.models.transformer as ttf
    stores, seen = [], {}

    def contexts():
        ctx = ttf.create_selective_checkpoint_contexts(ttf._dots_policy)
        stores.append(ctx[0].storage)
        return ctx

    def pack(t):
        seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        # a detached alias: a node that saves its own output would hold
        # the output's grad_fn, itself, and the graph would never be freed
        return t.detach()

    monkeypatch.setattr(ttf, "_dots_contexts", contexts)
    leaves, treedef = tree_flatten(params)
    leaves = [l.detach().requires_grad_() for l in leaves]
    params_ptrs = {l.untyped_storage().data_ptr() for l in leaves}
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        logits, aux, _ = Model(cfg).forward(tree_unflatten(treedef, leaves),
                                            batch)
        loss, _ = total_loss(cfg, logits, batch["labels"], aux)
    for store in stores:
        for outs in store.values():
            for out in outs.values():
                for w in (out if isinstance(out, (tuple, list)) else [out]):
                    t = getattr(w, "val", w)
                    if isinstance(t, torch.Tensor):
                        seen[t.untyped_storage().data_ptr()] = \
                            t.untyped_storage().nbytes()
    assert (cfg.remat == "dots") == bool(stores)
    return sum(n for p, n in seen.items() if p not in params_ptrs)


def test_remat_dots_keeps_the_matmuls_and_gives_the_same_grads(
        monkeypatch):
    """remat="dots" (the reference's checkpoint_dots: matmul outputs kept,
    the rest recomputed) gives block's and the JAX step's loss and
    gradients within 1e-5 in f32, and keeps strictly more bytes for the
    backward than "block" and fewer than "none"."""
    from repro.models.transformer import Model as JaxModel
    from repro.train.losses import total_loss as jax_total_loss
    arch = "olmo-1b-smoke"
    jcfg = dataclasses.replace(jax_get_config(arch), remat="dots")
    jparams = jax.tree_util.tree_map(
        np.asarray, jax_train_state_init(jcfg, jax.random.PRNGKey(0)).params)
    jbatch = jax_synthetic_batch(jcfg, 2, 16, seed=0)

    def jloss(p):
        logits, aux, _ = JaxModel(jcfg).forward(p, jbatch)
        return jax_total_loss(jcfg, logits, jbatch["labels"], aux)[0]

    jl, jg = jax.value_and_grad(jloss)(jparams)
    params = params_from_numpy(jparams, "cpu")
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in jbatch.items()}
    got, saved = {}, {}
    for remat in ("none", "block", "dots"):
        cfg = dataclasses.replace(get_config(arch), remat=remat)
        got[remat] = _grads(cfg, params, batch)
        saved[remat] = _saved_bytes(cfg, params, batch, monkeypatch)
    loss, grads = got["dots"]
    loss = loss.detach()
    np.testing.assert_allclose(float(loss), float(got["block"][0].detach()),
                               rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for g, b, j in zip(grads, got["block"][1], jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(g.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)
    assert saved["block"] < saved["dots"] < saved["none"], saved


def test_bf16_grad_boundary_rounds_the_cotangent():
    cfg = get_config("olmo-1b-smoke")
    x = torch.linspace(-1, 1, 7, requires_grad=True)
    g = torch.tensor([1 + 2 ** -10] * 7)
    (maybe_bf16_grads(cfg, x) * g).sum().backward()
    assert torch.equal(x.grad, g)
    x.grad = None
    (maybe_bf16_grads(cfg.with_opts("bf16_grads"), x) * g).sum().backward()
    assert x.grad.dtype == torch.float32
    assert torch.equal(x.grad, g.to(torch.bfloat16).float())


def test_later_slices_raise(one_rank, tmp_path):
    """Once refused here: ``comm="gspmd"`` (the default) and
    ``--ckpt-dir`` now work (``tests/test_torch_gspmd.py``,
    ``tests/test_torch_checkpoint.py``): the default step trains on one
    rank without a group, and the CLI writes a checkpoint. What still
    raises, naming item 14, is training on a model axis."""
    cfg = get_config("olmo-1b-smoke")
    step = make_train_step(cfg)                    # comm="gspmd" default
    state, m = step(train_state_init(cfg, 0, device="cpu", comm="gspmd"),
                    synthetic_batch(cfg, 2, 16, seed=0))
    assert int(state.step) == 1 and np.isfinite(float(m["loss"]))
    # every family trains: SSM and hybrid were the last refused
    for arch in ("mamba2-780m-smoke", "zamba2-7b-smoke"):
        make_train_step(get_config(arch), comm="vci")
    # the CLI's loop on this module's one-rank group (``main`` only adds
    # the ranks: tests/test_torch_checkpoint.py runs it)
    train_cli.train(train_cli.parse_args([
        "--device", "cpu", "--steps", "1", "--batch", "2", "--seq", "16",
        "--ckpt-dir", str(tmp_path)]), torch.device("cpu"))
    assert os.path.isfile(tmp_path / "step_00000001" / "manifest.json")
    # training on a model axis was the last refused
    # (tests/test_torch_model_axis.py); the Sharder takes one
    from repro_torch.core.collectives import RankMesh
    from repro_torch.dist.sharding import Sharder
    assert Sharder(RankMesh(2, 2), cfg, rank=0).tp_size == 2


def test_a_2d_mesh_refusal_names_item_14():
    """Once refused: a 2-D ``--mesh`` trains (``tests/test_torch_model_axis.
    py`` runs ``--mesh 2x2``), and so does the reference's 3-D form, the
    pod axis (``2x1x2`` there): its data lines span ``pod x data``. What
    still raises is a mesh of another rank count of axes."""
    mesh = train_cli.build_mesh("2x4x2")
    assert mesh.axis_names == ("pod", "data", "model")
    assert (mesh.pod, mesh.data, mesh.model, mesh.data_size) == (2, 4, 2, 8)
    assert train_cli._world_size("2x4x2") == 16
    assert train_cli._world_size("4x2") == 8
    with pytest.raises(ValueError, match="PxDxM"):
        train_cli.main(["--device", "cpu", "--mesh", "2x2x2x2"])


@pytest.mark.parametrize("paged", [False, True])
def test_kv_fp8_refusals_name_item_14(paged):
    """Once refused: a ``kv_fp8`` cache is made (``tests/
    test_torch_kv_fp8.py`` holds it against the reference). A bf16 cache
    stores ``float8_e4m3fn``, any other dtype stays as asked, as in the
    reference; what still refuses is a paged cache of an arch that has
    none (an SSM's)."""
    from repro_torch.models.transformer import init_cache, init_paged_cache
    cfg = get_config("olmo-1b-smoke").with_opts("kv_fp8")
    for dt, want in ((torch.bfloat16, torch.float8_e4m3fn),
                     (torch.float32, torch.float32)):
        if paged:
            c = init_paged_cache(cfg, 2, 32, page_size=8, num_pages=9,
                                 dtype=dt, device="cpu")
        else:
            c = init_cache(cfg, 2, 32, dtype=dt, device="cpu")
        assert c.kv.k.dtype == c.kv.v.dtype == want
    if paged:
        with pytest.raises(NotImplementedError, match="attention arch"):
            init_paged_cache(get_config("mamba2-780m-smoke").with_opts(
                "kv_fp8"), 2, 32, page_size=8, num_pages=9, device="cpu")


@pytest.mark.parametrize("remat,calls", [("none", 1), ("block", 2),
                                         ("dots", 1)])
def test_remat_dots_runs_the_flash_forward_once_a_layer(monkeypatch, remat,
                                                        calls):
    """The flash forward is one dispatcher op, so ``remat="dots"`` keeps
    its (o, lse) and the backward does not run it again: once a layer a
    forward + backward, as without remat; ``"block"`` twice."""
    from repro_torch.kernels import flash_attention as fa
    seen = []
    real = fa.flash_attention_fwd

    def counted(*a, **kw):
        seen.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention_fwd", counted)
    cfg = dataclasses.replace(get_config("olmo-1b-smoke"), remat=remat)
    params = train_state_init(cfg, 0, device="cpu").params
    batch = {k: torch.from_numpy(v) for k, v in
             synthetic_batch(cfg, 2, 16, seed=0).items()}
    _grads(cfg, params, batch)
    assert len(seen) == calls * cfg.num_layers


def test_cli_trains_on_two_cpu_ranks():
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
           "cpu", "--arch", "olmo-1b-smoke", "--steps", "2", "--batch", "4",
           "--seq", "32", "--mesh", "2", "--comm", "vci", "--pack", "pallas",
           "--num-streams", "4", "--log-every", "1"]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=240,
                       env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    steps = [ln for ln in r.stdout.splitlines() if ln.startswith("step ")]
    assert len(steps) == 2, r.stdout
    assert all(np.isfinite(float(ln.split()[3])) for ln in steps)


@pytest.mark.parametrize("arch,seq", [("mixtral-8x22b-smoke", 32),
                                      ("phi-3-vision-4.2b-smoke", 24),
                                      ("musicgen-large-smoke", 16),
                                      ("mamba2-780m-smoke", 40)])
def test_cli_trains_moe_vlm_and_audio_on_cpu(one_rank, capsys, arch, seq):
    """The CLI's arguments and training loop (``launch/train.py::train``,
    here on this module's one-rank group; ``main`` only adds the ranks,
    which ``test_cli_trains_on_two_cpu_ranks`` runs) train the MoE, VLM,
    audio and SSM archs with ``--device cpu``."""
    args = train_cli.parse_args([
        "--device", "cpu", "--arch", arch, "--steps", "2", "--batch", "2",
        "--seq", str(seq), "--comm", "vci", "--pack", "pallas",
        "--num-streams", "2", "--log-every", "1"])
    train_cli.train(args, torch.device("cpu"))
    out = capsys.readouterr().out
    assert f"arch={arch}" in out
    steps = [ln for ln in out.splitlines() if ln.startswith("step ")]
    assert len(steps) == 2, out
    assert all(np.isfinite(float(ln.split()[3])) for ln in steps)


def test_cli_needs_a_card_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--arch", "olmo-1b-smoke", "--steps", "1",
                        "--comm", "vci"])
