"""The port's MoE serve slice against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and fed to both sides; params come
from the reference's ``init_params`` through ``repro_torch.bridge``.

* ``row_gather_plain`` (the CPU path of the row-gather kernel) must equal
  ``row_gather_ref`` and ``row_gather_pallas`` in interpret mode exactly:
  the op is a copy.
* ``moe_ffn`` on mixtral-8x22b-smoke and on arctic-480b-smoke (a dense
  residual FFN beside the experts), with and without ``inference``, at a
  drop-free and at a dropping capacity: ``y`` within 1e-5 (the same f32
  math, summed in another order), both aux losses within rtol 1e-5, and the
  kept assignments identical.
* The serve engine's greedy tokens must equal the JAX engine's exactly.

The CUDA kernel is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.moe_gather import row_gather_pallas, row_gather_ref
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.serve import engine as jengine
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels import moe_gather
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.serve import engine as tengine
from repro_torch.train.trainer import make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5    # one MoE layer in f32
RTOL_AUX = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


# ---------------------------------------------------------------------------
# the row gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,m,d,lo,hi", [
    (16, 32, 64, -1, 16),      # some empty rows, M > T
    (8, 24, 700, -2, 8),       # d not a multiple of block_d=512, M > T
    (40, 16, 1024, -1, 40),    # two d tiles, M < T
    (4, 8, 128, -5, 0),        # every row empty
    (6, 12, 32, -1, 9),        # ids past T-1 clamp to the last row
])
def test_row_gather_plain_matches_reference(t, m, d, lo, hi, dtype):
    rng = np.random.default_rng(t * 1000 + d)
    np_dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    src = rng.normal(size=(t, d)).astype(np_dt)
    idx = rng.integers(lo, hi, (m,)).astype(np.int32)
    want_r = np.asarray(row_gather_ref(jnp.asarray(src), jnp.asarray(idx)))
    want_k = np.asarray(row_gather_pallas(jnp.asarray(src), jnp.asarray(idx),
                                          interpret=True))
    before = moe_gather.row_gather.launches
    got = moe_gather.row_gather(tensor_from_numpy(src, "cpu"),
                                torch.from_numpy(idx))
    assert moe_gather.row_gather.launches == before  # CPU: no kernel
    got = got.view(torch.int16 if dtype == "bfloat16" else torch.int32)
    assert got.shape == (m, d)
    np.testing.assert_array_equal(got.numpy(), _bits(want_r))
    np.testing.assert_array_equal(got.numpy(), _bits(want_k))


def test_row_gather_plain_keeps_autograd():
    src = torch.randn(5, 8, requires_grad=True)
    idx = torch.tensor([4, -1, 0, 4], dtype=torch.int32)
    moe_gather.row_gather(src, idx).sum().backward()
    want = torch.zeros(5, 8)
    want[4], want[0] = 2.0, 1.0
    assert torch.equal(src.grad, want)


@pytest.mark.parametrize("case", ["dtype", "idx_dtype", "rank", "strided",
                                  "row_bytes", "requires_grad", "device"])
def test_row_gather_kernel_refusals(case):
    """What the CUDA kernel cannot take is refused before a launch (checked
    here on CPU tensors; a CPU tensor itself never reaches the kernel)."""
    src = torch.zeros(4, 8)
    idx = torch.zeros(3, dtype=torch.int32)
    err, match = ValueError, None
    if case == "dtype":
        src, err, match = src.double(), TypeError, "takes"
    elif case == "idx_dtype":
        idx, err, match = idx.long(), TypeError, "int32"
    elif case == "rank":
        src, match = src[None], "T>=1"
    elif case == "strided":
        src, match = torch.zeros(8, 4).T, "contiguous"
    elif case == "row_bytes":
        src, match = torch.zeros(4, 3), "16 bytes"
    elif case == "requires_grad":
        # a source that requires grad is no longer refused (the kernel
        # trains through its gather-sum backward): the check gets as far as
        # the device; only a backward without the inverse table raises,
        # anywhere but on the CPU
        src = src.requires_grad_()
        with pytest.raises(NotImplementedError, match="inverse table"):
            moe_gather._scatter_add_plain(torch.zeros(3, 8, device="meta"),
                                          idx.to("meta"), 4)
        match = "CUDA device"
    else:
        match = "CUDA device"
    with pytest.raises(err, match=match):
        moe_gather._check_cuda_args(src, idx)


def _inverse_tables(t, m, k, seed):
    """A gather table ``idx`` (M,) over T source rows in which each source
    row fills at most ``k`` output slots (some none, some slots empty), and
    its exact inverse ``inv`` (T*k,), as ``dispatch_tables`` builds them."""
    rng = np.random.default_rng(seed)
    slots = rng.permutation(m)[:min(m, t * k)]
    owners = rng.permutation(np.repeat(np.arange(t), k))[:slots.size]
    keep = rng.random(slots.size) < 0.8
    idx = np.full(m, -1, np.int32)
    inv = np.full(t * k, -1, np.int32)
    fill = np.zeros(t, np.int64)
    for s_, o, kp in zip(slots, owners, keep):
        if kp:
            idx[s_] = o
            inv[o * k + fill[o]] = s_
            fill[o] += 1
    return torch.from_numpy(idx), torch.from_numpy(inv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 2])
def test_row_gather_grad_equals_autograd_of_plain(dtype, k):
    """The dispatcher op's backward given the inverse table (the gather-sum,
    each source row the sum of its K output rows' gradients) equals
    ``torch.autograd`` of the plain gather — rows read twice, rows read by
    none, empty output rows — bit for bit (at K <= 2 a sum in f32 rounded
    once is the scatter-add's)."""
    t, m, d = 12, 20, 16
    idx, inv = _inverse_tables(t, m, k, seed=k)
    assert int((idx < 0).sum()) > 0 and int((inv < 0).sum()) > 0
    if k == 2:
        assert int(torch.bincount(idx[idx >= 0].long()).max()) == 2
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(t, d)).astype(np.float32)).to(dtype)
    dy = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)
                          ).to(dtype)
    a = x.clone().requires_grad_()
    moe_gather.row_gather(a, idx, inv).backward(dy)
    b = x.clone().requires_grad_()
    moe_gather.row_gather_plain(b, idx).backward(dy)
    assert a.grad.dtype == dtype
    assert torch.equal(a.grad, b.grad)


def test_row_gather_grad_without_inverse_is_the_scatter_add():
    """Without ``inv`` the CPU backward adds each output row's gradient into
    its source row: duplicate ids sum, negative ids add nothing, ids past
    T-1 land on the last row (the forward clamps them)."""
    idx = torch.tensor([3, -1, 0, 3, 7, 3, -4], dtype=torch.int32)
    x = torch.randn(5, 8, requires_grad=True)
    dy = torch.randn(7, 8)
    moe_gather.row_gather(x, idx).backward(dy)
    want = torch.zeros(5, 8)
    for i, r in enumerate(idx.tolist()):
        if r >= 0:
            want[min(r, 4)] += dy[i]
    assert torch.allclose(x.grad, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_row_gather_sum_plain_matches_a_numpy_loop(dtype, k):
    """``row_gather_sum_plain`` (the CPU path and the card's yardstick of
    the gather-sum kernel) against a numpy loop: the entries >= 0 of each
    row summed in f32 in k order, ids past M-1 clamped, rounded once."""
    rng = np.random.default_rng(k)
    np_dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    m, t, d = 9, 6, 24
    src = rng.normal(size=(m, d)).astype(np_dt)
    inv = rng.integers(-3, m + 2, (t * k,)).astype(np.int32)
    want = np.zeros((t, d), np.float32)
    for r in range(t):
        for j in range(k):
            i = inv[r * k + j]
            if i >= 0:
                want[r] += src[min(i, m - 1)].astype(np.float32)
    want = want.astype(np_dt)
    got = moe_gather.row_gather_sum_plain(tensor_from_numpy(src, "cpu"),
                                          torch.from_numpy(inv), k)
    assert got.shape == (t, d)
    if k <= 2:   # two terms: one rounding, any order
        np.testing.assert_array_equal(_bits(np.asarray(
            got.float().numpy().astype(np_dt))), _bits(want))
    else:
        np.testing.assert_allclose(got.float().numpy(),
                                   want.astype(np.float32), rtol=1e-6,
                                   atol=1e-6 if dtype == "float32" else 0.05)
    # the wrapper on a CPU tensor is the plain version (K = 1: the gather)
    before = moe_gather.row_gather_sum.launches
    assert torch.equal(moe_gather.row_gather_sum(
        tensor_from_numpy(src, "cpu"), torch.from_numpy(inv), k), got)
    assert moe_gather.row_gather_sum.launches == before


def test_row_gather_refuses_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        moe_gather.row_gather(torch.zeros(4, 8, device="meta"),
                              torch.zeros(2, dtype=torch.int32,
                                          device="meta"))


# ---------------------------------------------------------------------------
# capacity, routing tables, moe_ffn
# ---------------------------------------------------------------------------

def test_capacity_matches_reference():
    for tokens in (1, 7, 20, 64, 1024):
        for experts in (4, 8, 128):
            for cf in (0.5, 1.25, 2.0, 8.0):
                for k in (1, 2):
                    assert tmoe.capacity(tokens, experts, cf, k) == \
                        jmoe.capacity(tokens, experts, cf, k)


def _jax_keep(jcfg, x, router, inference):
    """The reference's kept-assignment mask in token order, (B, S*K):
    ``repro/models/moe.py:44-58`` step by step (``moe_ffn`` does not
    return it)."""
    m = jcfg.moe
    B, S, _ = x.shape
    E, K = m.num_experts, m.top_k
    cf = m.capacity_factor_eval if inference else m.capacity_factor
    C = min(jmoe.capacity(S, E, cf, K), S)
    logits = (x @ router.astype(x.dtype)).astype(jnp.float32)
    _, eidx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    eid = eidx.reshape(B, S * K)
    order = jnp.argsort(eid, axis=1, stable=True)
    eids = jnp.take_along_axis(eid, order, axis=1)
    onehot = jax.nn.one_hot(eids, E, dtype=jnp.int32)
    rank = jnp.take_along_axis(jnp.cumsum(onehot, axis=1) - 1,
                               eids[..., None], axis=-1)[..., 0]
    keep = np.zeros((B, S * K), bool)
    np.put_along_axis(keep, np.asarray(order), np.asarray(rank < C), axis=1)
    return keep, np.asarray(eidx)


def _layer0(tree):
    return {k: _layer0(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


@pytest.fixture(scope="module", params=["mixtral-8x22b-smoke",
                                        "arctic-480b-smoke"])
def moe_layer(request):
    """(cfg, jcfg, port layer params, JAX layer params) of layer 0."""
    arch = request.param
    jcfg = jax_get_config(arch)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    jp = _layer0(jparams["layers"]["moe"])
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return get_config(arch), jcfg, tp, jp


@pytest.mark.parametrize("capacity", ["drop_free", "dropping"])
@pytest.mark.parametrize("inference", [False, True])
def test_moe_ffn_matches_reference(moe_layer, inference, capacity):
    cfg, jcfg, tp, jp = moe_layer
    assert cfg.moe.dense_residual == ("residual" in tp)
    cf = float(cfg.moe.num_experts) if capacity == "drop_free" else 0.5
    moe = dataclasses.replace(cfg.moe, capacity_factor=cf,
                              capacity_factor_eval=cf)
    cfg = dataclasses.replace(cfg, moe=moe)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=cf, capacity_factor_eval=cf))
    rng = np.random.default_rng(11)
    x = rng.normal(size=(3, 16, cfg.d_model)).astype(np.float32)

    y_j, aux_j = jmoe.moe_ffn(jcfg, jnp.asarray(x), jp, None,
                              inference=inference)
    y_t, aux_t = tmoe.moe_ffn(cfg, _t(x), tp, inference=inference)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=ATOL,
                               rtol=0)
    assert set(aux_t) == set(aux_j) == {"load_balance", "router_z"}
    for k in aux_j:
        np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]),
                                   rtol=RTOL_AUX)

    keep_j, eidx_j = _jax_keep(jcfg, jnp.asarray(x), jp["router"], inference)
    logits = _t(x) @ tp["router"]
    eidx_t = torch.sort(torch.softmax(logits, -1), dim=-1, descending=True,
                        stable=True)[1][..., :cfg.moe.top_k]
    np.testing.assert_array_equal(eidx_t.numpy(), eidx_j)
    C = min(tmoe.capacity(16, cfg.moe.num_experts, cf, cfg.moe.top_k), 16)
    disp, comb, _ = tmoe.dispatch_tables(eidx_t, cfg.moe.num_experts, C)
    keep_t = (comb >= 0).reshape(3, -1).numpy()
    np.testing.assert_array_equal(keep_t, keep_j)
    assert keep_t.all() == (capacity == "drop_free")
    assert int((disp >= 0).sum()) == int(keep_t.sum())


def test_dispatch_tables_round_trip():
    """Every kept assignment's slot holds its own token row; every filled
    slot is read back by exactly one assignment."""
    rng = np.random.default_rng(5)
    B, S, K, E, C = 3, 10, 2, 4, 4
    eidx = torch.from_numpy(np.stack([np.stack([rng.choice(E, K, replace=False)
                                                for _ in range(S)])
                                      for _ in range(B)]))
    disp, comb, asg = tmoe.dispatch_tables(eidx, E, C)
    assert disp.shape == asg.shape == (E * B * C,)
    assert comb.shape == (B * S * K,)
    assert disp.dtype == comb.dtype == asg.dtype == torch.int32
    for a, slot in enumerate(comb.tolist()):
        b, s, k = a // (S * K), (a // K) % S, a % K
        if slot >= 0:
            assert disp[slot] == b * S + s
            e, bc = divmod(slot, B * C)
            assert e == int(eidx[b, s, k]) and bc // C == b
    filled = disp[disp >= 0].numel()
    assert filled == int((comb >= 0).sum())
    assert sorted(comb[comb >= 0].tolist()) == \
        sorted((disp >= 0).nonzero()[:, 0].tolist())


# B, S, E, K, capacity factor: decode (S = 1), top-1 to top-4, drop-free
# and dropping capacities, mixtral-smoke's widths
_TABLE_CASES = [
    (1, 1, 8, 2, 2.0),
    (4, 1, 8, 2, 2.0),
    (2, 16, 4, 1, 1.0),
    (3, 10, 4, 2, 1.25),
    (2, 64, 8, 2, 0.5),
    (1, 33, 6, 3, 0.75),
    (2, 20, 16, 4, 1.0),
    (4, 20, 4, 2, 2.0),
]


def _tables(B, S, E, K, cf, seed=0):
    """Random top-K routing (K distinct experts a token) and its tables at
    the capacity ``moe_ffn`` gives a group of S tokens."""
    rng = np.random.default_rng(seed)
    eidx = torch.from_numpy(np.stack([np.stack([rng.choice(E, K, replace=False)
                                                for _ in range(S)])
                                      for _ in range(B)]))
    cap = min(tmoe.capacity(S, E, cf, K), S)
    disp, comb, _ = tmoe.dispatch_tables(eidx, E, cap)
    return cap, disp, comb


@pytest.mark.parametrize("B,S,E,K,cf", _TABLE_CASES)
def test_comb_is_the_inverse_of_disp(B, S, E, K, cf):
    """``comb`` is exactly ``disp``'s inverse, as the row gather's ``inv``
    must be: every kept slot's token row maps back to it, every dropped
    assignment is -1, no slot is named twice, every filled slot is named."""
    cap, disp, comb = _tables(B, S, E, K, cf)
    kept = comb >= 0
    tok = torch.arange(B * S).repeat_interleave(K)
    assert torch.equal(disp[comb[kept].long()], tok[kept].to(torch.int32))
    assert bool((comb[~kept] == -1).all())
    slots = comb[kept].long()
    assert slots.unique().numel() == slots.numel()
    assert bool(((slots >= 0) & (slots < E * B * cap)).all())
    assert torch.equal(slots.sort().values, (disp >= 0).nonzero()[:, 0])
    if cf < 1:
        assert int((~kept).sum()) > 0
    src = torch.zeros(B * S, 8)
    assert moe_gather._check_inv(src, comb) == K


@pytest.mark.parametrize("B,S,E,K,cf", _TABLE_CASES)
def test_asg_is_the_inverse_of_comb(B, S, E, K, cf):
    """``asg`` is exactly ``comb``'s inverse, as the combine's backward
    needs: every kept assignment's slot names it back, every slot no
    assignment reads is -1 (the empty slots, where ``disp`` is -1 too)."""
    rng = np.random.default_rng(4)
    eidx = torch.from_numpy(np.stack([np.stack([rng.choice(E, K, replace=False)
                                                for _ in range(S)])
                                      for _ in range(B)]))
    cap = min(tmoe.capacity(S, E, cf, K), S)
    disp, comb, asg = tmoe.dispatch_tables(eidx, E, cap)
    kept = (comb >= 0).nonzero()[:, 0]
    assert torch.equal(asg[comb[kept].long()], kept.to(torch.int32))
    assert torch.equal(asg >= 0, disp >= 0)
    read = asg[asg >= 0].long()
    assert read.unique().numel() == read.numel() == kept.numel()
    assert torch.equal(comb[read], (asg >= 0).nonzero()[:, 0].to(
        torch.int32))
    src = torch.zeros(E * B * cap, 8)
    assert moe_gather._check_inv(src, asg) == 1


@pytest.mark.parametrize("B,S,E,K,cf", _TABLE_CASES)
def test_read_once_dispatch_equals_the_gather(B, S, E, K, cf):
    """The dispatch as the kernel's read-once route does it — each token
    row read once and stored to the slots ``comb`` names for it, the other
    slots zero — equals ``row_gather_plain(x, disp)`` bit for bit; the CPU
    route ignores ``inv``."""
    _, disp, comb = _tables(B, S, E, K, cf, seed=1)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(B * S, 24)).astype(np.float32))
    out = torch.zeros((disp.numel(), 24))
    for t in range(B * S):
        row = x[t].clone()
        for slot in comb[t * K:(t + 1) * K].tolist():
            if slot >= 0:
                out[slot] = row
    want = moe_gather.row_gather_plain(x, disp)
    assert torch.equal(out, want)
    assert torch.equal(moe_gather.row_gather(x, disp, comb), want)


@pytest.mark.parametrize("t,d,dtype,k,want", [
    (4, 6144, torch.bfloat16, 2, False),      # mixtral decode dispatch
    (64, 6144, torch.bfloat16, 2, False),     # a 64-token prefill
    (8192, 6144, torch.bfloat16, 2, True),    # 8 groups of 1,024 tokens
    (8192, 6144, torch.bfloat16, 1, False),   # top-1: nothing is read twice
    (2048, 4096, torch.float32, 2, True),
])
def test_read_once_route_rule(t, d, dtype, k, want):
    """The read-once route is taken where it spares at least
    ``_READ_ONCE_MIN_BYTES`` of reads (shapes only: a meta tensor)."""
    src = torch.empty((t, d), dtype=dtype, device="meta")
    assert moe_gather._read_once(src, k) is want


@pytest.mark.parametrize("case", ["dtype", "length", "rank", "strided",
                                  "device"])
def test_row_gather_inv_refusals(case):
    """What the kernel cannot take as ``inv`` is refused before a launch
    (checked here on CPU tensors)."""
    src = torch.zeros(4, 8)
    inv = torch.full((8,), -1, dtype=torch.int32)
    err, match = ValueError, None
    if case == "dtype":
        inv, err, match = inv.long(), TypeError, "int32"
    elif case == "length":
        inv, match = inv[:6], "length"
    elif case == "rank":
        inv, match = inv.view(4, 2), "length"
    elif case == "strided":
        inv, match = inv.repeat(2)[::2], "contiguous"
    else:
        inv, match = inv.to("meta"), "must be on"
    with pytest.raises(err, match=match):
        moe_gather._check_inv(src, inv)


def test_moe_ffn_refuses_shard_and_comm(moe_layer):
    """Once refused: the ``shard=`` route is ported on a data-only mesh
    (``tests/test_torch_gspmd.py`` runs it on 2 and 4 ranks); on one rank
    it is the plain route, value for value. It stays exclusive of
    ``comm=`` (the manual-TP route, ``tests/test_torch_serve_tp.py``), as
    in the reference, and a model axis is refused by the Sharder, naming
    item 14."""
    from repro_torch.core.collectives import RankMesh
    from repro_torch.dist.sharding import Sharder
    cfg, _, tp, _ = moe_layer
    x = torch.randn(1, 6, cfg.d_model,
                    generator=torch.Generator().manual_seed(0))
    want, want_aux = tmoe.moe_ffn(cfg, x, tp)
    got, aux = tmoe.moe_ffn(cfg, x, tp, shard=Sharder(None, cfg))
    assert torch.equal(got, want)
    for k in want_aux:
        assert torch.equal(aux[k], want_aux[k]), k
    with pytest.raises(ValueError, match="shard or comm"):
        tmoe.moe_ffn(cfg, x, tp, shard=Sharder(None, cfg), comm=object())
    # a model axis is taken now (tests/test_torch_model_axis.py trains
    # mixtral on 2 x 2: experts over data, their ff dim over model), and so
    # is a kv_fp8 cache, once refused naming item 14
    cut = Sharder(RankMesh(2, 2), cfg, rank=1)
    assert cut.expert_parallel(("layers", "moe", "w_gate"))
    assert cut.model_dim(("layers", "moe", "w_gate")) == 3
    from repro_torch.models.transformer import init_paged_cache
    c = init_paged_cache(cfg.with_opts("kv_fp8"), 1, 8, page_size=4,
                         num_pages=3, device="cpu")
    assert c.kv.k.dtype == torch.float8_e4m3fn


def test_moe_params_match_reference_layout():
    """The port's MoE param tree has the reference's keys, shapes and
    dtypes; the router stays float32 under bf16 params."""
    for arch in ("mixtral-8x22b-smoke", "arctic-480b-smoke"):
        cfg = dataclasses.replace(get_config(arch), param_dtype="bfloat16")
        jcfg = dataclasses.replace(jax_get_config(arch),
                                   param_dtype="bfloat16")
        want = jax.eval_shape(lambda: jtf.init_params(
            jcfg, jax.random.PRNGKey(0)))
        got = ttf.init_params(cfg, 0, device="cpu")
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
        assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
        for (path, w), (_, g) in zip(flat_w, flat_g):
            assert tuple(g.shape) == w.shape, path
            assert str(g.dtype).replace("torch.", "") == str(w.dtype), path
        assert got["layers"]["moe"]["router"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

ARCH = "mixtral-8x22b-smoke"   # sliding_window=64: max_len 64 needs no ring


@pytest.fixture(scope="module")
def mixtral():
    jcfg = jax_get_config(ARCH)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    return get_config(ARCH), jcfg, tparams, jparams


def _requests(kind):
    """Mixed prompt lengths in one batch, or 5 requests on 2 slots (slots
    recycled: mid-stream admission)."""
    if kind in ("mixed", "dropping"):
        rng = np.random.default_rng(3)
        spec, batch = [(3, 6), (11, 6), (7, 6)], 3
    else:
        rng = np.random.default_rng(11)
        spec, batch = [(5, 3), (9, 6), (4, 8), (7, 2), (6, 5)], 2
    reqs = [dict(prompt=rng.integers(0, 512, (p,), dtype=np.int32),
                 max_new_tokens=n) for p, n in spec]
    return reqs, batch


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("kind", ["mixed", "recycling", "dropping"])
def test_moe_engine_tokens_match_reference(mixtral, kind, paged):
    """``dropping``: capacity_factor_eval 0.5, so the 11-wide prefill has
    C = 4 slots an expert for 22 assignments of each row (pad rows
    included) over 4 experts: some are dropped in every row."""
    cfg, jcfg, tparams, jparams = mixtral
    if kind == "dropping":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor_eval=0.5))
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor_eval=0.5))
    reqs, batch = _requests(kind)
    kw = dict(batch_size=batch, max_len=64, paged=paged, page_size=8,
              num_pages=13)
    jeng = jengine.ServeEngine(jcfg, jparams, **kw)
    want = [r.generated for r in jeng.generate(
        [jengine.Request(**r) for r in reqs])]
    teng = tengine.ServeEngine(cfg, tparams, device="cpu", **kw)
    done = teng.generate([tengine.Request(**r) for r in reqs])
    for i, (r, w) in enumerate(zip(done, want)):
        np.testing.assert_array_equal(r.generated, w,
                                      err_msg=f"request {i} ({kind})")
    assert teng.cache_bytes_resident == jeng.cache_bytes_resident


def test_moe_training_is_refused():
    """Once refused (ROADMAP item 15); now MoE trains: the step builds and
    gradients reach every expert table, the router and the layer's input
    through both row moves, with and without the (one-rank) GSPMD
    Sharder, to the same bits."""
    cfg = get_config(ARCH)
    make_train_step(cfg, comm="vci")
    params = ttf.init_params(cfg, 0, device="cpu")
    p = {k: v.detach().requires_grad_() for k, v in
         ttf.layer_params(params, 0)["moe"].items()}
    x = torch.randn(2, 12, cfg.d_model, requires_grad=True)
    y, aux = tmoe.moe_ffn(cfg, x, p)
    (y.square().sum() + aux["load_balance"] + aux["router_z"]).backward()
    for name in ("w_gate", "w_up", "w_down", "router"):
        assert p[name].grad is not None and p[name].grad.abs().sum() > 0
    assert x.grad.abs().sum() > 0
    # the GSPMD-sharded route trains too: on one rank, the same gradients
    from repro_torch.dist.sharding import Sharder
    grads = [p[k].grad.clone() for k in sorted(p)] + [x.grad.clone()]
    for t in list(p.values()) + [x]:
        t.grad = None
    y, aux = tmoe.moe_ffn(cfg, x, p, shard=Sharder(None, cfg))
    (y.square().sum() + aux["load_balance"] + aux["router_z"]).backward()
    for g, t in zip(grads, [p[k] for k in sorted(p)] + [x]):
        assert torch.equal(t.grad, g)


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "frozen",
                                  "x_grad", "w_grad"])
def test_assignment_table_only_where_autograd_reads_it(monkeypatch, mode):
    """``moe_ffn`` asks ``dispatch_tables`` for ``asg`` only where the
    combine's backward will run (a serve forward builds no such table),
    and its output does not depend on it."""
    cfg = get_config(ARCH)
    params = ttf.init_params(cfg, 0, device="cpu")
    p = dict(ttf.layer_params(params, 0)["moe"])
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 12, cfg.d_model)).astype(np.float32))
    want, _ = tmoe.moe_ffn(cfg, x, p)
    tables, asked = tmoe.dispatch_tables, []

    def recording(eidx, num_experts, cap, **kw):
        out = tables(eidx, num_experts, cap, **kw)
        asked.append(out[2] is not None)
        return out

    monkeypatch.setattr(tmoe, "dispatch_tables", recording)
    if mode == "x_grad":
        x = x.clone().requires_grad_()
    elif mode == "w_grad":
        p["w_down"] = p["w_down"].clone().requires_grad_()
    if mode == "no_grad":
        with torch.no_grad():
            y, _ = tmoe.moe_ffn(cfg, x.requires_grad_(), p)
    elif mode == "inference_mode":
        with torch.inference_mode():
            y, _ = tmoe.moe_ffn(cfg, x, p)
    else:
        y, _ = tmoe.moe_ffn(cfg, x, p)
    assert asked == [mode in ("x_grad", "w_grad")]
    assert torch.equal(y.detach(), want)
    if asked[0]:
        y.square().sum().backward()


def test_cli_serves_moe_on_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        "--device", "cpu", "--arch", ARCH, "--max-len", "64",
                        "--paged", "--vary-prompts"],
                       capture_output=True, text=True, cwd=REPO, env=env,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "arch=mixtral-8x22b-smoke" in r.stdout
    assert "8 requests, 256 new tokens" in r.stdout
