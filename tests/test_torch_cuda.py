"""Tests of the port that need a CUDA card (marker ``cuda``).

A hand-written kernel has no CPU mode, so these skip without a card. On
the GPU machine (no JAX there; this file imports none):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import bucket_pack, moe_gather, paged_kv, ssd_scan
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.transformer import Model, init_cache, init_params
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape", [(65, 16, 16, 128), (13, 8, 2, 64),
                                   (5, 3, 1, 8)])
def test_kernel_matches_plain(cuda_device, dtype, shape):
    """Bit-equal to the plain version, incl. unmapped and out-of-range ids
    (clipped to the last page), and one launch counted per call."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    table = torch.randint(-1, shape[0] + 2, (4, 16), generator=gen,
                          device=cuda_device, dtype=torch.int32)
    pool = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    n0 = paged_kv.paged_gather.launches
    got = paged_kv.paged_gather(pool, table)
    torch.cuda.synchronize()
    assert paged_kv.paged_gather.launches == n0 + 1
    want = paged_kv.paged_gather_plain(pool, table)
    assert got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("shape", [(1025, 16, 4, 128), (13, 16, 2, 64),
                                   (5, 4, 1, 8)])
def test_kernel_matches_plain_on_fp8_pools(cuda_device, shape):
    """A ``kv_fp8`` pool (1-byte pages; yi-9b's decode shape first, 8 KiB
    a page): the kernel moves its bytes as the plain version does."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    table = torch.randint(-1, shape[0] + 2, (4, 16), generator=gen,
                          device=cuda_device, dtype=torch.int32)
    pool = torch.randint(0, 256, shape, generator=gen, device=cuda_device,
                         dtype=torch.uint8).view(torch.float8_e4m3fn)
    n0 = paged_kv.paged_gather.launches
    got = paged_kv.paged_gather(pool, table)
    torch.cuda.synchronize()
    assert paged_kv.paged_gather.launches == n0 + 1
    want = paged_kv.paged_gather_plain(pool, table)
    assert got.dtype == want.dtype == torch.float8_e4m3fn
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def test_kernel_rejects_what_it_cannot_take(cuda_device):
    pool = torch.zeros((4, 2, 1, 8), device=cuda_device)
    table = torch.zeros((1, 2), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError, match="int32"):
        paged_kv.paged_gather(pool, table.long())
    with pytest.raises(ValueError, match="must be on"):
        paged_kv.paged_gather(pool, table.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        paged_kv.paged_gather(torch.zeros((4, 2, 2, 8), device=cuda_device
                                          ).transpose(1, 2), table)
    with pytest.raises(ValueError, match="16 bytes"):
        paged_kv.paged_gather(torch.zeros((4, 1, 1, 3), device=cuda_device),
                              table)


def test_engine_paged_equals_contiguous_on_card(cuda_device):
    """olmo-1b-smoke on the card: paged tokens equal contiguous tokens, and
    every decode step launched the gather twice per layer."""
    cfg = get_config("olmo-1b-smoke")
    params = init_params(cfg, 0, device=cuda_device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32)
               for n in (5, 9, 4, 7, 6)]
    toks = {}
    for paged in (True, False):
        eng = ServeEngine(cfg, params, batch_size=2, max_len=64,
                          device=cuda_device, paged=paged, page_size=8,
                          num_pages=13)
        paged_kv.paged_gather.launches = 0
        reqs = eng.generate([Request(prompt=p, max_new_tokens=6)
                             for p in prompts])
        want = 2 * cfg.num_layers * eng.decode_steps if paged else 0
        assert paged_kv.paged_gather.launches == want
        toks[paged] = [r.generated.tolist() for r in reqs]
    assert toks[True] == toks[False]


def _tables(rng, n_tiles, src_tiles, tile):
    """Random tables: some tiles unused (valid 0), some partial, some full;
    each used tile reads a distinct source tile."""
    block = rng.permutation(src_tiles)[:n_tiles].astype(np.int32)
    valid = rng.integers(0, tile + 1, n_tiles).astype(np.int32)
    valid[::5] = tile
    valid[1::7] = 0
    valid[2::11] = 1
    return block, valid


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_tiles,src_tiles", [(1, 1), (7, 9), (300, 301)])
def test_bucket_pack_kernel_matches_plain(cuda_device, dtype, n_tiles,
                                          src_tiles):
    """pack and unpack bit for bit against the plain version, into a fresh
    buffer and into a slice of a larger one; one launch counted each."""
    tile = bucket_pack.TILE
    rng = np.random.default_rng(n_tiles)
    blk, val = _tables(rng, n_tiles, src_tiles, tile)
    blk, val = (torch.from_numpy(a).to(cuda_device) for a in (blk, val))
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    src = torch.randn(src_tiles * tile, generator=gen,
                      device=cuda_device).to(dtype)
    want = bucket_pack.bucket_pack_plain(src, blk, val, n_tiles * tile)
    for fn, name in ((bucket_pack.bucket_pack, "pack"),
                     (bucket_pack.bucket_unpack, "unpack")):
        n0 = fn.launches
        got = fn(src, blk, val, n_tiles * tile)
        big = torch.full((n_tiles * tile + 2 * tile,), 7.0, dtype=dtype,
                         device=cuda_device)
        fn(src, blk, val, n_tiles * tile, out=big[tile:-tile])
        torch.cuda.synchronize()
        assert fn.launches == n0 + 2, name
        assert torch.equal(_bits(got), _bits(want)), name
        assert torch.equal(_bits(big[tile:-tile]), _bits(want)), name
        assert bool((big[:tile] == 7).all() and (big[-tile:] == 7).all())


def test_bucket_pack_rejects_what_it_cannot_take(cuda_device):
    tile = bucket_pack.TILE
    src = torch.zeros(2 * tile, device=cuda_device)
    t = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError, match="int32"):
        bucket_pack.bucket_pack(src, t.long(), t, 2 * tile)
    with pytest.raises(TypeError, match="takes"):
        bucket_pack.bucket_pack(src.half(), t, t, 2 * tile)
    with pytest.raises(ValueError, match="must be on"):
        bucket_pack.bucket_pack(src, t.cpu(), t, 2 * tile)
    with pytest.raises(ValueError, match="entries"):
        bucket_pack.bucket_pack(src, t[:1], t, 2 * tile)
    with pytest.raises(ValueError, match="contiguous"):
        bucket_pack.bucket_pack(src, t, t, 2 * tile,
                                out=torch.zeros((2 * tile, 2),
                                                device=cuda_device)[:, 0])


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _flash_inputs(dev, dtype, b, sq, skv, h, kv, hd, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                 for shape in ((b, sq, h, hd), (b, skv, kv, hd),
                               (b, skv, kv, hd)))


def _flash_errors(q, k, v, o, lse, **kw):
    """(o error, lse error, allowed o error, allowed lse error) of the
    kernel's (o, lse). f32: against the plain version, 2e-5 (the f32 kernel
    tolerance of tests/test_kernels.py). bf16: against the plain version
    run in f32 on the upcast inputs, at most 1.25 x the plain version's own
    error in the input dtype, + 1e-3."""
    if q.dtype == torch.float32:
        po, plse = fa.flash_attention_fwd_plain(q, k, v, **kw)
        return ((o - po).abs().max().item(), (lse - plse).abs().max().item(),
                2e-5, 2e-5)
    ro, rlse = fa.flash_attention_fwd_plain(q.float(), k.float(), v.float(),
                                            **kw)
    po, plse = fa.flash_attention_fwd_plain(q, k, v, **kw)
    return ((o.float() - ro).abs().max().item(),
            (lse - rlse).abs().max().item(),
            1.25 * (po.float() - ro).abs().max().item() + 1e-3,
            1.25 * (plse - rlse).abs().max().item() + 1e-3)


_FLASH_CASES = [  # hd, b, sq, skv, h, kv, causal, window, start
    (64, 2, 100, 100, 4, 2, True, 32, [0, 37]),   # ragged, GQA, pad rows
    (128, 2, 64, 64, 4, 4, True, None, [0, 10]),
    (256, 1, 96, 96, 4, 1, True, None, None),     # MQA at hd 256
    (64, 1, 40, 72, 2, 1, False, None, None),     # Sq != Skv
    (128, 1, 130, 130, 2, 2, True, 16, [129]),    # all but one pad row
    (64, 1, 80, 24, 2, 2, False, 8, None),        # rows with no valid key
    (96, 2, 130, 130, 32, 32, True, None, [0, 17]),  # phi-3-vision's hd
    (112, 1, 200, 200, 32, 32, True, None, None),    # zamba2-7b's hd
    (128, 2, 64, 64, 4, 2, True, None, None),     # the 64-row variant
    (128, 2, 65, 65, 4, 2, True, None, [3, 0]),   # the 128-row variant
    (64, 2, 150, 300, 4, 4, False, None, None),   # Skv not a multiple of 128
    (128, 1, 384, 384, 2, 2, True, None, None),   # full tiles, then diagonal
    (256, 1, 400, 400, 2, 1, True, 200, None),    # full tiles inside a window
    # at least 132 units (one an SM of an H100 SXM): pairs of query blocks
    (64, 1, 384, 384, 66, 66, True, None, None),  # odd count: one alone
    (128, 2, 512, 512, 34, 17, True, 100, [0, 130]),
    # mixtral's GQA 48/8 at hd 128 with a window shorter than the sequence
    # (whole KV blocks below the window's edge skipped)
    (128, 1, 700, 700, 48, 8, True, 256, None),
    # phi-3-vision's prefill of 576 patches + 448 text tokens, and
    # musicgen-large's of 1,000 frames (Sq not a multiple of the tile) and
    # of 64 frames (the variant for Sq <= 64)
    (96, 1, 1024, 1024, 32, 32, True, None, None),
    (64, 1, 1000, 1000, 32, 32, True, None, None),
    (64, 2, 64, 64, 32, 32, True, None, None),
    # the tensor-parallel ranks' prefills at tp 4 (chip_smoke phase 7):
    # olmo-1b's 4 of 16 heads with pad rows, and mixtral-8x22b's 12 query
    # heads on 2 KV heads (GQA 6:1) at 8 x 1,024 (paired query blocks) and
    # in the serve batch's prefill (the variant for Sq <= 64)
    (128, 4, 64, 64, 4, 4, True, None, [0, 9, 33, 63]),
    (128, 8, 1024, 1024, 12, 2, True, None, None),
    (128, 4, 64, 64, 12, 2, True, None, [0, 9, 33, 63]),
    # gemma-2b's short prefill (chip_smoke phase 18a): head_dim 256 on one
    # KV head, the variant for Sq <= 64, with pad rows
    (256, 4, 64, 64, 8, 1, True, None, [0, 9, 33, 63]),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _FLASH_CASES, ids=str)
def test_flash_kernel_matches_plain(cuda_device, dtype, case):
    """o and lse against the plain version (pad rows included); a second
    launch gives equal bits; one launch counted per call."""
    hd, b, sq, skv, h, kv, causal, window, start = case
    q, k, v = _flash_inputs(cuda_device, dtype, b, sq, skv, h, kv, hd)
    st = None if start is None else torch.tensor(start, dtype=torch.int32,
                                                  device=cuda_device)
    kw = dict(causal=causal, window=window, start=st)
    n0 = fa.flash_attention.launches
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    o2, lse2 = fa.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 2
    assert o.shape == q.shape and o.dtype == dtype
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    assert torch.equal(_bits(o), _bits(o2)) and torch.equal(_bits(lse),
                                                             _bits(lse2))
    eo, el, tol_o, tol_l = _flash_errors(q, k, v, o, lse, **kw)
    assert eo <= tol_o, (eo, tol_o)
    assert el <= tol_l, (el, tol_l)


@pytest.mark.parametrize("s,hd", [(48, 64), (48, 128), (200, 128)])
def test_flash_kernel_takes_strided_heads(cuda_device, s, hd):
    """q/k/v as slices of one fused projection (strided over S and H, the
    last dim contiguous) give the same bits as contiguous copies, on both
    the 64-row (s <= 64) and the 128-row variant."""
    b, h = 2, 4
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    qkv = torch.randn((b, s, 3 * h, hd), generator=gen,
                      device=cuda_device).to(torch.bfloat16)
    q, k, v = qkv[:, :, :h], qkv[:, :, h:2 * h], qkv[:, :, 2 * h:]
    got = fa.flash_attention_fwd(q, k, v)
    want = fa.flash_attention_fwd(q.contiguous(), k.contiguous(),
                                  v.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert torch.equal(_bits(got[1]), _bits(want[1]))


def test_flash_kernel_rejects_what_it_cannot_take(cuda_device):
    q, k, v = _flash_inputs(cuda_device, torch.float32, 1, 8, 8, 2, 2, 64)
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(*(t[..., :32].contiguous() for t in (q, k, v)))
    wide = torch.zeros((1, 8, 2, 128), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous last dim"):
        fa.flash_attention(wide[..., ::2], k, v)
    with pytest.raises(ValueError, match="must be on"):
        fa.flash_attention(q, k.cpu(), v)


def test_flash_function_grads_on_card(cuda_device):
    """The Function's recompute backward from the kernel's (o, lse) against
    autograd of the plain forward, f32 (1e-4: the kernel's lse differs from
    the plain one by <= 2e-5, which each probability carries)."""
    q, k, v = (t.requires_grad_() for t in _flash_inputs(
        cuda_device, torch.float32, 2, 72, 72, 4, 2, 64, seed=1))
    do = torch.randn_like(q)
    got = torch.autograd.grad(fa.flash_attention(q, k, v, window=24),
                              (q, k, v), do)
    want = torch.autograd.grad(
        fa.flash_attention_fwd_plain(q, k, v, window=24)[0], (q, k, v), do)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 1e-4


def test_model_runs_flash_once_a_layer_and_twice_under_remat(cuda_device):
    """olmo-1b-smoke f32: a forward launches the kernel once a layer; a
    training forward + backward under remat="block" twice (the block's
    recompute); logits and grads equal the CPU's within 1e-4 (grads
    relative to their largest element)."""
    cfg = dataclasses.replace(get_config("olmo-1b-smoke"), remat="block")
    params = init_params(cfg, 0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32))
    leaves, treedef = tree_flatten(params)
    out = {}
    for dev in ("cpu", cuda_device):
        mine = [t.detach().to(dev).requires_grad_() for t in leaves]
        n0 = fa.flash_attention.launches
        logits = Model(cfg).forward(tree_unflatten(treedef, mine),
                                    {"tokens": tokens.to(dev)})[0]
        fwd = fa.flash_attention.launches - n0
        logits.square().mean().backward()
        if dev != "cpu":
            torch.cuda.synchronize()
            assert fwd == cfg.num_layers
            assert fa.flash_attention.launches - n0 == 2 * cfg.num_layers
        out[str(dev)] = (logits.detach().cpu(), [t.grad.cpu() for t in mine])
    (lc, gc), (lg, gg) = out["cpu"], out[str(cuda_device)]
    assert (lc - lg).abs().max().item() <= 1e-4
    for a, b in zip(gc, gg):
        assert (a - b).abs().max().item() <= 1e-4 * max(1.0, a.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _FLASH_CASES[:3], ids=str)
def test_flash_op_equals_the_forward_bits(cuda_device, dtype, case):
    """The dispatcher op ``repro_torch::flash_fwd`` gives the bits of
    ``flash_attention_fwd`` (one launch a call)."""
    hd, b, sq, skv, h, kv, causal, window, start = case
    q, k, v = _flash_inputs(cuda_device, dtype, b, sq, skv, h, kv, hd)
    st = None if start is None else torch.tensor(start, dtype=torch.int32,
                                                  device=cuda_device)
    n0 = fa.flash_attention.launches
    o, lse = fa.flash_fwd(q, k, v, st, causal, window)
    wo, wl = fa.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                    start=st)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 2
    assert torch.equal(_bits(o), _bits(wo)) and torch.equal(_bits(lse),
                                                             _bits(wl))


def test_remat_dots_keeps_the_flash_output(cuda_device):
    """olmo-1b-smoke f32 forward + backward: remat="dots" launches the
    kernel once a layer (the selective checkpoint keeps the op's (o,
    lse)), "block" twice, "none" once; the three give the same grads
    within 1e-5."""
    grads = {}
    for remat, per_layer in (("none", 1), ("block", 2), ("dots", 1)):
        cfg = dataclasses.replace(get_config("olmo-1b-smoke"), remat=remat)
        params = init_params(cfg, 0, device=cuda_device)
        leaves, treedef = tree_flatten(params)
        leaves = [t.detach().requires_grad_() for t in leaves]
        tokens = torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (2, 64)).astype(np.int32)).to(cuda_device)
        n0 = fa.flash_attention.launches
        logits = Model(cfg).forward(tree_unflatten(treedef, leaves),
                                    {"tokens": tokens})[0]
        grads[remat] = torch.autograd.grad(logits.square().mean(), leaves)
        torch.cuda.synchronize()
        assert fa.flash_attention.launches - n0 == \
            per_layer * cfg.num_layers, remat
    for a, b, c in zip(grads["none"], grads["block"], grads["dots"]):
        assert (a - b).abs().max().item() <= 1e-5 * max(1.0, a.abs().max())
        assert (a - c).abs().max().item() <= 1e-5 * max(1.0, a.abs().max())


@pytest.fixture
def nccl_rank(cuda_device, tmp_path):
    """A one-rank data group: NCCL for CUDA tensors, gloo for CPU ones."""
    import torch.distributed as dist
    dist.init_process_group("cpu:gloo,cuda:nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield cuda_device
    dist.destroy_process_group()


def test_p2p_on_one_nccl_rank(nccl_rank):
    """The mixed group runs CUDA tensors on NCCL, so the window ops take
    them: a perm of one rank is a local copy, and a get counts one
    issue."""
    from repro_torch.core.collectives import CommRuntime, _cuda_backend
    from repro_torch.core.comm import CommWorld
    assert _cuda_backend(None) == "nccl"
    rt = CommRuntime(CommWorld(num_vcis=4))
    x = torch.arange(6.0, device=nccl_rank)
    assert torch.equal(rt.sendrecv(x, rt.world.create("c"), perm=[(0, 0)]),
                       x)
    w = rt.world.create("w", kind="rma")
    got = rt.get(x, w, perm=[(0, 0)])
    rt.flush(w)
    assert torch.equal(got.value, x) and rt.engine.issued == 2


@pytest.mark.parametrize("optimizer,schedule", [
    ("zero1", "post"), ("replicated", "overlap"), ("zero1", "overlap")])
def test_zero1_and_overlap_steps_on_card_equal_cpu(nccl_rank, optimizer,
                                                   schedule):
    """3 olmo-1b-smoke f32 steps (pack="pallas", accum 2 under overlap) on
    a one-rank NCCL group against the same step on the CPU: loss and grad
    norm within 1e-5, params within 1e-4 + 2e-5 rel (the card's kernels
    and matmuls sum in other orders); the ZeRO-1 post step launches the
    pack kernel once a bucket, the overlap step none, and the overlap
    hooks issue every bucket inside the backward in ready order."""
    from repro_torch.core import get_comm_plan
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.train.trainer import make_train_step, train_state_init
    cfg = get_config("olmo-1b-smoke")
    params = init_params(cfg, 0, device="cpu")
    accum = 2 if schedule == "overlap" else 1
    knobs = dict(comm="vci", pack="pallas", num_streams=4, num_vcis=4,
                 optimizer=optimizer, schedule=schedule, accum_steps=accum)
    runs = {}
    for dev in ("cpu", nccl_rank):
        state = train_state_init(
            cfg, params=tree_map(lambda t: t.clone().to(dev), params),
            optimizer=optimizer, num_streams=4, pack="pallas",
            schedule=schedule)
        step = make_train_step(cfg, **knobs)
        metrics = []
        n0 = bucket_pack.bucket_pack.launches
        for i in range(3):
            state, m = step(state, synthetic_batch(cfg, 4, 64, seed=i))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        if dev != "cpu":
            cp = get_comm_plan(state.params, num_streams=4, num_vcis=4,
                               pack="pallas", schedule=schedule)
            packs = bucket_pack.bucket_pack.launches - n0
            if schedule == "post":
                assert packs == 3 * cp.plan.num_buckets
            else:
                assert packs == 0
                issue = step.last_issue
                assert issue["order"] == cp.ready_order
                assert issue["in_backward"] == cp.plan.num_buckets
        runs[str(dev)] = (metrics, [t.cpu() for t in
                                    tree_flatten(state.params)[0]])
    (mc, pc), (mg, pg) = runs["cpu"], runs[str(nccl_rank)]
    np.testing.assert_allclose(mg, mc, rtol=1e-5)
    for a, b in zip(pc, pg):
        assert bool(((a - b).abs() <= 1e-4 + 2e-5 * a.abs()).all())


# ---------------------------------------------------------------------------
# the MoE row gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("t,m,d", [(4, 32, 6144), (64, 256, 6144),
                                   (7, 3, 8), (300, 1000, 256)])
def test_row_gather_kernel_matches_plain(cuda_device, dtype, t, m, d):
    """Bit-equal to the plain version, incl. empty rows and ids past T-1
    (clamped to the last row), and one launch counted per call."""
    gen = torch.Generator(device=cuda_device).manual_seed(t + m)
    src = torch.randn((t, d), generator=gen, device=cuda_device).to(dtype)
    idx = torch.randint(-2, t + 2, (m,), generator=gen, device=cuda_device,
                        dtype=torch.int32)
    n0 = moe_gather.row_gather.launches
    got = moe_gather.row_gather(src, idx)
    torch.cuda.synchronize()
    assert moe_gather.row_gather.launches == n0 + 1
    want = moe_gather.row_gather_plain(src, idx)
    assert got.shape == want.shape == (m, d)
    assert torch.equal(_bits(got), _bits(want))
    none = moe_gather.row_gather(src, torch.full((m,), -1, dtype=torch.int32,
                                                 device=cuda_device))
    assert torch.equal(_bits(none), torch.zeros_like(_bits(none)))


def _routing(dev, groups, tokens, experts, top_k, cf, seed, crowd=False):
    """``dispatch_tables`` of random top-k routing (``crowd``: every token
    to the same experts, so most of them are dropped)."""
    from repro_torch.models.moe import capacity, dispatch_tables
    gen = torch.Generator(device=dev).manual_seed(seed)
    eidx = torch.rand((groups, tokens, experts), generator=gen,
                      device=dev).argsort(-1)[..., :top_k]
    if crowd:
        eidx = torch.arange(top_k, device=dev).expand(groups, tokens, top_k)
    cap = min(capacity(tokens, experts, cf, top_k), tokens)
    return dispatch_tables(eidx, experts, cap)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("top_k", [1, 2])
def test_row_gather_inv_matches_plain(cuda_device, monkeypatch, dtype, cf,
                                      top_k):
    """The read-once route (``inv`` = ``comb``; forced: the wrapper takes it
    only for large tables) at a dropping capacity is bit-equal to the plain
    gather, one launch a call."""
    monkeypatch.setattr(moe_gather, "_READ_ONCE_MIN_BYTES", 0)
    d = 6144 if dtype == torch.bfloat16 else 256
    groups, tokens = 4, 96
    disp, comb, _ = _routing(cuda_device, groups, tokens, 8, top_k, cf,
                             7)
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    src = torch.randn((groups * tokens, d), generator=gen,
                      device=cuda_device).to(dtype)
    n0 = moe_gather.row_gather.launches
    r0 = moe_gather.row_gather.read_once_launches
    got = moe_gather.row_gather(src, disp, comb)
    torch.cuda.synchronize()
    assert moe_gather.row_gather.launches == n0 + 1
    assert moe_gather.row_gather.read_once_launches == r0 + 1
    assert cf > 1 or int((comb < 0).sum()) > 0
    want = moe_gather.row_gather_plain(src, disp)
    assert torch.equal(_bits(got), _bits(want))


def test_row_gather_inv_fully_dropped_and_empty(cuda_device, monkeypatch):
    """Tokens whose every assignment was dropped are never read; a table
    with every slot empty gives zeros (the read-once route, forced)."""
    monkeypatch.setattr(moe_gather, "_READ_ONCE_MIN_BYTES", 0)
    disp, comb, _ = _routing(cuda_device, 2, 64, 8, 2, 0.5, 9, crowd=True)
    dropped = (comb.view(-1, 2) < 0).all(1)
    assert int(dropped.sum()) > 0
    src = torch.randn((128, 512), device=cuda_device).to(torch.bfloat16)
    got = moe_gather.row_gather(src, disp, comb)
    assert torch.equal(_bits(got),
                       _bits(moe_gather.row_gather_plain(src, disp)))
    empty = torch.full_like(disp, -1)
    none = moe_gather.row_gather(src, empty, torch.full_like(comb, -1))
    torch.cuda.synchronize()
    assert torch.equal(_bits(none), torch.zeros_like(_bits(none)))


def test_row_gather_inv_rejects_a_bad_table(cuda_device):
    src = torch.zeros((4, 8), device=cuda_device)
    idx = torch.zeros(3, dtype=torch.int32, device=cuda_device)
    inv = torch.full((8,), -1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError, match="inv must be int32"):
        moe_gather.row_gather(src, idx, inv.long())
    with pytest.raises(ValueError, match="length"):
        moe_gather.row_gather(src, idx, inv[:6])
    with pytest.raises(ValueError, match="inv must be on"):
        moe_gather.row_gather(src, idx, inv.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        moe_gather.row_gather(src, idx, inv.repeat(2)[::2])


def test_row_gather_kernel_rejects_what_it_cannot_take(cuda_device):
    src = torch.zeros((4, 8), device=cuda_device)
    idx = torch.zeros(3, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError, match="int32"):
        moe_gather.row_gather(src, idx.long())
    with pytest.raises(TypeError, match="takes"):
        moe_gather.row_gather(src.double(), idx)
    with pytest.raises(ValueError, match="CUDA device"):
        moe_gather.row_gather(src, idx.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        moe_gather.row_gather(torch.zeros((8, 4), device=cuda_device).T, idx)
    with pytest.raises(ValueError, match="16 bytes"):
        moe_gather.row_gather(torch.zeros((4, 3), device=cuda_device), idx)
    # a source that requires grad trains (once refused): the backward
    # without the inverse table raises, naming it
    out = moe_gather.row_gather(src.requires_grad_(), idx)
    with pytest.raises(NotImplementedError, match="inverse table"):
        out.sum().backward()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("t,d", [(300, 256), (64, 6144), (5, 8)])
def test_row_gather_sum_kernel_matches_plain(cuda_device, dtype, k, t, d):
    """The gather-sum kernel against ``row_gather_sum_plain``: bit for bit
    at K <= 2 (a sum of two in f32, rounded once), at K = 3 within two
    roundings of the row dtype relative to the terms' magnitudes (the two
    sum three terms in other orders); empty entries, ids past M-1 (clamped), rows
    with no entry (zero), one launch a call (K = 1: the gather kernel's)."""
    gen = torch.Generator(device=cuda_device).manual_seed(t + k)
    m = 2 * t + 3
    src = torch.randn((m, d), generator=gen, device=cuda_device).to(dtype)
    inv = torch.randint(-2, m + 2, (t * k,), generator=gen,
                        device=cuda_device, dtype=torch.int32)
    inv[:k] = -1                               # row 0 has no entry
    n0 = moe_gather.row_gather_sum.launches
    g0 = moe_gather.row_gather.launches
    got = moe_gather.row_gather_sum(src, inv, k)
    torch.cuda.synchronize()
    assert (moe_gather.row_gather_sum.launches - n0,
            moe_gather.row_gather.launches - g0) == \
        ((0, 1) if k == 1 else (1, 0))
    want = moe_gather.row_gather_sum_plain(src, inv, k)
    assert got.shape == want.shape == (t, d)
    assert torch.equal(_bits(got[0]), torch.zeros_like(_bits(got[0])))
    if k <= 2:
        assert torch.equal(_bits(got), _bits(want))
    else:
        ulp = {torch.float32: 2 ** -23, torch.bfloat16: 2 ** -8,
               torch.float16: 2 ** -10}[dtype]
        mag = moe_gather.row_gather_sum_plain(src.abs(), inv, k).float()
        assert bool(((got.float() - want.float()).abs()
                     <= 2 * ulp * mag).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_gather_grad_on_card_goes_through_the_kernels(cuda_device,
                                                          dtype):
    """``row_gather``'s backward on a CUDA tensor, given the dispatch's
    inverse (K = 2) or the combine's (K = 1), launches the gather-sum or
    the gather kernel and equals autograd of the plain gather bit for
    bit."""
    disp, comb, asg = _routing(cuda_device, 4, 96, 8, 2, 1.25, 11)
    d = 6144 if dtype == torch.bfloat16 else 256
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    x = torch.randn((4 * 96, d), generator=gen, device=cuda_device).to(dtype)
    for idx, inv, rows, kernel in ((disp, comb, 4 * 96, "row_gather_sum"),
                                   (comb, asg, disp.numel(), "row_gather")):
        src = x if rows == x.shape[0] else torch.randn(
            (rows, d), generator=gen, device=cuda_device).to(dtype)
        dy = torch.randn((idx.numel(), d), generator=gen,
                         device=cuda_device).to(dtype)
        a = src.clone().requires_grad_()
        out = moe_gather.row_gather(a, idx, inv)
        n0 = getattr(moe_gather, kernel).launches
        out.backward(dy)
        torch.cuda.synchronize()
        assert getattr(moe_gather, kernel).launches == n0 + 1
        b = src.clone().requires_grad_()
        moe_gather.row_gather_plain(b, idx).backward(dy)
        assert torch.equal(_bits(a.grad), _bits(b.grad))


def test_moe_train_step_on_card_equals_cpu(nccl_rank):
    """3 mixtral-8x22b-smoke f32 steps (pack="pallas", remat="block") on a
    one-rank NCCL group against the same step on the CPU: loss, grad norm,
    load balance and router z within 1e-5, params within 1e-4 + 2e-5 rel;
    the card's steps launch the row gather 5 times a layer a step (dispatch
    and combine, their remat recompute, the combine's backward) and the
    gather-sum once (the dispatch's backward)."""
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.train.trainer import make_train_step, train_state_init
    cfg = dataclasses.replace(_moe_smoke(), remat="block")
    params = init_params(cfg, 0, device="cpu")
    knobs = dict(comm="vci", pack="pallas", num_streams=4, num_vcis=4)
    runs = {}
    for dev in ("cpu", nccl_rank):
        state = train_state_init(cfg, params=tree_map(
            lambda t: t.clone().to(dev), params))
        step = make_train_step(cfg, **knobs)
        metrics = []
        n0 = moe_gather.row_gather.launches
        s0 = moe_gather.row_gather_sum.launches
        for i in range(3):
            state, m = step(state, synthetic_batch(cfg, 4, 32, seed=i))
            metrics.append([float(m[k]) for k in ("loss", "grad_norm",
                                                  "load_balance",
                                                  "router_z")])
        if dev != "cpu":
            assert moe_gather.row_gather.launches - n0 == \
                3 * 5 * cfg.num_layers
            assert moe_gather.row_gather_sum.launches - s0 == \
                3 * cfg.num_layers
        runs[str(dev)] = (metrics, [t.cpu() for t in
                                    tree_flatten(state.params)[0]])
    (mc, pc), (mg, pg) = runs["cpu"], runs[str(nccl_rank)]
    assert np.isfinite(mg).all()
    np.testing.assert_allclose(mg, mc, rtol=1e-5)
    for a, b in zip(pc, pg):
        assert bool(((a - b).abs() <= 1e-4 + 2e-5 * a.abs()).all())


def _moe_smoke():
    return get_config("mixtral-8x22b-smoke")


def test_moe_forward_launches_row_gather_twice_a_layer(cuda_device):
    """mixtral-8x22b-smoke f32: a forward (prefill into a cache) launches
    the kernel twice a layer (dispatch and combine), a decode step too;
    logits and aux equal the CPU's within 1e-4."""
    cfg = _moe_smoke()
    params = init_params(cfg, 0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (3, 12)).astype(np.int32))
    start = torch.tensor([0, 4, 11], dtype=torch.int32)
    out = {}
    with torch.inference_mode():
        for dev in ("cpu", cuda_device):
            p = tree_map(lambda t: t.to(dev), params)
            cache = init_cache(cfg, 3, 32, dtype=torch.float32, device=dev)
            n0 = moe_gather.row_gather.launches
            logits, aux, cache = Model(cfg).forward(
                p, {"tokens": tokens.to(dev)}, cache=cache,
                start=start.to(dev))
            nxt = logits[:, -1:].argmax(-1).to(torch.int32)
            step, cache = Model(cfg).decode_step(p, nxt, cache,
                                                 start=start.to(dev))
            if dev != "cpu":
                torch.cuda.synchronize()
                assert moe_gather.row_gather.launches - n0 == \
                    2 * 2 * cfg.num_layers
            out[str(dev)] = (logits.cpu(), step.cpu(),
                             {k: v.cpu() for k, v in aux.items()})
    (lc, sc, ac), (lg, sg, ag) = out["cpu"], out[str(cuda_device)]
    assert (lc - lg).abs().max().item() <= 1e-4
    assert (sc - sg).abs().max().item() <= 1e-4
    for k in ac:
        assert abs(float(ac[k]) - float(ag[k])) <= 1e-5 * abs(float(ac[k]))


def test_moe_engine_paged_equals_contiguous_on_card(cuda_device):
    """mixtral-8x22b-smoke on the card: paged tokens equal contiguous
    tokens (slots recycled), every forward call through the kernel."""
    cfg = _moe_smoke()
    params = init_params(cfg, 0, device=cuda_device)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32)
               for n in (5, 9, 4, 7, 6)]
    toks = {}
    for paged in (True, False):
        eng = ServeEngine(cfg, params, batch_size=2, max_len=64,
                          device=cuda_device, paged=paged, page_size=8,
                          num_pages=13)
        moe_gather.row_gather.launches = 0
        reqs = eng.generate([Request(prompt=p, max_new_tokens=6)
                             for p in prompts])
        assert moe_gather.row_gather.launches > 2 * cfg.num_layers * \
            eng.decode_steps
        toks[paged] = [r.generated.tolist() for r in reqs]
    assert toks[True] == toks[False]


def test_moe_layer_issues_no_host_sync(cuda_device):
    """The routing tables are built on the card: ``moe_ffn`` at decode and
    prefill shapes never waits for the device (torch's sync debug mode
    raises on any op that would)."""
    from repro_torch.models.moe import moe_ffn
    cfg = _moe_smoke()
    params = init_params(cfg, 0, device=cuda_device)
    p = tree_map(lambda t: t[0], params["layers"]["moe"])
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    xs = [torch.randn((4, s, cfg.d_model), generator=gen, device=cuda_device)
          for s in (1, 20)]
    with torch.inference_mode():
        moe_ffn(cfg, xs[0], p, inference=True)   # builds and loads the kernel
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for x in xs:
                moe_ffn(cfg, x, p, inference=True)
        finally:
            torch.cuda.set_sync_debug_mode(0)


# ---------------------------------------------------------------------------
# the SSD intra-chunk kernel (mamba2)
# ---------------------------------------------------------------------------

def _ssd_inputs(dev, dtype, b, s, h, p, g, n, chunk, seed=0):
    """x/B/C ~ N(0,1) in ``dtype``; dt in the softplus range; cum the
    per-chunk cumsum of dt*A with A in [-16, -1] (f32)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=gen, device=dev).to(dtype)
    dt = 1e-3 + 0.099 * torch.rand((b, s, h), generator=gen, device=dev)
    A = -1.0 - 15.0 * torch.rand((h,), generator=gen, device=dev)
    cum = (dt * A).reshape(b, s // chunk, chunk, h).cumsum(2).reshape(b, s, h)
    B = torch.randn((b, s, g, n), generator=gen, device=dev).to(dtype)
    C = torch.randn((b, s, g, n), generator=gen, device=dev).to(dtype)
    return x, dt, cum, B, C


def _ssd_close(got, want):
    """max |got - want| <= 2e-5 * max(1, max |want|): the same f32
    products, summed in another order (TF32 off)."""
    tol = 2e-5 * max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    assert err <= tol, (err, tol)


# b, s, h, p, g, n, chunk
_SSD_CASES = [
    (2, 512, 4, 64, 1, 128, 256),   # the mamba2-780m widths, 2 chunks
    (1, 64, 6, 32, 2, 16, 32),      # smoke widths, 3 heads a group
    (1, 200, 3, 24, 3, 40, 100),    # ragged: chunk, p and n off the tiles
    (1, 128, 2, 128, 1, 256, 128),  # the largest p and n it takes
    (1, 512, 48, 64, 1, 128, 256),  # mamba2-780m: 48 heads share C B^T
    # the bf16 path's rule takes heads that do not divide a group (on a
    # 132-SM H100): zamba2's n = 64 with g 2, sets of 2 and 1 of 3 heads;
    # 5 heads a group, sets of 4 and 1
    (2, 4096, 6, 64, 2, 64, 256),
    (4, 4096, 5, 64, 1, 128, 256),
    (4, 256, 48, 64, 1, 128, 256),  # one chunk (the second serve call)
    # C and the three B key tiles outgrow an x stage (n well above p)
    (1, 256, 2, 64, 1, 256, 256),
    (1, 256, 2, 32, 1, 128, 256),
    # zamba2-7b: 112 heads on one group at n 64 (its serve prefill, and a
    # one-chunk batch of one)
    (4, 1024, 112, 64, 1, 64, 256),
    (1, 256, 112, 64, 1, 64, 256),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _SSD_CASES, ids=str)
def test_ssd_kernel_matches_plain(cuda_device, dtype, case):
    torch.backends.cuda.matmul.allow_tf32 = False
    b, s, h, p, g, n, chunk = case
    args = _ssd_inputs(cuda_device, dtype, b, s, h, p, g, n, chunk)
    n0 = ssd_scan.ssd_chunk.launches
    y, st = ssd_scan.ssd_chunk(*args, chunk)
    y2, st2 = ssd_scan.ssd_chunk(*args, chunk)
    torch.cuda.synchronize()
    assert ssd_scan.ssd_chunk.launches == n0 + 2
    assert torch.equal(_bits(y), _bits(y2)) and torch.equal(_bits(st),
                                                            _bits(st2))
    wy, wst = ssd_scan.ssd_chunk_plain(*args, chunk)
    assert y.shape == wy.shape and st.shape == wst.shape
    assert bool(torch.isfinite(y).all() and torch.isfinite(st).all())
    _ssd_close(y, wy)
    _ssd_close(st, wst)


def test_ssd_kernel_takes_strided_views(cuda_device):
    """x, B and C as views of one (b, s, channels) tensor, as the model
    passes them (no copy); dt and cum transposed views."""
    b, s, h, p, g, n, chunk = 2, 128, 4, 32, 2, 16, 64
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    xbc = torch.randn((b, s, h * p + 2 * g * n), generator=gen,
                      device=cuda_device)
    x = xbc[..., : h * p].reshape(b, s, h, p)
    B = xbc[..., h * p: h * p + g * n].reshape(b, s, g, n)
    C = xbc[..., h * p + g * n:].reshape(b, s, g, n)
    dt = (1e-3 + 0.099 * torch.rand((b, h, s), generator=gen,
                                    device=cuda_device)).transpose(1, 2)
    cum = (-dt).reshape(b, s // chunk, chunk, h).cumsum(2).reshape(b, s, h)
    cum = cum.transpose(1, 2).contiguous().transpose(1, 2)
    assert not (x.is_contiguous() or dt.is_contiguous()
                or cum.is_contiguous())
    y, st = ssd_scan.ssd_chunk(x, dt, cum, B, C, chunk)
    wy, wst = ssd_scan.ssd_chunk_plain(x, dt, cum, B, C, chunk)
    _ssd_close(y, wy)
    _ssd_close(st, wst)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_takes_unaligned_views(cuda_device, dtype):
    """x, B and C as views at an odd element offset of one (b, s, channels)
    tensor with an odd channel count: no base or row is 16-byte aligned, so
    the tensor-core path loads them a scalar at a time."""
    b, s, h, p, g, n, chunk = 2, 320, 4, 40, 2, 24, 160
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    width = 1 + h * p + 2 * g * n + 1
    xbc = torch.randn((b, s, width), generator=gen,
                      device=cuda_device).to(dtype)
    x = xbc[..., 1: 1 + h * p].reshape(b, s, h, p)
    B = xbc[..., 1 + h * p: 1 + h * p + g * n].reshape(b, s, g, n)
    C = xbc[..., 1 + h * p + g * n: -1].reshape(b, s, g, n)
    dt = 1e-3 + 0.099 * torch.rand((b, s, h), generator=gen,
                                   device=cuda_device)
    A = -1.0 - 15.0 * torch.rand((h,), generator=gen, device=cuda_device)
    cum = (dt * A).reshape(b, s // chunk, chunk, h).cumsum(2).reshape(b, s, h)
    assert x.data_ptr() % 16 and x.stride(1) % 8
    y, st = ssd_scan.ssd_chunk(x, dt, cum, B, C, chunk)
    y2, st2 = ssd_scan.ssd_chunk(x, dt, cum, B, C, chunk)
    torch.cuda.synchronize()
    assert torch.equal(_bits(y), _bits(y2)) and torch.equal(_bits(st),
                                                            _bits(st2))
    wy, wst = ssd_scan.ssd_chunk_plain(x, dt, cum, B, C, chunk)
    _ssd_close(y, wy)
    _ssd_close(st, wst)


def test_ssd_kernel_rejects_what_it_cannot_take(cuda_device):
    x, dt, cum, B, C = _ssd_inputs(cuda_device, torch.float32, 1, 64, 2, 8,
                                   1, 8, 32)
    with pytest.raises(ValueError, match="must be on"):
        ssd_scan.ssd_chunk(x, dt.cpu(), cum, B, C, 32)
    with pytest.raises(ValueError, match="dy"):    # the backward's input
        ssd_scan.ssd_chunk_bwd(x, dt, cum, B, C, x.double(), None, 32)
    with pytest.raises(TypeError, match="one dtype"):
        ssd_scan.ssd_chunk(x.half(), dt, cum, B.half(), C.half(), 32)
    with pytest.raises(TypeError, match="one dtype"):
        ssd_scan.ssd_chunk(x, dt, cum, B.bfloat16(), C, 32)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_scan.ssd_chunk(x, dt, cum, B, C, 48)


# the SSD backward kernel: b, s, h, p, g, n, chunk
_SSD_BWD_CASES = [
    (2, 512, 4, 64, 1, 128, 256),   # the mamba2-780m widths, 2 chunks
    (1, 512, 8, 64, 2, 64, 256),    # g 2 at zamba2's n 64
    (2, 96, 6, 32, 2, 16, 32),      # smoke widths, chunk 32, 3 heads a group
    (1, 256, 2, 128, 1, 128, 256),  # the largest p and n it takes
    (1, 200, 3, 24, 3, 40, 100),    # ragged: chunk, p and n off the tiles
    (1, 1024, 112, 64, 1, 64, 256),  # zamba2-7b: 112 heads on one group
]


def _ssd_grads(dev, b, s, h, p, n, chunk, seed=1, dst=True):
    """Output gradients: dy (b,s,h,p) and dst (b,nc,h,n,p) ~ N(0,1), f32."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    dy = torch.randn((b, s, h, p), generator=gen, device=dev)
    ds = torch.randn((b, s // chunk, h, n, p), generator=gen, device=dev)
    return dy, ds if dst else None


def _ssd_bwd_close(got, want):
    """f32 outputs within 2e-5 x max(1, max|want|) of the plain version run
    in f32 on the same inputs; bf16 outputs within one bf16 ulp of that f32
    result plus the same term (the kernel rounds its f32 sum once)."""
    tol = 2e-5 * max(1.0, want.abs().max().item())
    err = (got.float() - want).abs()
    if got.dtype == torch.bfloat16:
        _, e = torch.frexp(want)
        err = err - torch.ldexp(torch.ones_like(want), e - 8)
    assert err.max().item() <= tol, (got.dtype, err.max().item(), tol)


def _ssd_bwd_check(x, dt, cum, B, C, dy, dst, chunk):
    """Two launches (equal bits, counted once each), finite outputs of the
    inputs' dtypes and shapes, each within :func:`_ssd_bwd_close` of
    ``ssd_chunk_bwd_plain`` on the f32 upcast inputs."""
    n0 = ssd_scan.ssd_chunk_bwd.launches
    got = ssd_scan.ssd_chunk_bwd(x, dt, cum, B, C, dy, dst, chunk)
    again = ssd_scan.ssd_chunk_bwd(x, dt, cum, B, C, dy, dst, chunk)
    torch.cuda.synchronize()
    assert ssd_scan.ssd_chunk_bwd.launches == n0 + 2
    want = ssd_scan.ssd_chunk_bwd_plain(x.float(), dt, cum, B.float(),
                                        C.float(), dy, dst, chunk)
    for g, g2, w, t in zip(got, again, want, (x, dt, cum, B, C)):
        assert g.shape == t.shape and g.dtype == t.dtype
        assert torch.equal(_bits(g), _bits(g2))
        assert bool(torch.isfinite(g).all())
        _ssd_bwd_close(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _SSD_BWD_CASES, ids=str)
def test_ssd_bwd_kernel_matches_plain(cuda_device, dtype, case):
    torch.backends.cuda.matmul.allow_tf32 = False
    b, s, h, p, g, n, chunk = case
    args = _ssd_inputs(cuda_device, dtype, b, s, h, p, g, n, chunk)
    _ssd_bwd_check(*args, *_ssd_grads(cuda_device, b, s, h, p, n, chunk),
                   chunk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_bwd_kernel_takes_strided_views_and_no_dst(cuda_device, dtype):
    """x, B and C as views of one (b, s, channels) tensor, as the model
    passes them; dt, cum and dy transposed views; dst ``None`` (one chunk
    reaches only the unused final state)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    b, s, h, p, g, n, chunk = 2, 256, 4, 64, 1, 128, 256
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    xbc = torch.randn((b, s, h * p + 2 * g * n), generator=gen,
                      device=cuda_device).to(dtype)
    x = xbc[..., : h * p].reshape(b, s, h, p)
    B = xbc[..., h * p: h * p + g * n].reshape(b, s, g, n)
    C = xbc[..., h * p + g * n:].reshape(b, s, g, n)
    dt = (1e-3 + 0.099 * torch.rand((b, h, s), generator=gen,
                                    device=cuda_device)).transpose(1, 2)
    A = -1.0 - 15.0 * torch.rand((h,), generator=gen, device=cuda_device)
    cum = (dt * A).reshape(b, s // chunk, chunk, h).cumsum(2).reshape(b, s, h)
    cum = cum.transpose(1, 2).contiguous().transpose(1, 2)
    dy = torch.randn((b, h, s, p), generator=gen,
                     device=cuda_device).transpose(1, 2)
    assert not (x.is_contiguous() or dt.is_contiguous()
                or dy.is_contiguous())
    _ssd_bwd_check(x, dt, cum, B, C, dy, None, chunk)


def test_ssd_bwd_kernel_masks_before_exp(cuda_device):
    """One chunk of 256 rows, dt 0.1, A = -linspace(1, 16, 4): above the
    diagonal cum_i - cum_j reaches 408, where exp overflows in f32; the
    kernel's gradients are finite and equal the plain version's."""
    b, s, h, p, g, n, chunk = 1, 256, 4, 64, 1, 128, 256
    x, _, _, B, C = _ssd_inputs(cuda_device, torch.float32, b, s, h, p, g, n,
                                chunk)
    dt = torch.full((b, s, h), 0.1, device=cuda_device)
    A = -torch.linspace(1.0, 16.0, h, device=cuda_device)
    cum = (dt * A).cumsum(1)
    _ssd_bwd_check(x, dt, cum, B, C,
                   *_ssd_grads(cuda_device, b, s, h, p, n, chunk), chunk)


def test_ssd_op_backward_launches_the_kernel_once(cuda_device, monkeypatch):
    """The op's autograd on CUDA tensors: one forward and one backward
    launch a call, the plain versions never run, and the gradients equal
    the same op's on the CPU (the plain forward and backward)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    b, s, h, p, g, n, chunk = 2, 512, 4, 64, 2, 64, 256
    args = _ssd_inputs(cuda_device, torch.float32, b, s, h, p, g, n, chunk)
    dy, dst = _ssd_grads(cuda_device, b, s, h, p, n, chunk)
    grads = {}
    for dev in ("cpu", cuda_device):
        ins = [t.detach().to(dev).requires_grad_() for t in args]
        if dev != "cpu":
            def refuse(*a, **kw):
                raise AssertionError("a plain version ran on the card")
            monkeypatch.setattr(ssd_scan, "ssd_chunk_plain", refuse)
            monkeypatch.setattr(ssd_scan, "ssd_chunk_bwd_plain", refuse)
            n0 = (ssd_scan.ssd_chunk.launches,
                  ssd_scan.ssd_chunk_bwd.launches)
        y, st = ssd_scan.ssd_chunk(*ins, chunk)
        torch.autograd.backward((y, st), (dy.to(dev), dst.to(dev)))
        if dev != "cpu":
            torch.cuda.synchronize()
            assert (ssd_scan.ssd_chunk.launches - n0[0],
                    ssd_scan.ssd_chunk_bwd.launches - n0[1]) == (1, 1)
        grads[str(dev)] = [t.grad.cpu() for t in ins]
    for a, w in zip(grads[str(cuda_device)], grads["cpu"]):
        _ssd_bwd_close(a, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [12, 24])
def test_ssd_kernels_at_a_model_ranks_heads(cuda_device, dtype, heads):
    """A tensor-parallel Mamba2 block's scan on one model rank: mamba2-780m
    splits its 48 heads of 64 over model 4 (12) and 2 (24). The rank's
    heads are cut out of the gathered conv output as the block cuts them
    (x a contiguous copy of rank 1's channels, B and C views of the
    whole), then the forward and the backward run against their plain
    versions; in bf16 the backward takes the tensor-core route."""
    torch.backends.cuda.matmul.allow_tf32 = False
    b, s, p, g, n, chunk, whole, r = 2, 512, 64, 1, 128, 256, 48, 1
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    xbc = torch.randn((b, s, whole * p + 2 * g * n), generator=gen,
                      device=cuda_device).to(dtype)
    x = xbc[..., r * heads * p:(r + 1) * heads * p].contiguous().reshape(
        b, s, heads, p)
    B = xbc[..., whole * p:whole * p + g * n].reshape(b, s, g, n)
    C = xbc[..., whole * p + g * n:].reshape(b, s, g, n)
    dt = 1e-3 + 0.099 * torch.rand((b, s, heads), generator=gen,
                                   device=cuda_device)
    A = -1.0 - 15.0 * torch.rand((heads,), generator=gen, device=cuda_device)
    cum = (dt * A).reshape(b, s // chunk, chunk, heads).cumsum(2).reshape(
        b, s, heads)
    n0 = ssd_scan.ssd_chunk.launches
    y, st = ssd_scan.ssd_chunk(x, dt, cum, B, C, chunk)
    torch.cuda.synchronize()
    assert ssd_scan.ssd_chunk.launches == n0 + 1
    wy, wst = ssd_scan.ssd_chunk_plain(x, dt, cum, B, C, chunk)
    _ssd_close(y, wy)
    _ssd_close(st, wst)
    dy, dst = _ssd_grads(cuda_device, b, s, heads, p, n, chunk)
    want = "tc" if dtype == torch.bfloat16 else "ffma"
    assert ssd_scan.bwd_route(x, B, C, dy, dst, chunk) == want
    tc0 = ssd_scan.ssd_chunk_bwd.tc_launches
    _ssd_bwd_check(x, dt, cum, B, C, dy, dst, chunk)
    assert ssd_scan.ssd_chunk_bwd.tc_launches - tc0 == \
        (2 if want == "tc" else 0)


def test_ssd_bwd_kernel_rejects_what_it_cannot_take(cuda_device):
    x, dt, cum, B, C = _ssd_inputs(cuda_device, torch.float32, 1, 64, 2, 8,
                                   1, 200, 32)
    dy, dst = _ssd_grads(cuda_device, 1, 64, 2, 8, 200, 32)
    with pytest.raises(ValueError, match="d_state <= 128"):
        ssd_scan.ssd_chunk_bwd(x, dt, cum, B, C, dy, dst, 32)
    x, dt, cum, B, C = _ssd_inputs(cuda_device, torch.float32, 1, 64, 2, 8,
                                   1, 8, 32)
    dy, dst = _ssd_grads(cuda_device, 1, 64, 2, 8, 8, 32)
    with pytest.raises(ValueError, match="dst"):
        ssd_scan.ssd_chunk_bwd(x, dt, cum, B, C, dy, dst[:, :1], 32)
    with pytest.raises(ValueError, match="dy"):
        ssd_scan.ssd_chunk_bwd(x, dt, cum, B, C, dy.cpu(), dst, 32)


# the backward's tensor-core route: b, s, h, p, g, n, chunk
_SSD_BWD_TC_CASES = [
    (1, 512, 48, 64, 1, 128, 256),  # mamba2-780m training widths, batch 1
    (1, 512, 112, 64, 1, 64, 256),  # zamba2-7b training widths, batch 1
    (1, 512, 8, 64, 2, 64, 256),    # g 2
    (2, 96, 6, 32, 2, 16, 32),      # the smoke archs' chunk 32, n 16
    (1, 192, 4, 64, 1, 128, 96),    # chunk 96: a ragged second tile
    (1, 200, 3, 24, 3, 40, 100),    # ragged chunk, p and n off the tiles
    (2, 256, 30, 64, 1, 128, 256),  # head sets that do not divide a group
]


def _ssd_bwd_tc_check(x, dt, cum, B, C, dy, dst, chunk):
    """:func:`_ssd_bwd_check` on the tensor-core route, which both launches
    take (counted in ``tc_launches``)."""
    assert ssd_scan.bwd_route(x, B, C, dy, dst, chunk) == "tc"
    n0 = ssd_scan.ssd_chunk_bwd.tc_launches
    _ssd_bwd_check(x, dt, cum, B, C, dy, dst, chunk)
    assert ssd_scan.ssd_chunk_bwd.tc_launches == n0 + 2


@pytest.mark.parametrize("hpb", [None, 7, 24])
@pytest.mark.parametrize("case", _SSD_BWD_TC_CASES, ids=str)
def test_ssd_bwd_tc_route_matches_plain(cuda_device, monkeypatch, case, hpb):
    """``hpb`` heads a block (None: the rule, which takes one head a block
    at these small grids; 7 leaves a smaller last set; 24 the most)."""
    b, s, h, p, g, n, chunk = case
    if hpb is not None:
        monkeypatch.setattr(ssd_scan, "tc_heads_per_block",
                            lambda *a: hpb)
    args = _ssd_inputs(cuda_device, torch.bfloat16, b, s, h, p, g, n, chunk)
    _ssd_bwd_tc_check(*args, *_ssd_grads(cuda_device, b, s, h, p, n, chunk),
                      chunk)


def test_ssd_bwd_tc_route_takes_strided_views_and_no_dst(cuda_device):
    """bf16 x, B and C as views of one (b, s, channels) tensor, as the
    model passes them; dt, cum and dy transposed views; dst ``None``."""
    b, s, h, p, g, n, chunk = 2, 512, 4, 64, 1, 128, 256
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    xbc = torch.randn((b, s, h * p + 2 * g * n), generator=gen,
                      device=cuda_device).bfloat16()
    x = xbc[..., : h * p].reshape(b, s, h, p)
    B = xbc[..., h * p: h * p + g * n].reshape(b, s, g, n)
    C = xbc[..., h * p + g * n:].reshape(b, s, g, n)
    dt = (1e-3 + 0.099 * torch.rand((b, h, s), generator=gen,
                                    device=cuda_device)).transpose(1, 2)
    A = -1.0 - 15.0 * torch.rand((h,), generator=gen, device=cuda_device)
    cum = (dt * A).reshape(b, s // chunk, chunk, h).cumsum(2).reshape(b, s, h)
    cum = cum.transpose(1, 2).contiguous().transpose(1, 2)
    dy = torch.randn((b, h, s, p), generator=gen,
                     device=cuda_device).transpose(1, 2)
    assert not (x.is_contiguous() or dt.is_contiguous()
                or dy.is_contiguous())
    _ssd_bwd_tc_check(x, dt, cum, B, C, dy, None, chunk)


def test_ssd_bwd_tc_route_masks_before_exp(cuda_device):
    """bf16, one chunk of 256 rows, dt 0.1, A = -linspace(1, 16, 4): above
    the diagonal cum_i - cum_j reaches 408, where exp overflows in f32."""
    b, s, h, p, g, n, chunk = 1, 256, 4, 64, 1, 128, 256
    x, _, _, B, C = _ssd_inputs(cuda_device, torch.bfloat16, b, s, h, p, g,
                                n, chunk)
    dt = torch.full((b, s, h), 0.1, device=cuda_device)
    A = -torch.linspace(1.0, 16.0, h, device=cuda_device)
    cum = (dt * A).cumsum(1)
    _ssd_bwd_tc_check(x, dt, cum, B, C,
                      *_ssd_grads(cuda_device, b, s, h, p, n, chunk), chunk)


def test_ssd_bwd_routes_agree_and_the_ffma_route_is_forced(cuda_device):
    """``route="ffma"`` takes the FFMA kernel for inputs the tensor cores
    take (chip_smoke times both); both are within the tolerance of plain,
    and an unknown route is refused."""
    b, s, h, p, g, n, chunk = 1, 512, 8, 64, 1, 128, 256
    args = _ssd_inputs(cuda_device, torch.bfloat16, b, s, h, p, g, n, chunk)
    grads = _ssd_grads(cuda_device, b, s, h, p, n, chunk)
    n0 = (ssd_scan.ssd_chunk_bwd.launches, ssd_scan.ssd_chunk_bwd.tc_launches)
    ffma = ssd_scan.ssd_chunk_bwd(*args, *grads, chunk, route="ffma")
    tc = ssd_scan.ssd_chunk_bwd(*args, *grads, chunk)
    assert (ssd_scan.ssd_chunk_bwd.launches - n0[0],
            ssd_scan.ssd_chunk_bwd.tc_launches - n0[1]) == (2, 1)
    x, dt, cum, B, C = args
    want = ssd_scan.ssd_chunk_bwd_plain(x.float(), dt, cum, B.float(),
                                        C.float(), *grads, chunk)
    for f, t, w in zip(ffma, tc, want):
        _ssd_bwd_close(f, w)
        _ssd_bwd_close(t, w)
    with pytest.raises(ValueError, match="unknown route"):
        ssd_scan.ssd_chunk_bwd(*args, *grads, chunk, route="tc")


@pytest.mark.parametrize("p,route", [(64, "tc"), (128, "ffma")])
def test_ssd_op_takes_f32_C_beside_bf16_x(cuda_device, p, route):
    """The model's call: bf16 x and B, C as the f32 copy of bf16 values.
    The forward equals the bf16-C op's bits; the backward (on either route:
    head_dim 128 takes FFMA) returns dC in f32, within 2e-5 x max(1,
    max|plain|) of the plain version (no bf16 rounding), and dx, dB, ddt
    and dcum equal the bf16-C op's."""
    b, s, h, g, n, chunk = 2, 512, 8, 1, 128, 256
    x, dt, cum, B, C = _ssd_inputs(cuda_device, torch.bfloat16, b, s, h, p,
                                   g, n, chunk)
    dy, dst = _ssd_grads(cuda_device, b, s, h, p, n, chunk)
    assert ssd_scan.bwd_route(x, B, C, dy, dst, chunk) == route
    outs, grads = {}, {}
    for name, c in (("bf16", C), ("f32", C.float())):
        ins = [t.detach().clone().requires_grad_() for t in (x, dt, cum, B)]
        ins.append(c.detach().clone().requires_grad_())
        n0 = ssd_scan.ssd_chunk_bwd.tc_launches
        outs[name] = ssd_scan.ssd_chunk(*ins, chunk)
        torch.autograd.backward(outs[name], (dy, dst))
        torch.cuda.synchronize()
        assert ssd_scan.ssd_chunk_bwd.tc_launches == n0 + (route == "tc")
        grads[name] = [t.grad for t in ins]
    for a, w in zip(outs["f32"], outs["bf16"]):
        assert torch.equal(a, w)
    dC = grads["f32"][4]
    assert dC.dtype == torch.float32 and grads["bf16"][4].dtype == \
        torch.bfloat16
    for a, w in zip(grads["f32"][:4], grads["bf16"][:4]):
        assert torch.equal(_bits(a), _bits(w))
    want = ssd_scan.ssd_chunk_bwd_plain(x.float(), dt, cum, B.float(),
                                        C.float(), dy, dst, chunk)[4]
    _ssd_bwd_close(dC, want)


def test_bf16_ssm_grads_through_the_tc_route_equal_plain(cuda_device,
                                                         monkeypatch):
    """One bf16 mamba2-780m-smoke forward and backward (the smoke archs are
    f32, so nothing else runs the tensor-core route inside a model): the
    parameter gradients with the backward on the tensor cores (once a
    layer) against the same step with the backward monkeypatched to the
    plain version: each within 2e-5 x max(1, max|plain|) plus one bf16 ulp
    of the plain's value."""
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.train.losses import total_loss
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("mamba2-780m-smoke"),
                              dtype="bfloat16", param_dtype="bfloat16")
    params = tree_map(lambda t: t.to(cuda_device),
                      init_params(cfg, 0, device="cpu"))
    batch = {k: torch.from_numpy(v).to(cuda_device) for k, v in
             synthetic_batch(cfg, 4, 96, seed=0).items()}
    leaves, treedef = tree_flatten(params)

    def grads():
        ls = [t.detach().requires_grad_() for t in leaves]
        logits, aux, _ = Model(cfg).forward(tree_unflatten(treedef, ls),
                                            batch)
        loss, _ = total_loss(cfg, logits, batch["labels"], aux)
        return torch.autograd.grad(loss, ls)

    n0 = ssd_scan.ssd_chunk_bwd.tc_launches
    got = grads()
    torch.cuda.synchronize()
    assert ssd_scan.ssd_chunk_bwd.tc_launches - n0 == cfg.num_layers
    plain = ssd_scan.ssd_chunk_bwd_plain
    monkeypatch.setattr(ssd_scan, "ssd_chunk_bwd",
                        lambda *a, **kw: plain(*a, **kw))
    want = grads()
    for g_, w in zip(got, want):
        assert g_.dtype == w.dtype and bool(torch.isfinite(g_).all())
        _ssd_bwd_close(g_, w.float())


@pytest.mark.parametrize("arch,layers,seq", [("mamba2-780m-smoke", None, 96),
                                             ("zamba2-7b-smoke", 3, 96)])
def test_ssm_train_step_on_card_equals_cpu(nccl_rank, arch, layers, seq):
    """3 f32 steps (pack="pallas", remat="block") on a one-rank NCCL group
    against the same step on the CPU: loss and grad norm within 1e-5,
    params within 1e-4 + 2e-5 rel; the card's steps launch the SSD forward
    twice a layer a step (the forward and remat's recompute) and its
    backward once."""
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.train.trainer import make_train_step, train_state_init
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, remat="block",
                              num_layers=layers or cfg.num_layers)
    params = init_params(cfg, 0, device="cpu")
    knobs = dict(comm="vci", pack="pallas", num_streams=4, num_vcis=4)
    runs = {}
    for dev in ("cpu", nccl_rank):
        state = train_state_init(cfg, params=tree_map(
            lambda t: t.clone().to(dev), params))
        step = make_train_step(cfg, **knobs)
        metrics = []
        n0 = (ssd_scan.ssd_chunk.launches, ssd_scan.ssd_chunk_bwd.launches)
        for i in range(3):
            state, m = step(state, synthetic_batch(cfg, 4, seq, seed=i))
            metrics.append([float(m[k]) for k in ("loss", "grad_norm")])
        if dev != "cpu":
            assert (ssd_scan.ssd_chunk.launches - n0[0],
                    ssd_scan.ssd_chunk_bwd.launches - n0[1]) == (
                3 * 2 * cfg.num_layers, 3 * cfg.num_layers)
        runs[str(dev)] = (metrics, [t.cpu() for t in
                                    tree_flatten(state.params)[0]])
    (mc, pc), (mg, pg) = runs["cpu"], runs[str(nccl_rank)]
    assert np.isfinite(mg).all()
    np.testing.assert_allclose(mg, mc, rtol=1e-5)
    for a, b in zip(pc, pg):
        assert bool(((a - b).abs() <= 1e-4 + 2e-5 * a.abs()).all())


def test_ssm_model_runs_the_kernel_once_a_layer(cuda_device):
    """mamba2-780m-smoke f32: a prefill into a cache (40 tokens: padded,
    two chunks) launches the kernel once a layer, a decode step not at all;
    logits equal the CPU's within 1e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("mamba2-780m-smoke")
    params = init_params(cfg, 0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (3, 40)).astype(np.int32))
    out = {}
    with torch.inference_mode():
        for dev in ("cpu", cuda_device):
            p = tree_map(lambda t: t.to(dev), params)
            cache = init_cache(cfg, 3, 64, dtype=torch.float32, device=dev)
            n0 = ssd_scan.ssd_chunk.launches
            logits, _, cache = Model(cfg).forward(
                p, {"tokens": tokens.to(dev)}, cache=cache)
            if dev != "cpu":
                torch.cuda.synchronize()
                assert ssd_scan.ssd_chunk.launches - n0 == cfg.num_layers
            nxt = logits[:, -1:].argmax(-1).to(torch.int32)
            n0 = ssd_scan.ssd_chunk.launches
            step, cache = Model(cfg).decode_step(p, nxt, cache)
            assert ssd_scan.ssd_chunk.launches == n0
            out[str(dev)] = (logits.cpu(), step.cpu())
    (lc, sc), (lg, sg) = out["cpu"], out[str(cuda_device)]
    assert (lc - lg).abs().max().item() <= 1e-4
    assert (sc - sg).abs().max().item() <= 1e-4


def test_ssm_engine_on_card_equals_cpu(cuda_device):
    """mamba2-780m-smoke f32 through the grouped engine on the card and on
    the CPU: identical greedy tokens; one kernel launch a layer a group."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("mamba2-780m-smoke")
    params = init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32)
               for n in (5, 40, 5, 9)]
    toks = {}
    for dev in ("cpu", cuda_device):
        eng = ServeEngine(cfg, tree_map(lambda t: t.to(dev), params),
                          batch_size=2, max_len=64, device=dev, paged=True)
        assert not eng._paged
        n0 = ssd_scan.ssd_chunk.launches
        reqs = eng.generate([Request(prompt=p, max_new_tokens=6)
                             for p in prompts])
        if dev != "cpu":
            assert ssd_scan.ssd_chunk.launches - n0 == 3 * cfg.num_layers
        toks[str(dev)] = [r.generated.tolist() for r in reqs]
    assert toks["cpu"] == toks[str(cuda_device)]


@pytest.mark.parametrize("arch,layers,s,max_len,lens,new", [
    ("mixtral-8x22b-smoke", None, 80, 160, (80, 40, 80), 32),  # ring of 64
    ("zamba2-7b-smoke", 5, 40, 96, (40, 9, 40, 5), 16),        # hybrid
    ("phi-3-vision-4.2b-smoke", None, 40, 64, (), 0),          # no engine
    ("musicgen-large-smoke", None, 40, 64, (24, 9, 24, 5), 6),
])
def test_ring_and_hybrid_engines_on_card_equal_cpu(cuda_device, arch, layers,
                                                   s, max_len, lens, new):
    """f32 on the card and on the CPU: a prefill of ``s`` positions (the
    VLM's 16 patches + 24 text tokens, the audio's 40 frames of 4
    codebooks) + 8 greedy decode steps, logits within 1e-4 and identical
    tokens, one flash launch a site (and one SSD launch a hybrid layer) in
    the card's prefill; then the grouped engine (which refuses a VLM):
    identical greedy tokens and cache bytes; the ring's 80-token prompts
    roll at prefill and every group decodes past the window; the hybrid at
    5 layers runs two groups, their shared attention sites and a remainder
    layer."""
    from repro_torch.data.pipeline import synthetic_batch
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    params = init_params(cfg, 0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(
        cfg, 2, s, seed=9).items() if k != "labels"}
    rng = np.random.default_rng(8)
    lead = (cfg.num_codebooks,) if cfg.modality == "audio" else ()
    prompts = [rng.integers(0, cfg.vocab_size, lead + (n,), dtype=np.int32)
               for n in lens]
    sites = (cfg.num_layers // cfg.hybrid_attn_every
             if cfg.family == "hybrid" else cfg.num_layers)
    ssd = cfg.num_layers if cfg.family == "hybrid" else 0
    groups = sum(-(-lens.count(n) // 2) for n in set(lens))   # batch 2
    out = {}
    for dev in ("cpu", cuda_device):
        p = tree_map(lambda t: t.to(dev), params)
        cache = init_cache(cfg, 2, max_len, dtype=torch.float32, device=dev)
        n0 = (fa.flash_attention.launches, ssd_scan.ssd_chunk.launches)
        with torch.inference_mode():
            lg, _, cache = Model(cfg).forward(
                p, {k: v.to(dev) for k, v in batch.items()}, cache=cache)
            if dev != "cpu":
                torch.cuda.synchronize()
                assert (fa.flash_attention.launches - n0[0],
                        ssd_scan.ssd_chunk.launches - n0[1]) == (sites, ssd)
            logits, toks = [lg[..., -1:, :].cpu()], []
            for _ in range(8):
                toks.append(logits[-1].argmax(-1).to(torch.int32))
                lg, cache = Model(cfg).decode_step(p, toks[-1].to(dev), cache)
                logits.append(lg.cpu())
        engine = None
        if prompts:
            eng = ServeEngine(cfg, p, batch_size=2, max_len=max_len,
                              device=dev, paged=True)
            assert not eng._paged
            n0 = (fa.flash_attention.launches, ssd_scan.ssd_chunk.launches)
            reqs = eng.generate([Request(prompt=q, max_new_tokens=new)
                                 for q in prompts])
            if dev != "cpu":
                torch.cuda.synchronize()
                assert (fa.flash_attention.launches - n0[0],
                        ssd_scan.ssd_chunk.launches - n0[1]) == (
                    sites * groups, ssd * groups)
            engine = ([r.generated.tolist() for r in reqs],
                      eng.cache_bytes_resident)
        out[str(dev)] = (logits, toks, engine)
    (lc, tc, ec), (lg, tg, eg) = out["cpu"], out[str(cuda_device)]
    for a, c in zip(lc, lg):
        assert (a - c).abs().max().item() <= 1e-4
    assert all(torch.equal(a, c) for a, c in zip(tc, tg))
    assert ec == eg


# two ranks sharing the one card (the layout of chip_smoke's phase 7):
# the launcher's backend choice; gloo takes all_reduce,
# all_gather_into_tensor and the list all_gather of CUDA tensors in every
# dtype the serve path moves (a refusal raises and fails the test), and
# the ZeRO-1 path's reduce_scatter on a VCI group, while the port refuses
# the window path's send/recv of CUDA tensors on gloo; then a psum and a tiled all-gather of CUDA tensors on VCI streams
# along the model axis
_SHARED_CARD = r"""
import os, sys, torch, torch.distributed as dist
from repro_torch.core.collectives import RankMesh
from repro_torch.launch.serve import join_ranks
from repro_torch.serve.comm import ServeCommPlan

def rank_main(rank, store, out):
    dev, backend, why = join_ranks(rank, 2, "cuda", store)
    n = 2
    for dt in (torch.float32, torch.bfloat16, torch.int32):
        x = torch.full((4,), rank + 1, dtype=dt, device=dev)
        dist.all_reduce(x)
        assert x.is_cuda and torch.equal(
            x.cpu(), torch.full((4,), n * (n + 1) // 2, dtype=dt)), (dt, x)
        want = torch.arange(1, n + 1, dtype=dt).repeat_interleave(4)
        y = torch.full((4,), rank + 1, dtype=dt, device=dev)
        out_t = torch.empty(4 * n, dtype=dt, device=dev)
        dist.all_gather_into_tensor(out_t, y)
        assert out_t.is_cuda and torch.equal(out_t.cpu(), want), (dt, out_t)
        outs = [torch.empty(4, dtype=dt, device=dev) for _ in range(n)]
        dist.all_gather(outs, y)
        assert torch.equal(torch.cat(outs).cpu(), want), (dt, outs)
    # the ZeRO-1 and window paths: reduce_scatter_tensor, and the
    # point-to-point batch (send/recv) of CUDA tensors on a VCI group
    from repro_torch.core.collectives import CommRuntime
    from repro_torch.core.comm import CommWorld
    rt = CommRuntime(CommWorld(num_vcis=4))
    ctx = rt.world.create("z1")
    for dt in (torch.float32, torch.bfloat16):
        x = torch.arange(8, dtype=dt, device=dev) * (rank + 1)
        got = rt.wait(rt.reduce_scatter(x, ctx))
        assert got.is_cuda and torch.equal(
            got.cpu(), (torch.arange(8, dtype=dt) * 3)[rank * 4:][:4]), got
    # gloo's TCP pairs write a CUDA tensor's device pointer and abort the
    # rank: the port refuses point-to-point CUDA sends on gloo (no host
    # staging)
    x = torch.ones(5, device=dev)
    try:
        rt.sendrecv(x, ctx, perm=[(0, 1), (1, 0)])
        raise AssertionError("gloo p2p of a CUDA tensor was not refused")
    except RuntimeError as e:
        assert "point to point" in str(e), e
    mesh = RankMesh(1, 2)
    plan = ServeCommPlan(num_vcis=8)
    plan.create_groups(mesh)
    comm = plan.comm(mesh=mesh)
    want = torch.tensor([1.0, 1.0, 2.0, 2.0]).repeat(3, 1)
    x = torch.full((3, 5), float(rank + 1), device=dev, dtype=torch.bfloat16)
    g = comm.all_gather(x[:, :2].contiguous(), "sample", gather_axis=1)
    s = comm.psum(x, "tp_attn")
    assert s.is_cuda and torch.equal(s.cpu(), torch.full(
        (3, 5), 3.0, dtype=torch.bfloat16)), s
    assert g.is_cuda and torch.equal(g.float().cpu(), want), g
    if rank == 0:
        with open(out, "w") as f:
            f.write(f"{backend}|{why}")
    dist.barrier()
    dist.destroy_process_group()

if __name__ == "__main__":
    torch.multiprocessing.start_processes(
        rank_main, args=(sys.argv[1], sys.argv[2]), nprocs=2,
        start_method="spawn")
"""


def test_shared_card_ranks_take_gloo_cuda_collectives(cuda_device, tmp_path):
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES=str(
        torch.cuda.current_device()))
    env["PYTHONPATH"] = os.path.join(repo, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    script = tmp_path / "ranks.py"
    script.write_text(_SHARED_CARD)
    r = subprocess.run([sys.executable, str(script), str(tmp_path / "store"),
                        str(tmp_path / "out")], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    backend, why = (tmp_path / "out").read_text().split("|")
    assert backend == "gloo" and "share" in why, why
