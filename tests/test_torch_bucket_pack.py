"""The port's bucket pack/unpack kernel module against the JAX reference.

On the CPU the wrappers run the plain versions, which must equal the
Pallas kernel (interpret mode), the scalar oracle and the vectorised
gather exactly: the op is a copy with a tail mask. The host tables must
equal the reference's. The CUDA kernel itself is held against the plain
version on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import subprocess
import sys

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.bucketing import CommPlan as JCommPlan
from repro.core.bucketing import plan_buckets as jplan_buckets
from repro.kernels import bucket_pack as jbp
from repro_torch.bridge import tensor_from_numpy
from repro_torch.kernels import bucket_pack as tbp

TILE = tbp.TILE

# the leaf shapes of tests/test_bucket_path.py::TestPallasKernels
SHAPES = [
    [(7,), (33,), (4, 5)],
    [(1,)],
    [(16,), (16,), (16,), (3, 3, 3)],
    [(100,), (2,), (50,)],
]


def _tree(shapes, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return {f"l{i}": rng.normal(size=s).astype(dtype)
            for i, s in enumerate(shapes)}


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _tbits(t: torch.Tensor) -> np.ndarray:
    return _bits(_np(t))


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("nb", [1, 2])
@pytest.mark.parametrize("shapes", SHAPES, ids=lambda s: str(len(s)))
def test_plain_pack_unpack_match_reference(shapes, nb, dtype):
    """Every bucket's pack, then the unpack of all buckets, bit for bit
    against bucket_pack_pallas(interpret=True), the oracle and the
    gather; and the round trip gives the arena back."""
    tree = _tree(shapes, dtype)
    jcp = JCommPlan(jplan_buckets(tree, nb, align=TILE, slot_align=TILE),
                    num_vcis=1)
    tile, offs, arena_size, pack_tables, unpack_table = jcp.tables
    leaves = [tree[k] for k in sorted(tree)]
    jarena, _ = jbp.arena_from_leaves([jnp.asarray(l) for l in leaves],
                                      tile=tile)
    tarena, toffs = tbp.arena_from_leaves(
        [tensor_from_numpy(l, "cpu") for l in leaves], tile=tile)
    np.testing.assert_array_equal(_tbits(tarena), _bits(jarena))
    np.testing.assert_array_equal(toffs, offs)

    packed = []
    for (blk, val), b in zip(pack_tables, jcp.plan.buckets):
        tb, tv = torch.from_numpy(blk), torch.from_numpy(val)
        got = tbp.bucket_pack(tarena, tb, tv, b.padded_size, tile=tile)
        for want in (
                jbp.bucket_pack_pallas(jarena, jnp.asarray(blk),
                                       jnp.asarray(val), b.padded_size,
                                       tile=tile, interpret=True),
                jbp.bucket_pack_ref(jarena, blk, val, b.padded_size, tile),
                jbp.bucket_pack_gather(jarena, blk, val, b.padded_size,
                                       tile)):
            np.testing.assert_array_equal(_tbits(got), _bits(want))
        packed.append(got)
    allp = torch.cat(packed)
    ub, uv = (torch.from_numpy(a) for a in unpack_table)
    got = tbp.bucket_unpack(allp, ub, uv, arena_size, tile=tile)
    want = jbp.bucket_unpack_pallas(
        jnp.asarray(_np(allp)), jnp.asarray(unpack_table[0]),
        jnp.asarray(unpack_table[1]), arena_size, tile=tile, interpret=True)
    np.testing.assert_array_equal(_tbits(got), _bits(want))
    np.testing.assert_array_equal(_tbits(got), _tbits(tarena))
    # the plain functions are what the wrappers ran
    np.testing.assert_array_equal(
        _tbits(tbp.bucket_unpack_plain(allp, ub, uv, arena_size, tile=tile)),
        _tbits(got))


def test_out_buffer_is_written():
    src = torch.arange(2 * TILE, dtype=torch.float32)
    blk = torch.tensor([1, 0], dtype=torch.int32)
    val = torch.tensor([5, 0], dtype=torch.int32)
    out = torch.full((3 * TILE,), -1.0)
    res = tbp.bucket_pack(src, blk, val, 2 * TILE, out=out[TILE:])
    assert res.data_ptr() == out[TILE:].data_ptr()
    assert torch.equal(out[:TILE], torch.full((TILE,), -1.0))
    assert torch.equal(out[TILE:TILE + 5], src[TILE:TILE + 5])
    assert not out[TILE + 5:].any()


@pytest.mark.parametrize("shapes", SHAPES + [[(3000,), (1,), (1025, 3)]],
                         ids=lambda s: str(len(s)))
def test_tables_and_arena_layout_equal_reference(shapes):
    """The vectorised build_tile_tables equals the reference's loop, on
    every plan of these trees (pack tables and the unpack table)."""
    tree = _tree(shapes, np.float32)
    for nb in (1, 2, 3):
        jcp = JCommPlan(jplan_buckets(tree, nb, align=TILE, slot_align=TILE),
                        num_vcis=1)
        _, offs, arena_size, pack_tables, unpack_table = jcp.tables
        sizes = [int(np.prod(s)) for s in (tree[k].shape
                                           for k in sorted(tree))]
        t_offs, t_size = tbp.arena_layout(sizes, TILE)
        np.testing.assert_array_equal(t_offs, offs)
        assert t_size == arena_size
        bases = np.cumsum([0] + [b.padded_size for b in jcp.plan.buckets])
        for b, (blk, val) in zip(jcp.plan.buckets, pack_tables):
            args = ([offs[s.index] for s in b.slots],
                    [s.offset for s in b.slots], [s.size for s in b.slots],
                    b.padded_size, TILE)
            for got, want in zip(tbp.build_tile_tables(*args), (blk, val)):
                assert got.dtype == want.dtype == np.int32
                np.testing.assert_array_equal(got, want)
        src, dst, szs = [], [], []
        for bi, b in enumerate(jcp.plan.buckets):
            for s in b.slots:
                src.append(int(bases[bi]) + s.offset)
                dst.append(int(offs[s.index]))
                szs.append(s.size)
        for got, want in zip(tbp.build_tile_tables(src, dst, szs,
                                                   arena_size, TILE),
                             unpack_table):
            np.testing.assert_array_equal(got, want)


def test_cpu_tensors_count_no_launch():
    tbp.bucket_pack.launches = tbp.bucket_unpack.launches = 0
    src = torch.ones(TILE)
    t = torch.zeros(1, dtype=torch.int32)
    tbp.bucket_pack(src, t, t + 3, TILE)
    tbp.bucket_unpack(src, t, t, TILE)
    assert tbp.bucket_pack.launches == 0
    assert tbp.bucket_unpack.launches == 0


def test_plain_rejects_unaligned_sizes():
    t = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiples of tile"):
        tbp.bucket_pack(torch.ones(TILE + 1), t, t, TILE)
    with pytest.raises(ValueError, match="multiple of tile"):
        tbp.build_tile_tables([0], [0], [3], TILE + 1)


def test_module_imports_without_nvcc():
    """Importing the module (and building tables) compiles nothing: the
    build happens only at a CUDA launch."""
    code = ("import os; os.environ['PATH'] = ''; "
            "os.environ.pop('CUDA_HOME', None); "
            "from repro_torch.kernels import bucket_pack as b; "
            "from repro_torch.kernels import _build; "
            "b.build_tile_tables([0], [0], [5], 1024); "
            "print(_build.load.cache_info().currsize)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "0"
