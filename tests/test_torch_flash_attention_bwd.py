"""The flash-attention backward's dispatch without a card: the op
``repro_torch::flash_bwd`` on the CPU and on meta tensors, the argument
checks of its CUDA kernel, and the dry-run's meta training step through
the op's fake. The kernel itself is held against the plain backward in
``tests/test_torch_cuda_flash_bwd.py`` (on the card); the plain backward
against ``jax.vjp`` in ``tests/test_torch_flash_attention_op.py``.
"""

import pytest
import torch

import _torch_cpu  # noqa: F401  (one intra-op thread: see its docstring)
from _torch_flash import model_layout, qkv
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import dryrun, report


def _refuse(*a, **kw):
    raise AssertionError("the plain backward ran")


def test_cpu_backward_is_the_plain_one_and_launches_nothing():
    """On CPU tensors the op and :func:`flash_attention_bwd` return the
    plain backward's tensors and count no launch."""
    q, k, v = (model_layout(x) for x in qkv(20, 2, 6, 2, 16, 16, 64))
    o, lse = fa.flash_attention_fwd_plain(q, k, v, window=5)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(0))
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, window=5)
    n0 = fa.flash_attention_bwd.launches
    for got in (fa.flash_attention_bwd(q, k, v, o, lse, do, window=5),
                fa.flash_bwd(q, k, v, o, lse, do, True, 5)):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert fa.flash_attention_bwd.launches == n0


def test_meta_backward_takes_the_fake(monkeypatch):
    """A meta tensor's backward goes through the op's registered fake:
    gradients of the inputs' shapes and dtypes, no arithmetic, and never
    the plain backward; the function itself refuses the device."""
    monkeypatch.setattr(fa, "flash_attention_bwd_plain", _refuse)
    q = torch.empty(2, 16, 8, 128, device="meta", dtype=torch.bfloat16)
    k, v = (torch.empty(2, 16, 1, 128, device="meta", dtype=torch.bfloat16)
            for _ in range(2))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o = fa.flash_attention(q, k, v, window=4)
    grads = torch.autograd.grad(o, (q, k, v), torch.empty_like(o))
    for g, t in zip(grads, (q, k, v)):
        assert (g.device.type, g.shape, g.dtype) == ("meta", t.shape,
                                                     t.dtype)
    lse = torch.empty(2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention_bwd(q.detach(), k.detach(), v.detach(),
                               o.detach(), lse, o.detach())


def test_backward_argument_checks():
    """What the backward kernel refuses: o/dO in another dtype or shape, a
    head dim it has no build for, a strided last dim, a misshapen or
    non-f32 lse, a non-contiguous o; and ``start``, on any device."""
    q, k, v = (model_layout(x) for x in qkv(21, 1, 4, 2, 8, 8, 64))
    o, lse = fa.flash_fwd(q, k, v, None, True, None)   # o contiguous
    do = torch.ones_like(q)
    fa._check_bwd_args(q, k, v, o, lse, do, None)          # accepted
    with pytest.raises(TypeError, match="o must be in q's dtype"):
        fa._check_bwd_args(q, k, v, o.bfloat16(), lse, do, None)
    with pytest.raises(TypeError, match="do must be in q's dtype"):
        fa._check_bwd_args(q, k, v, o, lse, do.double(), None)
    with pytest.raises(ValueError, match="head_dim"):
        cut = [t[..., :32].contiguous() for t in (q, k, v, o, do)]
        fa._check_bwd_args(*cut[:4], lse, cut[4], None)
    wide = torch.zeros(*q.shape[:3], 128)
    with pytest.raises(ValueError, match="contiguous last dim"):
        fa._check_bwd_args(q, k, v, wide[..., ::2], lse, do, None)
    with pytest.raises(ValueError, match="contiguous last dim"):
        fa._check_bwd_args(q, k, v, o, lse, wide[..., ::2], None)
    with pytest.raises(ValueError, match="contiguous and 16-byte"):
        fa._check_bwd_args(q, k, v, o.transpose(1, 2).contiguous()
                           .transpose(1, 2), lse, do, None)
    with pytest.raises(ValueError, match="lse must be"):
        fa._check_bwd_args(q, k, v, o, lse[:, :, :4], do, None)
    with pytest.raises(ValueError, match="lse must be"):
        fa._check_bwd_args(q, k, v, o, lse.double(), do, None)
    with pytest.raises(ValueError, match="do must have q's shape"):
        fa._check_bwd_args(q, k, v, o, lse, do[:, :4], None)
    with pytest.raises(ValueError, match="must be on"):
        fa._check_bwd_args(q, k, v, o, lse.to("meta"), do, None)
    with pytest.raises(ValueError, match="start"):
        fa.flash_attention_bwd(q, k, v, o, lse, do,
                               start=torch.zeros(1, dtype=torch.int32))


def test_dryrun_meta_train_step_runs_through_the_fake(tmp_path, capsys,
                                                      monkeypatch):
    """The dry-run's meta-device training step of an attention arch still
    runs with the backward op: the flash backward takes its fake, and no
    plain attention runs on the meta tensors."""
    monkeypatch.setattr(fa, "flash_attention_bwd_plain", _refuse)
    monkeypatch.setattr(fa, "flash_attention_fwd_plain", _refuse)
    out = tmp_path / "rows"
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "olmo-1b", "--shape", "train_4k", "--out",
                     str(out)])
    assert done.value.code == 0
    assert "done; failures=0" in capsys.readouterr().out
    (row,) = report.load(str(out))
    assert row["status"] == "ok" and row["shape"] == "train_4k"
