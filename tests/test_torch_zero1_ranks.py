"""The port's ZeRO-1 on spawned CPU ranks: 5 steps over 4 gloo ranks
against the replicated optimizer (``test_torch_ranks.py zero1``), with
the reference's ``check_zero1_matches_replicated`` tolerances (loss and
grad norm rtol 1e-5, params rtol 2e-5 / atol 1e-6), and the training
CLI's ``--optimizer zero1`` on two ranks. The flat-space units and the
one-rank step are ``tests/test_torch_zero1.py``'s.
"""

import subprocess
import sys

import numpy as np

from _torch_cpu import cli_env  # one intra-op thread: see its docstring
from _torch_train import held, write_rank_inputs
from repro_torch.configs import get_config
from repro_torch.core import bucketing as tbk
from repro_torch.tree import tree_flatten

from test_torch_ranks import run_ranks


def test_zero1_over_4_ranks_matches_replicated(tmp_path):
    """5 steps on gemma-2b-smoke over 4 gloo ranks: ZeRO-1 against the
    replicated optimizer (the analogue of ``check_zero1_matches_
    replicated``), and a rank's optimizer state 1/N of the replicated
    state's up to the buckets' padding."""
    n = 4
    write_rank_inputs(tmp_path, "gemma-2b-smoke", n, 5)
    r = run_ranks("zero1", tmp_path, n=n)
    assert r.returncode == 0, r.stdout + r.stderr
    out = np.load(tmp_path / "out_zero1.npz")
    assert held(out, "zero1/post/1", "replicated/post/1", "zero1") > 0
    cfg = get_config("gemma-2b-smoke")
    from repro_torch.models.transformer import init_params
    params = init_params(cfg, 0, device="cpu")
    plan = tbk.plan_buckets(params, 4, slot_align=tbk.TILE)
    full = sum(p.numel() for p in tree_flatten(params)[0])
    rep, z1 = int(out["replicated/post/1/opt_bytes"]), \
        int(out["zero1/post/1/opt_bytes"])
    # replicated: f32 m and v of every element (+ the int32 count); ZeRO-1:
    # f32 master, m and v of 1/N of the padded buckets, the padding less
    # than a tile a bucket
    assert rep == 8 * full + 4
    assert z1 == 12 * plan.total_padded // n + 4
    assert 0 <= plan.total_padded - full < plan.num_buckets * tbk.TILE


def _cli(*extra):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
           "cpu", "--arch", "olmo-1b-smoke", "--steps", "2", "--batch", "4",
           "--seq", "32", "--mesh", "2", "--comm", "vci", "--pack", "pallas",
           "--num-streams", "4", "--log-every", "1", *extra]
    env = cli_env()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=240,
                       env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    return [ln.split()[:6] for ln in r.stdout.splitlines()
            if ln.startswith("step ")]


def test_cli_zero1_on_two_cpu_ranks():
    """``--optimizer zero1`` with f32 wire prints the replicated run's
    loss and grad norm lines; with ``--zero1-wire bfloat16`` it trains
    (finite losses)."""
    rep = _cli()
    assert len(rep) == 2
    assert _cli("--optimizer", "zero1") == rep
    bf16 = _cli("--optimizer", "zero1", "--zero1-wire", "bfloat16")
    assert len(bf16) == 2 and all(np.isfinite(float(ln[3])) for ln in bf16)
