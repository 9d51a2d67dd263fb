"""The port's ``comm="gspmd"`` on spawned CPU ranks beside the train step:
the FSDP gather's backward on 2 and 4 gloo ranks, and the training CLI's
default comm (one rank, and FSDP over two spawned ranks).
"""

import subprocess
import sys

import numpy as np
import pytest

from _torch_cpu import cli_env  # one intra-op thread: see its docstring

from test_torch_ranks import run_ranks


@pytest.mark.parametrize("n", [2, 4])
def test_materialize_backward_equals_whole_leaf_autograd(tmp_path, n):
    """The reduce-scatter backward of the FSDP gather gives each rank its
    slice of autograd's gradient of the summed per-rank losses through the
    whole leaves."""
    r = run_ranks("gather_grad", tmp_path, n=n)
    assert r.returncode == 0, r.stdout + r.stderr
    for rank in range(n):
        assert float(np.load(tmp_path / f"gather_grad_r{rank}.npy")) < 2e-6


def _cli(*extra, timeout=300):
    env = cli_env()
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
           "cpu", "--arch", "olmo-1b-smoke", "--steps", "2", "--batch", "4",
           "--seq", "32", "--log-every", "1", *extra]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                       env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


@pytest.mark.parametrize("mesh", ["none", "2"])
def test_cli_trains_with_the_default_comm(mesh):
    """``--comm`` defaults to gspmd, as in the reference: one rank in this
    process, or FSDP over two spawned ranks; the two print the same loss
    lines."""
    out = _cli("--mesh", mesh)
    assert "comm=gspmd" in out
    steps = [ln.split()[:4] for ln in out.splitlines()
             if ln.startswith("step ")]
    assert len(steps) == 2 and all(np.isfinite(float(s[3])) for s in steps)
    assert [s[3] for s in steps] == ["6.2922", "6.2704"], out
