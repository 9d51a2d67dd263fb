"""The training CLI on a ``data x model`` mesh: ``--mesh 2x2`` spawns 4
CPU ranks in both comm modes.
"""

import subprocess
import sys

import pytest

from _torch_cpu import cli_env  # one intra-op thread: see its docstring


def _cli(*extra, timeout=300):
    env = cli_env()
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
           "cpu", "--arch", "olmo-1b-smoke", "--steps", "2", "--batch", "4",
           "--seq", "32", "--log-every", "1", *extra]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                       env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


@pytest.mark.parametrize("comm", ["gspmd", "vci"])
def test_cli_trains_on_a_2x2_mesh(comm):
    """``--mesh 2x2`` spawns 4 ranks as data 2 x model 2 in both modes; the
    loss lines are the one-rank run's (``tests/test_torch_gspmd.py``
    prints these for ``--mesh none`` and ``--mesh 2``)."""
    out = _cli("--mesh", "2x2", "--comm", comm)
    assert "devices=4 mesh=2x2" in out and f"comm={comm}" in out
    steps = [ln.split()[3] for ln in out.splitlines()
             if ln.startswith("step ")]
    assert steps == ["6.2922", "6.2704"], out
