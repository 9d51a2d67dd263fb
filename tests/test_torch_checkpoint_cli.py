"""The training CLI's checkpoints: it resumes from ``--ckpt-dir`` and
prints ``resumed from step N``; its loss lines after the resume equal an
uninterrupted run's.
"""

import os
import subprocess
import sys

from _torch_cpu import cli_env  # one intra-op thread: see its docstring
from repro_torch.checkpoint import latest_step

ARCH = "olmo-1b-smoke"


def _cli(*extra):
    env = cli_env()
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
           "cpu", "--arch", ARCH, "--batch", "4", "--seq", "32",
           "--log-every", "1", *extra]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                       env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def _loss_lines(out):
    return [ln.split()[:4] for ln in out.splitlines()
            if ln.startswith("step ")]


def test_cli_resumes_from_its_checkpoint_dir(tmp_path):
    """``--steps 4 --ckpt-every 2`` on 2 ranks, then ``--steps 6`` on one
    in the same directory: ``resumed from step 4``, and steps 5-6 print
    the loss lines of an uninterrupted 6-step run."""
    ck = str(tmp_path / "ck")
    first = _cli("--steps", "4", "--ckpt-every", "2", "--mesh", "2",
                 "--ckpt-dir", ck)
    assert f"checkpoint -> {ck}" in first
    assert latest_step(ck) == 4 and os.path.isdir(
        os.path.join(ck, "step_00000002"))
    second = _cli("--steps", "6", "--ckpt-dir", ck)
    assert "resumed from step 4" in second
    assert latest_step(ck) == 6
    full = _loss_lines(_cli("--steps", "6"))
    assert _loss_lines(first) == full[:4]
    assert _loss_lines(second) == full[4:]
