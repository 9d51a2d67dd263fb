"""The training CLI's ``--overlap`` on two CPU ranks with ``--accum 2``:
the post schedule's loss and grad norm lines, for both optimizers.
"""

import subprocess
import sys

import pytest

from _torch_cpu import cli_env  # one intra-op thread: see its docstring


def _cli(*extra):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
           "cpu", "--arch", "olmo-1b-smoke", "--steps", "2", "--batch", "8",
           "--seq", "32", "--mesh", "2", "--comm", "vci", "--pack", "pallas",
           "--num-streams", "4", "--accum", "2", "--log-every", "1", *extra]
    env = cli_env()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=240,
                       env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    return [ln.split()[:6] for ln in r.stdout.splitlines()
            if ln.startswith("step ")]


@pytest.mark.parametrize("optimizer", ["replicated", "zero1"])
def test_cli_overlap_prints_the_post_lines(optimizer):
    """``--overlap`` on 2 CPU ranks with ``--accum 2`` prints the post
    schedule's loss and grad norm lines, for both optimizers."""
    post = _cli("--optimizer", optimizer)
    assert len(post) == 2
    assert _cli("--optimizer", optimizer, "--overlap") == post
