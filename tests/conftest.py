"""Shared test configuration.

NOTE: XLA_FLAGS / host-device-count is deliberately NOT set here — smoke
tests and benchmarks must see the single real CPU device. Multi-device
checks run in subprocesses (tests/_multidev_checks.py) that set the flag
themselves before importing jax.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")

# The one multi-device topology every subprocess-based test pins: 8 virtual
# host devices (the production-ablation mesh size that all EXPERIMENTS.md
# numbers quote). Benchmarks and _multidev_checks both inherit it through
# the fixtures below.
MULTIDEV_DEVICES = 8


def multidev_env(devices: int = MULTIDEV_DEVICES) -> dict:
    """Environment pinning XLA_FLAGS to N virtual host devices + PYTHONPATH."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


def run_multidev(script: str, *args: str, devices: int = MULTIDEV_DEVICES,
                 timeout: int = 900) -> subprocess.CompletedProcess:
    """Run a helper script in a subprocess with N virtual host devices."""
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "tests", script), *args],
        capture_output=True, text=True, timeout=timeout,
        env=multidev_env(devices))


@pytest.fixture(scope="session")
def multidev():
    return run_multidev


@pytest.fixture(scope="session")
def xla_multidev_env():
    """The pinned 8-device XLA_FLAGS environment, for subprocess tests that
    launch their own commands (e.g. benchmark smoke runs)."""
    return multidev_env()


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers",
        "multidev: runs a subprocess check on the 8-virtual-device CPU mesh "
        "(tests/_multidev_checks.py via the multidev fixture); part of the "
        "default tier-1 run — select with -m multidev, skip with "
        "-m 'not multidev'")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (a hand-written kernel of repro_torch has no "
        "CPU mode); skips without one — run on the GPU with -m cuda")
