"""Shared set-up of the port's CPU tests: importing this module pins
PyTorch to one intra-op thread and warms up ``torch.exp``. Every
``tests/test_torch_*.py`` imports it before it computes anything
(``tests/test_torch_hygiene.py`` checks that each one does).

One thread. The test run spreads the files over several worker processes
on one host (``pytest -n 6 --dist loadfile`` on 8 cores), and a worker's
PyTorch would otherwise start as many intra-op threads as the host has
cores: each worker's threads then compete with every other worker's, and a
step that takes 2 s alone took minutes. The tests' shapes are small, so one
thread costs them nothing alone. It also keeps a run's sums in one order
from run to run (a threaded backward of this CPU build sums some gradients,
the embedding's, in another order each time, so two runs of one step
differ in their last bits), which the bit-for-bit resume tests rely on.
The ranks a test spawns take their threads from their parent
(``repro_torch.launch.ranks.rank_threads``): one each. A test that runs a
CLI in a fresh process passes ``OMP_NUM_THREADS=1`` in its environment.
JAX's own thread pool is left as it is: the reference's tests run in the
same workers.

The ``exp`` warm-up. The first ``torch.exp`` of a process that runs on more
than one thread of PyTorch's CPU build (2.13.0+cpu, AVX512, MKL) sometimes
returns one thread's share of the elements wrong: contiguous float ``exp``
splits its work into blocks of 2,048 elements over the intra-op pool, and
in about one fresh process in five the elements of one such block come back
≈1.5e-4 off (relative), where the reference's ``exp`` and f64 numpy agree
to f32 rounding. Later calls are right, and no call is wrong with one
thread. In the SSD intra-chunk step's plain version this puts ≈120 of
``y``'s 4,096 elements ≈1e-4 off at the small test shapes; the chunk
states, which take a later ``exp``, stay right. The one call below runs
first, over every thread of the default pool, and only then is the pool
pinned to one thread, with which no call shows the fault.
"""

import os

import pytest
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cli_env() -> dict:
    """The environment of a port CLI or script that a test runs in a fresh
    process: the port's sources on ``PYTHONPATH``, and one intra-op thread
    (``OMP_NUM_THREADS=1``, PyTorch's standard variable), so the ranks it
    spawns take one each."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    return env


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A one-rank gloo data group in this process."""
    store = tmp_path_factory.mktemp("store") / "store"
    dist.init_process_group("gloo", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def warm_cpu_exp() -> None:
    """One ``torch.exp`` over enough elements for every thread of the
    intra-op pool (its result is discarded)."""
    torch.exp(torch.zeros(1 << 20))


warm_cpu_exp()
torch.set_num_threads(1)
