"""Shared set-up of the port's CPU conformance tests: importing this
module warms up ``torch.exp``.

The first ``torch.exp`` of a process that runs on more than one thread of
PyTorch's CPU build (2.13.0+cpu, AVX512, MKL) sometimes returns one
thread's share of the elements wrong: contiguous float ``exp`` splits its
work into blocks of 2,048 elements over the intra-op pool, and in about one
fresh process in five the elements of one such block come back ≈1.5e-4 off
(relative), where the reference's ``exp`` and f64 numpy agree to f32
rounding. Later calls are right, and no call is wrong with one thread
(``torch.set_num_threads(1)``). In the SSD intra-chunk step's plain version
this puts ≈120 of ``y``'s 4,096 elements ≈1e-4 off at the small test
shapes; the chunk states, which take a later ``exp``, stay right.

So every test module that holds ``exp``-based results of the port against
the reference (the SSD step and its backward, Mamba2 blocks, SSM and hybrid
models, partial attention) imports this module before it computes
anything: the one call below, over every thread of the pool, takes the
fault. A rank process that a test spawns imports it too.
"""

import torch


def warm_cpu_exp() -> None:
    """One ``torch.exp`` over enough elements for every thread of the
    intra-op pool (its result is discarded)."""
    torch.exp(torch.zeros(1 << 20))


warm_cpu_exp()
