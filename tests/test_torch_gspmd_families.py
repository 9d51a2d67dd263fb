"""The port's ``comm="gspmd"`` train step (FSDP over the data ranks)
against the reference's single-device ``comm="gspmd"`` step on the whole
batch, the SSM, VLM (ranks holding different counts of ``PAD_LABEL``) and
audio cases: ``tests/_torch_gspmd.py`` (its module doc) holds the cases,
their reference and their worlds of 1, 2 and 4 spawned gloo ranks;
``tests/test_torch_gspmd.py`` holds the dense and MoE cases.
"""

import pytest

import _torch_cpu  # noqa: F401  (one intra-op thread: see its docstring)
from _torch_gspmd import check_slices, check_step, fixtures

CASES = ["mamba2", "phi3v", "musicgen"]
reference, ranks = fixtures(CASES)


@pytest.mark.parametrize("case", CASES)
def test_gspmd_step_matches_reference_gspmd_step(reference, ranks, case):
    """Metrics each step and params after two steps against the
    reference's single-device step on the global batch."""
    check_step(reference, ranks, case)


@pytest.mark.parametrize("case", CASES)
def test_gspmd_ranks_agree_and_hold_their_slices(ranks, case):
    """Every rank's metrics equal rank 0's (they are the global batch's);
    each rank holds its slice of the sliced leaves' params and moments and
    the whole replicated leaves, to the byte."""
    check_slices(ranks, case)
