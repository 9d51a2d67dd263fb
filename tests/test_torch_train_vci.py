"""The port's VCI train step against the JAX reference, the dense and
MoE archs: ``tests/_torch_train.py``'s ``STEP_CASES`` up to arctic (the
rest are in ``tests/test_torch_train_families.py``), held by that module's
rules.
"""

import pytest

from _torch_cpu import one_rank  # noqa: F401
from _torch_train import STEP_CASES, check_vci_step

CASES = STEP_CASES[:5]


@pytest.mark.parametrize("arch,seq,noise_rule,layers", CASES)
def test_vci_step_matches_reference_vci_step(one_rank, arch, seq,
                                             noise_rule, layers):
    """3 steps of the port's pack="pallas" VCI step on a one-rank group
    against the reference's on a one-device mesh: the MoE archs through the
    row gather's backward and the aux losses, the SSM and hybrid archs
    through the SSD step's backward, the VLM's labels over image + text,
    audio's loss over the K codebook heads."""
    check_vci_step(arch, seq, noise_rule, layers)
