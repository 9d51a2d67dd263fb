"""What the port's SSM tests share (``tests/test_torch_ssm.py`` and
``tests/test_torch_ssm_ssd.py``): the tolerances and the array helpers.
"""

import numpy as np
import torch

import _torch_cpu  # noqa: F401  (one intra-op thread: see its docstring)

ATOL = 1e-5      # one SSD scan or one Mamba2 block in f32
ATOL_MODEL = 1e-4


def tensor(a):
    return torch.from_numpy(np.array(a))


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=atol)
