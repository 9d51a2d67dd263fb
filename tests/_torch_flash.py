"""What the port's flash-attention tests share
(``tests/test_torch_flash_attention.py`` and
``tests/test_torch_flash_attention_op.py``): seeded inputs in the
reference's layout and the conversions between the layouts.
"""

import numpy as np
import torch

import _torch_cpu  # noqa: F401  (one intra-op thread: see its docstring)


def qkv(seed, b, h, kv, sq, sk, hd):
    """numpy f32 q (B,H,Sq,hd), k/v (B,KV,Skv,hd): the reference layout."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, sq, hd)).astype(np.float32),
            rng.normal(size=(b, kv, sk, hd)).astype(np.float32),
            rng.normal(size=(b, kv, sk, hd)).astype(np.float32))


def model_layout(x, dtype=torch.float32):
    """(B,H,S,hd) numpy -> (B,S,H,hd) torch tensor of ``dtype``."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3))
                            ).to(dtype)


def to_numpy(t):
    return t.detach().float().numpy()
