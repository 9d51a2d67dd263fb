"""PyTorch + CUDA port of the ``repro`` package, for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; this package mirrors its module
names (``configs``, ``models``, ``kernels``, ``serve``, ``launch``) and is
held against it by the ``tests/test_torch_*.py`` conformance tests. It
imports ``torch`` and never ``jax``, and nothing from ``repro``.

Ported so far: the paged continuous-batching serve path for dense text
archs (``serve.engine.ServeEngine``), whose one kernel is the hand-written
CUDA page gather in ``kernels/csrc/paged_gather.cu``. See ``ROADMAP.md``
for what is still to come.

Every entry point resolves its device with :func:`repro_torch.device.
resolve_device`: CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
