"""Hand-written Hopper kernels of the port.

Each kernel lives in ``csrc/<name>.cu`` (CUDA C++ for ``sm_90a``, built by
:mod:`repro_torch.kernels._build` at first use and bound with ``ctypes``)
with its Python wrapper, its plain PyTorch version and its launch count in
``<name>.py`` beside the reference module of the same name:

* :mod:`repro_torch.kernels.paged_kv` — ``paged_gather`` (replaces
  ``repro/kernels/paged_kv.py::paged_gather_pallas``);
* :mod:`repro_torch.kernels.bucket_pack` — ``bucket_pack`` /
  ``bucket_unpack`` (replace ``repro/kernels/bucket_pack.py::
  bucket_pack_pallas`` / ``bucket_unpack_pallas``);
* :mod:`repro_torch.kernels.flash_attention` — ``flash_attention``, the
  forward (replaces ``repro/kernels/flash_attention.py::
  flash_attention_pallas``) with a plain recompute backward;
* :mod:`repro_torch.kernels.moe_gather` — ``row_gather``, the MoE
  dispatch and combine row moves (replaces ``repro/kernels/moe_gather.py::
  row_gather_pallas``), and ``row_gather_sum``, the gather-sum that is its
  backward (no TPU counterpart: the reference differentiates its gathers
  through XLA);
* :mod:`repro_torch.kernels.ssd_scan` — ``ssd_chunk``, the Mamba2 SSD
  intra-chunk step (replaces ``repro/kernels/ssd_scan.py::
  ssd_chunk_pallas``), and ``ssd_chunk_bwd``, its backward
  (``csrc/ssd_chunk_bwd.cu``; no TPU counterpart: the reference
  differentiates its einsums through XLA).

Every Pallas kernel of the reference now has its CUDA counterpart.
"""
