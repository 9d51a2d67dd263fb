"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/<source>.cu`` is compiled on its own by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, then loaded with
``ctypes``; no PyTorch headers are involved, so a build takes seconds.
Libraries go to ``kernels/build/`` (listed in ``.gitignore``), named by a
hash of the source and the flags, so an edited source rebuilds and an
unchanged one is reused. Builds happen at first use, never at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel name -> (its source csrc/<source>.cu, C entry point, its ctypes
# argtypes); a source may hold more than one kernel's entry point
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNELS: Dict[str, tuple] = {
    "paged_gather": ("paged_gather", "paged_gather_launch",
                     [_P, _P, _P, _LL, _I, _LL, _P]),
    "bucket_pack": ("bucket_pack", "bucket_pack_launch",
                    [_P, _P, _P, _P, _LL, _LL, _LL, _I, _P]),
    "flash_attention": ("flash_attention", "flash_attention_fwd_launch",
                        [_P] * 6 + [_LL] * 9 + [_I] * 9 + [_P]),
    "row_gather": ("row_gather", "row_gather_launch",
                   [_P, _P, _P, _P, _LL, _LL, _I, _LL, _P]),
    "row_gather_sum": ("row_gather", "row_gather_sum_launch",
                       [_P, _P, _P, _LL, _LL, _I, _LL, _I, _P]),
    "ssd_chunk": ("ssd_chunk", "ssd_chunk_launch",
                  [_P] * 7 + [_LL] * 15 + [_I] * 8 + [_P]),
    "ssd_chunk_bwd": ("ssd_chunk_bwd", "ssd_chunk_bwd_launch",
                      [_P] * 13 + [_LL] * 18 + [_I] * 9 + [_P]),
    "ssd_chunk_bwd_tc": ("ssd_chunk_bwd_tc", "ssd_chunk_bwd_tc_launch",
                         [_P] * 21 + [_LL] * 18 + [_I] * 9 + [_P]),
}


def nvcc_path() -> str:
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "of repro_torch are built from source at first use")


def lib_path(source: str) -> Path:
    """The shared library built from ``csrc/<source>.cu``."""
    src = CSRC / f"{source}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[List[str]] = None) -> Dict[str, str]:
    """Compile the sources of the named kernels (default: all) not yet
    built, one ``nvcc`` per source, all started together; wait for each.
    Returns ``{source: compiler log}`` for the sources built by this call
    (``-Xptxas -v``: registers, spills). Raises ``RuntimeError`` with the
    compiler's output if a build fails."""
    names = list(KERNELS) if names is None else names
    sources = dict.fromkeys(KERNELS[n][0] for n in names)
    todo = [n for n in sources if not lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        tmp = lib_path(n).with_suffix(f".tmp{os.getpid()}")
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for n, (tmp, p) in procs.items():
        logs[n] = p.communicate()[0]
        if p.returncode != 0:
            failed.append(f"{n}: nvcc exit {p.returncode}\n{logs[n]}")
            continue
        os.replace(tmp, lib_path(n))  # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


@functools.cache
def load(name: str):
    """The kernel's C entry point as a ctypes function (built if needed)."""
    build_all([name])
    source, sym, argtypes = KERNELS[name]
    lib = ctypes.CDLL(str(lib_path(source)))
    fn = getattr(lib, sym)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
