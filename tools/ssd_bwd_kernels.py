#!/usr/bin/env python3
"""Where the SSD backward's tensor-core route spends its time, on one CUDA
card.

    python3 tools/ssd_bwd_kernels.py

At the mamba2-780m and zamba2-7b training shapes (chip_smoke's phase 14a
inputs), prints each kernel of the route (the split pass, dx, the column
and the row terms, the finish) by device time a launch (``torch.profiler``,
10 calls), first with the heads a block that ``tc_heads_per_block`` picks,
then with 4, 8, 16 and 24. Then it builds two more copies of
``csrc/ssd_chunk_bwd_tc.cu``, one whose item loops load nothing after
their first item and one whose item loops compute nothing, and times
their kernels the same way: how much of each kernel its loads alone and
its products alone take. It prints the card's name and power limit
first and exits non-zero without a card. ``chip_smoke.py`` is the check
of the kernels; this script only measures (the copies' outputs are
wrong by design).
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "src"))

import chip_smoke as cs  # noqa: E402  (phase_device, the 14a inputs)

SHAPES = (("mamba2-780m train", (8, 1024, 48, 64, 1, 128, 256)),
          ("zamba2-7b train", (4, 1024, 112, 64, 1, 64, 256)))


def kernel_us(args) -> dict:
    """Device µs a launch of each of the route's kernels (each launches
    once a call), over 10 calls after 3 to warm up; the profiler's count
    of each kernel's launches divides its time, so that a launch it did
    not record does not count as zero time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ssd_scan
    for _ in range(3):
        ssd_scan.ssd_chunk_bwd(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            ssd_scan.ssd_chunk_bwd(*args)
        torch.cuda.synchronize()
    total, count = {}, {}
    for e in prof.key_averages():
        name = re.search(r"ssd_bwd_(\w+)_kernel(<(true|false))?", e.key)
        if e.device_type == DeviceType.CUDA and name:
            key = {"true": "column", "false": "row"}.get(name.group(3),
                                                         name.group(1))
            total[key] = total.get(key, 0.0) + e.self_device_time_total
            count[key] = count.get(key, 0) + e.count
    return {k: total[k] / count[k] for k in total if count[k]}


def show(what: str, us: dict) -> None:
    if len(us) < 5:
        print(f"ssd_bwd_kernels {what}: not measured (the profiler recorded "
              f"{sorted(us)} of the 5 kernels)", flush=True)
        return
    parts = ", ".join(f"{k} {us[k]:.1f}"
                      for k in ("prep", "dx", "column", "row", "finish"))
    print(f"ssd_bwd_kernels {what}: total {sum(us.values()):.1f} us "
          f"({parts}; {len(us)} kernels)", flush=True)


def variant_libs(tmp: str) -> dict:
    """The route's source built with the item loads, or the item
    products, switched off after the first item."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "ssd_chunk_bwd_tc.cu").read_text()
    src = re.sub(r"if \(k \+ (\d) < total\) issue\(k \+ (\d)\);",
                 r"if (!NOLOAD && k + \1 < total) issue(k + \2);", src)
    src = re.sub(r"step\(\);\n(\s*)if \(live\) \{",
                 r"step();\n\1if (live && !NOCOMP) {", src)
    path = os.path.join(tmp, "variant.cu")
    with open(path, "w") as f:
        f.write(src)
    procs = {}
    for name, flags in (("loads only", ["-DNOLOAD=0", "-DNOCOMP=1"]),
                        ("products only", ["-DNOLOAD=1", "-DNOCOMP=0"])):
        lib = os.path.join(tmp, f"lib{len(procs)}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            sys.exit(f"ssd_bwd_kernels: the {name} copy did not build:\n"
                     f"{log}")
        fn = ctypes.CDLL(lib).ssd_chunk_bwd_tc_launch
        fn.argtypes = _build.KERNELS["ssd_chunk_bwd_tc"][2]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("ssd_bwd_kernels: needs a CUDA card")
    cs.phase_device()
    from repro_torch.kernels import _build, ssd_scan
    _build.build_all(["ssd_chunk_bwd_tc"])
    gen = torch.Generator(device="cuda").manual_seed(14)
    inputs = {}
    for name, (b, s, h, p, g, n, chunk) in SHAPES:
        x, dt, cum, B, C = cs._ssd_inputs(torch.bfloat16, b, s, h, p, g, n,
                                          chunk, gen)
        dy = torch.randn((b, s, h, p), generator=gen, device="cuda")
        dst = torch.randn((b, s // chunk, h, n, p), generator=gen,
                          device="cuda")
        inputs[name] = (x, dt, cum, B, C, dy, dst, chunk)
        rule = ssd_scan.tc_heads_per_block
        picked = rule(b, s // chunk, g, h // g, -(-chunk // 64),
                      torch.cuda.get_device_properties(0)
                      .multi_processor_count)
        show(f"{name} heads a block {picked} (the rule)",
             kernel_us(inputs[name]))
        try:
            for hpb in (4, 8, 16, 24):
                ssd_scan.tc_heads_per_block = lambda *a, _h=hpb: _h
                show(f"{name} heads a block {hpb}", kernel_us(inputs[name]))
        finally:
            ssd_scan.tc_heads_per_block = rule
    load = _build.load
    with tempfile.TemporaryDirectory() as tmp:
        for variant, fn in variant_libs(tmp).items():
            _build.load = lambda k, _fn=fn: (
                _fn if k == "ssd_chunk_bwd_tc" else load(k))
            try:
                for name, args in inputs.items():
                    show(f"{name} {variant}", kernel_us(args))
            finally:
                _build.load = load


if __name__ == "__main__":
    main()
