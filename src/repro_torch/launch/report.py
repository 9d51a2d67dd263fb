"""Aggregate the dry-run's rows into markdown tables (port of
``repro.launch.report``).

    PYTHONPATH=src python -m repro_torch.launch.report [--dir reports/dryrun]

Reads the rows :mod:`repro_torch.launch.dryrun` wrote and prints the
reference's tables: the dry-run summary (per-card argument bytes and the
collectives a step) and the roofline table (three terms at H100
constants, the dominant one, the model-FLOPs ratio, and what would move
it), then the collectives by kind and by line on the single-node-axis
mesh (``32x8``). The port records no dependency depth, so the collective
column gives the count a step.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List


def _fmt_t(s: float) -> str:
    if s >= 1.0:
        return f"{s:.2f}s"
    if s >= 1e-3:
        return f"{s*1e3:.1f}ms"
    return f"{s*1e6:.0f}us"


def _fmt_b(b) -> str:
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if b < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def suggestion(row: Dict) -> str:
    dom = row["dominant"]
    shape = row["shape"]
    if dom == "compute":
        if row.get("model_ratio", 1) < 0.5:
            return "recompute waste: relax remat policy / recompute less"
        return "compute-bound at high useful-FLOPs ratio: near roofline; " \
               "try more chips or lower precision"
    if dom == "memory":
        if "decode" in shape or shape == "long_500k":
            return "KV/state reads dominate: shrink cache dtype (int8/fp8), " \
                   "or shard sequence further"
        return "increase arithmetic intensity: larger per-chip batch/fusion"
    # collective
    if shape == "train_4k":
        return "gradient/FSDP traffic: overlap collectives with compute, " \
               "bigger buckets, or rebalance data-vs-model axes"
    if "decode" in shape or shape == "long_500k":
        return "TP all-reduces dominate tiny decode step: shrink model " \
               "axis for decode or batch requests"
    return "prefill TP traffic: overlap all-gathers with layer compute"


def load(dir_: str) -> List[Dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    return rows


SHAPE_ORDER = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2,
               "long_500k": 3}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="reports/dryrun")
    ap.add_argument("--mesh", default=None, help="filter: 32x8 | 2x32x8")
    args = ap.parse_args(argv)
    rows = load(args.dir)
    ok = [r for r in rows if r.get("status") == "ok"]
    fails = [r for r in rows if r.get("status") != "ok"]

    print(f"## Dry-run summary: {len(ok)} ok / {len(fails)} failed "
          f"of {len(rows)} (arch x shape x mesh)\n")
    if fails:
        for r in fails:
            print(f"- FAIL {r.get('requested_arch')} {r.get('shape')} "
                  f"{r.get('mesh')}: {r.get('error')}")
        print()

    sel = [r for r in ok if args.mesh is None or r["mesh"] == args.mesh]
    sel.sort(key=lambda r: (r["requested_arch"],
                            SHAPE_ORDER.get(r["shape"], 9), r["mesh"]))

    print("| arch | shape | mesh | compute | memory | collective | dominant "
          "| MODEL/total | per-card argbytes | coll. ops a step | "
          "what moves the dominant term |")
    print("|---|---|---|---|---|---|---|---|---|---|---|")
    for r in sel:
        mem = r.get("memory_per_chip") or {}
        st = (r.get("collectives") or {}).get("_structure", {})
        print(f"| {r['requested_arch']} | {r['shape']} | {r['mesh']} "
              f"| {_fmt_t(r['t_compute_s'])} | {_fmt_t(r['t_memory_s'])} "
              f"| {_fmt_t(r['t_collective_s'])} | **{r['dominant']}** "
              f"| {r['model_ratio']:.2f} "
              f"| {_fmt_b(mem.get('argument_bytes'))} "
              f"| {st.get('collective_count', 0):.0f} "
              f"| {suggestion(r)} |")

    # aggregate collective schedule, by line
    print("\n### Collective schedule (per-kind link-bytes by line, 32x8)\n")
    agg: Dict[tuple, Dict[str, float]] = {}
    for r in sel:
        if r["mesh"] != "32x8":
            continue
        by_line = (r.get("collectives") or {}).get("_by_line", {})
        for line, kinds in by_line.items():
            for kind, d in kinds.items():
                a = agg.setdefault((line, kind),
                                   {"count": 0, "link_bytes": 0.0})
                a["count"] += d["count"]
                a["link_bytes"] += d["link_bytes"]
    print("| line | kind | total ops | total link-bytes |")
    print("|---|---|---|---|")
    for (line, kind), d in sorted(agg.items()):
        print(f"| {line} | {kind} | {d['count']:.0f} "
              f"| {_fmt_b(d['link_bytes'])} |")


if __name__ == "__main__":
    main()
