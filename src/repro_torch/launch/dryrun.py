"""Production dry-run: one rank's step of every (arch x input-shape x mesh)
on the meta device (port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \\
        --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both \\
        --out reports/dryrun_torch

It needs no card and allocates nothing: every tensor is on the meta
device. The reference lowers and compiles each pair for a TPU mesh and
reads XLA's HLO; the port has no compiler between the model and the
card, so for each pair this script

1. builds the production mesh (:mod:`repro_torch.launch.mesh`: ``32x8``
   H100s, or ``2x32x8`` with ``--multi-pod``) and joins a process group of
   that many ranks on torch's fake backend (no process, no traffic), as
   rank 0;
2. builds rank 0's inputs (:mod:`repro_torch.launch.inputs`) and runs the
   port's own step on them once: ``make_train_step(comm="gspmd")`` for a
   train shape, ``make_prefill`` for prefill, ``make_serve_step`` for
   decode (the GSPMD route), the kernels' dispatcher ops taking their
   shape-only fakes;
3. records every collective the step issues (its op, its line of the mesh
   and its payload) and writes the reference's row
   (:func:`repro_torch.launch.roofline.build_roofline`): the three
   roofline terms at H100 constants, the dominant one, the analytic FLOPs
   and bytes, the link bytes a card, the collectives by op and by line,
   and ``memory_per_chip``, whose ``argument_bytes`` are exact; the
   port's cache layout beside the reference's (``cache_layout``).

Temp and peak bytes are ``null``: a meta tensor has no storage for a
memory tracker to count (``memory_note`` says so).

It writes only under ``--out``; ``reports/dryrun_baseline/`` holds the
reference's TPU rows and is neither read nor written here.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, config_for_shape
from repro_torch.core.collectives import RankMesh, release_groups
from repro_torch.dist import tp as tp_mod
from repro_torch.launch import inputs as I
from repro_torch.launch.mesh import (
    GPUS_PER_NODE,
    make_production_mesh,
    mesh_name,
)
from repro_torch.launch.roofline import CollectiveOp, build_roofline

MEMORY_NOTE = ("temp and peak bytes not measured: the dry-run's tensors "
               "live on the meta device, which has no storage to track")


def _crosses_nodes(mesh: RankMesh, axis: str) -> bool:
    line = mesh.lines(axis)[0]
    return len({r // GPUS_PER_NODE for r in line}) > 1


def join_fake_world(size: int) -> None:
    """Be rank 0 of a ``size``-rank group on torch's fake backend (every
    collective returns at once), replacing any group of another size."""
    if dist.is_initialized():
        if dist.get_world_size() == size and \
                dist.get_backend() == "fake":
            return
        release_groups()
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


class CollectiveRecorder:
    """Records the collectives the port issues while it is active: the
    data line's and the model line's (:class:`Sharder`'s groups, named by
    :meth:`bind`), each as a :class:`CollectiveOp`."""

    def __init__(self, mesh: RankMesh):
        self.mesh = mesh
        self.ops: List[CollectiveOp] = []
        self._lines: Dict[int, str] = {}

    def bind(self, shard) -> None:
        """Name the groups of ``shard`` (a live Sharder): its data line's
        and, with a model axis, its model line's (``None``, the default
        group, is the data line on a data-only mesh)."""
        if shard._data_group is not None:
            self._lines[id(shard._data_group)] = "data"
        if shard.tp is not None:
            self._lines[id(shard.tp.group)] = "model"

    def _line(self, group) -> str:
        if group is None:
            return "data" if self.mesh.model == 1 else "world"
        return self._lines.get(id(group), "other")

    def _add(self, kind: str, t: torch.Tensor, group) -> None:
        line = self._line(group)
        if line == "world":
            size, crosses = self.mesh.size, True
        elif line == "model":
            size, crosses = self.mesh.model, _crosses_nodes(self.mesh,
                                                             "model")
        else:
            size, crosses = self.mesh.data_size, _crosses_nodes(self.mesh,
                                                                 "data")
        self.ops.append(CollectiveOp(kind, t.numel() * t.element_size(),
                                     size, line, crosses))

    @contextlib.contextmanager
    def active(self):
        orig = (dist.all_reduce, dist.all_to_all_single, tp_mod._all_gather,
                tp_mod._reduce_scatter)

        def all_reduce(t, op=dist.ReduceOp.SUM, group=None, async_op=False):
            self._add("all-reduce", t, group)
            return orig[0](t, op=op, group=group, async_op=async_op)

        def all_to_all(out, inp, *a, group=None, **kw):
            self._add("all-to-all", inp, group)
            return orig[1](out, inp, *a, group=group, **kw)

        def all_gather(out, inp, group=None, **kw):
            self._add("all-gather", inp, group)
            return orig[2](out, inp, group=group, **kw)

        def reduce_scatter(out, inp, group=None, **kw):
            self._add("reduce-scatter", inp, group)
            return orig[3](out, inp, group=group, **kw)

        dist.all_reduce, dist.all_to_all_single = all_reduce, all_to_all
        tp_mod._all_gather, tp_mod._reduce_scatter = all_gather, \
            reduce_scatter
        try:
            yield self
        finally:
            (dist.all_reduce, dist.all_to_all_single, tp_mod._all_gather,
             tp_mod._reduce_scatter) = orig


@contextlib.contextmanager
def meta_kernels():
    """While active, a meta tensor reaches the row gather's and the SSD
    step's dispatcher ops (whose registered fakes give its shapes) and
    their backwards give meta gradients of the inputs' shapes. The
    wrappers themselves refuse a tensor that is on neither the CPU nor a
    card; a CPU or CUDA tensor goes through them unchanged here."""
    from repro_torch.kernels import moe_gather, ssd_scan
    from repro_torch.models import moe, ssm
    orig = (moe.row_gather, ssm.ssd_chunk, moe_gather.row_gather_sum,
            ssd_scan.ssd_chunk_bwd)

    def row_gather(src, idx, inv=None):
        if src.device.type == "meta":
            return moe_gather.row_gather_op(src, idx, inv)
        return orig[0](src, idx, inv)

    def ssd_chunk(x, dt, cum, B, C, chunk):
        if x.device.type == "meta":
            return ssd_scan.ssd_chunk_op(x, dt, cum, B, C, chunk)
        return orig[1](x, dt, cum, B, C, chunk)

    def row_gather_sum(src, inv, k):
        if src.device.type == "meta":
            return src.new_empty((inv.shape[0] // k, src.shape[1]))
        return orig[2](src, inv, k)

    def ssd_chunk_bwd(x, dt, cum, B, C, dy, dst, chunk, route=None):
        if x.device.type == "meta":
            return tuple(torch.empty_like(t) for t in (x, dt, cum, B, C))
        return orig[3](x, dt, cum, B, C, dy, dst, chunk, route=route)

    moe.row_gather, ssm.ssd_chunk = row_gather, ssd_chunk
    moe_gather.row_gather_sum, ssd_scan.ssd_chunk_bwd = row_gather_sum, \
        ssd_chunk_bwd
    try:
        yield
    finally:
        (moe.row_gather, ssm.ssd_chunk, moe_gather.row_gather_sum,
         ssd_scan.ssd_chunk_bwd) = orig


def shaped_config(arch: str, shape_name: str, opts: tuple = (),
                  tp: int = 8):
    """The config of a pair under ``opts`` (the reference's ``--opt``:
    config toggles, ``remat:<policy>``; ``decode_cache`` expands the
    stored KV heads to the model axis ``tp`` where the batch splits over
    the data axes and the heads divide ``tp``)."""
    shape = INPUT_SHAPES[shape_name]
    cfg = config_for_shape(arch, shape_name)
    if opts:
        remats = [o for o in opts if o.startswith("remat:")]
        real = tuple(o for o in opts if not o.startswith("remat:"))
        if real:
            cfg = cfg.with_opts(*real)
        for r in remats:
            cfg = dataclasses.replace(cfg, remat=r.split(":", 1)[1])
        if "decode_cache" in cfg.opts:
            kv = cfg.num_kv_heads
            batch_shards = shape.global_batch % tp == 0 \
                and shape.global_batch >= tp
            if (batch_shards and cfg.num_heads and kv and kv < tp
                    and tp % kv == 0 and cfg.num_heads % tp == 0):
                cfg = dataclasses.replace(cfg, decode_kv_expand=tp // kv)
    return cfg


def _run_step(cfg, shape, mesh: RankMesh, rec: CollectiveRecorder) -> None:
    """Rank 0's step of ``shape`` on the meta device, recorded."""
    from repro_torch.serve.engine import make_prefill, make_serve_step
    from repro_torch.train.trainer import make_train_step
    if shape.kind == "train":
        step = make_train_step(cfg, mesh=mesh, comm="gspmd")
        rec.bind(step.sharder())
        state = I.train_state_struct(cfg, mesh)
        batch = {k: torch.empty(s, dtype=d, device="meta")
                 for k, (s, d) in I.batch_spec(cfg, shape).items()}
        with rec.active(), meta_kernels():
            step(state, batch)
        return
    fn = (make_prefill if shape.kind == "prefill" else make_serve_step)(
        cfg, mesh)
    rec.bind(fn.sharder)
    params = I.rank_params(cfg, mesh)
    cache = I.cache_struct(cfg, shape, mesh, sharder=fn.sharder)
    with torch.inference_mode(), rec.active(), meta_kernels():
        if shape.kind == "prefill":
            batch = {k: torch.empty(s, dtype=d, device="meta")
                     for k, (s, d) in I.batch_spec(cfg, shape).items()}
            fn(params, batch, cache)
        else:
            # one token against a full cache: the cursor at its last slot
            cache = dataclasses.replace(cache, length=shape.seq_len - 1)
            if cache.kv is not None:
                cache.kv.length = shape.seq_len - 1
            fn(params, I.decode_token_struct(cfg, shape, mesh), cache)


def lower_pair(arch: str, shape_name: str, *, multi_pod: bool,
               opts: tuple = ()) -> dict:
    """The row of one pair (see the module doc)."""
    shape = INPUT_SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg = shaped_config(arch, shape_name, opts, tp=mesh.model)
    t0 = time.time()
    join_fake_world(mesh.size)
    rec = CollectiveRecorder(mesh)
    _run_step(cfg, shape, mesh, rec)
    args = I.argument_bytes(cfg, shape, mesh)
    mem = {"argument_bytes": args["total"], "output_bytes": None,
           "temp_bytes": None, "generated_code_bytes": None}
    rl = build_roofline(cfg, shape, mesh_name(mesh), mesh.size, rec.ops, mem)
    out = rl.row()
    out["requested_arch"] = arch
    out["argument_bytes_by_input"] = args
    out["memory_note"] = MEMORY_NOTE
    if shape.kind != "train":
        out["cache_layout"] = I.cache_layout(cfg, shape, mesh)
    out["compile_s"] = time.time() - t0
    out["status"] = "ok"
    return out


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default=None)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both", action="store_true",
                    help="run single-pod AND multi-pod meshes")
    ap.add_argument("--out", default="reports/dryrun")
    ap.add_argument("--opt", default="",
                    help="comma-separated optimization toggles (kv_fp8, "
                         "decode_cache, moe_dispatch, fsdp, remat:<policy>)")
    ap.add_argument("--stable", action="store_true",
                    help="deterministic reports: drop wall-clock fields "
                         "(compile_s)")
    args = ap.parse_args(argv)
    opts = tuple(o for o in args.opt.split(",") if o)

    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = [False, True] if args.both else [args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    try:
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    name = mesh_name(make_production_mesh(multi_pod=mp))
                    tag = f"{arch}__{shape}__{name}"
                    if opts:
                        tag += "__opt_" + "_".join(opts)
                    try:
                        row = lower_pair(arch, shape, multi_pod=mp,
                                         opts=opts)
                        print(f"[ok] {tag:55s} "
                              f"compile={row['compile_s']:.1f}s "
                              f"dom={row['dominant']} "
                              f"C/M/K={row['t_compute_s']:.3g}/"
                              f"{row['t_memory_s']:.3g}/"
                              f"{row['t_collective_s']:.3g}s", flush=True)
                    except Exception as e:
                        failures += 1
                        row = {"requested_arch": arch, "shape": shape,
                               "mesh": name, "status": "fail",
                               "error": repr(e),
                               "traceback": traceback.format_exc()}
                        print(f"[FAIL] {tag}: {e!r}", flush=True)
                    if args.stable:
                        row.pop("compile_s", None)
                    with open(os.path.join(args.out, tag + ".json"),
                              "w") as f:
                        json.dump(row, f, indent=1, default=str)
    finally:
        if dist.is_initialized():
            release_groups()
            dist.destroy_process_group()
    print(f"done; failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
