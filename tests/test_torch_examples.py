"""The port's examples (``examples_torch/``) and its collective critical
depth (``launch/roofline.py::CollectiveDepth``), in this process on a
one-rank gloo group; the paper's applications on 8 ranks are in
``tests/test_torch_bucketing_ranks.py`` (the ``collectives`` world of
``tests/test_torch_ranks.py``).

The reference reads its depth from compiled HLO, where XLA's all-reduce
combiner merges the four accumulates that ``accumulate_ordering="none"``
leaves un-chained into one all-reduce: 9 collectives against the port's 12
(the eager port issues every accumulate it is asked for). The depths of
the two agree (6 and 3).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_cpu import one_rank  # noqa: F401  (one intra-op thread: see its docstring)
from repro_torch.checkpoint.io import load_state
from repro_torch.core import progress as tprogress
from repro_torch.core.collectives import CommRuntime
from repro_torch.core.comm import CommWorld
from repro_torch.launch.roofline import CollectiveDepth
from repro_torch.train.trainer import train_state_init
from repro_torch.tree import tree_flatten_with_paths

from test_torch_ranks import APP_DEPTHS, PROGRESS, example

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _app_run(app: str, progress: str) -> dict:
    """One application of ``examples_torch/`` on this rank: its
    ``CollectiveDepth`` dict (``bspmm/<ordering>``: that ordering's)."""
    if app == "stencil":
        return example("stencil_halo").run(CPU, progress=progress)
    if app == "ebms":
        return example("ebms_bands").run(CPU, progress=progress)
    return example("bspmm_accumulate").run(
        CPU, progress=progress)[app.split("/")[1]]


@pytest.mark.parametrize("progress", PROGRESS)
@pytest.mark.parametrize("app", sorted(APP_DEPTHS))
def test_example_depth_on_one_rank(one_rank, app, progress):
    """The applications' issue graphs on one rank (every exchange a local
    copy) have the count and depth they have on 8 ranks."""
    res = _app_run(app, progress)
    assert (res["collective_count"], res["critical_depth"]) == \
        APP_DEPTHS[app][progress]
    assert res["parallelism"] == pytest.approx(
        res["collective_count"] / res["critical_depth"])


@pytest.mark.parametrize("app", ("stencil_halo", "ebms_bands",
                                 "bspmm_accumulate"))
def test_app_command_line_gives_its_rank_body_arguments(app):
    """Each application's command line, parsed by its ``parser``, gives
    its rank body what it takes after the device (``rank_args``, as
    ``main`` hands them to ``spawn_ranks``), ``--json`` last."""
    import inspect
    mod = example(app)
    got = mod.rank_args(mod.parser().parse_args(["--json", "out.json"]))
    inspect.signature(mod._rank).bind(CPU, *got)
    assert got[-1] == "out.json"


def test_collective_depth_edges(one_rank):
    """The edges ``CollectiveDepth`` records: a chained issue follows its
    stream's last op, streams apart do not, an un-chained accumulate
    follows nothing but its input, a tensor computed from a waited result
    carries its depth into the next issue, and a hybrid round leaves every
    stream at the deepest one's depth. Nothing is recorded outside the
    block, and the engine's recorders are empty after it."""
    x = torch.ones(4)
    world = CommWorld(num_vcis=4)
    rt = CommRuntime(world, progress="per_vci")
    a, b = world.create("a"), world.create("b")
    win = world.create("w", kind="rma", accumulate_ordering="none")
    with CollectiveDepth() as d:
        r1 = rt.all_reduce(x.clone(), a)
        r2 = rt.all_reduce(x.clone(), a)             # after r1 on a's stream
        r3 = rt.all_reduce(x.clone(), b)             # a stream of its own
        assert [d.depth_of(r.value) for r in (r1, r2, r3)] == [1, 2, 1]
        y = rt.wait(r2) * 2 + 1                      # through torch ops
        assert d.depth_of(y) == 2
        r4 = rt.all_reduce(y, b)                     # its input is 2 deep
        r5 = rt.accumulate(x, win)                   # un-chained, input 0
        r6 = rt.accumulate(x, win)
        assert [d.depth_of(r.value) for r in (r4, r5, r6)] == [3, 1, 1]
    assert dict(d) == {"collective_count": 6, "critical_depth": 3,
                       "parallelism": 2.0}
    assert tprogress.RECORDERS == []
    rt.all_reduce(x.clone(), a)
    assert d["collective_count"] == 6

    rt = CommRuntime(CommWorld(num_vcis=4), progress="hybrid", join_every=3)
    a, b = rt.world.create("a"), rt.world.create("b")
    with CollectiveDepth() as d:
        rt.all_reduce(x.clone(), a)
        rt.all_reduce(x.clone(), a)
        rt.all_reduce(x.clone(), b)                  # the round: b joins a
        r = rt.all_reduce(x.clone(), b)
        assert d.depth_of(r.value) == 3
    with CollectiveDepth() as d:
        pass
    assert dict(d) == {"collective_count": 0, "critical_depth": 0,
                       "parallelism": 1.0}


_REFERENCE_BSPMM = r"""
import json, runpy, sys
import repro.launch.roofline as rl
depth, seen = rl.collective_critical_depth, []

def spy(hlo):
    d = depth(hlo)
    kinds = {}
    for op in rl.parse_collectives(hlo, 8):
        kinds[op.kind] = kinds.get(op.kind, 0) + op.multiplier
    seen.append({**d, "kinds": kinds})
    return d

rl.collective_critical_depth = spy
runpy.run_path(sys.argv[1], run_name="__main__")
print(json.dumps(dict(zip(("rar", "none"), seen))))
"""


def test_bspmm_depth_beside_the_reference(one_rank):
    """The reference's ``examples/bspmm_accumulate.py`` on 8 virtual devices
    (its HLO's depth, the kinds of its collectives counted) beside the
    port's issue graph: the same depths (6 and 3, so "none" <= "rar"
    in both); 12 collectives under both orderings in the port against the
    reference's 12 and 9, because XLA's all-reduce combiner merged the 4
    un-chained accumulates of "none" into one all-reduce."""
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src") + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", _REFERENCE_BSPMM,
                        os.path.join(REPO, "examples",
                                     "bspmm_accumulate.py")],
                       capture_output=True, text=True, timeout=240, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    ref = json.loads(r.stdout.strip().splitlines()[-1])
    port = example("bspmm_accumulate").run(CPU)
    for ordering in ("rar", "none"):
        print(f"{ordering}: port {port[ordering]['collective_count']} "
              f"collectives, depth {port[ordering]['critical_depth']}; "
              f"reference {ref[ordering]['collective_count']:.0f} "
              f"{ref[ordering]['kinds']}, depth "
              f"{ref[ordering]['critical_depth']:.0f}")
    assert port["rar"]["critical_depth"] == ref["rar"]["critical_depth"] == 6
    assert port["none"]["critical_depth"] == \
        ref["none"]["critical_depth"] == 3
    assert port["none"]["critical_depth"] < port["rar"]["critical_depth"]
    assert (port["rar"]["collective_count"],
            port["none"]["collective_count"]) == (12, 12)
    assert (ref["rar"]["collective_count"],
            ref["none"]["collective_count"]) == (12, 9)
    assert ref["rar"]["kinds"] == {"collective-permute": 8, "all-reduce": 4}
    assert ref["none"]["kinds"] == {"collective-permute": 8, "all-reduce": 1}


def test_quickstart_trains_and_serves(one_rank):
    """``quickstart.py`` at fewer steps: the loss falls, and each of the 4
    requests gets its 12 tokens."""
    res = example("quickstart").quickstart(CPU, steps=8,
                                           log=lambda *a: None)
    assert len(res["losses"]) == 8 and np.all(np.isfinite(res["losses"]))
    assert res["losses"][-1] < res["losses"][0]
    assert [r.generated.shape for r in res["requests"]] == [(12,)] * 4


@pytest.mark.parametrize("arch", example("serve_batch").ARCHS)
def test_serve_batch_serves_every_family(arch):
    """``serve_batch.py``'s demo at 4 new tokens: every request gets them
    (audio: on each codebook)."""
    sb = example("serve_batch")
    done = sb.demo(arch, CPU, new=4, log=lambda *a: None)
    k = 4 if arch == "musicgen-large" else 1
    assert sb.tokens_of(done) == 4 * 4 * k
    assert all(r.generated.shape[-1] == 4 for r in done)


def test_train_e2e_tiny_learns_and_restores(one_rank, tmp_path):
    """``train_e2e.py --tiny`` at fewer steps: ce falls, and the saved
    checkpoint restores the state bit for bit."""
    e2e = example("train_e2e")
    from repro_torch.configs import get_config
    cfg = get_config("olmo-1b-smoke")
    res = e2e.train(cfg, CPU, steps=8, batch=8, seq=64,
                    ckpt_dir=str(tmp_path), log=lambda *a: None)
    assert res["ce"][-1] < res["ce"][0]
    assert res["ckpt_bytes"] > 0 and res["peak_bytes"] is None
    like = train_state_init(cfg, 1, device=CPU, pack="pallas")
    back = load_state(str(tmp_path), 8, like)
    got = tree_flatten_with_paths(back)
    want = tree_flatten_with_paths(res["state"])
    assert [p for p, _ in got] == [p for p, _ in want] and len(got) > 3
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), path
