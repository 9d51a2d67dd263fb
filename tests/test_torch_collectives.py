"""The VCI runtime's process groups at exit (``repro_torch.core.collectives``).

``vci_group`` keeps its process groups in a module registry, which outlives
``destroy_process_group``; their gloo worker threads live as long as the
groups. A worker that is still releasing a finished collective's tensors
takes the GIL, and one that asks for it after the interpreter has begun to
finalize is ended by ``pthread_exit``, whose unwind through a ``noexcept``
frame aborts the process ("terminate called without an active exception").
``release_groups``, run at exit, drops the registry first, so the groups'
destructors join their workers while the interpreter still serves the GIL.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one gloo rank: an all_gather on VCI 1, destroy_process_group, then exit;
# prints the live gloo worker threads after the destroy and in an exit
# handler registered before the port's, so run after it
_SCRIPT = r"""
import atexit, glob, sys
import torch
import torch.distributed as dist

def workers():
    names = []
    for f in glob.glob("/proc/self/task/*/comm"):
        try:
            with open(f) as fh:
                names.append(fh.read().strip())
        except OSError:
            pass
    return names.count("pt_gloo_runloop")

atexit.register(lambda: print("at exit", workers(), flush=True))
from repro_torch.core.collectives import CommRuntime
from repro_torch.core.comm import CommWorld

dist.init_process_group("gloo", store=dist.FileStore(sys.argv[1], 1),
                        rank=0, world_size=1)
world = CommWorld(num_vcis=4)
ctx = world.create("x")
rt = CommRuntime(world)
out = rt.wait(rt.all_gather(torch.arange(8.0), ctx))
assert ctx.vci.index > 0 and out.tolist() == list(range(8))
dist.destroy_process_group()
print("after destroy", workers(), flush=True)
"""


def test_vci_groups_join_their_workers_before_the_interpreter_finalizes(
        tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", _SCRIPT,
                        str(tmp_path / "store")], capture_output=True,
                       text=True, timeout=240, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    counts = dict(line.rsplit(" ", 1) for line in r.stdout.splitlines()
                  if line.startswith(("after destroy", "at exit")))
    # the registry holds the groups, and their workers, past the destroy
    assert int(counts["after destroy"]) > 0, r.stdout
    assert int(counts["at exit"]) == 0, r.stdout


def test_mesh_axis_groups_join_their_workers_too(tmp_path):
    """The groups made along a mesh axis (one a VCI a line, the serve
    path's) sit in the same registry: ``release_groups`` drops them at
    exit as well."""
    script = _SCRIPT.replace(
        "from repro_torch.core.comm import CommWorld",
        "from repro_torch.core.comm import CommWorld\n"
        "from repro_torch.core.collectives import RankMesh").replace(
        "rt = CommRuntime(world)\n"
        "out = rt.wait(rt.all_gather(torch.arange(8.0), ctx))",
        "rt = CommRuntime(world, mesh=RankMesh(1, 1))\n"
        "out = rt.wait(rt.all_gather(torch.arange(8.0), ctx, axis='model'))")
    assert "axis='model'" in script
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", script,
                        str(tmp_path / "store")], capture_output=True,
                       text=True, timeout=240, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    counts = dict(line.rsplit(" ", 1) for line in r.stdout.splitlines()
                  if line.startswith(("after destroy", "at exit")))
    assert int(counts["after destroy"]) > 0, r.stdout
    assert int(counts["at exit"]) == 0, r.stdout
