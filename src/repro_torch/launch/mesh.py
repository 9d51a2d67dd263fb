"""Production and host meshes (port of ``repro.launch.mesh``).

Functions, not module-level constants, and nothing here touches a device
or a process group: a mesh is a :class:`~repro_torch.core.collectives.
RankMesh`, the ranks' places.

The production meshes describe H100 nodes of 8 cards joined by NVLink
inside a node and InfiniBand between nodes, at the reference's chip
counts (256 and 512), so a row compares with the reference's at equal
chips: ``32x8`` (data 32 x model 8, the model axis inside one node's
NVLink) and ``2x32x8`` (pod 2 x data 32 x model 8).
"""

from __future__ import annotations

import torch.distributed as dist

from repro_torch.core.collectives import RankMesh

GPUS_PER_NODE = 8


def make_production_mesh(*, multi_pod: bool = False) -> RankMesh:
    """``32x8`` = 256 cards; ``2x32x8`` = 512 cards with ``multi_pod``."""
    return RankMesh(2, 32, 8) if multi_pod else RankMesh(32, 8)


def mesh_name(mesh: RankMesh) -> str:
    """``"32x8"``, ``"2x32x8"``: the mesh's axes joined by ``x``."""
    return "x".join(str(d) for d in mesh.dims)


def make_host_mesh(data: int = 4, model: int = 2) -> RankMesh:
    """A small ``data x model`` mesh of gloo ranks (the tests' worlds): as
    many data rows as the default group holds at ``model`` a row (all of
    ``data`` without a group)."""
    n = dist.get_world_size() if dist.is_initialized() else data * model
    return RankMesh(min(data, max(1, n // model)), model)
