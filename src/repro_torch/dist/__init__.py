"""repro_torch.dist — mesh/axis bookkeeping, sharding rules and the FSDP
weight gather (port of ``repro.dist``).

Public API:
    Sharder                 — the rule table on a mesh, and the gathers
    batch_axes, data_axes   — the mesh's data-parallel axes
    param_specs             — the spec tree mirroring a config's params
"""

from repro_torch.dist.sharding import Sharder, batch_axes, data_axes, param_specs

__all__ = ["Sharder", "batch_axes", "data_axes", "param_specs"]
