"""repro_torch.core — the paper's contribution, VCIs, on torch.distributed.

Port of ``repro.core``. Public API:
    VCIPool, VCI              — the interface pool (paper §4.2)
    CommWorld, CommContext    — communicator/window analogues (§2)
    CommRuntime, Request      — stream-tagged collectives (§4.3), one
                                process group per VCI (per mesh line along
                                an axis of a RankMesh)
    ProgressEngine            — global | per_vci | hybrid progress (§4.1/4.3)
                                over ``Work`` handles
    plan_buckets, reduce_gradients — gradient→VCI bucketing (training)
    CommPlan, get_comm_plan   — persistent comm plans (cached BucketPlan +
                                CommWorld + contexts + pack tables)

The reference's ordering-token helpers (``after``, ``token_after``,
``fresh_token``, ``join_tokens``) have no counterpart: a stream's token is
the ``Work`` of its last operation (see :mod:`repro_torch.core.progress`).
"""

from repro_torch.core.bucketing import (
    Bucket,
    BucketPlan,
    CommPlan,
    ShardLayout,
    TILE,
    all_gather_shards,
    bucket_ready_order,
    comm_plan_key,
    get_comm_plan,
    overlap_boundaries,
    pack_bucket,
    plan_buckets,
    plan_cache_clear,
    plan_cache_stats,
    reduce_gradients,
    unpack_bucket,
)
from repro_torch.core.collectives import CommRuntime, RankMesh, Request
from repro_torch.core.comm import CommContext, CommWorld
from repro_torch.core.progress import PROGRESS_MODES, ProgressEngine
from repro_torch.core.vci import POLICIES, VCI, VCIPool

__all__ = [
    "Bucket", "BucketPlan", "CommPlan", "ShardLayout", "TILE",
    "all_gather_shards", "bucket_ready_order", "comm_plan_key",
    "get_comm_plan", "overlap_boundaries",
    "pack_bucket", "plan_buckets", "plan_cache_clear",
    "plan_cache_stats", "reduce_gradients", "unpack_bucket", "CommRuntime",
    "RankMesh", "Request", "CommContext", "CommWorld", "PROGRESS_MODES",
    "ProgressEngine", "POLICIES", "VCI", "VCIPool",
]
