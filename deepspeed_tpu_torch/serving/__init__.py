"""Continuous-batching serving over a paged KV pool, with speculative
decode, shared-prefix KV reuse, chunked prefill, int8 KV pages, the
host-DRAM KV tier and retries, the multi-replica fleet with live session
migration (``fleet``), the seeded trace-replay harness (``replay``) and
the tensor-parallel and disaggregated placements over the ranks of the
default process group (``placement``) (the port's counterpart of
``deepspeed_tpu.serving``)."""

from .fleet import FleetError, FleetReplica, FleetRouter, replay_fleet

from .kv_cache import (
    SCRATCH_PAGE,
    PageAllocator,
    PageAllocatorError,
    PrefixCache,
    SlotTable,
    init_pools,
    pages_for,
    pool_bytes,
    scales_bytes,
)
from .replay import ReplayClock, ReplayItem, WorkloadSpec, generate_workload, replay
from .request import Request, RequestStatus
from .scheduler import ServingEngine
from .tiering import (
    TIERING_POLICIES,
    HostPageStore,
    HostTierError,
    KVTieringEngine,
    policy_victim_key,
    replay_live_tier,
)

__all__ = [
    "SCRATCH_PAGE", "PageAllocator", "PageAllocatorError", "PrefixCache", "SlotTable",
    "init_pools", "pages_for", "pool_bytes", "Request", "RequestStatus", "scales_bytes",
    "ServingEngine", "HostPageStore", "HostTierError", "KVTieringEngine", "TIERING_POLICIES",
    "policy_victim_key", "replay_live_tier", "FleetError", "FleetReplica", "FleetRouter",
    "replay_fleet", "ReplayClock", "ReplayItem", "WorkloadSpec", "generate_workload", "replay",
]
