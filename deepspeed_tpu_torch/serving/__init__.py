"""Continuous-batching serving over a paged KV pool, with speculative
decode, shared-prefix KV reuse, chunked prefill and int8 KV pages (the port's counterpart
of ``deepspeed_tpu.serving``)."""

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
from .request import Request, RequestStatus
from .scheduler import ServingEngine

__all__ = [
    "SCRATCH_PAGE", "PageAllocator", "PageAllocatorError", "PrefixCache", "SlotTable",
    "init_pools", "pages_for", "pool_bytes", "Request", "RequestStatus", "scales_bytes",
    "ServingEngine",
]
