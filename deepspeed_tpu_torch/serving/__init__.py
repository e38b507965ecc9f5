"""Continuous-batching serving over a paged KV pool, with speculative
decode, shared-prefix KV reuse and chunked prefill (the port's counterpart
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
)
from .request import Request, RequestStatus
from .scheduler import ServingEngine

__all__ = [
    "SCRATCH_PAGE", "PageAllocator", "PageAllocatorError", "PrefixCache", "SlotTable",
    "init_pools", "pages_for", "pool_bytes", "Request", "RequestStatus",
    "ServingEngine",
]
