"""Continuous-batching serving over a paged KV pool (the port's counterpart
of ``deepspeed_tpu.serving`` on its default path)."""

from .kv_cache import (
    SCRATCH_PAGE,
    PageAllocator,
    PageAllocatorError,
    SlotTable,
    init_pools,
    pages_for,
    pool_bytes,
)
from .request import Request, RequestStatus
from .scheduler import ServingEngine

__all__ = [
    "SCRATCH_PAGE", "PageAllocator", "PageAllocatorError", "SlotTable",
    "init_pools", "pages_for", "pool_bytes", "Request", "RequestStatus",
    "ServingEngine",
]
