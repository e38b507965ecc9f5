"""Attention against the serving subsystem's paged KV pool (counterpart of
the paged pieces of ``deepspeed_tpu/ops/attention.py``).

Layout: ``q [B, H, D]``, pools ``[P, KV, page, D]`` (KV == H, or H % KV == 0
for GQA), ``block_tables [B, n]`` pool-page ids per slot, ``pos [B]`` each
slot's highest valid cache index (inclusive).
"""

from __future__ import annotations

from typing import Optional

from .paged_decode_attention import paged_decode_attention, paged_decode_attention_ref


def gather_pool_pages(k_pool, v_pool, block_tables):
    """Each slot's pages as a dense ``[B, n, KV, page, D]`` view (a copy):
    pure data movement, full-precision pools only."""
    idx = block_tables.long()
    return k_pool[idx], v_pool[idx]


def paged_cached_attention(q, k_pool, v_pool, block_tables, pos,
                           sm_scale: Optional[float] = None):
    """Single-token decode attention against a paged KV cache → ``[B, H, D]``.

    CUDA tensors go to the hand-written kernel (which raises on what it does
    not take); CPU tensors to its plain version. There is no other route."""
    if q.device.type == "cuda":
        return paged_decode_attention(q, k_pool, v_pool, block_tables, pos, sm_scale)
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, block_tables, pos, sm_scale)
    raise ValueError(f"paged_cached_attention: no implementation for device {q.device}")
