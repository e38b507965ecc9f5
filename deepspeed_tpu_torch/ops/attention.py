"""Attention dispatch (counterpart of ``deepspeed_tpu/ops/attention.py``):
dense causal attention for training, and attention against the serving
subsystem's paged KV pool.

Dense layout: ``q [B, S, H, D]``, ``k``/``v`` ``[B, S, KV, D]`` (H % KV ==
0). Paged layout: ``q [B, H, D]`` (one query per slot) or ``[B, T, H, D]``
(T per slot), pools ``[P, KV, page, D]`` (KV == H, or H % KV == 0 for GQA),
``block_tables [B, n]`` pool-page ids per slot, ``pos [B]`` each slot's
highest valid cache index (inclusive), ``base [B]`` the position of a
slot's first query.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash
from .paged_decode_attention import paged_decode_attention, paged_decode_attention_ref
from .paged_multitoken_attention import (
    paged_multitoken_attention,
    paged_multitoken_attention_ref,
)


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


def paged_multitoken_cached_attention(q, k_pool, v_pool, block_tables, base,
                                      sm_scale: Optional[float] = None, scales=None):
    """T-token causal attention against a paged KV cache → ``[B, T, H, D]``:
    query t of slot b sits at ``base[b] + t`` and attends keys ``<= base[b]
    + t``; the chunk's own K/V must already be in the pool.

    CUDA tensors go to the hand-written kernel (which raises on what it does
    not take); CPU tensors to its plain version. There is no other route.
    The int8 pool mode (``scales``) is not ported yet and raises."""
    if scales is not None:
        raise NotImplementedError(
            "paged_multitoken_cached_attention: the int8 pool mode (scales) "
            "is not ported yet"
        )
    if q.device.type == "cuda":
        return paged_multitoken_attention(q, k_pool, v_pool, block_tables, base, sm_scale)
    if q.device.type == "cpu":
        return paged_multitoken_attention_ref(q, k_pool, v_pool, block_tables, base, sm_scale)
    raise ValueError(
        f"paged_multitoken_cached_attention: no implementation for device {q.device}"
    )


def causal_attention_windowed_ref(q, k, v, window, sm_scale: Optional[float] = None):
    """Plain sliding-window causal attention (the JAX package's jnp
    reference): key j visible to query i iff ``i - window < j <= i``
    (``window <= 0`` = global); f32 scores and softmax, probabilities cast
    to q's dtype before the product with v. GQA k/v are repeated."""
    B, S, H, D = q.shape
    if k.shape[2] != H:
        rep = H // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    w = int(window or 0)
    keep = (j <= i) & ((j > i - w) if w > 0 else True)
    logits = logits.masked_fill(~keep, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def causal_attention_ref(q, k, v, sm_scale: Optional[float] = None):
    """Plain causal attention: the ``window <= 0`` case of
    :func:`causal_attention_windowed_ref`."""
    return causal_attention_windowed_ref(q, k, v, 0, sm_scale)


def causal_attention(q, k, v, impl: str = "auto", sm_scale: Optional[float] = None,
                     window=None):
    """``[B, S, H, D]`` causal attention (optionally sliding-window).

    CUDA tensors go to the flash kernels through their autograd Function at
    any S (the kernels mask a ragged edge), which launch or raise; CPU
    tensors take the plain version. There is no other route: ``impl="jnp"``
    (the plain version by name) is taken for CPU tensors and refused for
    CUDA tensors, which always run the kernels."""
    if impl not in ("auto", "pallas", "jnp"):
        raise ValueError(f"unknown attention impl {impl}")
    if q.device.type == "cuda":
        if impl == "jnp":
            raise ValueError("causal_attention: impl='jnp' (the plain version) does not run "
                             "on the card; CUDA tensors take the flash kernels (impl='auto')")
        return flash(q, k, v, True, sm_scale, window)
    if q.device.type == "cpu":
        return causal_attention_windowed_ref(q, k, v, window, sm_scale)
    raise ValueError(f"causal_attention: no implementation for device {q.device}")
