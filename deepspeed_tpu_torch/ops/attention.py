"""Attention dispatch (counterpart of ``deepspeed_tpu/ops/attention.py``):
dense causal attention for training, dense bidirectional (encoder)
attention for BERT, single-token attention against a
contiguous KV cache for offline ``generate``, and attention against the
serving subsystem's paged KV pool.

Dense layout: ``q [B, S, H, D]``, ``k``/``v`` ``[B, S, KV, D]`` (H % KV ==
0). Contiguous cache: ``q [B, H, D]`` against ``[B, Smax, KV, D]`` caches
with one ``pos`` for the batch. Paged layout: ``q [B, H, D]`` (one query
per slot) or ``[B, T, H, D]`` (T per slot), pools ``[P, KV, page, D]`` (KV
== H, or H % KV == 0 for GQA), ``block_tables [B, n]`` pool-page ids per
slot, ``pos [B]`` each slot's highest valid cache index (inclusive),
``base [B]`` the position of a slot's first query. An int8 pool comes with
``scales [P, KV, 2]`` f32 (K at index 0, V at 1), given exactly when the
pool is int8.
"""

from __future__ import annotations

from typing import Optional

import torch

from .decode_attention import decode_attention, decode_attention_ref
from .flash_attention import flash
from .paged_decode_attention import paged_decode_attention, paged_decode_attention_ref
from .paged_multitoken_attention import (
    paged_multitoken_attention,
    paged_multitoken_attention_ref,
)


def gather_pool_pages(k_pool, v_pool, block_tables, scales=None):
    """Each slot's pages as a dense ``[B, n, KV, page, D]`` view (a copy);
    an int8 pool is dequantized to f32 through ``scales [P, KV, 2]``
    gathered by the same table."""
    idx = block_tables.long()
    kd, vd = k_pool[idx], v_pool[idx]
    if scales is not None:
        st = scales[idx]  # [B, n, KV, 2]
        kd = kd.float() * st[..., 0][..., None, None]
        vd = vd.float() * st[..., 1][..., None, None]
    return kd, vd


def _check_scales(name, k_pool, scales):
    if (scales is None) == (k_pool.dtype == torch.int8):
        raise ValueError(
            f"{name}: scales must be given exactly when the pool is int8 (pool "
            f"dtype {k_pool.dtype}, scales {'given' if scales is not None else 'missing'})"
        )


def cached_attention(q, k_cache, v_cache, pos, impl: str = "auto",
                     sm_scale: Optional[float] = None):
    """Single-token decode attention against a contiguous KV cache: ``q
    [B, H, D]``, caches ``[B, Smax, KV, D]`` (any strides with a unit last
    one, e.g. a layer's slice of ``KVCache.k``), ``pos`` the highest valid
    index for the whole batch → ``[B, H, D]``. ``pos`` is an int32
    one-element tensor on q's device, which the kernel reads (the plain
    version also takes a Python int).

    CUDA tensors go to the hand-written kernel (which raises on what it does
    not take); CPU tensors to its plain version. There is no other route:
    ``impl="jnp"`` (the plain version by name) is refused for CUDA tensors."""
    if impl not in ("auto", "pallas", "jnp"):
        raise ValueError(f"unknown attention impl {impl}")
    if q.device.type == "cuda":
        if impl == "jnp":
            raise ValueError("cached_attention: impl='jnp' (the plain version) does not run "
                             "on the card; CUDA tensors take the decode kernel")
        return decode_attention(q, k_cache, v_cache, pos, sm_scale)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, pos, sm_scale)
    raise ValueError(f"cached_attention: no implementation for device {q.device}")


def paged_cached_attention(q, k_pool, v_pool, block_tables, pos,
                           sm_scale: Optional[float] = None, scales=None):
    """Single-token decode attention against a paged KV cache → ``[B, H, D]``.

    CUDA tensors go to the hand-written kernel (which raises on what it does
    not take); CPU tensors to its plain version. There is no other route."""
    _check_scales("paged_cached_attention", k_pool, scales)
    if q.device.type == "cuda":
        return paged_decode_attention(q, k_pool, v_pool, block_tables, pos, sm_scale, scales)
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, block_tables, pos, sm_scale,
                                          scales)
    raise ValueError(f"paged_cached_attention: no implementation for device {q.device}")


def paged_multitoken_cached_attention(q, k_pool, v_pool, block_tables, base,
                                      sm_scale: Optional[float] = None, scales=None):
    """T-token causal attention against a paged KV cache → ``[B, T, H, D]``:
    query t of slot b sits at ``base[b] + t`` and attends keys ``<= base[b]
    + t``; the chunk's own K/V must already be in the pool.

    CUDA tensors go to the hand-written kernel (which raises on what it does
    not take); CPU tensors to its plain version. There is no other route."""
    _check_scales("paged_multitoken_cached_attention", k_pool, scales)
    if q.device.type == "cuda":
        return paged_multitoken_attention(q, k_pool, v_pool, block_tables, base, sm_scale,
                                          scales)
    if q.device.type == "cpu":
        return paged_multitoken_attention_ref(q, k_pool, v_pool, block_tables, base, sm_scale,
                                              scales)
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


def bidirectional_attention_ref(q, k, v, mask=None, sm_scale: Optional[float] = None):
    """Plain encoder attention (the JAX package's
    ``bidirectional_attention_jnp``): ``[B, S, H, D]`` → ``[B, S, H, D]``,
    an optional padding ``mask [B, S]`` (1 = attend), f32 scores and
    softmax, probabilities cast to q's dtype before the product with v."""
    D = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask.to(q.device).bool()[:, None, None, :], -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def bidirectional_attention(q, k, v, mask=None, impl: str = "auto",
                            sm_scale: Optional[float] = None):
    """Non-causal ``[B, S, H, D]`` attention with an optional padding
    ``mask [B, S]``.

    An unmasked call on CUDA tensors runs the flash kernels (non-causal),
    which launch or raise; a mask goes to the plain masked path on any
    device, as in the JAX package (the kernels have no mask input); CPU
    tensors take the plain version. ``impl="jnp"`` (the plain version by
    name) is refused for CUDA tensors."""
    if impl not in ("auto", "pallas", "jnp"):
        raise ValueError(f"unknown attention impl {impl}")
    if q.device.type == "cuda" and impl == "jnp":
        raise ValueError("bidirectional_attention: impl='jnp' (the plain version) does not run "
                         "on the card; CUDA tensors take the flash kernels (impl='auto')")
    if mask is not None or q.device.type == "cpu":
        return bidirectional_attention_ref(q, k, v, mask, sm_scale)
    if q.device.type == "cuda":
        return flash(q, k, v, False, sm_scale)
    raise ValueError(f"bidirectional_attention: no implementation for device {q.device}")
