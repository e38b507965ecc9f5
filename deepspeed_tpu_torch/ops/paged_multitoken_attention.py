"""Paged multi-token attention: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/paged_multitoken_attention.cu``) replaces the Pallas
kernel ``deepspeed_tpu/ops/pallas/decode_attention.py``
``paged_multitoken_attention`` (body ``_paged_multitoken_kernel``): T query
tokens per serving slot, query t at position ``base[b] + t``, attend the
slot's pages of a shared ``[P, KV, page, D]`` pool through its block-table
row, keys past ``base[b] + t`` masked, online softmax in f32. Its int8 mode
dequantizes the pool's codes with the page's per-kv-head f32 scale
(``scales [P, KV, 2]``, gathered by the same table index). Chunked
prefill and prefix-cache tails run it (the chunk's K/V already written:
update-then-attend). At chunk widths up to ~256 it is bound by the HBM
bytes of the live K/V rows, beyond that by its flops; the source's header
says what its simple design does and does not do about either.

:func:`paged_multitoken_attention_ref` is the plain PyTorch version (gather
the pages, the f32 einsum with the ``[B, T, S]`` mask ``j <= base + t``, as
the JAX package's jnp fallback computes it). The dispatcher
``ops.attention.paged_multitoken_cached_attention`` uses it for CPU tensors;
for CUDA tensors it calls :func:`paged_multitoken_attention`, which launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .paged_decode_attention import (
    DTYPE_CODES,
    HEAD_DIMS,
    KV_DTYPE_CODES,
    PAGE_RANGE,
    check_scales_tensor,
)

# kernel launches by this process (the main path's proof that it ran
# here): full-precision pools, and the int8 mode
LAUNCHES = 0
LAUNCHES_INT8 = 0

MAX_T = 1024


def _check_shapes(q, k_pool, v_pool, block_tables, base):
    if q.dim() != 4 or k_pool.dim() != 4:
        raise ValueError(
            f"expected q [B,T,H,D] and pools [P,KV,page,D]; got {tuple(q.shape)}, "
            f"{tuple(k_pool.shape)}"
        )
    B, T, H, D = q.shape
    P, KV, page, Dk = k_pool.shape
    if v_pool.shape != k_pool.shape or Dk != D:
        raise ValueError(
            f"pool shapes {tuple(k_pool.shape)}/{tuple(v_pool.shape)} do not "
            f"match q {tuple(q.shape)}"
        )
    if H % KV != 0:
        raise ValueError(f"q heads {H} must divide by KV heads {KV}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B or tuple(base.shape) != (B,):
        raise ValueError(
            f"expected block_tables [B={B}, n] and base [B]; got "
            f"{tuple(block_tables.shape)}, {tuple(base.shape)}"
        )


def paged_multitoken_attention_ref(q, k_pool, v_pool, block_tables, base,
                                   sm_scale: Optional[float] = None, scales=None):
    """Plain PyTorch paged multi-token attention → ``[B, T, H, D]`` in
    ``q.dtype``; scores, softmax and the probability-weighted sum in f32 (an
    int8 pool dequantized to f32 through ``scales`` first)."""
    from .attention import gather_pool_pages

    _check_shapes(q, k_pool, v_pool, block_tables, base)
    if scales is not None:
        check_scales_tensor("paged_multitoken_attention_ref", k_pool, scales)
    B, T, H, D = q.shape
    KV = k_pool.shape[1]
    kd, vd = gather_pool_pages(k_pool, v_pool, block_tables, scales)  # [B,n,KV,page,D]
    kd = kd.transpose(2, 3).reshape(B, -1, KV, D)
    vd = vd.transpose(2, 3).reshape(B, -1, KV, D)
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    S = kd.shape[1]
    # [B, T, S]: key j visible to query t iff j <= base + t
    mask = (
        torch.arange(S, device=q.device)[None, None, :]
        <= base.to(q.device).long()[:, None, None]
        + torch.arange(T, device=q.device)[None, :, None]
    )
    rep = H // KV
    qg = q.reshape(B, T, KV, rep, D)
    scores = torch.einsum("btgrd,bsgd->btgrs", qg.float(), kd.float()) * scale
    scores = torch.where(mask[:, :, None, None, :], scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("btgrs,bsgd->btgrd", probs, vd.float())
    return o.reshape(B, T, H, D).to(q.dtype)


def paged_multitoken_attention(q, k_pool, v_pool, block_tables, base,
                               sm_scale: Optional[float] = None, scales=None):
    """Launch the CUDA kernel on ``torch.cuda.current_stream()`` → a new
    ``[B, T, H, D]`` tensor in ``q.dtype``. Every operand must be a
    contiguous tensor on one CUDA device: q float32, float16 or bfloat16,
    the pools one of those or int8 (then with ``scales [P, KV, 2]``
    float32), ``block_tables [B, n]`` and ``base [B]`` int32 (``base >=
    0``), ``1 <= T <= 1024``. Raises on anything else."""
    global LAUNCHES, LAUNCHES_INT8
    _check_shapes(q, k_pool, v_pool, block_tables, base)
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
               "block_tables": block_tables, "base": base}
    if scales is not None:
        check_scales_tensor("paged_multitoken_attention", k_pool, scales)
        tensors["scales"] = scales
    elif k_pool.dtype == torch.int8:
        raise ValueError("paged_multitoken_attention: an int8 pool needs its scales")
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(
                f"paged_multitoken_attention: {name} is on {t.device}, expected "
                "every operand on the one CUDA device of q"
            )
        if not t.is_contiguous():
            raise ValueError(f"paged_multitoken_attention: {name} must be contiguous")
    if q.dtype not in DTYPE_CODES or k_pool.dtype not in KV_DTYPE_CODES:
        raise TypeError(
            f"paged_multitoken_attention: q {q.dtype} must be float32, float16 "
            f"or bfloat16 and the pools {k_pool.dtype} one of those or int8"
        )
    if v_pool.dtype != k_pool.dtype:
        raise TypeError(f"k_pool {k_pool.dtype} and v_pool {v_pool.dtype} differ")
    if block_tables.dtype != torch.int32 or base.dtype != torch.int32:
        raise TypeError("paged_multitoken_attention: block_tables and base must be int32")
    B, T, H, D = q.shape
    P, KV, page, _ = k_pool.shape
    n = block_tables.shape[1]
    if D not in HEAD_DIMS:
        raise ValueError(f"paged_multitoken_attention: head dim {D} not in {HEAD_DIMS}")
    if not PAGE_RANGE[0] <= page <= PAGE_RANGE[1]:
        raise ValueError(f"paged_multitoken_attention: page {page} outside {PAGE_RANGE}")
    if not 1 <= T <= MAX_T:
        raise ValueError(f"paged_multitoken_attention: T={T} outside [1, {MAX_T}]")
    if n < 1:
        raise ValueError("paged_multitoken_attention: block_tables has no columns")
    for name in ("q", "k_pool", "v_pool"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"paged_multitoken_attention: {name} is not 16-byte aligned")
    out = torch.empty_like(q)
    if B == 0:
        return out
    from .op_builder import load

    lib = load("paged_multitoken_attention")
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    err = lib.paged_multitoken_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), base.data_ptr(),
        scales.data_ptr() if scales is not None else None, out.data_ptr(),
        B, T, H, KV, P, page, n, D, ctypes.c_float(scale),
        DTYPE_CODES[q.dtype], KV_DTYPE_CODES[k_pool.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"paged_multitoken_attention: kernel launch failed, CUDA error {err}"
        )
    if scales is not None:
        LAUNCHES_INT8 += 1
    else:
        LAUNCHES += 1
    return out
