"""Paged decode attention: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/paged_decode_attention.cu``) replaces the Pallas kernel
``deepspeed_tpu/ops/pallas/decode_attention.py`` ``paged_decode_attention``
(body ``_paged_kernel``): one query token per serving slot attends the
slot's pages of a shared ``[P, KV, page, D]`` pool through its block-table
row, keys past ``pos[b]`` masked, online softmax in f32. It is bound by the
HBM bytes of the live K/V rows; the source's header says what its simple
design does and does not do about that.

:func:`paged_decode_attention_ref` is the plain PyTorch version (gather the
pages, grouped einsum, masked f32 softmax, as the JAX package's jnp
fallback computes it). The dispatcher ``ops.attention.paged_cached_attention``
uses it for CPU tensors; for CUDA tensors it calls
:func:`paged_decode_attention`, which launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

# kernel launches by this process (the main path's proof that it ran here)
LAUNCHES = 0

DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
HEAD_DIMS = (64, 128, 256)
PAGE_RANGE = (8, 64)


def _check_shapes(q, k_pool, v_pool, block_tables, pos):
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError(
            f"expected q [B,H,D] and pools [P,KV,page,D]; got {tuple(q.shape)}, "
            f"{tuple(k_pool.shape)}"
        )
    B, H, D = q.shape
    P, KV, page, Dk = k_pool.shape
    if v_pool.shape != k_pool.shape or Dk != D:
        raise ValueError(
            f"pool shapes {tuple(k_pool.shape)}/{tuple(v_pool.shape)} do not "
            f"match q {tuple(q.shape)}"
        )
    if H % KV != 0:
        raise ValueError(f"q heads {H} must divide by KV heads {KV}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B or tuple(pos.shape) != (B,):
        raise ValueError(
            f"expected block_tables [B={B}, n] and pos [B]; got "
            f"{tuple(block_tables.shape)}, {tuple(pos.shape)}"
        )


def paged_decode_attention_ref(q, k_pool, v_pool, block_tables, pos,
                               sm_scale: Optional[float] = None):
    """Plain PyTorch paged decode attention → ``[B, H, D]`` in ``q.dtype``;
    scores, softmax and the probability-weighted sum in f32."""
    from .attention import gather_pool_pages

    _check_shapes(q, k_pool, v_pool, block_tables, pos)
    B, H, D = q.shape
    KV = k_pool.shape[1]
    kd, vd = gather_pool_pages(k_pool, v_pool, block_tables)  # [B,n,KV,page,D]
    kd = kd.transpose(2, 3).reshape(B, -1, KV, D)
    vd = vd.transpose(2, 3).reshape(B, -1, KV, D)
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    S = kd.shape[1]
    mask = (
        torch.arange(S, device=q.device)[None, None, :]
        <= pos.to(q.device).long()[:, None, None]
    )  # [B,1,S]
    rep = H // KV
    qg = q.reshape(B, KV, rep, D)
    scores = torch.einsum("bgrd,bsgd->bgrs", qg.float(), kd.float()) * scale
    scores = torch.where(mask[:, :, None], scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bgrs,bsgd->bgrd", probs, vd.float())
    return o.reshape(B, H, D).to(q.dtype)


def paged_decode_attention(q, k_pool, v_pool, block_tables, pos,
                           sm_scale: Optional[float] = None, scales=None):
    """Launch the CUDA kernel on ``torch.cuda.current_stream()`` → a new
    ``[B, H, D]`` tensor in ``q.dtype``. Every operand must be a contiguous
    tensor on one CUDA device: q and the pools float32, float16 or bfloat16
    (the pools one dtype), ``block_tables [B, n]`` and ``pos [B]`` int32.
    Raises on anything else; the int8 pool mode (``scales``) is not ported
    yet."""
    global LAUNCHES
    if scales is not None:
        raise NotImplementedError(
            "paged_decode_attention: the int8 pool mode (scales) is not "
            "ported to the CUDA kernel yet"
        )
    _check_shapes(q, k_pool, v_pool, block_tables, pos)
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
               "block_tables": block_tables, "pos": pos}
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(
                f"paged_decode_attention: {name} is on {t.device}, expected "
                "every operand on the one CUDA device of q"
            )
        if not t.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be contiguous")
    if q.dtype not in DTYPE_CODES or k_pool.dtype not in DTYPE_CODES:
        raise TypeError(
            f"paged_decode_attention: q {q.dtype} / pools {k_pool.dtype} must "
            "be float32, float16 or bfloat16"
        )
    if v_pool.dtype != k_pool.dtype:
        raise TypeError(f"k_pool {k_pool.dtype} and v_pool {v_pool.dtype} differ")
    if block_tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("paged_decode_attention: block_tables and pos must be int32")
    B, H, D = q.shape
    P, KV, page, _ = k_pool.shape
    n = block_tables.shape[1]
    if D not in HEAD_DIMS:
        raise ValueError(f"paged_decode_attention: head dim {D} not in {HEAD_DIMS}")
    if not PAGE_RANGE[0] <= page <= PAGE_RANGE[1]:
        raise ValueError(f"paged_decode_attention: page {page} outside {PAGE_RANGE}")
    if n < 1:
        raise ValueError("paged_decode_attention: block_tables has no columns")
    for name in ("q", "k_pool", "v_pool"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"paged_decode_attention: {name} is not 16-byte aligned")
    out = torch.empty_like(q)
    if B == 0:
        return out
    from .op_builder import load

    lib = load("paged_decode_attention")
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    err = lib.paged_decode_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
        B, H, KV, P, page, n, D, ctypes.c_float(scale),
        DTYPE_CODES[q.dtype], DTYPE_CODES[k_pool.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"paged_decode_attention: kernel launch failed, CUDA error {err}")
    LAUNCHES += 1
    return out
