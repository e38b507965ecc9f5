"""Paged decode attention: the CUDA kernel's wrapper, its launch plan and
its plain versions.

The kernel (``csrc/paged_decode_attention.cu``) replaces the Pallas kernel
``deepspeed_tpu/ops/pallas/decode_attention.py`` ``paged_decode_attention``
(body ``_paged_kernel``): one query token per serving slot attends the
slot's pages of a shared ``[P, KV, page, D]`` pool through its block-table
row, keys past ``pos[b]`` masked, online softmax in f32. It is bound by the
HBM bytes of the live K/V rows. It carries the contiguous decode kernel's
design over to pages: 16-byte loads, a GQA group's heads a block, and
split-K over whole pages with an in-kernel merge in chunk order
(:func:`kernel_plan` decides the split from shapes alone, never from
``pos``, which lives on the device; :func:`paged_decode_attention_split_ref`
is the split computation in plain PyTorch). One device launch a call.

:func:`paged_decode_attention_ref` is the plain PyTorch version (gather the
pages, grouped einsum, masked f32 softmax, as the JAX package's jnp
fallback computes it). The dispatcher ``ops.attention.paged_cached_attention``
uses it for CPU tensors; for CUDA tensors it calls
:func:`paged_decode_attention`, which launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from .decode_attention import (
    DTYPE_CODES,
    HEAD_DIMS,
    _sm_count,
    heads_per_block,
    merge_partials,
    plan_splits,
    rows_per_pass,
    split_scratch,
)
from .launches import LAUNCHES, register

# its launches in the registry (the main path's proof that it ran here):
# full-precision pools, and the int8 mode
KERNELS = register("paged_decode_attention", "paged_decode_attention_int8")

KV_DTYPE_CODES = {**DTYPE_CODES, torch.int8: 3}
PAGE_RANGE = (8, 64)
# the kernel keeps 4 consecutive rows of one page in flight a lane
PAGE_MULTIPLE = 4
# a lane holds q and the accumulator of its E columns for each of the G
# heads of its block: G * E at most this (int8 at D64, E = 16: 4 heads)
MAX_HEAD_ELEMENTS = 64


@functools.lru_cache(maxsize=1024)
def kernel_plan(B: int, H: int, KV: int, D: int, itemsize: int, page: int, n: int,
                sm_count: int):
    """The kernel's launch for one call → ``(G, W, splits, chunk)``: heads
    and warps a block, and the table's ``n * page`` rows cut into chunks of
    whole pages and whole passes. From host-known shapes only (never
    ``pos``). Heads a block: the largest of 8, 4, 2, 1 dividing H / KV
    whose registers fit (:data:`MAX_HEAD_ELEMENTS`). A table that one
    16-warp pass covers, at 1 or 2 heads a block, takes 16 warps and one
    chunk (no merge); otherwise 4-warp blocks over :func:`plan_splits`'
    chunks of the table's rows."""
    G = heads_per_block(H // KV)
    while G * D // min(D * itemsize // 16, 32) > MAX_HEAD_ELEMENTS:
        G //= 2  # q and the accumulators of G heads stay in registers
    rows = n * page
    if G <= 2 and rows <= rows_per_pass(D, itemsize, 16):
        return G, 16, 1, rows
    one_pass = rows_per_pass(D, itemsize, 4)
    unit = one_pass * page // math.gcd(one_pass, page)
    splits, chunk = plan_splits(B, KV, rows, sm_count, H // KV // G, unit)
    return G, 4, splits, chunk


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


def check_scales_tensor(name, k_pool, scales):
    """An int8 pool's ``scales``: f32 ``[P, KV, 2]`` on the pool's device."""
    P, KV = k_pool.shape[:2]
    if k_pool.dtype != torch.int8:
        raise TypeError(f"{name}: scales given for a {k_pool.dtype} pool (int8 only)")
    if tuple(scales.shape) != (P, KV, 2) or scales.dtype != torch.float32:
        raise ValueError(
            f"{name}: scales must be float32 [P={P}, KV={KV}, 2]; got "
            f"{scales.dtype} {tuple(scales.shape)}"
        )


def paged_decode_attention_ref(q, k_pool, v_pool, block_tables, pos,
                               sm_scale: Optional[float] = None, scales=None):
    """Plain PyTorch paged decode attention → ``[B, H, D]`` in ``q.dtype``;
    scores, softmax and the probability-weighted sum in f32 (an int8 pool
    dequantized to f32 through ``scales`` first)."""
    from .attention import gather_pool_pages

    _check_shapes(q, k_pool, v_pool, block_tables, pos)
    if scales is not None:
        check_scales_tensor("paged_decode_attention_ref", k_pool, scales)
    B, H, D = q.shape
    KV = k_pool.shape[1]
    kd, vd = gather_pool_pages(k_pool, v_pool, block_tables, scales)  # [B,n,KV,page,D]
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


def paged_decode_attention_split_ref(q, k_pool, v_pool, block_tables, pos, chunk: int,
                                     sm_scale: Optional[float] = None, scales=None):
    """Plain PyTorch of the kernel's split computation → ``[B, H, D]`` in
    ``q.dtype``: each slot's live rows ``0..min(pos, n * page - 1)`` in
    chunks of ``chunk`` rows (a multiple of the page), each chunk's ``(m,
    l, acc)`` in f32 over its pages alone (an int8 pool's K scale applied
    to the score, its V scale to the probability), the live chunks merged
    in chunk order by :func:`merge_partials`; a slot with no live row gets
    zeros."""
    _check_shapes(q, k_pool, v_pool, block_tables, pos)
    if scales is not None:
        check_scales_tensor("paged_decode_attention_split_ref", k_pool, scales)
    B, H, D = q.shape
    P, KV, page, _ = k_pool.shape
    n = block_tables.shape[1]
    if chunk <= 0 or chunk % page:
        raise ValueError(f"chunk {chunk} must be a positive multiple of the page {page}")
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    rep = H // KV
    out = torch.zeros(B, H, D, dtype=torch.float32, device=q.device)
    for b in range(B):
        n_rows = max(0, min(int(pos[b]), n * page - 1) + 1)
        qg = q[b].reshape(KV, rep, D).float()
        ms, ls, accs = [], [], []
        for r0 in range(0, n_rows, chunk):
            r1 = min(r0 + chunk, n_rows)
            pages = block_tables[b, r0 // page:(r1 + page - 1) // page].long().clamp(0, P - 1)
            kc = k_pool[pages].float().transpose(0, 1).reshape(KV, -1, D)[:, :r1 - r0]
            vc = v_pool[pages].float().transpose(0, 1).reshape(KV, -1, D)[:, :r1 - r0]
            s = torch.einsum("grd,gsd->grs", qg, kc) * scale
            pv = torch.ones_like(s)
            if scales is not None:
                sc = scales[pages].float().repeat_interleave(page, 0)[:r1 - r0]  # [rows, KV, 2]
                s = s * sc[:, :, 0].t()[:, None, :]
                pv = sc[:, :, 1].t()[:, None, :].expand_as(s)
            m = s.amax(-1)
            p = torch.exp(s - m[..., None])
            ms.append(m)
            ls.append(p.sum(-1))
            accs.append(torch.einsum("grs,gsd->grd", p * pv, vc))
        if ms:
            out[b] = merge_partials(torch.stack(ms, -1), torch.stack(ls, -1),
                                    torch.stack(accs, -2)).reshape(H, D)
    return out.to(q.dtype)


def paged_decode_attention(q, k_pool, v_pool, block_tables, pos,
                           sm_scale: Optional[float] = None, scales=None):
    """Launch the CUDA kernel on ``torch.cuda.current_stream()`` → a new
    ``[B, H, D]`` tensor in ``q.dtype``. Every operand must be a contiguous
    tensor on one CUDA device: q float32, float16 or bfloat16, the pools one
    of those or int8 (then with ``scales [P, KV, 2]`` float32),
    ``block_tables [B, n]`` and ``pos [B]`` int32; the page a multiple of 4
    rows. Raises on anything else. ``pos`` is never read on the host."""
    _check_shapes(q, k_pool, v_pool, block_tables, pos)
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
               "block_tables": block_tables, "pos": pos}
    if scales is not None:
        check_scales_tensor("paged_decode_attention", k_pool, scales)
        tensors["scales"] = scales
    elif k_pool.dtype == torch.int8:
        raise ValueError("paged_decode_attention: an int8 pool needs its scales")
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(
                f"paged_decode_attention: {name} is on {t.device}, expected "
                "every operand on the one CUDA device of q"
            )
        if not t.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be contiguous")
    if q.dtype not in DTYPE_CODES or k_pool.dtype not in KV_DTYPE_CODES:
        raise TypeError(
            f"paged_decode_attention: q {q.dtype} must be float32, float16 or "
            f"bfloat16 and the pools {k_pool.dtype} one of those or int8"
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
    if not PAGE_RANGE[0] <= page <= PAGE_RANGE[1] or page % PAGE_MULTIPLE:
        raise ValueError(f"paged_decode_attention: page {page} outside {PAGE_RANGE} or not a "
                         f"multiple of {PAGE_MULTIPLE}")
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
    G, W, splits, chunk = kernel_plan(B, H, KV, D, k_pool.element_size(), page, n,
                                      _sm_count(q.device))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scratch = split_scratch(q.device, stream, B, H, splits, D, G) if splits > 1 else (None,) * 3
    err = lib.paged_decode_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), pos.data_ptr(),
        scales.data_ptr() if scales is not None else None, out.data_ptr(), *scratch,
        B, H, KV, P, page, n, D, splits, chunk, G, W, ctypes.c_float(scale),
        DTYPE_CODES[q.dtype], KV_DTYPE_CODES[k_pool.dtype], stream,
    )
    if err != 0:
        raise RuntimeError(f"paged_decode_attention: kernel launch failed, CUDA error {err}")
    LAUNCHES[KERNELS[scales is not None]] += 1
    return out
