"""Paged multi-token attention: the CUDA kernel's wrapper, its launch plan
and its plain versions.

The kernel (``csrc/paged_multitoken_attention.cu``) replaces the Pallas
kernel ``deepspeed_tpu/ops/pallas/decode_attention.py``
``paged_multitoken_attention`` (body ``_paged_multitoken_kernel``): T query
tokens per serving slot, query t at position ``base[b] + t``, attend the
slot's pages of a shared ``[P, KV, page, D]`` pool through its block-table
row, keys past ``base[b] + t`` masked, online softmax in f32. Its int8 mode
dequantizes the pool's codes with the page's per-kv-head f32 scale
(``scales [P, KV, 2]``, gathered by the same table index). Chunked
prefill and prefix-cache tails run it (the chunk's K/V already written:
update-then-attend).

Which kernel a call takes is a rule on shapes alone
(:func:`tensor_core_route`), never a ``try`` that falls back: q in bf16 or
fp16, a pool of q's dtype or int8, head dim 64 or 128 and a page a
multiple of 8 rows run the tensor-core kernel (mma.sync with f32
accumulators, P rounded to q's dtype for P·V as the JAX kernel's bf16 path
does); anything else (fp32 q or pools, D 256, a pool of the other 16-bit
dtype) runs the FMA kernel, which keeps P in f32, so fp32 serving stays
exact against the CPU. On the tensor-core route a unit is 64 query rows of
one (slot, kv head): 64 tokens of one query head, or for T < 64 the T
tokens of several query heads of a GQA group stacked (one K/V read serves
them); :func:`kernel_plan` cuts the table's rows into chunks of whole pages
across blocks from shapes alone (never ``base``, which lives on the
device), and the last block of a unit to finish merges the live chunks in
chunk order (:func:`paged_multitoken_attention_split_ref` is that walk in
plain PyTorch). The chunks' partials and the merge's counters are the
scratch of :func:`~.decode_attention.split_scratch`, kept per stream, so a
call allocates only its output. One device launch a call.

:func:`paged_multitoken_attention_ref` is the plain PyTorch version (gather
the pages, the f32 einsum with the ``[B, T, S]`` mask ``j <= base + t``, as
the JAX package's jnp fallback computes it). The dispatcher
``ops.attention.paged_multitoken_cached_attention`` uses it for CPU tensors;
for CUDA tensors it calls :func:`paged_multitoken_attention`, which launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from .decode_attention import (
    HEADS_PER_BLOCK,
    _sm_count,
    merge_partials,
    plan_splits,
    split_scratch,
)
from .paged_decode_attention import (
    DTYPE_CODES,
    HEAD_DIMS,
    KV_DTYPE_CODES,
    PAGE_RANGE,
    check_scales_tensor,
)
from .launches import LAUNCHES, register

# its launches in the registry (the main path's proof that it ran here):
# full-precision pools, and the int8 mode
KERNELS = register("paged_multitoken_attention", "paged_multitoken_attention_int8")

MAX_T = 1024
# the tensor-core route: query rows of a unit (4 warps x 16), keys of a
# tile of its ring, its q dtypes and head dims, and the page grid (an
# 8-key column tile of the products lies in one page)
UNIT_ROWS = 64
KEY_TILE = 64
TC_DTYPES = (torch.float16, torch.bfloat16)
TC_HEAD_DIMS = (64, 128)
TC_PAGE_MULTIPLE = 8


def tensor_core_route(q, k_pool) -> bool:
    """The kernels' rule on shapes alone: q bf16/fp16, the pools q's dtype or
    int8, head dim 64 or 128, a page a multiple of 8 rows → the tensor-core
    kernel; anything else → the FMA kernel."""
    return (q.dtype in TC_DTYPES and k_pool.dtype in (q.dtype, torch.int8)
            and q.shape[-1] in TC_HEAD_DIMS and k_pool.shape[2] % TC_PAGE_MULTIPLE == 0)


@functools.lru_cache(maxsize=1024)
def kernel_plan(B: int, T: int, H: int, KV: int, page: int, n: int, sm_count: int):
    """The tensor-core kernel's launch for one call → ``(heads, tokens,
    units, splits, chunk)``: a unit is ``tokens`` tokens of ``heads`` query
    heads of one GQA group (``heads * tokens <= 64``: 64 tokens of one head
    when T >= 64, else all T tokens of the largest of 8, 4, 2, 1 heads
    dividing H / KV that fit), ``units`` of them a call; the table's ``n *
    page`` rows cut into ``splits`` chunks of ``chunk`` rows, whole pages
    and whole 64-key tiles (:func:`plan_splits`: about 4 blocks a SM, at
    most 64 chunks). From host-known shapes only (never ``base``)."""
    rep = H // KV
    if T >= UNIT_ROWS:
        heads, tokens = 1, UNIT_ROWS
    else:
        heads = next(g for g in HEADS_PER_BLOCK if rep % g == 0 and g * T <= UNIT_ROWS)
        tokens = T
    units = B * KV * (rep // heads) * -(-T // tokens)
    unit_rows = page * KEY_TILE // math.gcd(page, KEY_TILE)
    splits, chunk = plan_splits(1, units, n * page, sm_count, 1, unit_rows)
    return heads, tokens, units, splits, chunk


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


def _unit_rows(u: int, plan, T: int, H: int, KV: int):
    """Unit ``u`` of ``plan`` (:func:`kernel_plan`) → ``(slot, kv head, first
    token, [(token, query head)] of its live rows)``, the kernel's order."""
    heads, tokens = plan[0], plan[1]
    rep = H // KV
    ntt = -(-T // tokens)
    tt, rest = u % ntt, u // ntt
    hg, rest = rest % (rep // heads), rest // (rep // heads)
    kvh, b = rest % KV, rest // KV
    t0 = tt * tokens
    rows = [(t0 + r % tokens, kvh * rep + hg * heads + r // tokens)
            for r in range(UNIT_ROWS) if r // tokens < heads and t0 + r % tokens < T]
    return b, kvh, t0, rows


def paged_multitoken_attention_split_ref(q, k_pool, v_pool, block_tables, base, plan,
                                         sm_scale: Optional[float] = None, scales=None):
    """Plain PyTorch of the tensor-core kernel's walk → ``[B, T, H, D]`` in
    ``q.dtype``. For each unit of ``plan`` (:func:`kernel_plan`'s ``(heads,
    tokens, units, splits, chunk)``): its rows (token t of a query head of
    the GQA group), its live keys ``0..min(base + t_last, n * page - 1)`` in
    chunks of ``chunk`` rows, each chunk's ``(m, l, acc)`` in f32 over its
    keys alone with key j kept for token t iff ``j <= base + t``, p rounded
    to q's dtype for P·V (an int8 pool's K scale on the score, its V scale
    folded into p and the product taken as two terms rounded to q's dtype,
    the rounding and its remainder), the live chunks merged in chunk order
    by :func:`merge_partials`."""
    _check_shapes(q, k_pool, v_pool, block_tables, base)
    if scales is not None:
        check_scales_tensor("paged_multitoken_attention_split_ref", k_pool, scales)
    B, T, H, D = q.shape
    P, KV, page, _ = k_pool.shape
    rows = block_tables.shape[1] * page
    chunk = plan[4]
    if chunk <= 0 or chunk % page:
        raise ValueError(f"chunk {chunk} must be a positive multiple of the page {page}")
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    out = torch.zeros(B, T, H, D, dtype=torch.float32, device=q.device)
    for u in range(plan[2]):
        b, kvh, t0, unit = _unit_rows(u, plan, T, H, KV)
        if not unit:
            continue
        tok = torch.tensor([r[0] for r in unit], device=q.device)
        head = torch.tensor([r[1] for r in unit], device=q.device)
        b0 = int(base[b])
        last = min(b0 + int(tok.max()), rows - 1)
        qu = q[b, tok, head].float()  # [rows of the unit, D]
        ms, ls, accs = [], [], []
        for c0 in range(0, last + 1, chunk):
            keys = torch.arange(c0, min(c0 + chunk, last + 1), device=q.device)
            pages = block_tables[b, keys // page].long().clamp(0, P - 1)
            kc = k_pool[pages, kvh, keys % page].float()
            vc = v_pool[pages, kvh, keys % page].float()
            s = qu @ kc.T * scale
            if scales is not None:
                s = s * scales[pages, kvh, 0][None]
            s = s.masked_fill(keys[None] > (b0 + tok)[:, None], float("-inf"))
            m = s.amax(-1).clamp_min(-1e30)  # a row with no kept key here: p = 0
            p = torch.exp(s - m[:, None])
            ms.append(m)
            ls.append(p.sum(-1))
            if scales is None:
                pv = p.to(q.dtype).float()
            else:
                x = p * scales[pages, kvh, 1][None]
                hi = x.to(q.dtype).float()
                pv = hi + (x - hi).to(q.dtype).float()
            accs.append(pv @ vc)
        out[b, tok, head] = merge_partials(torch.stack(ms, -1), torch.stack(ls, -1),
                                           torch.stack(accs, -2))
    return out.to(q.dtype)


def paged_multitoken_attention(q, k_pool, v_pool, block_tables, base,
                               sm_scale: Optional[float] = None, scales=None):
    """Launch the CUDA kernel on ``torch.cuda.current_stream()`` → a new
    ``[B, T, H, D]`` tensor in ``q.dtype``: the tensor-core kernel on
    :func:`kernel_plan`'s chunks where :func:`tensor_core_route` says so,
    else the FMA kernel. Every operand must be a contiguous tensor on one
    CUDA device: q float32, float16 or bfloat16, the pools one of those or
    int8 (then with ``scales [P, KV, 2]`` float32), ``block_tables [B, n]``
    and ``base [B]`` int32 (``base >= 0``), ``1 <= T <= 1024``. Raises on
    anything else. ``base`` is never read on the host."""
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
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if tensor_core_route(q, k_pool):
        heads, tokens, units, splits, chunk = kernel_plan(B, T, H, KV, page, n,
                                                          _sm_count(q.device))
        scratch = split_scratch(q.device, stream, 1, units * UNIT_ROWS, splits, D, UNIT_ROWS)
    else:
        heads = tokens = splits = chunk = 0
        scratch = (None,) * 3
    err = lib.paged_multitoken_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), base.data_ptr(),
        scales.data_ptr() if scales is not None else None, out.data_ptr(), *scratch,
        B, T, H, KV, P, page, n, D, heads, tokens, splits, chunk, ctypes.c_float(scale),
        DTYPE_CODES[q.dtype], KV_DTYPE_CODES[k_pool.dtype], stream,
    )
    if err != 0:
        raise RuntimeError(
            f"paged_multitoken_attention: kernel launch failed, CUDA error {err}"
        )
    LAUNCHES[KERNELS[scales is not None]] += 1
    return out
