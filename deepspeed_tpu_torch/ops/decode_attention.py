"""Decode attention against a contiguous KV cache: the CUDA kernel's wrapper
and its plain version.

The kernel (``csrc/decode_attention.cu``) replaces the Pallas kernel
``deepspeed_tpu/ops/pallas/decode_attention.py`` ``decode_attention`` (body
``_decode_kernel``): one query token per (batch, head) attends rows
``0..pos`` of its ``[Smax, KV, D]`` cache (one ``pos`` for the batch),
online softmax in f32; rows past ``pos`` are never read. Offline
``generate`` runs it once per layer and decode step.

:func:`decode_attention_ref` is the plain PyTorch version (the grouped
einsum with the mask ``s <= pos`` and f32 probabilities, as the JAX
package's jnp fallback of ``cached_attention`` computes it). The dispatcher
``ops.attention.cached_attention`` uses it for CPU tensors; for CUDA tensors
it calls :func:`decode_attention`, which launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .paged_decode_attention import DTYPE_CODES, HEAD_DIMS

# kernel launches by this process (the main path's proof that it ran here)
LAUNCHES = 0


def _check_shapes(q, k_cache, v_cache):
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(
            f"expected q [B,H,D] and caches [B,Smax,KV,D]; got {tuple(q.shape)}, "
            f"{tuple(k_cache.shape)}"
        )
    B, H, D = q.shape
    Bk, S, KV, Dk = k_cache.shape
    if v_cache.shape != k_cache.shape or Bk != B or Dk != D:
        raise ValueError(
            f"cache shapes {tuple(k_cache.shape)}/{tuple(v_cache.shape)} do not "
            f"match q {tuple(q.shape)}"
        )
    if H % KV != 0:
        raise ValueError(f"q heads {H} must divide by KV heads {KV}")


def decode_attention_ref(q, k_cache, v_cache, pos: int, sm_scale: Optional[float] = None):
    """Plain PyTorch decode attention → ``[B, H, D]`` in ``q.dtype``;
    scores, softmax and the probability-weighted sum in f32, keys past
    ``pos`` masked (their contents never reach the output)."""
    _check_shapes(q, k_cache, v_cache)
    B, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    mask = torch.arange(S, device=q.device) <= int(pos)  # [S]
    qg = q.reshape(B, KV, H // KV, D)
    scores = torch.einsum("bgrd,bsgd->bgrs", qg.float(), k_cache.float()) * scale
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bgrs,bsgd->bgrd", probs, v_cache.float())
    return o.reshape(B, H, D).to(q.dtype)


def decode_attention(q, k_cache, v_cache, pos: int, sm_scale: Optional[float] = None):
    """Launch the CUDA kernel on ``torch.cuda.current_stream()`` → a new
    ``[B, H, D]`` tensor in ``q.dtype``. q contiguous, the caches any
    strides with a unit-stride head dim and 16-byte aligned rows, all on
    one CUDA device, float32, float16 or bfloat16 (the caches one dtype);
    ``pos`` a Python int, ``pos >= 0`` (past ``Smax - 1`` it means every
    row). Raises on anything else."""
    global LAUNCHES
    _check_shapes(q, k_cache, v_cache)
    tensors = {"q": q, "k_cache": k_cache, "v_cache": v_cache}
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(
                f"decode_attention: {name} is on {t.device}, expected every "
                "operand on the one CUDA device of q"
            )
    if not q.is_contiguous():
        raise ValueError("decode_attention: q must be contiguous")
    if q.dtype not in DTYPE_CODES or k_cache.dtype not in DTYPE_CODES:
        raise TypeError(
            f"decode_attention: q {q.dtype} / caches {k_cache.dtype} must be "
            "float32, float16 or bfloat16"
        )
    if v_cache.dtype != k_cache.dtype:
        raise TypeError(f"k_cache {k_cache.dtype} and v_cache {v_cache.dtype} differ")
    B, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {D} not in {HEAD_DIMS}")
    if isinstance(pos, torch.Tensor):
        raise TypeError("decode_attention: pos must be a Python int (no device read per call)")
    pos = int(pos)
    if pos < 0:
        raise ValueError(f"decode_attention: pos {pos} < 0")
    item = k_cache.element_size()
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.stride(3) != 1:
            raise ValueError(f"decode_attention: {name} head dim must be unit-stride")
        if t.data_ptr() % 16 or any(st * item % 16 for st in t.stride()[:3]):
            raise ValueError(f"decode_attention: {name} rows are not 16-byte aligned")
    if q.data_ptr() % 16:
        raise ValueError("decode_attention: q is not 16-byte aligned")
    out = torch.empty_like(q)
    if B == 0:
        return out
    from .op_builder import load

    lib = load("decode_attention")
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    err = lib.decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        B, S, H, KV, D, pos, *k_cache.stride()[:3], *v_cache.stride()[:3],
        ctypes.c_float(scale), DTYPE_CODES[q.dtype], DTYPE_CODES[k_cache.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"decode_attention: kernel launch failed, CUDA error {err}")
    LAUNCHES += 1
    return out
