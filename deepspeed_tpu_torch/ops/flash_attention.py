"""Flash attention: the CUDA kernels' wrappers, their plain versions and the
autograd Function that ties them together.

Counterpart of ``deepspeed_tpu/ops/pallas/flash_attention.py``. The
kernels (``csrc/flash_attention_fwd.cu``, ``csrc/flash_attention_bwd.cu``)
replace the Pallas forward (``_fwd_kernel`` / ``_fwd_grid_kernel``) and
backward (``_bwd_fused_kernel``, ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``
and their grid variants): one forward and one backward entry serve every
sequence length, because Hopper streams K/V through shared memory where
the TPU had to choose between VMEM-resident and grid-blocked variants.

Layout: q ``[B, S, H, D]``, k/v ``[B, S, KV, D]`` with ``H % KV == 0``
(GQA), any batch / sequence / head strides with a contiguous last dim (so
q, k and v may be views of the ``[B, S, 3E]`` qkv projection); lse and
delta ``[B, H, S]`` f32 (the TPU's 128-lane broadcast is gone).

The precision contract is the JAX kernels': scores from storage-dtype
operands with an f32 accumulator, ``sm_scale`` applied to the f32 scores,
masked scores -1e30 (key j kept for query i iff ``j <= i`` and, under a
window w > 0, ``j > i - w``), P rounded to the storage dtype before PV,
``l`` clamped at 1e-30, ``lse = m + log l``; backward ``p = exp(s - lse)``,
``ds = p (dp - delta)`` rounded to the storage dtype before dq = ds K and
dk = dsᵀ Q, dq and dk scaled once, dk/dv summed over the GQA group with one
rounding. The plain versions :func:`flash_attention_fwd_ref` /
:func:`flash_attention_bwd_ref` compute the same formulas with whole
``[S, S]`` score matrices.

:func:`flash_attention` (and ``ops.attention.causal_attention``) run the
kernels for CUDA tensors and the plain versions for CPU tensors, inside
one ``torch.autograd.Function``; a CUDA tensor never reaches a plain
version.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .launches import LAUNCHES, register

# its launches in the registry, per wrapper (the main path's proof that it
# ran here)
KERNELS = register("flash_attention_fwd", "flash_attention_bwd")

HEAD_DIMS = (64, 128, 256)
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# the JAX kernels' tile (BQ = BK): flash_attention keeps its S % 128 rule
BLOCK = 128
# the kernels' TMA/wgmma path (the rest: mma.sync at D256, FMA at fp32)
TMA_DTYPES = (torch.float16, torch.bfloat16)
TMA_HEAD_DIMS = (64, 128)


def validate_kv_heads(H: int, k, v) -> int:
    """K/V head counts must match and divide the q head count → H // KV."""
    KV = k.shape[-2]
    if v.shape[-2] != KV or H % KV != 0:
        raise ValueError(
            f"kv heads ({KV}/{v.shape[-2]}) must match and divide q heads ({H})"
        )
    return H // KV


def _window(causal: bool, window) -> int:
    """The window as the kernels take it: 0 = global."""
    w = 0 if window is None else int(window)
    if w > 0 and not causal:
        raise ValueError("window requires causal attention")
    return max(w, 0)


def _scale(D: int, sm_scale: Optional[float]) -> float:
    return float(sm_scale) if sm_scale is not None else 1.0 / (D ** 0.5)


def _keep(S: int, causal: bool, window: int, device) -> torch.Tensor:
    """``[S, S]`` bool: key j visible to query i."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    if not causal:
        return torch.ones(S, S, dtype=torch.bool, device=device)
    keep = j <= i
    if window > 0:
        keep = keep & (j > i - window)
    return keep


def _heads(x, rep: int):
    """``[B, S, KV, D]`` → ``[B, S, KV * rep, D]`` f32, head h reading kv
    head h // rep (the plain versions materialise the repeat)."""
    return x.float().repeat_interleave(rep, dim=2) if rep > 1 else x.float()


def _scores(q, k, rep, causal, window, scale):
    """Masked scaled scores ``[B, H, S, S]`` f32."""
    S = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), _heads(k, rep)) * scale
    return s.masked_fill(~_keep(S, causal, window, q.device), -1e30)


def flash_attention_fwd_ref(q, k, v, causal: bool = True, sm_scale: Optional[float] = None,
                            window=None):
    """Plain PyTorch forward → ``(o [B, S, H, D] in q.dtype, lse [B, H, S]
    f32)``."""
    B, S, H, D = q.shape
    rep = validate_kv_heads(H, k, v)
    w = _window(causal, window)
    s = _scores(q, k, rep, causal, w, _scale(D, sm_scale))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), _heads(v, rep))
    o = o / l.permute(0, 2, 1, 3)
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal: bool = True,
                            sm_scale: Optional[float] = None, window=None):
    """Plain PyTorch backward → ``(dq, dk, dv)`` in q/k/v's dtypes, from
    the saved ``o`` and ``lse`` by the kernels' recompute formula."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    rep = validate_kv_heads(H, k, v)
    w = _window(causal, window)
    scale = _scale(D, sm_scale)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1)  # [B, H, S]
    p = torch.exp(_scores(q, k, rep, causal, w, scale) - lse[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), _heads(v, rep))
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, _heads(k, rep)) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    # per-q-head grads summed over the GQA group in f32, rounded once
    dk = dk.reshape(B, S, KV, rep, D).sum(3)
    dv = dv.reshape(B, S, KV, rep, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

def _strides_ok(t) -> bool:
    vec = 16 // t.element_size()
    return (t.stride(-1) == 1 and all(s % vec == 0 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def _check(name, tensors, device, dtype):
    for what, t in tensors.items():
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(
                f"{name}: {what} is on {t.device}, expected every operand on the one "
                "CUDA device of q"
            )
        if t.dtype != dtype:
            raise TypeError(f"{name}: {what} is {t.dtype}, expected q's dtype {dtype}")
        if not _strides_ok(t):
            raise ValueError(
                f"{name}: {what} needs a contiguous last dim, 16-byte aligned data and "
                f"strides that are multiples of 16 bytes; got strides {t.stride()}"
            )


def _check_shapes(name, q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: expected q [B,S,H,D] and k/v [B,S,KV,D]")
    B, S, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[1] != S or k.shape[3] != D:
        raise ValueError(
            f"{name}: k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}"
        )
    validate_kv_heads(H, k, v)
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: q is {q.dtype}; the kernel takes float32, float16, bfloat16")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not in {HEAD_DIMS}")


def _tma_strides_ok(t) -> bool:
    """The batch, sequence and head strides a TMA tensor map takes: positive
    and under 2^40 bytes."""
    return all(0 < st and st * t.element_size() < 1 << 40 for st in t.stride()[:3])


def _check_tma(name, tensors):
    """At bf16/fp16 and D 64/128 both kernels read their operands through
    TMA tensor maps (:func:`_tma_strides_ok`)."""
    q = tensors["q"]
    if q.dtype not in TMA_DTYPES or q.shape[-1] not in TMA_HEAD_DIMS:
        return
    for what, t in tensors.items():
        if not _tma_strides_ok(t):
            raise ValueError(
                f"{name}: {what} strides {t.stride()} cannot make a TMA tensor map: "
                "the batch, sequence and head strides must be positive and under 2^40 bytes"
            )


def _strides3(t):
    return [t.stride(0), t.stride(1), t.stride(2)]


def flash_attention_fwd(q, k, v, causal: bool = True, sm_scale: Optional[float] = None,
                        window=None):
    """Launch the forward kernel on ``torch.cuda.current_stream()`` → ``(o
    [B, S, H, D] contiguous in q.dtype, lse [B, H, S] f32)``. Raises on what
    the kernel does not take (device, dtype, head dim, strides; at bf16/fp16
    and D 64/128 the inputs are read through TMA tensor maps, which also
    need positive batch, sequence and head strides)."""
    name = "flash_attention_fwd"
    _check_shapes(name, q, k, v)
    tensors = {"q": q, "k": k, "v": v}
    _check(name, tensors, q.device, q.dtype)
    B, S, H, D = q.shape
    _check_tma(name, tensors)
    w = _window(causal, window)
    o = torch.empty(B, S, H, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    if B == 0 or S == 0:
        return o, lse
    from .op_builder import load

    lib = load("flash_attention_fwd")
    err = lib.flash_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, S, H, k.shape[2], D, *_strides3(q), *_strides3(k), *_strides3(v), *_strides3(o),
        int(bool(causal)), w, ctypes.c_float(_scale(D, sm_scale)), DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {err}")
    LAUNCHES[name] += 1
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        sm_scale: Optional[float] = None, window=None):
    """Launch the backward kernels (delta, dk/dv, dq: one C entry) on
    ``torch.cuda.current_stream()`` → ``(dq [B, S, H, D], dk, dv [B, S, KV,
    D])`` contiguous, in q's dtype. ``lse`` is the forward's ``[B, H, S]``
    f32. Raises on what the kernels do not take (as the forward; at
    bf16/fp16 and D 64/128 q, k, v and dO are read through TMA tensor
    maps)."""
    name = "flash_attention_bwd"
    _check_shapes(name, q, k, v)
    tensors = {"q": q, "k": k, "v": v, "o": o, "do": do}
    _check(name, tensors, q.device, q.dtype)
    B, S, H, D = q.shape
    KV = k.shape[2]
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"{name}: o {tuple(o.shape)} / do {tuple(do.shape)} must be q's shape")
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, S) or not lse.is_contiguous()
            or lse.device != q.device):
        raise ValueError(f"{name}: lse must be a contiguous [B, H, S] float32 tensor on q's device")
    _check_tma(name, tensors)
    w = _window(causal, window)
    dq = torch.empty(B, S, H, D, dtype=q.dtype, device=q.device)
    dk = torch.empty(B, S, KV, D, dtype=q.dtype, device=q.device)
    dv = torch.empty(B, S, KV, D, dtype=q.dtype, device=q.device)
    if B == 0 or S == 0:
        return dq, dk, dv
    # delta's scratch: [B, H, S] on the fp32 and D256 paths; [B, H, 2, Sp]
    # (lse in log2 units beside delta, Sp = S rounded up to 4) on the TMA path
    delta = torch.empty(B * H * 2 * (-(-S // 4) * 4), dtype=torch.float32, device=q.device)
    from .op_builder import load

    lib = load("flash_attention_bwd")
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, S, H, KV, D, *_strides3(q), *_strides3(k), *_strides3(v), *_strides3(o),
        *_strides3(do), int(bool(causal)), w, ctypes.c_float(_scale(D, sm_scale)),
        DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {err}")
    LAUNCHES[name] += 1
    return dq, dk, dv


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

def _on(device, kernel, plain, what):
    if device.type == "cuda":
        return kernel
    if device.type == "cpu":
        return plain
    raise ValueError(f"flash attention {what}: no implementation for device {device}")


def forward_backward(device):
    """``(forward, backward)`` for tensors on ``device``: the kernels for
    CUDA, the plain versions for the CPU; any other device raises."""
    return (_on(device, flash_attention_fwd, flash_attention_fwd_ref, "forward"),
            _on(device, flash_attention_bwd, flash_attention_bwd_ref, "backward"))


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v); saves ``(q, k, v, o, lse)``. CUDA tensors run
    the kernels, CPU tensors their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, window):
        fwd = _on(q.device, flash_attention_fwd, flash_attention_fwd_ref, "forward")
        o, lse = fwd(q, k, v, causal, sm_scale, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = (causal, sm_scale, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = _on(q.device, flash_attention_bwd, flash_attention_bwd_ref, "backward")
        if do.device.type == "cuda" and (not _strides_ok(do) or min(do.stride()[:3]) <= 0):
            do = do.contiguous()  # the layout the kernel reads, not another route
        dq, dk, dv = bwd(q, k, v, o, lse, do, *ctx.opts)
        return dq, dk, dv, None, None, None


def flash(q, k, v, causal: bool = True, sm_scale: Optional[float] = None, window=None):
    """The autograd Function without :func:`flash_attention`'s S % 128 rule:
    the kernels mask a ragged edge themselves."""
    validate_kv_heads(q.shape[2], k, v)
    if window is not None and not causal:
        raise ValueError("window requires causal attention")
    return FlashAttention.apply(q, k, v, bool(causal), sm_scale, window)


def flash_attention(q, k, v, causal: bool = True, sm_scale: Optional[float] = None,
                    window=None):
    """``[B, S, H, D]`` flash attention (causal by default) with the JAX
    entry's checks: kv heads divide q heads, S is a multiple of 128, a
    window requires ``causal``."""
    S = q.shape[1]
    validate_kv_heads(q.shape[2], k, v)
    if S % BLOCK != 0:
        raise ValueError(f"seq {S} must be a multiple of {BLOCK}/{BLOCK}")
    return flash(q, k, v, causal, sm_scale, window)
