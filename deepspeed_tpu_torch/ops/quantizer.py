"""Group-wise int8 weight quantization and the int8 KV page codec
(counterpart of ``deepspeed_tpu/ops/quantizer.py`` and of the int8 block
rule of ``deepspeed_tpu/comm/compressed.py``).

One symmetric block scale per (page, kv head): ``scale = amax / 127``
(a block of zeros gets scale 1, so its codes are exactly 0), codes
``round_half_even(x / scale)`` clipped to ±127, every step in f32. The
serving pools keep the scales beside the codes (``serving/kv_cache.py``
``init_pools``), ``[L, P, KV, 2]`` f32 with K at index 0 and V at 1; a
fresh pool's scale is 0, so a never-written page dequantizes to zeros.

Weight-only int8 (``init_inference(dtype="int8")``): a weight ``w [...,
I, O]`` is cut into G groups along its input dimension, ``q [..., G, I/G,
O]`` int8 with one scale per (group, output channel) ``[..., G, 1, O]``
stored in the compute dtype. Round-to-nearest goes through the same block
rule as the KV pages (:func:`kv_page_scale`, :func:`quantize_kv_token`:
amax / 127, round-half-even, clip ±127), so the module has one codec, as
the JAX package has; ``key=`` gives stochastic rounding ``floor(x + u)``
with the JAX draw (``ops/prng.py``). The models call
:func:`maybe_dequantize` at every weight use: the codes times the
bf16-rounded scale in f32, cast to the compute dtype, a transient per use
(no dequantized copy of the tree is kept). The general block codec of
``comm/compressed.py`` (a short tail block, ``dequantize_blocks``) is not
ported: nothing here needs it.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from . import prng

INT8_QMAX = 127.0

PyTree = Any


class QuantizedWeight(NamedTuple):
    """int8 weight + per-group scales."""

    q: torch.Tensor      # [..., G, I/G, O] int8
    scale: torch.Tensor  # [..., G, 1, O] float


class AsymQuantizedWeight(NamedTuple):
    """Asymmetric variant: codes 0..255 biased by -128, per-group scale and
    zero point (the real value of code -128)."""

    q: torch.Tensor           # [..., G, I/G, O] int8
    scale: torch.Tensor       # [..., G, 1, O] float
    zero_point: torch.Tensor  # [..., G, 1, O] float


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A divisor as an f32 tensor on ``like``'s device (cached there, no
    copy a call): divided by a CPU scalar, the card would multiply by its
    reciprocal, and its scales and codes would part from the CPU's (and
    JAX's) in the last bit."""
    return prng.device_scalar(value, like.device)


def _round(x: torch.Tensor, key) -> torch.Tensor:
    """Round-half-even, or with ``key`` stochastic rounding ``floor(x +
    u)``, u the JAX ``uniform(key, x.shape)`` (unbiased: E = x)."""
    if key is None:
        return torch.round(x)
    return torch.floor(x + prng.uniform(key, x.shape, device=x.device))


def _grouped(w: torch.Tensor, groups: int) -> torch.Tensor:
    """``w [..., I, O]`` → f32 ``[..., g, I/g, O]``, g the largest divisor
    of I not above ``groups``."""
    *lead, I, O = w.shape
    g = min(int(groups), I)
    while I % g:
        g -= 1
    return w.reshape(*lead, g, I // g, O).float()


def quantize(w: torch.Tensor, groups: int = 64, scale_dtype: torch.dtype = torch.bfloat16,
             key=None) -> QuantizedWeight:
    """Symmetric group int8 of ``w [..., I, O]``; stochastic rounding when
    ``key`` is given. Round-to-nearest codes each (group, output channel)
    column as one block of the codec."""
    wg = _grouped(w, groups)
    if key is None:
        wt = wg.transpose(-1, -2)  # [..., G, O, I/G]: a group's elements last
        scale = kv_page_scale(wt)  # [..., G, O]
        q = quantize_kv_token(wt, scale)
        return QuantizedWeight(q=q.transpose(-1, -2).contiguous(),
                               scale=scale[..., None, :].to(scale_dtype))
    amax = wg.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax / _const(INT8_QMAX, amax), torch.ones_like(amax))
    q = _round(wg / scale, key).clamp(-INT8_QMAX, INT8_QMAX).to(torch.int8)
    return QuantizedWeight(q=q, scale=scale.to(scale_dtype))


def quantize_asym(w: torch.Tensor, groups: int = 64, scale_dtype: torch.dtype = torch.bfloat16,
                  key=None) -> AsymQuantizedWeight:
    """Asymmetric group int8: the codes span [min, max] of each group."""
    wg = _grouped(w, groups)
    lo = wg.amin(dim=-2, keepdim=True)
    hi = wg.amax(dim=-2, keepdim=True)
    scale = torch.where(hi > lo, (hi - lo) / _const(255.0, hi), torch.ones_like(hi))
    q = _round((wg - lo) / scale, key).clamp(0, 255) - 128
    return AsymQuantizedWeight(q=q.to(torch.int8), scale=scale.to(scale_dtype),
                               zero_point=lo.to(scale_dtype))


def dequantize(qw: QuantizedWeight, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q * scale`` in f32 → ``[..., I, O]`` in ``dtype``."""
    *lead, g, gsz, O = qw.q.shape
    w = qw.q.float() * qw.scale.float()
    return w.reshape(*lead, g * gsz, O).to(dtype)


def dequantize_asym(qw: AsymQuantizedWeight, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``(q + 128) * scale + zero_point`` in f32 (the product and the sum
    rounded once, as XLA's CPU build contracts them) → ``[..., I, O]``."""
    *lead, g, gsz, O = qw.q.shape
    w = ((qw.q.double() + 128.0) * qw.scale.double() + qw.zero_point.double()).float()
    return w.reshape(*lead, g * gsz, O).to(dtype)


def maybe_dequantize(x, dtype: Optional[torch.dtype] = None):
    """The models' hook at every weight use: tensors pass through,
    quantized weights expand (to ``dtype``, default their scales')."""
    if isinstance(x, QuantizedWeight):
        return dequantize(x, dtype or x.scale.dtype)
    if isinstance(x, AsymQuantizedWeight):
        return dequantize_asym(x, dtype or x.scale.dtype)
    return x


def quantize_tree(params: PyTree, groups: int = 64, dtype: torch.dtype = torch.bfloat16,
                  key=None) -> PyTree:
    """Quantize the float leaves of ndim >= 3 (the stacked ``[L, I, O]``
    block weights); cast the other float leaves to ``dtype``. With ``key``,
    stochastic rounding, a fresh key split off per quantized leaf in the
    JAX tree order (dict keys sorted)."""
    box = [key]

    def visit(x):
        if isinstance(x, dict):
            return {k: visit(x[k]) for k in sorted(x)}
        if torch.is_tensor(x) and x.is_floating_point():
            if x.dim() >= 3:
                leaf_key = None
                if box[0] is not None:
                    box[0], leaf_key = prng.split(box[0])
                return quantize(x, groups=groups, scale_dtype=dtype, key=leaf_key)
            return x.to(dtype)
        return x

    return visit(params)


def quantization_error(w: torch.Tensor, groups: int = 64) -> float:
    """Relative L2 reconstruction error of the round-to-nearest codes."""
    deq = dequantize(quantize(w, groups=groups), torch.float32)
    return float(torch.linalg.vector_norm(deq - w.float())
                 / (torch.linalg.vector_norm(w.float()) + 1e-12))


def quantize_kv_pages(chunks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[..., KV, page, D]`` K/V pages → (int8 codes of the same shape,
    f32 scales ``[..., KV]``): each (page, kv head) slab is one block."""
    scale = kv_page_scale(chunks.flatten(-2))
    return quantize_kv_token(chunks, scale[..., None]), scale


def dequantize_kv_pages(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``codes [..., KV, page, D]`` int8 and ``scales [..., KV]`` → f32."""
    return codes.float() * scales[..., None, None]


def kv_page_scale(values: torch.Tensor) -> torch.Tensor:
    """The codec's scale of ``values [..., n]`` reduced over the last axis
    (the one place the scale rule lives): the token write at a page's offset 0 sets the page's scale with it, and
    the scale then stays frozen while the page fills."""
    amax = values.float().abs().amax(dim=-1)
    return torch.where(amax > 0, amax / _const(INT8_QMAX, amax), torch.ones_like(amax))


def quantize_kv_token(values: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Code one token's ``[..., D]`` slab against its page's frozen
    ``scale [...]`` (values past it saturate at ±127): the one place the
    round-half-even and clip rule lives."""
    y = values.float() / scale[..., None]
    return torch.round(y).clamp(-INT8_QMAX, INT8_QMAX).to(torch.int8)
