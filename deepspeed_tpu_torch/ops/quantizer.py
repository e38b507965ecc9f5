"""The int8 KV page codec (counterpart of the KV-page part of
``deepspeed_tpu/ops/quantizer.py`` and of the int8 block rule of
``deepspeed_tpu/comm/compressed.py``).

One symmetric block scale per (page, kv head): ``scale = amax / 127``
(a block of zeros gets scale 1, so its codes are exactly 0), codes
``round_half_even(x / scale)`` clipped to ±127, every step in f32. The
serving pools keep the scales beside the codes (``serving/kv_cache.py``
``init_pools``), ``[L, P, KV, 2]`` f32 with K at index 0 and V at 1; a
fresh pool's scale is 0, so a never-written page dequantizes to zeros.

Weight-only int8 (``quantize``, ``quantize_tree``, ``maybe_dequantize``)
and the general block codec of ``comm/compressed.py`` (a short tail
block, ``dequantize_blocks``) are not ported yet: the KV pages need
neither.
"""

from __future__ import annotations

from typing import Tuple

import torch

INT8_QMAX = 127.0


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
    return torch.where(amax > 0, amax / INT8_QMAX, torch.ones_like(amax))


def quantize_kv_token(values: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Code one token's ``[..., D]`` slab against its page's frozen
    ``scale [...]`` (values past it saturate at ±127): the one place the
    round-half-even and clip rule lives."""
    y = values.float() / scale[..., None]
    return torch.round(y).clamp(-INT8_QMAX, INT8_QMAX).to(torch.int8)
