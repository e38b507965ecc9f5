"""Layer norm and RMSNorm with fp32 statistics (counterpart of
``deepspeed_tpu/ops/layer_norm.py``): the statistics are taken in fp32
whatever the activation dtype, and the result is cast back to it."""

from __future__ import annotations

import torch


def layer_norm(x, scale, bias, eps):
    xf = x.float()
    m = xf.mean(dim=-1, keepdim=True)
    v = (xf - m).square().mean(dim=-1, keepdim=True)
    y = (xf - m) * torch.rsqrt(v + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def rms_norm(x, scale, eps):
    """RMSNorm (no mean subtraction, no bias) with fp32 statistics: the
    LLaMA-family normalisation."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)
