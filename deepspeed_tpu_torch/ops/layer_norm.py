"""Layer norm with fp32 statistics (counterpart of
``deepspeed_tpu/ops/layer_norm.py``): mean and variance are taken in fp32
whatever the activation dtype, and the result is cast back to it."""

from __future__ import annotations

import torch


def layer_norm(x, scale, bias, eps):
    xf = x.float()
    m = xf.mean(dim=-1, keepdim=True)
    v = (xf - m).square().mean(dim=-1, keepdim=True)
    y = (xf - m) * torch.rsqrt(v + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)
