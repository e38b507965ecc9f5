"""JAX's dropout through the threefry kernel (``csrc/threefry.cu``), with
its plain version.

:func:`dropout` is ``where(bernoulli(key, 1 - rate, x.shape), x / (1 -
rate), 0)``, the JAX package's GPT-2 ``_dropout``
(``deepspeed_tpu/models/gpt2.py:251-256``) bit for bit. ``1 - rate`` is
rounded to x's dtype before the division (jax's weak Python float), and the
keep test is ``uniform < f32(1 - rate)``. A ``torch.autograd.Function``
whose backward is the same draw applied to ``dy`` (the VJP of
``where(keep, x / c, 0)`` is ``where(keep, dy / c, 0)``): the mask is
recomputed from the key, never stored, so remat's recomputation gives the
same mask by construction.

CUDA tensors go to the kernel (``ops/prng.py`` :func:`~.prng.dropout_kernel`,
counted in ``ops/launches.py``'s ``LAUNCHES["threefry_dropout"]``, one launch
for a forward and one for a backward), which launches or raises; CPU tensors
to the plain version; any other device raises.

The key is a device key (an int32 ``[2]`` tensor of the key's bits, read
where it lies: a training step's key table slot, which a captured step
refills every step) or a host key (copied up at each call). A ``[4]`` key
(``prng.shard_key``) adds a shard index s: x is then elements ``[s n, (s +
1) n)`` of the draw, the slice a data-parallel rank holds of JAX's draw
over the global batch (``jax_threefry_partitionable``: element i's counter
is its flat index in the global shape).
"""

from __future__ import annotations

import torch

from . import prng


def dropout_ref(x: torch.Tensor, key, rate: float) -> torch.Tensor:
    """The plain version: torch ops on x's device, the divisor a tensor of
    x's dtype there (a CPU scalar would let the card multiply by its
    reciprocal instead); a device key is widened there, never read on the
    host."""
    p, c = prng.keep_scale(prng.check_rate(rate), x.dtype)
    if not prng.is_device_key(key):
        key = prng.device_keys(prng.host_dropout_key(key), x.device)
    key = key.reshape(-1)
    offset = prng.shard_offset(key.to(x.device), x.numel()) if key.numel() == 4 else None
    row = key[:2].reshape(1, 2)
    u = prng.uniform_rows_ref(row, x.numel(), device=x.device, offset=offset)
    keep = u.reshape(x.shape) < prng.device_scalar(p, x.device)
    return torch.where(keep, x / prng.device_scalar(c, x.device, x.dtype),
                       prng.device_scalar(0.0, x.device, x.dtype))


def _apply(x: torch.Tensor, key, rate: float) -> torch.Tensor:
    if x.device.type == "cuda":
        return prng.dropout_kernel(x.contiguous(), key, rate)
    if x.device.type == "cpu":
        return dropout_ref(x, key, rate)
    raise ValueError(f"dropout: no implementation for device {x.device}")


class _Dropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, key, rate):
        ctx.key, ctx.rate = key, rate
        return _apply(x, key, rate)

    @staticmethod
    def backward(ctx, dy):
        return _apply(dy, ctx.key, ctx.rate), None, None


def dropout(x: torch.Tensor, key, rate: float) -> torch.Tensor:
    """JAX's dropout of ``x`` under ``key`` (one ``[2]`` key: a device key,
    or a host key as numpy or an int64 tensor) at ``rate``, differentiable;
    the kernel on the card."""
    if not prng.is_device_key(key):
        key = prng.host_dropout_key(key)
    return _Dropout.apply(x, key, float(rate))
