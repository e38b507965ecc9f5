"""Activation checkpointing (counterpart of
``deepspeed_tpu/runtime/activation_checkpointing``): the "full" policy,
which saves a block's input and recomputes the whole block in backward,
as ``torch.utils.checkpoint`` without reentrancy. The selective policies
("dots", "attn"), partitioned and CPU checkpointing are not ported yet."""

from __future__ import annotations

import torch.utils.checkpoint


def checkpoint(fn, *args):
    """``fn(*args)`` whose activations are recomputed in backward."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
