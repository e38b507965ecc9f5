"""deepspeed_tpu_torch: the PyTorch/CUDA port of deepspeed_tpu.

A second package beside the JAX one, for NVIDIA Hopper (H100). What is
ported so far is GPT-2 continuous-batching serving on one card: the paged
KV pool, the scheduler and the serving programs, with the decode step's
paged attention as a hand-written CUDA kernel (``csrc/``, built at first
use). It imports torch, numpy and the standard library, and nothing of JAX
or of ``deepspeed_tpu``.

Entry point: :func:`init_inference`, then ``.serve()``.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

from .inference.engine import InferenceEngine
from .models.gpt2 import GPT2Config, get_config


def init_inference(model_config: Union[GPT2Config, str] = "gpt2",
                   params=None, dtype=None, device=None, seed: int = 0,
                   config: Optional[Dict] = None) -> InferenceEngine:
    """Build an :class:`InferenceEngine` (counterpart of
    ``deepspeed_tpu.init_inference``): GPT-2 weights from ``params`` (a
    nested dict of tensors in the JAX package's layout) or the seeded
    initialiser, cast to ``dtype`` (bf16 by default) on ``device``
    (default the CUDA card; raises when there is none)."""
    return InferenceEngine(model_config, params=params, dtype=dtype,
                           device=device, seed=seed, config=config)


__all__ = ["InferenceEngine", "GPT2Config", "get_config", "init_inference"]
