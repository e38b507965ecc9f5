"""deepspeed_tpu_torch: the PyTorch/CUDA port of deepspeed_tpu.

A second package beside the JAX one, for NVIDIA Hopper (H100). What is
ported so far: GPT-2 continuous-batching serving on one card (the paged KV
pool, the scheduler and the serving programs, with speculation, the prefix
cache, chunked prefill and int8 KV pages), offline GPT-2 generation over a
contiguous KV cache, weight-only int8 inference (``dtype="int8"``), and
training on one card (the single-device engine: bf16/fp16 on an fp32
master, accumulation, clipping, the optimizer family, LR schedules, loss
scaling, remat, dropout) of GPT-2, dense or with block-sparse attention
(a ``sparse_attention`` section), and of BERT pre-training (MLM + NSP,
dense or block-sparse), with checkpoints that load in either package
(the ``resilience`` section's crc manifest), rollback, fault injection
and preemption, and a host-DRAM KV tier for the serving prefix cache.
Sampled tokens, dropout masks and stochastic
rounding draw JAX's threefry bits from JAX's key schedules
(``ops/prng.py``), so they equal the JAX package's. Its kernels are
hand-written CUDA (``csrc/``, built at first use): paged decode and
multi-token attention (each with an int8 mode) for serving, contiguous
decode attention for ``generate``, flash attention forward and backward
and block-sparse attention forward, dq and dk/dv for training, the fused
AdamW/LAMB update, and the threefry dropout and uniform draws. It imports torch, numpy and the standard library, and
nothing of JAX or of ``deepspeed_tpu``.

Entry points: :func:`init_inference`, then ``.serve()``, ``.generate(...)``
or ``engine(batch)``; :func:`initialize`, then ``engine.train_batch(...)``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

from .inference.engine import InferenceEngine
from .models.bert import BertConfig
from .models.gpt2 import GPT2Config, get_config
from .runtime.config import (
    DeepSpeedConfig,
    DeepSpeedConfigError,
    NotPortedError,
    SparseAttentionConfig,
)
from .runtime.engine import DeepSpeedEngine
from .runtime.module import ModuleSpec


def init_inference(model_config: Union[GPT2Config, str] = "gpt2",
                   params=None, dtype=None, device=None, seed: int = 0,
                   config: Optional[Dict] = None, quantize_bits: Optional[int] = None,
                   quantize_groups: Optional[int] = None) -> InferenceEngine:
    """Build an :class:`InferenceEngine` (counterpart of
    ``deepspeed_tpu.init_inference``): GPT-2 weights from ``params`` (a
    nested dict of tensors in the JAX package's layout) or the seeded
    initialiser, cast to ``dtype`` (bf16 by default) on ``device``
    (default the CUDA card; raises when there is none). ``dtype="int8"``
    (or ``quantization_setting`` in ``config``, or ``quantize_bits=8``)
    serves weight-only int8: codes and per-group scales, bf16 compute."""
    return InferenceEngine(model_config, params=params, dtype=dtype,
                           device=device, seed=seed, config=config,
                           quantize_bits=quantize_bits, quantize_groups=quantize_groups)


def initialize(model: Optional[ModuleSpec] = None, optimizer: Any = None,
               model_parameters: Any = None, training_data: Any = None,
               lr_scheduler: Any = None, collate_fn: Any = None, config: Any = None,
               seed: int = 0, device=None) -> Tuple[DeepSpeedEngine, Any, Any, Any]:
    """Build a :class:`DeepSpeedEngine` (counterpart of
    ``deepspeed_tpu.initialize``): ``model`` a :class:`ModuleSpec`
    (``models.gpt2.make_module(cfg)``, ``models.bert.make_module(cfg)``),
    ``model_parameters`` an optional
    parameter tree (else ``model.init`` draws it from ``seed``), ``config``
    a dict, JSON string or path, ``lr_scheduler`` an optional ``step -> lr``
    callable, ``device`` the training device (default the CUDA card; raises
    when there is none). → ``(engine, optimizer, training_dataloader,
    lr_schedule)``."""
    if model is None:
        raise ValueError("deepspeed_tpu_torch.initialize: model is required")
    if optimizer is not None:
        raise NotPortedError(
            "initialize(optimizer=...): deepspeed_tpu_torch takes no client optimizer "
            "(the JAX package's initialize does not read one either); configure the "
            "config's optimizer section"
        )
    if config is None:
        raise ValueError("deepspeed_tpu_torch.initialize: config is required")
    engine = DeepSpeedEngine(model, config, params=model_parameters,
                             lr_schedule=lr_scheduler if callable(lr_scheduler) else None,
                             seed=seed, training_data=training_data, collate_fn=collate_fn,
                             device=device)
    return engine, engine.optimizer, engine.training_dataloader, engine.lr_schedule


__all__ = ["BertConfig", "DeepSpeedConfig", "DeepSpeedConfigError", "DeepSpeedEngine",
           "GPT2Config", "InferenceEngine", "ModuleSpec", "NotPortedError",
           "SparseAttentionConfig", "get_config", "init_inference", "initialize"]
