"""Inference engine: GPT-2 parameters on a device, in a dtype (counterpart
of ``deepspeed_tpu/inference/engine.py`` for GPT-2 models).

Builds the parameters from the seeded initialiser or takes a given tree,
casts the floating leaves to ``dtype`` (bf16 by default, as the JAX package
does) and places them on ``device``. Then: :meth:`generate` (offline
generation over a contiguous KV cache, prompts padded to length buckets),
:meth:`forward` / ``engine(batch)`` (the logits of a batch), and
:meth:`serve` (a continuous-batching :class:`ServingEngine`).
``device=None`` means the CUDA card: without one the engine raises instead
of running on the CPU; pass ``device="cpu"`` to ask for the CPU.

Weight-only int8 follows the JAX engine (``inference/engine.py:134-149``,
``:262-271``): ``dtype="int8"`` means 8-bit weights with bf16 compute;
``quantization_setting`` (groups, or ``(mlp_extra_grouping, groups)``,
whose last element counts) or ``quantize_bits=8`` turns it on at the given
dtype; the groups default to 1. The fp32 tree goes through
``ops.quantizer.quantize_tree``: the stacked block weights become int8
codes with per-group scales in the compute dtype, every other float leaf
is cast to it, and the models dequantize at each use. ``generate`` and
``serve`` run on that tree, with or without int8 KV pages. Sampling draws
with JAX's keys: ``generate(seed=s)`` uses ``PRNGKey(s)``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..models import gpt2
from ..models.gpt2 import GPT2Config
from ..ops import prng
from ..ops.quantizer import quantize_tree
from ..runtime.config import DeepSpeedConfigError, NotPortedError
from ..utils.logging import log_dist
from ..utils.weights import tree_map

PyTree = Any

_DTYPE_NAMES = {
    "fp16": torch.float16, "half": torch.float16, "float16": torch.float16,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "fp32": torch.float32, "float": torch.float32, "float32": torch.float32,
}


def _is_int8(d) -> bool:
    return d is torch.int8 or str(d).lower().replace("torch.", "") == "int8"


def _parse_dtype(d) -> torch.dtype:
    if isinstance(d, torch.dtype):
        if d not in _DTYPE_NAMES.values():
            raise ValueError(f"unsupported inference dtype {d}")
        return d
    key = str(d).lower().replace("torch.", "")
    if key not in _DTYPE_NAMES:
        raise ValueError(f"unknown inference dtype {d!r}")
    return _DTYPE_NAMES[key]


def resolve_device(device=None) -> torch.device:
    """``None`` → the CUDA card, which must exist; anything else as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "deepspeed_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev


class InferenceEngine:
    def __init__(
        self,
        model_config: Union[GPT2Config, str],
        params: Optional[PyTree] = None,
        dtype=None,
        device=None,
        seed: int = 0,
        config: Optional[Dict] = None,
        quantize_bits: Optional[int] = None,
        quantize_groups: Optional[int] = None,
    ):
        c = dict(config or {})
        cfg_dtype = c.pop("dtype", None)
        q = c.pop("quantization_setting", None)
        self._serving_config = c.pop("serving", None)
        cfg_max = c.pop("max_out_tokens", c.pop("max_tokens", None))
        self.max_tokens = int(cfg_max if cfg_max is not None else 1024)
        # None: power-of-two prompt buckets; a list pins the sizes; [] or
        # False turns bucketing off
        self._prompt_buckets = c.pop("prompt_bucket_sizes", None)
        # generate_cache_size caps the JAX package's compiled-generate
        # executables; this eager engine keeps none (captured CUDA graphs
        # would be what it bounds), so the key is accepted with nothing to
        # bound yet
        c.pop("generate_cache_size", None)
        if c:
            raise NotPortedError(
                f"init_inference: config keys {sorted(c)} are not ported to "
                "deepspeed_tpu_torch yet"
            )
        if isinstance(model_config, str):
            model_config = gpt2.get_config(model_config)
        if not isinstance(model_config, GPT2Config):
            raise DeepSpeedConfigError(
                "InferenceEngine serves GPT2Config models; got "
                f"{type(model_config).__name__}"
            )
        self.model_config = model_config
        dtype = dtype if dtype is not None else (
            cfg_dtype if cfg_dtype is not None else torch.bfloat16)
        # quantization_setting: groups, or (mlp_extra_grouping, groups); none
        # means 1 group (JAX inference/engine.py:134-149)
        cfg_groups = None if q is None else int(q[-1] if isinstance(q, (tuple, list)) else q)
        self.quantize_groups = int(quantize_groups if quantize_groups is not None
                                   else (cfg_groups if cfg_groups is not None else 1))
        bits = int(quantize_bits if quantize_bits is not None else (8 if q is not None else 0))
        if _is_int8(dtype):
            # dtype=int8 means 8-bit weights, bf16 compute
            bits, dtype = 8, torch.bfloat16
        if bits not in (0, 8):
            raise NotPortedError(f"quantize_bits={bits}: weight quantization is 8-bit only "
                                 "(as in the JAX package)")
        self.quantized = bits == 8
        self.dtype = _parse_dtype(dtype)
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
            params = gpt2.init_params(model_config, gen, self.device, torch.float32)
        params = tree_map(lambda p: p.to(self.device), params)
        if self.quantized:
            # from the given (fp32) weights, once, on the device
            params = quantize_tree(params, groups=self.quantize_groups, dtype=self.dtype)
        else:
            params = tree_map(
                lambda p: p.to(self.dtype) if p.is_floating_point() else p, params)
        self.params = params
        log_dist(
            f"InferenceEngine: device={self.device} "
            f"dtype={str(self.dtype).replace('torch.', '')} quantized={self.quantized}"
            + (f" (groups {self.quantize_groups})" if self.quantized else "")
        )

    def forward(self, batch):
        """The logits ``[B, S, V]`` of ``batch["input_ids"] [B, S]`` (a
        tensor or array; the flash kernels on the card)."""
        ids = batch["input_ids"]
        if not isinstance(ids, torch.Tensor):
            ids = torch.from_numpy(np.asarray(ids))
        ids = ids.to(self.device).long()
        with torch.no_grad():
            return gpt2.forward(self.model_config, self.params, ids)

    __call__ = forward

    def _prompt_bucket(self, S: int, max_new_tokens: int) -> Optional[int]:
        """The padded prompt length for ``generate``, or None when bucketing
        is off (``prompt_bucket_sizes: []`` or ``False``). Default: the next
        power of two; a list pins the sizes (the next power of two past the
        largest). Capped so that bucket + max_new_tokens fits n_positions,
        and never below the true length."""
        b = self._prompt_buckets
        if b is False or (isinstance(b, (list, tuple)) and len(b) == 0):
            return None
        cap = int(self.model_config.n_positions) - int(max_new_tokens)
        if isinstance(b, (list, tuple)):
            fits = sorted(int(x) for x in b if int(x) >= S)
            bucket = fits[0] if fits else 1 << max(0, S - 1).bit_length()
        else:
            bucket = 1 << max(0, S - 1).bit_length()
        return max(S, min(bucket, cap))

    def generate(self, input_ids, max_new_tokens: int = 20, temperature: float = 0.0,
                 seed: int = 0, top_k: int = 0, top_p: float = 1.0) -> np.ndarray:
        """Autoregressive generation over a contiguous KV cache: the prompt
        (padded to its bucket unless bucketing is off) prefills once, then
        ``max_new_tokens - 1`` single-token decode steps, each running the
        decode kernel once per layer on the card. Greedy unless
        ``temperature > 0``; then the draws are the JAX engine's under
        ``PRNGKey(seed)`` (the threefry kernel on the card). → prompt + new
        tokens, ``[B, S + max_new_tokens]`` numpy, read from the device once
        at the end."""
        ids_np = np.asarray(input_ids)
        B, S = ids_np.shape
        ids = torch.from_numpy(ids_np.astype(np.int64)).to(self.device)
        bucket = self._prompt_bucket(S, max_new_tokens)
        if bucket is not None and bucket > S:
            ids = torch.cat([ids, ids.new_zeros((B, bucket - S))], dim=1)
        new = gpt2.generate(self.model_config, self.params, ids, max_new_tokens,
                            temperature=temperature, rng=prng.PRNGKey(seed),
                            cache_dtype=self.dtype,
                            top_k=top_k, top_p=top_p, prompt_len=S)
        return np.concatenate([ids_np, new.cpu().numpy().astype(ids_np.dtype)], axis=1)

    def serve(self, serving_config=None, clock=None, track_margins: bool = False):
        """Continuous-batching server over this engine (a
        :class:`~deepspeed_tpu_torch.serving.ServingEngine`).
        ``serving_config`` (dict or :class:`ServingConfig`) overrides the
        ``serving`` section given to ``init_inference``."""
        from ..serving.scheduler import ServingEngine

        cfg = serving_config if serving_config is not None else self._serving_config
        return ServingEngine(
            self, cfg, clock=clock if clock is not None else time.monotonic,
            track_margins=track_margins,
        )
