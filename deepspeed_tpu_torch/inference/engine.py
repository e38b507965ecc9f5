"""Inference engine: GPT-2 parameters on a device, in a dtype, ready to serve
(counterpart of ``deepspeed_tpu/inference/engine.py`` for the serving path).

Builds the parameters from the seeded initialiser or takes a given tree,
casts the floating leaves to ``dtype`` (bf16 by default, as the JAX package
does), places them on ``device`` and hands out :class:`ServingEngine`s
through :meth:`serve`. ``device=None`` means the CUDA card: without one the
engine raises instead of running on the CPU; pass ``device="cpu"`` to ask
for the CPU.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Union

import torch

from ..models import gpt2
from ..models.gpt2 import GPT2Config
from ..runtime.config import DeepSpeedConfigError, NotPortedError
from ..utils.logging import log_dist
from ..utils.weights import tree_map

PyTree = Any

_DTYPE_NAMES = {
    "fp16": torch.float16, "half": torch.float16, "float16": torch.float16,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "fp32": torch.float32, "float": torch.float32, "float32": torch.float32,
}


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
    ):
        c = dict(config or {})
        cfg_dtype = c.pop("dtype", None)
        self._serving_config = c.pop("serving", None)
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
        self.dtype = _parse_dtype(
            dtype if dtype is not None else (cfg_dtype if cfg_dtype is not None else torch.bfloat16)
        )
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
            params = gpt2.init_params(model_config, gen, self.device, torch.float32)
        self.params = tree_map(
            lambda p: p.to(device=self.device, dtype=self.dtype)
            if p.is_floating_point() else p.to(self.device),
            params,
        )
        log_dist(
            f"InferenceEngine: device={self.device} "
            f"dtype={str(self.dtype).replace('torch.', '')}"
        )

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
