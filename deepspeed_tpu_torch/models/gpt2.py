"""GPT-2: config, presets, parameter initialiser and the block pieces the
serving programs are built from.

Counterpart of ``deepspeed_tpu/models/gpt2.py``. Parameters keep the JAX
package's layout: a nested dict with the blocks stacked on a leading
``[L, ...]`` axis and weights in the ``x @ W`` convention (``c_attn_w`` is
``[E, 3E]``), so a tree can move between the two packages unchanged.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..ops.layer_norm import layer_norm

PyTree = Any


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5
    # pad the embedding table to a multiple of this; vocab_size stays the
    # logical vocab everywhere, the logits are sliced back to it. 1 = off.
    pad_vocab_multiple: int = 1

    @property
    def padded_vocab_size(self) -> int:
        m = max(1, int(self.pad_vocab_multiple))
        return -(-self.vocab_size // m) * m

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


# name → config, sizes per the GPT-2 paper / HF checkpoints
PRESETS: Dict[str, Dict] = {
    "gpt2-tiny": dict(n_embd=64, n_layer=2, n_head=4, vocab_size=512, n_positions=128),
    "gpt2": dict(n_embd=768, n_layer=12, n_head=12),
    "gpt2-125m": dict(n_embd=768, n_layer=12, n_head=12),
    "gpt2-medium": dict(n_embd=1024, n_layer=24, n_head=16),
    "gpt2-large": dict(n_embd=1280, n_layer=36, n_head=20),
    "gpt2-xl": dict(n_embd=1600, n_layer=48, n_head=25),
}


def get_config(name: str, **overrides) -> GPT2Config:
    base = dict(PRESETS[name])
    base.update(overrides)
    return GPT2Config(**base)


def init_params(cfg: GPT2Config, generator: torch.Generator, device=None,
                dtype: torch.dtype = torch.float32) -> PyTree:
    """Random GPT-2 weights: normal(0, 0.02) matrices, the residual
    projections at 0.02 / sqrt(2L), zero biases, unit LN scales, and the
    padded vocab rows exactly zero. Drawn with ``generator`` on its device
    (the numbers differ from the JAX package's for the same seed), then
    placed on ``device`` in ``dtype``."""
    E, L, V, P = cfg.n_embd, cfg.n_layer, cfg.vocab_size, cfg.n_positions
    gen_device = generator.device
    device = gen_device if device is None else torch.device(device)
    std = 0.02
    pstd = std / math.sqrt(2.0 * L)

    def normal(shape, s):
        x = torch.randn(shape, generator=generator, device=gen_device) * s
        return x.to(device=device, dtype=dtype)

    def const(shape, value):
        return torch.full(shape, value, device=device, dtype=dtype)

    Vp = cfg.padded_vocab_size
    wte = normal((Vp, E), std)
    if Vp > V:
        wte[V:] = 0
    return {
        "wte": wte,
        "wpe": normal((P, E), std),
        "ln_f": {"scale": const((E,), 1.0), "bias": const((E,), 0.0)},
        "blocks": {
            "ln_1": {"scale": const((L, E), 1.0), "bias": const((L, E), 0.0)},
            "ln_2": {"scale": const((L, E), 1.0), "bias": const((L, E), 0.0)},
            "attn": {
                "c_attn_w": normal((L, E, 3 * E), std),
                "c_attn_b": const((L, 3 * E), 0.0),
                "c_proj_w": normal((L, E, E), pstd),
                "c_proj_b": const((L, E), 0.0),
            },
            "mlp": {
                "c_fc_w": normal((L, E, 4 * E), std),
                "c_fc_b": const((L, 4 * E), 0.0),
                "c_proj_w": normal((L, 4 * E, E), pstd),
                "c_proj_b": const((L, E), 0.0),
            },
        },
    }


def _layer_norm(x, scale, bias, eps):
    return layer_norm(x, scale, bias, eps)


def _mlp(cfg: GPT2Config, lp, h):
    """Dense FFN: ``gelu_tanh(h @ c_fc_w + c_fc_b) @ c_proj_w + c_proj_b``
    (the tanh GELU matches ``jax.nn.gelu(approximate=True)``)."""
    x = h @ lp["c_fc_w"] + lp["c_fc_b"]
    x = F.gelu(x, approximate="tanh")
    return x @ lp["c_proj_w"] + lp["c_proj_b"]
