"""A standalone transformer encoder layer: the public kernel-layer API
(counterpart of ``deepspeed_tpu/ops/transformer.py``, the reference's
``DeepSpeedTransformerLayer``).

One layer is the QKV product, bidirectional self-attention, the output
projection, residual and dropout, and the tanh-GELU MLP, pre- or post-
LayerNorm, forward and backward (autograd over the same functions).
Attention goes through ``ops.attention.bidirectional_attention``: the
non-causal flash kernels on the card for an unmasked batch, the plain
masked path for a padding mask, the plain versions on the CPU. Dropout is
JAX's (``ops/dropout.py``: the threefry kernel on the card): the layer's
key splits three ways, the attention output's, the attention residual's
and the MLP residual's, so a key draws the JAX layer's masks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from . import prng
from .attention import bidirectional_attention
from .dropout import dropout as _dropout_op
from .layer_norm import layer_norm


@dataclass
class DeepSpeedTransformerConfig:
    """The reference's ``DeepSpeedTransformerConfig`` without its CUDA-only
    knobs; ``dtype`` is the parameters' dtype."""

    hidden_size: int = 768
    intermediate_size: Optional[int] = None  # default 4 * hidden
    heads: int = 12
    attn_dropout_ratio: float = 0.1
    hidden_dropout_ratio: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    pre_layer_norm: bool = True
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size
        if self.hidden_size % self.heads:
            raise ValueError(f"hidden_size={self.hidden_size} is not a multiple of "
                             f"heads={self.heads}")


def _dropout(x, rate: float, key, train: bool):
    if not train or rate <= 0.0 or key is None:
        return x
    return _dropout_op(x, key, rate)


class DeepSpeedTransformerLayer:
    """Functional encoder layer: ``params = layer.init(generator)``;
    ``y = layer(params, x, attention_mask, train, rng)``. ``x`` is ``[B,
    S, E]``; ``attention_mask`` (optional) is HF's ``[B, S]``, 1 = attend;
    ``rng`` a JAX key (``ops.prng.PRNGKey``) for the dropouts."""

    def __init__(self, config: DeepSpeedTransformerConfig):
        self.config = config

    def init(self, generator: torch.Generator, device=None):
        """Random parameters: normal(0, initializer_range) matrices, zero
        biases, unit LN scales, drawn with ``generator`` on its device (the
        numbers differ from the JAX package's for the same seed)."""
        c = self.config
        E, I = c.hidden_size, c.intermediate_size
        gen_device = generator.device
        device = gen_device if device is None else torch.device(device)

        def norm(*shape):
            x = torch.randn(shape, generator=generator, device=gen_device) * c.initializer_range
            return x.to(device=device, dtype=c.dtype)

        def const(shape, value):
            return torch.full(shape, value, device=device, dtype=c.dtype)

        return {
            "attn": {"qkv_w": norm(E, 3 * E), "qkv_b": const((3 * E,), 0.0),
                     "out_w": norm(E, E), "out_b": const((E,), 0.0)},
            "mlp": {"fc_w": norm(E, I), "fc_b": const((I,), 0.0),
                    "proj_w": norm(I, E), "proj_b": const((E,), 0.0)},
            "ln1": {"scale": const((E,), 1.0), "bias": const((E,), 0.0)},
            "ln2": {"scale": const((E,), 1.0), "bias": const((E,), 0.0)},
        }

    def __call__(self, params, x, attention_mask=None, train: bool = False, rng=None):
        c = self.config
        B, S, E = x.shape
        H, D = c.heads, c.hidden_size // c.heads
        keys = prng.split(rng, 3) if rng is not None else (None, None, None)

        def attn_block(h):
            qkv = (h @ params["attn"]["qkv_w"] + params["attn"]["qkv_b"]).reshape(B, S, 3, H, D)
            q, k, v = (qkv[:, :, i].contiguous() for i in range(3))
            out = bidirectional_attention(q, k, v, mask=attention_mask)
            out = _dropout(out, c.attn_dropout_ratio, keys[0], train)
            return out.reshape(B, S, E) @ params["attn"]["out_w"] + params["attn"]["out_b"]

        def mlp_block(h):
            h = F.gelu(h @ params["mlp"]["fc_w"] + params["mlp"]["fc_b"], approximate="tanh")
            return h @ params["mlp"]["proj_w"] + params["mlp"]["proj_b"]

        def ln(h, p):
            return layer_norm(h, p["scale"], p["bias"], c.layer_norm_eps)

        if c.pre_layer_norm:
            x = x + _dropout(attn_block(ln(x, params["ln1"])), c.hidden_dropout_ratio,
                             keys[1], train)
            return x + _dropout(mlp_block(ln(x, params["ln2"])), c.hidden_dropout_ratio,
                                keys[2], train)
        x = ln(x + _dropout(attn_block(x), c.hidden_dropout_ratio, keys[1], train),
               params["ln1"])
        return ln(x + _dropout(mlp_block(x), c.hidden_dropout_ratio, keys[2], train),
                  params["ln2"])
