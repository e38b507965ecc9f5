"""GPT-2: config, presets, parameter initialiser, the block pieces the
serving programs are built from, and the training trunk and loss.

Counterpart of ``deepspeed_tpu/models/gpt2.py``. Parameters keep the JAX
package's layout: a nested dict with the blocks stacked on a leading
``[L, ...]`` axis and weights in the ``x @ W`` convention (``c_attn_w`` is
``[E, 3E]``), so a tree can move between the two packages unchanged. The
training trunk walks the stacked blocks in a Python loop (the JAX
package's ``lax.scan``), with ``remat`` wrapping each block in
``torch.utils.checkpoint``; attention goes through
``ops.attention.causal_attention`` (the flash kernels on the card).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.attention import causal_attention
from ..ops.layer_norm import layer_norm
from ..runtime.activation_checkpointing import checkpoint
from ..runtime.config import NotPortedError
from ..runtime.module import ModuleSpec
from .lm_loss import head_token_loss

PyTree = Any

_ATTN_IMPLS = ("auto", "pallas", "jnp")
_UNPORTED_ATTN_IMPLS = ("ring", "ring_flash", "ulysses", "sparse")


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
    # training knobs; a value that is not ported raises NotPortedError
    dropout: float = 0.0
    remat: bool = False
    remat_policy: str = "full"
    # auto | pallas (both: the CUDA kernels on the card) | jnp (CPU tensors only)
    attn_impl: str = "auto"
    ce_chunk: int = 0
    moe_experts: int = 0

    def __post_init__(self):
        item = "ROADMAP queue 1 item 5"
        if self.dropout > 0.0:
            raise NotPortedError(
                f"dropout={self.dropout}: dropout is not ported to deepspeed_tpu_torch yet "
                "(its random bits need the JAX key schedule's parity, ROADMAP queue 1 item 6)"
            )
        if self.ce_chunk > 0:
            raise NotPortedError(f"ce_chunk={self.ce_chunk}: chunked cross-entropy is not "
                                 f"ported yet ({item})")
        if self.moe_experts > 0:
            raise NotPortedError(f"moe_experts={self.moe_experts}: MoE is not ported yet "
                                 "(ROADMAP queue 1 item 10)")
        if self.attn_impl in _UNPORTED_ATTN_IMPLS:
            raise NotPortedError(f"attn_impl={self.attn_impl!r} is not ported yet "
                                 "(ROADMAP queue 1 item 10)")
        if self.attn_impl not in _ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}")
        if self.remat_policy in ("dots", "attn"):
            raise NotPortedError(f"remat_policy={self.remat_policy!r}: only 'full' is "
                                 f"ported yet ({item})")
        if self.remat_policy != "full":
            raise ValueError(f"unknown remat_policy {self.remat_policy!r} (full|dots|attn)")

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


# ---------------------------------------------------------------------------
# training trunk
# ---------------------------------------------------------------------------

def _attention(cfg: GPT2Config, lp, h):
    """Causal self-attention of ``h [B, S, E]``: q, k and v are strided
    views of the ``[B, S, 3E]`` projection (no copies on the way into the
    kernel)."""
    B, S, E = h.shape
    H, D = cfg.n_head, cfg.head_dim
    qkv = h @ lp["c_attn_w"] + lp["c_attn_b"]
    q, k, v = (x.unflatten(-1, (H, D)) for x in qkv.split(E, dim=-1))
    o = causal_attention(q, k, v, impl=cfg.attn_impl)
    return o.reshape(B, S, E) @ lp["c_proj_w"] + lp["c_proj_b"]


def _block(cfg: GPT2Config, lp, h):
    eps = cfg.layer_norm_epsilon
    h = h + _attention(cfg, lp["attn"], layer_norm(h, lp["ln_1"]["scale"], lp["ln_1"]["bias"], eps))
    return h + _mlp(cfg, lp["mlp"], layer_norm(h, lp["ln_2"]["scale"], lp["ln_2"]["bias"], eps))


def _unstack(tree, n: int):
    """The stacked ``[L, ...]`` block tree → a list of L per-layer trees.
    ``unbind`` once (its backward is one stack of the layers' grads) rather
    than indexing per layer (whose backward scatters into a zero copy of
    the whole stack, once per layer)."""
    def unbind(t):
        return {k: unbind(v) for k, v in t.items()} if isinstance(t, dict) else t.unbind(0)

    def pick(t, i):
        return {k: pick(v, i) for k, v in t.items()} if isinstance(t, dict) else t[i]

    u = unbind(tree)
    return [pick(u, i) for i in range(n)]


def hidden_with_aux(cfg: GPT2Config, params: PyTree, input_ids, train: bool = False,
                    generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``input_ids [B, S]`` → (final-LN hidden states ``[B, S, E]``, the MoE
    aux loss, 0 for a dense model)."""
    B, S = input_ids.shape
    h = params["wte"][input_ids] + params["wpe"][:S][None, :, :]
    for lp in _unstack(params["blocks"], cfg.n_layer):
        if cfg.remat:
            h = checkpoint(functools.partial(_block, cfg, lp), h)
        else:
            h = _block(cfg, lp, h)
    h = layer_norm(h, params["ln_f"]["scale"], params["ln_f"]["bias"], cfg.layer_norm_epsilon)
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


def forward_with_aux(cfg: GPT2Config, params: PyTree, input_ids, train: bool = False,
                     generator: Optional[torch.Generator] = None):
    """``input_ids [B, S]`` → (logits ``[B, S, V]`` over the logical vocab,
    aux loss); the embedding is tied."""
    h, aux = hidden_with_aux(cfg, params, input_ids, train, generator)
    return (h @ params["wte"].t())[..., : cfg.vocab_size], aux


def forward(cfg: GPT2Config, params: PyTree, input_ids, train: bool = False,
            generator: Optional[torch.Generator] = None):
    """``input_ids [B, S]`` → logits ``[B, S, V]``."""
    return forward_with_aux(cfg, params, input_ids, train, generator)[0]


def _head_token_loss(cfg: GPT2Config, wte, h, batch):
    return head_token_loss(lambda x: x @ wte.t(), h, batch, cfg.ce_chunk,
                           logical_vocab=cfg.vocab_size)


def lm_loss(cfg: GPT2Config, params: PyTree, batch: Dict[str, torch.Tensor],
            generator: Optional[torch.Generator], train: bool):
    """Next-token cross-entropy → ``(loss, {"ntokens", "moe_aux"})``. batch:
    ``{"input_ids": [B, S]}`` and optional ``"labels"`` (-100 = ignore) /
    ``"attention_mask"``."""
    h, aux = hidden_with_aux(cfg, params, batch["input_ids"], train, generator)
    loss, ntokens = _head_token_loss(cfg, params["wte"], h, batch)
    return loss, {"ntokens": ntokens, "moe_aux": aux}


def make_module(cfg: GPT2Config) -> ModuleSpec:
    """GPT-2 as a :class:`ModuleSpec` for ``deepspeed_tpu_torch.initialize``;
    ``init`` draws on the generator's device."""
    return ModuleSpec(
        init=lambda generator: init_params(cfg, generator),
        loss_fn=lambda params, batch, generator, train: lm_loss(cfg, params, batch, generator, train),
        apply_fn=lambda params, batch: forward(cfg, params, batch["input_ids"]),
    )
