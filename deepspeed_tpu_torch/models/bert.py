"""BERT encoder with the pre-training heads (counterpart of
``deepspeed_tpu/models/bert.py``).

Post-LN residual layout (original BERT): ``h = LN(h + attn(h)); h = LN(h +
mlp(h))`` with eps 1e-12 and the exact (erf) GELU; token-type embeddings,
a tanh pooler over the first token, and with ``pretraining=True`` the MLM
transform with its decoder tied to ``wte`` plus the NSP classifier. The
parameter tree keeps the JAX package's layout (blocks stacked on a leading
``[L, ...]`` axis, weights in the ``x @ W`` convention), so a tree moves
between the packages unchanged.

Attention: ``attn_impl="sparse"`` goes through ``ops.sparse_attention``
(the block-sparse kernels on the card; a padding mask takes the masked
dense path); otherwise ``ops.attention.bidirectional_attention`` (the
non-causal flash kernels on the card for an unmasked batch, the plain
masked path for a masked one). Every block weight goes through
``ops.quantizer.maybe_dequantize`` at its use, as in the JAX package.

``dropout`` is accepted and applies nothing, as in the JAX package: its
``pretraining_loss`` calls ``forward`` without a key, and no BERT layer
reads ``BertConfig.dropout``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import bidirectional_attention
from ..ops.layer_norm import layer_norm
from ..ops.quantizer import maybe_dequantize as _deq
from ..ops.sparse_attention import FixedSparsityConfig, sparse_attention
from ..runtime.module import ModuleSpec
from .gpt2 import _unstack

PyTree = Any

_ATTN_IMPLS = ("auto", "pallas", "jnp", "sparse")


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    n_positions: int = 512
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    ffn_dim: int = 3072
    type_vocab_size: int = 2
    layer_norm_epsilon: float = 1e-12
    dropout: float = 0.0  # accepted, applied nowhere (as in the JAX package)
    # adds the MLM transform/decoder and NSP heads and a training loss_fn
    pretraining: bool = False
    # auto | pallas (both: the flash kernels on the card) | jnp (CPU
    # tensors only) | sparse (block-sparse attention under sparsity_config,
    # None: FixedSparsityConfig at n_head)
    attn_impl: str = "auto"
    sparsity_config: object = None

    def __post_init__(self):
        if self.attn_impl not in _ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}")

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


PRESETS: Dict[str, Dict] = {
    "bert-tiny": dict(n_embd=64, n_layer=2, n_head=4, ffn_dim=256, vocab_size=512, n_positions=128),
    "bert-base": dict(n_embd=768, n_layer=12, n_head=12, ffn_dim=3072),
    "bert-large": dict(n_embd=1024, n_layer=24, n_head=16, ffn_dim=4096),
}


def get_config(name: str, **overrides) -> BertConfig:
    base = dict(PRESETS[name])
    base.update(overrides)
    return BertConfig(**base)


def init_params(cfg: BertConfig, generator: torch.Generator, device=None,
                dtype: torch.dtype = torch.float32) -> PyTree:
    """Random BERT weights: normal(0, 0.02) matrices, zero biases, unit LN
    scales. Drawn with ``generator`` on its device (the numbers differ from
    the JAX package's for the same seed), then placed on ``device`` in
    ``dtype``."""
    E, L, F_ = cfg.n_embd, cfg.n_layer, cfg.ffn_dim
    gen_device = generator.device
    device = gen_device if device is None else torch.device(device)

    def nrm(*shape):
        x = torch.randn(shape, generator=generator, device=gen_device) * 0.02
        return x.to(device=device, dtype=dtype)

    def const(shape, value):
        return torch.full(shape, value, device=device, dtype=dtype)

    def ln(*lead):
        return {"scale": const((*lead, E), 1.0), "bias": const((*lead, E), 0.0)}

    params = {
        "wte": nrm(cfg.vocab_size, E),
        "wpe": nrm(cfg.n_positions, E),
        "wtt": nrm(cfg.type_vocab_size, E),
        "emb_ln": ln(),
        "blocks": {
            "attn": {
                "wq": nrm(L, E, E), "bq": const((L, E), 0.0),
                "wk": nrm(L, E, E), "bk": const((L, E), 0.0),
                "wv": nrm(L, E, E), "bv": const((L, E), 0.0),
                "wo": nrm(L, E, E), "bo": const((L, E), 0.0),
            },
            "attn_ln": ln(L),
            "mlp": {
                "fc_in_w": nrm(L, E, F_), "fc_in_b": const((L, F_), 0.0),
                "fc_out_w": nrm(L, F_, E), "fc_out_b": const((L, E), 0.0),
            },
            "out_ln": ln(L),
        },
        "pooler": {"w": nrm(E, E), "b": const((E,), 0.0)},
    }
    if cfg.pretraining:
        params["mlm"] = {"w": nrm(E, E), "b": const((E,), 0.0), "ln": ln(),
                         "decoder_b": const((cfg.vocab_size,), 0.0)}
        params["nsp"] = {"w": nrm(E, 2), "b": const((2,), 0.0)}
    return params


def _block(cfg: BertConfig, lp, h, attention_mask):
    B, S, E = h.shape
    H, D = cfg.n_head, cfg.head_dim
    eps = cfg.layer_norm_epsilon
    a = lp["attn"]
    q = (h @ _deq(a["wq"], h.dtype) + a["bq"]).unflatten(-1, (H, D))
    k = (h @ _deq(a["wk"], h.dtype) + a["bk"]).unflatten(-1, (H, D))
    v = (h @ _deq(a["wv"], h.dtype) + a["bv"]).unflatten(-1, (H, D))
    if cfg.attn_impl == "sparse":
        sc = cfg.sparsity_config or FixedSparsityConfig(num_heads=H)
        o = sparse_attention(q, k, v, sc, causal=False, key_mask=attention_mask)
    else:
        o = bidirectional_attention(q, k, v, mask=attention_mask, impl=cfg.attn_impl)
    o = o.reshape(B, S, E)
    h = layer_norm(h + (o @ _deq(a["wo"], o.dtype) + a["bo"]), lp["attn_ln"]["scale"],
                   lp["attn_ln"]["bias"], eps)
    m = lp["mlp"]
    y = F.gelu(h @ _deq(m["fc_in_w"], h.dtype) + m["fc_in_b"])
    y = y @ _deq(m["fc_out_w"], y.dtype) + m["fc_out_b"]
    return layer_norm(h + y, lp["out_ln"]["scale"], lp["out_ln"]["bias"], eps)


def forward(cfg: BertConfig, params: PyTree, input_ids, attention_mask=None,
            token_type_ids=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``input_ids [B, S]`` → (last hidden state ``[B, S, E]``, pooled
    ``[B, E]`` or None)."""
    B, S = input_ids.shape
    tt = token_type_ids if token_type_ids is not None else torch.zeros_like(input_ids)
    h = params["wte"][input_ids] + params["wpe"][:S][None] + params["wtt"][tt]
    h = layer_norm(h, params["emb_ln"]["scale"], params["emb_ln"]["bias"], cfg.layer_norm_epsilon)
    for lp in _unstack(params["blocks"], cfg.n_layer):
        h = _block(cfg, lp, h, attention_mask)
    pooled = None
    if params.get("pooler") is not None:
        pooled = torch.tanh(h[:, 0] @ params["pooler"]["w"] + params["pooler"]["b"])
    return h, pooled


def pretraining_loss(cfg: BertConfig, params: PyTree, batch, rng=None, train: bool = True):
    """Masked-LM + next-sentence-prediction loss → ``(loss, metrics)``
    (``rng`` and ``train`` are accepted and unused, as in the JAX package).
    Batch: ``input_ids [B, S]``, ``labels [B, S]`` with -100 on unmasked
    positions, optional ``attention_mask`` / ``token_type_ids``, optional
    ``next_sentence_label [B]``. Both log-softmaxes in f32."""
    h, pooled = forward(cfg, params, batch["input_ids"], batch.get("attention_mask"),
                        batch.get("token_type_ids"))
    m = params["mlm"]
    t = F.gelu(h @ m["w"] + m["b"])
    t = layer_norm(t, m["ln"]["scale"], m["ln"]["bias"], cfg.layer_norm_epsilon)
    logits = (t @ params["wte"].to(t.dtype).t() + m["decoder_b"]).float()
    labels = batch["labels"]
    mask = (labels != -100).float()
    safe = torch.where(labels == -100, torch.zeros_like(labels), labels)
    logp = torch.log_softmax(logits, dim=-1)
    tok_ll = logp.gather(-1, safe[..., None].long())[..., 0]
    # under data parallelism: the global masked count and rows (the
    # engine's "__norm__", from :func:`loss_norm`), as JAX's loss over the
    # whole batch divides
    norm = batch.get("__norm__")
    mlm_loss = -(tok_ll * mask).sum() / (mask.sum().clamp_min(1.0) if norm is None else norm[0])
    metrics = {"mlm_loss": mlm_loss}
    loss = mlm_loss
    nsl = batch.get("next_sentence_label")
    if nsl is not None:
        cls_logits = (pooled @ params["nsp"]["w"] + params["nsp"]["b"]).float()
        nsp_ll = torch.log_softmax(cls_logits, dim=-1).gather(-1, nsl[:, None].long())
        nsp_loss = -(nsp_ll.mean() if norm is None else nsp_ll.sum() / norm[1])
        metrics["nsp_loss"] = nsp_loss
        loss = loss + nsp_loss
    return loss, metrics


def loss_norm(batch) -> np.ndarray:
    """The global denominators of :func:`pretraining_loss` over a host
    micro-batch (numpy leaves): ``[max(masked count, 1), rows]``."""
    masked = float((np.asarray(batch["labels"]) != -100).sum())
    return np.asarray([max(masked, 1.0), len(batch["labels"])], np.float32)


def make_module(cfg: BertConfig) -> ModuleSpec:
    """BERT as a :class:`ModuleSpec` for ``deepspeed_tpu_torch.initialize``
    (a ``loss_fn`` only with ``pretraining=True``); ``init`` draws on the
    generator's device."""
    return ModuleSpec(
        init=lambda generator: init_params(cfg, generator),
        loss_fn=((lambda params, batch, rng, train:
                  pretraining_loss(cfg, params, batch, rng, train))
                 if cfg.pretraining else None),
        apply_fn=lambda params, batch: forward(
            cfg, params, batch["input_ids"], batch.get("attention_mask"),
            batch.get("token_type_ids"))[0],
        loss_norm=loss_norm if cfg.pretraining else None,
    )
