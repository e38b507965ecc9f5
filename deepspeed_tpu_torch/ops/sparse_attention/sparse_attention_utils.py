"""Model-integration helpers for block-sparse attention (counterpart of
``deepspeed_tpu/ops/sparse_attention/sparse_attention_utils.py``): pad
ragged inputs up to the kernels' block granularity, unpad the outputs,
extend position embeddings past the trained window, and build a BERT whose
self-attention is block-sparse (the functional analog of the reference's
``replace_model_self_attention_with_sparse_self_attention``: models here
are functions over a parameter tree, so "replacement" builds the same
model config with ``attn_impl="sparse"``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

PyTree = Any


def pad_to_block_size(block_size: int, input_ids, attention_mask=None, token_type_ids=None,
                      position_ids=None, pad_token_id: int = 0) -> Tuple[int, Any, Any, Any, Any]:
    """Pad ``[B, S]`` tensors so S becomes a multiple of ``block_size`` →
    ``(pad_len, input_ids, attention_mask, token_type_ids, position_ids)``:
    input_ids / token_type_ids with ``pad_token_id`` / 0, attention_mask
    with 0 (padded keys masked out), position_ids by continuing the running
    index (keeps the position lookups valid)."""
    S = input_ids.shape[1]
    pad_len = (-S) % block_size
    if pad_len == 0:
        return 0, input_ids, attention_mask, token_type_ids, position_ids

    def pad(x, value):
        if x is None:
            return None
        x = torch.as_tensor(x)
        widths = [0, 0] * (x.dim() - 2) + [0, pad_len, 0, 0]
        return F.pad(x, widths, value=value)

    input_ids = pad(input_ids, pad_token_id)
    attention_mask = pad(attention_mask, 0)
    token_type_ids = pad(token_type_ids, 0)
    if position_ids is not None:
        position_ids = torch.as_tensor(position_ids)
        tail = torch.arange(S, S + pad_len, dtype=position_ids.dtype, device=position_ids.device)
        position_ids = torch.cat([position_ids, tail.expand(position_ids.shape[0], pad_len)], 1)
    return pad_len, input_ids, attention_mask, token_type_ids, position_ids


def unpad_sequence_output(pad_len: int, sequence_output):
    """Strip the positions added by :func:`pad_to_block_size`."""
    if pad_len == 0:
        return sequence_output
    return sequence_output[:, :-pad_len]


def extend_position_embedding(params: PyTree, max_position: int) -> PyTree:
    """Extend ``wpe`` beyond the trained window by tiling the learned table
    (positions past the window reuse its geometry) → a new tree."""
    wpe = params["wpe"]
    orig = wpe.shape[0]
    assert max_position > orig, (max_position, orig)
    reps = -(-max_position // orig)  # ceil
    out = dict(params)
    out["wpe"] = torch.cat([wpe] * reps, dim=0)[:max_position]
    return out


def update_tokenizer_model_max_length(tokenizer, max_position: int):
    """Keep a tokenizer's window in sync after :func:`extend_position_embedding`."""
    tokenizer.model_max_length = max_position
    if hasattr(tokenizer, "init_kwargs"):
        tokenizer.init_kwargs["model_max_length"] = max_position
    return tokenizer


def sparse_bert_module(name_or_cfg="bert-large", sparsity_config=None, **overrides):
    """BERT with block-sparse self-attention: ``name_or_cfg`` a
    ``models.bert`` preset name or a ``BertConfig`` → ``(cfg, ModuleSpec)``."""
    from ...models import bert

    if isinstance(name_or_cfg, str):
        cfg = bert.get_config(name_or_cfg, attn_impl="sparse", sparsity_config=sparsity_config,
                              **overrides)
    else:
        cfg = dataclasses.replace(name_or_cfg, attn_impl="sparse",
                                  sparsity_config=sparsity_config, **overrides)
    return cfg, bert.make_module(cfg)
