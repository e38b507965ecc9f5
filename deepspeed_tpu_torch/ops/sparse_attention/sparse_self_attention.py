"""Sparse self-attention over a block-sparsity config (counterpart of
``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``).

Routing, as in the JAX package:

- ``impl="auto"`` / ``"pallas"``: the block-sparse kernels for CUDA tensors,
  their plain versions for CPU tensors (``ops/block_sparse_attention.py``,
  one autograd Function); inactive blocks are never touched on the card.
- ``impl="jnp"``: masked dense attention (the exact reference semantics),
  for CPU tensors only; CUDA tensors always take the kernels.
- a ``key_mask`` (padded keys) goes to the masked dense path on any device:
  neither package has a kernel with a mask input. At S >= 2048 that path
  warns. Every dense call is counted in
  ``block_sparse_attention.DENSE_CALLS``, so a run can show it took none.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from .. import block_sparse_attention as bsa
from .sparsity_config import FixedSparsityConfig, SparsityConfig

NEG_INF = -1e30


def _dense_masked(q, k, v, mask_hss: torch.Tensor, causal: bool, sm_scale: float,
                  key_mask=None):
    """``[B, S, H, D]`` dense attention under an ``[H, S, S]`` element mask
    (the reference path); an optional ``[B, S]`` key padding mask (1 =
    attend) is ANDed in. f32 scores and softmax, probabilities cast to v's
    dtype; a row with nothing to attend to gets zeros."""
    bsa.DENSE_CALLS["sparse_attention_dense"] += 1
    S = q.shape[1]
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * sm_scale
    mask = mask_hss[None]  # [1, H, S, S]
    if causal:
        mask = mask & torch.ones(S, S, dtype=torch.bool, device=q.device).tril()[None, None]
    if key_mask is not None:
        mask = mask & key_mask.to(q.device).bool()[:, None, None, :]
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(mask.any(dim=-1, keepdim=True), probs, torch.zeros_like(probs))
    return torch.einsum("bhst,bthd->bshd", probs.to(v.dtype), v)


def sparse_attention(q, k, v, sparsity_config: SparsityConfig, causal: bool = False,
                     sm_scale: Optional[float] = None, impl: str = "auto", key_mask=None):
    """q/k/v ``[B, S, H, D]`` → ``[B, S, H, D]``. ``key_mask [B, S]`` (1 =
    attend) masks padded keys (ragged inputs padded by
    ``sparse_attention_utils.pad_to_block_size``) and routes to the masked
    dense path."""
    B, S, H, D = q.shape
    if H != sparsity_config.num_heads:
        raise ValueError(f"q has {H} heads, the sparsity config {sparsity_config.num_heads}")
    if impl not in ("auto", "pallas", "jnp"):
        raise ValueError(f"unknown sparse attention impl {impl!r}")
    if impl == "jnp" and q.device.type == "cuda":
        raise ValueError("sparse_attention: impl='jnp' (the plain version) does not run on the "
                         "card; CUDA tensors take the block-sparse kernels (impl='auto')")
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    lists = bsa.index_lists(sparsity_config, S, q.device)
    if impl != "jnp" and key_mask is None:
        return bsa.block_sparse(q, k, v, lists, causal, scale)
    if impl != "jnp" and S >= 2048:
        # the long-sequence regime the kernels exist for: make the O(S^2)
        # dense path loud (drop the mask, e.g. run unpadded full-length
        # batches, to regain the kernels)
        warnings.warn(
            f"sparse_attention: key_mask at S={S} routes to the dense masked path (the "
            "block-sparse kernels have no mask input); materializes [B,H,S,S] scores"
        )
    return _dense_masked(q, k, v, lists.dense_mask(q.device), causal, scale, key_mask=key_mask)


class SparseSelfAttention(torch.nn.Module):
    """The reference module's surface, as an ``nn.Module`` with no
    parameters."""

    def __init__(self, sparsity_config: Optional[SparsityConfig] = None,
                 attn_mask_mode: str = "mul", max_seq_length: int = 2048, impl: str = "auto"):
        super().__init__()
        self.sparsity_config = sparsity_config or FixedSparsityConfig(num_heads=4)
        self.attn_mask_mode = attn_mask_mode
        self.max_seq_length = max_seq_length
        self.impl = impl

    def forward(self, query, key, value, causal: bool = True,
                sm_scale: Optional[float] = None) -> torch.Tensor:
        return sparse_attention(query, key, value, self.sparsity_config, causal=causal,
                                sm_scale=sm_scale, impl=self.impl)
