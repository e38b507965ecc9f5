"""Serving programs over the paged KV pool (counterpart of
``deepspeed_tpu/serving/model.py`` for full-precision pools):

- :func:`paged_prefill`: one request's prompt (right-padded to the prefill
  width) through the model, its K/V written page by page into the slot's
  pool pages, the first token sampled at the true last prompt position.
- :func:`paged_decode_step`: one token for every slot. Each slot's new K/V
  is written into its current page first, then attention reads the slot's
  pages through its block-table row (update-then-attend), via
  ``ops.attention.paged_cached_attention``: the CUDA kernel on the card,
  its plain version on the CPU.

The pools are updated IN PLACE (slice assignment / ``index_put_``); the JAX
package threads them through as donated buffers instead, so there too the
cache never exists twice. Inactive slots ride along pointed at the scratch
page: their writes land there and their outputs are never read.

Padded key positions contribute exact zeros through the masked softmax
(``exp(-1e30 - m)`` is 0), and a position past a slot's length is either
masked or overwritten by the decode write before it is ever attended.
"""

from __future__ import annotations

import math
from typing import Any, List, Optional

import torch

from ..models.gpt2 import GPT2Config, _layer_norm, _mlp
from ..ops.attention import paged_cached_attention
from ..ops.sampling import sample_logits

PyTree = Any


def _layer_params(params: PyTree, l: int) -> PyTree:
    """Layer ``l``'s slice of the stacked block params (views, no copy)."""
    def take(tree):
        if isinstance(tree, dict):
            return {k: take(v) for k, v in tree.items()}
        return tree[l]
    return take(params["blocks"])


def _proj(o, w, b):
    """The attention output projection."""
    return o @ w + b


def _write_pool_pages(pool, l, page_ids, chunks):
    """Whole-page write: ``chunks [n_pp, KV, page, D]`` into layer ``l``'s
    pages ``page_ids`` (in place)."""
    pool[l][page_ids] = chunks.to(pool.dtype)


def _write_pool_token(pool, l, pidx, poff, vals):
    """One-token write: ``vals [B, KV, D]`` to (layer ``l``, page
    ``pidx[b]``, offset ``poff[b]``) (in place)."""
    pool[l][pidx, :, poff] = vals.to(pool.dtype)


def _logits(cfg: GPT2Config, params, h_last):
    h_last = _layer_norm(
        h_last, params["ln_f"]["scale"], params["ln_f"]["bias"], cfg.layer_norm_epsilon
    )
    return (h_last @ params["wte"].T)[..., : cfg.vocab_size]


# ---------------------------------------------------------------------------
# paged prefill (one request into one slot's pages)
# ---------------------------------------------------------------------------

def _attention_prefill_paged(cfg, lp, h, k_pool, v_pool, page_ids, l):
    """Causal self-attention over the prompt, its K/V written to layer
    ``l``'s pages. The prompt starts at position 0 of a fresh slot, so the
    cache is the prompt itself: the attention is a dense causal
    matmul + masked softmax in f32, as the JAX package computes it outside
    any kernel."""
    B, Sp, E = h.shape
    H, D = cfg.n_head, cfg.head_dim
    page = k_pool.shape[3]
    qkv = h @ lp["c_attn_w"] + lp["c_attn_b"]
    q, k_, v = qkv.split(H * D, dim=-1)
    q = q.reshape(B, Sp, H, D)
    k_c = k_.reshape(B, Sp, H, D).to(k_pool.dtype)
    v_c = v.reshape(B, Sp, H, D).to(v_pool.dtype)

    # [Sp, H, D] → [n_pp, H, page, D] whole pages; padded page ids point at
    # the scratch page, and garbage positions stay masked until the decode
    # write claims them
    n_pp = Sp // page
    _write_pool_pages(k_pool, l, page_ids, k_c[0].reshape(n_pp, page, H, D).transpose(1, 2))
    _write_pool_pages(v_pool, l, page_ids, v_c[0].reshape(n_pp, page, H, D).transpose(1, 2))

    scale = 1.0 / math.sqrt(D)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k_c.float()) * scale
    causal = torch.ones(Sp, Sp, dtype=torch.bool, device=h.device).tril()
    scores = torch.where(causal, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(v_c.dtype)
    o = torch.einsum("bhst,bthd->bshd", probs, v_c)
    o = o.reshape(B, Sp, H * D).to(h.dtype)
    return _proj(o, lp["c_proj_w"], lp["c_proj_b"])


@torch.no_grad()
def paged_prefill(
    cfg: GPT2Config,
    params: PyTree,
    input_ids: torch.Tensor,   # [1, Sp] right-padded to the prefill width
    prompt_len: int,           # true prompt length
    k_pool: torch.Tensor,      # [L, P, KV, page, D], written in place
    v_pool: torch.Tensor,
    page_ids: torch.Tensor,    # [Sp // page] slot pages (scratch-padded)
    generator: Optional[torch.Generator] = None,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    return_logits: bool = False,
):
    """→ first token ``[1]`` (and its logits ``[1, V]`` when asked)."""
    B, Sp = input_ids.shape
    eps = cfg.layer_norm_epsilon
    positions = torch.arange(Sp, device=input_ids.device)
    h = params["wte"][input_ids] + params["wpe"][positions][None, :, :]
    page_ids = page_ids.long()

    for l in range(cfg.n_layer):
        lp = _layer_params(params, l)
        h = h + _attention_prefill_paged(
            cfg, lp["attn"],
            _layer_norm(h, lp["ln_1"]["scale"], lp["ln_1"]["bias"], eps),
            k_pool, v_pool, page_ids, l,
        )
        h = h + _mlp(cfg, lp["mlp"], _layer_norm(h, lp["ln_2"]["scale"], lp["ln_2"]["bias"], eps))

    logits = _logits(cfg, params, h[:, int(prompt_len) - 1])
    first = sample_logits(logits, generator, temperature, top_k, top_p)
    return (first, logits) if return_logits else first


# ---------------------------------------------------------------------------
# paged decode step (one token for every slot)
# ---------------------------------------------------------------------------

def _attention_decode_paged(cfg, lp, h, k_pool, v_pool, block_tables, pos, pidx, poff, l):
    """One-token attention per slot against its paged cache (layer ``l``).
    ``pos[b]`` = tokens already cached for slot b = the new token's
    position; the new K/V is written at (page ``pidx[b]``, offset
    ``poff[b]``) before attention reads the pool."""
    B, S, E = h.shape  # S == 1
    H, D = cfg.n_head, cfg.head_dim
    qkv = h @ lp["c_attn_w"] + lp["c_attn_b"]
    q, k_, v = qkv.split(H * D, dim=-1)
    q = q.reshape(B, H, D).contiguous()
    _write_pool_token(k_pool, l, pidx, poff, k_.reshape(B, H, D))
    _write_pool_token(v_pool, l, pidx, poff, v.reshape(B, H, D))
    o = paged_cached_attention(
        q, k_pool[l], v_pool[l], block_tables, pos, sm_scale=1.0 / math.sqrt(D)
    )
    o = o.reshape(B, S, E).to(h.dtype)
    return _proj(o, lp["c_proj_w"], lp["c_proj_b"])


@torch.no_grad()
def paged_decode_step(
    cfg: GPT2Config,
    params: PyTree,
    tokens: torch.Tensor,        # [B] last emitted token per slot
    seq_lens: torch.Tensor,      # [B] int32 tokens already cached per slot
    k_pool: torch.Tensor,        # [L, P, KV, page, D], written in place
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [B, n] int32
    generators: Optional[List[Optional[torch.Generator]]] = None,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    return_logits: bool = False,
):
    """→ next tokens ``[B]`` (and the logits ``[B, V]`` when asked). Greedy
    unless ``temperature > 0``; then slot b draws from ``generators[b]``
    (a slot without a generator is inactive and takes the argmax)."""
    page = k_pool.shape[3]
    eps = cfg.layer_norm_epsilon
    seq_lens = seq_lens.to(torch.int32).contiguous()
    block_tables = block_tables.to(torch.int32).contiguous()
    sl = seq_lens.long()
    h = params["wte"][tokens.long()][:, None, :] + params["wpe"][sl][:, None, :]
    pidx = block_tables.long().gather(1, (sl // page)[:, None])[:, 0]
    poff = sl % page

    for l in range(cfg.n_layer):
        lp = _layer_params(params, l)
        h = h + _attention_decode_paged(
            cfg, lp["attn"],
            _layer_norm(h, lp["ln_1"]["scale"], lp["ln_1"]["bias"], eps),
            k_pool, v_pool, block_tables, seq_lens, pidx, poff, l,
        )
        h = h + _mlp(cfg, lp["mlp"], _layer_norm(h, lp["ln_2"]["scale"], lp["ln_2"]["bias"], eps))

    logits = _logits(cfg, params, h[:, -1])
    if not temperature or temperature <= 0.0:
        nxt = torch.argmax(logits.float(), dim=-1)
    else:
        nxt = torch.stack([
            sample_logits(logits[b : b + 1], g, temperature, top_k, top_p)[0]
            if g is not None else torch.argmax(logits[b].float())
            for b, g in enumerate(generators)
        ])
    return (nxt, logits) if return_logits else nxt
