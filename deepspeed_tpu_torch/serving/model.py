"""Serving programs over the paged KV pool (counterpart of
``deepspeed_tpu/serving/model.py``):

- :func:`paged_prefill`: one request's prompt (right-padded to the prefill
  width) through the model, its K/V written page by page into the slot's
  pool pages, the first token sampled at the true last prompt position.
- :func:`paged_decode_step`: one token for every slot. Each slot's new K/V
  is written into its current page first, then attention reads the slot's
  pages through its block-table row (update-then-attend), via
  ``ops.attention.paged_cached_attention``: the CUDA kernel on the card,
  its plain version on the CPU.
- :func:`paged_verify_step`: speculative verify, T = k+1 tokens per slot in
  one pass; attention runs as T single-token calls of the decode kernel.
- :func:`paged_chunk_prefill`: one page-aligned chunk of a prompt that
  attends the slot's cached prefix (earlier chunks or shared prefix pages)
  through ``ops.attention.paged_multitoken_cached_attention``.

int8 pools (``serving.kv_cache_dtype = "int8"``) hold codes and come with
``scales [L, P, KV, 2]`` (``scales=`` of every program; ``None`` for a
full-precision pool). A page's scale is set exactly once, by the
whole-page write that fills it (prefill, chunk prefill, COW recompute) or
by the token write at its offset 0, and stays frozen until the page is
refilled from offset 0: later token writes code against it and never
re-code earlier positions. So a verify step whose T token writes follow
that order leaves the pool (codes and scales) exactly as T decode steps
would, and every reader (prefill included) attends the dequantized
codes.

The pools are updated IN PLACE (slice assignment / ``index_put_``); the JAX
package threads them through as donated buffers instead, so there too the
cache never exists twice. Inactive slots ride along pointed at the scratch
page: their writes land there and their outputs are never read.

Each program bakes no host value into an op: the prompt length and a
chunk's start are int32 ``[1]`` tensors on the device (``device_int``
normalises them once at a program's top), and the positions, the chunk's
``base``, the head's row and every write target come from device
arithmetic and indexing. So the scheduler captures each program once as a CUDA graph
(``utils/graphs.py``) and replays it on refilled static inputs.

Every weight goes through ``ops.quantizer.maybe_dequantize`` at its use
(a weight-only int8 tree dequantizes layer by layer into transients).
Sampled tokens are the JAX package's draws: the prefill and chunk
programs take the request's key (one ``[2]`` key), the decode step one key
per slot (``[B, 2]``, the JAX programs' ``vmap``), all rows drawn in one
``uniform_rows`` (the threefry kernel on the card).

Under a tensor-parallel placement (``serving/placement.py``) every
program takes the placement's process group as ``tp_group`` and the
per-rank config (``n_embd`` and ``n_head`` divided by tp) with this rank's
slices of the weights and its ``KV/tp`` pool heads: attention runs over the
local heads, and the attention and MLP output projections all-reduce their
partial products over the group before the replicated bias (JAX's
``tp_axis`` psums). ``tp_group=None`` is the plain graph.

Padded key positions contribute exact zeros through the masked softmax
(``exp(-1e30 - m)`` is 0), and a position past a slot's length is either
masked or overwritten by the decode write before it is ever attended.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch

from ..comm.torch import all_reduce
from ..models.gpt2 import GPT2Config, _layer_norm, _mlp, device_int, row_at
from ..ops.attention import paged_cached_attention, paged_multitoken_cached_attention
from ..ops.quantizer import (
    dequantize_kv_pages,
    kv_page_scale,
    maybe_dequantize,
    quantize_kv_pages,
    quantize_kv_token,
)
from ..ops.sampling import sample_logits

PyTree = Any


def _layer_params(params: PyTree, l: int) -> PyTree:
    """Layer ``l``'s slice of the stacked block params (views, no copy; a
    quantized weight's codes and scales sliced alike)."""
    def take(tree):
        if isinstance(tree, dict):
            return {k: take(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return type(tree)(*[take(v) for v in tree])
        return tree[l]
    return take(params["blocks"])


def _proj(o, w, b, tp_group=None):
    """The attention output projection. Under a tensor-parallel placement
    (``tp_group``, JAX's ``tp_axis``) ``w`` is this rank's row-parallel
    slice: the partial product is all-reduced over the group BEFORE the
    replicated bias is added once. With ``tp_group=None`` it is the plain
    ``o @ w + b``."""
    out = o @ maybe_dequantize(w, o.dtype)
    if tp_group is not None:
        out = all_reduce(out, tp_group)
    return out + b


def _qkv(lp, h):
    """The attention input projection."""
    return h @ maybe_dequantize(lp["c_attn_w"], h.dtype) + lp["c_attn_b"]


def _write_pool_pages(pool, scales, l, page_ids, chunks, sidx):
    """Whole-page write: ``chunks [n_pp, KV, page, D]`` (in the dtype of
    :func:`_pool_dtype`) into layer ``l``'s pages ``page_ids`` (in place),
    quantized with fresh page scales when the pool is int8 (``sidx`` 0 = K
    scales, 1 = V). → what attention must read
    for these tokens: the chunks, or the dequantized codes of an int8
    pool."""
    if scales is None:
        pool[l][page_ids] = chunks
        return chunks
    codes, s = quantize_kv_pages(chunks)
    pool[l][page_ids] = codes
    scales[l][page_ids, :, sidx] = s
    return dequantize_kv_pages(codes, s)


def _write_pool_tokens(pool, scales, l, pidx, poff, vals, sidx):
    """Token writes: ``vals [B, T, KV, D]`` (in the dtype of
    :func:`_pool_dtype`) to (layer ``l``, page
    ``pidx[b, t]``, offset ``poff[b, t]``) (in place); a slot's T tokens
    sit at consecutive positions. The decode step's one token per slot
    comes as ``pidx``/``poff [B]`` and ``vals [B, KV, D]``.

    int8: a token at offset 0 sets its page's scale from its own values;
    any other token codes against its page's scale as the writes before it
    left it. That is the result of writing the tokens one at a time in
    order, computed at once: token t's page was set in this call by token
    ``t - poff[b, t]`` when that index is >= 0, and otherwise keeps its
    frozen scale. (Writes past a slot's table land on the scratch page,
    whose contents no live slot reads.)"""
    if scales is None:
        pool[l][pidx, :, poff] = vals
        return
    if pidx.dim() == 1:
        pidx, poff, vals = pidx[:, None], poff[:, None], vals[:, None]
    sl = scales[l]
    T = vals.shape[1]
    opener = torch.arange(T, device=poff.device)[None, :] - poff  # [B, T]
    fresh = kv_page_scale(vals)  # [B, T, KV]
    fresh = fresh.gather(1, opener.clamp(min=0)[..., None].expand_as(fresh))
    s = torch.where((opener >= 0)[..., None], fresh, sl[pidx, :, sidx])
    pool[l][pidx, :, poff] = quantize_kv_token(vals, s)
    sl[pidx, :, sidx] = s


def _pool_dtype(pool, scales, compute_dtype):
    """The dtype K/V are cast to before the write: the pool's, or for an
    int8 pool the compute dtype (the codec quantizes from it)."""
    return compute_dtype if scales is not None else pool.dtype


def _logits(cfg: GPT2Config, params, h_last):
    h_last = _layer_norm(
        h_last, params["ln_f"]["scale"], params["ln_f"]["bias"], cfg.layer_norm_epsilon
    )
    return (h_last @ params["wte"].T)[..., : cfg.vocab_size]


# ---------------------------------------------------------------------------
# paged prefill (one request into one slot's pages)
# ---------------------------------------------------------------------------

def _attention_prefill_paged(cfg, lp, h, k_pool, v_pool, page_ids, l, scales=None,
                             tp_group=None):
    """Causal self-attention over the prompt, its K/V written to layer
    ``l``'s pages. The prompt starts at position 0 of a fresh slot, so the
    cache is the prompt itself: the attention is a dense causal
    matmul + masked softmax in f32, as the JAX package computes it outside
    any kernel. An int8 pool's prompt attends its dequantized codes, as
    every later read of those pages does."""
    B, Sp, E = h.shape
    H, D = cfg.n_head, cfg.head_dim
    page = k_pool.shape[3]
    qkv = _qkv(lp, h)
    q, k_, v = qkv.split(H * D, dim=-1)
    q = q.reshape(B, Sp, H, D)
    pool_dt = _pool_dtype(k_pool, scales, h.dtype)
    k_c = k_.reshape(B, Sp, H, D).to(pool_dt)
    v_c = v.reshape(B, Sp, H, D).to(pool_dt)

    # [Sp, H, D] → [n_pp, H, page, D] whole pages; padded page ids point at
    # the scratch page, and garbage positions stay masked until the decode
    # write claims them
    n_pp = Sp // page
    k_att = _write_pool_pages(k_pool, scales, l, page_ids,
                              k_c[0].reshape(n_pp, page, H, D).transpose(1, 2), 0)
    v_att = _write_pool_pages(v_pool, scales, l, page_ids,
                              v_c[0].reshape(n_pp, page, H, D).transpose(1, 2), 1)
    if scales is not None:
        # [n_pp, KV, page, D] dequantized (f32) → the [B, Sp, H, D] prompt
        k_c = k_att.transpose(1, 2).reshape(B, Sp, H, D)
        v_c = v_att.transpose(1, 2).reshape(B, Sp, H, D)

    scale = 1.0 / math.sqrt(D)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k_c.float()) * scale
    causal = torch.ones(Sp, Sp, dtype=torch.bool, device=h.device).tril()
    scores = torch.where(causal, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(v_c.dtype)
    o = torch.einsum("bhst,bthd->bshd", probs, v_c)
    o = o.reshape(B, Sp, H * D).to(h.dtype)
    return _proj(o, lp["c_proj_w"], lp["c_proj_b"], tp_group)


@torch.no_grad()
def paged_prefill(
    cfg: GPT2Config,
    params: PyTree,
    input_ids: torch.Tensor,   # [1, Sp] right-padded to the prefill width
    prompt_len,                # true prompt length: int32 [1] on the device
    k_pool: torch.Tensor,      # [L, P, KV, page, D], written in place
    v_pool: torch.Tensor,
    page_ids: torch.Tensor,    # [Sp // page] slot pages (scratch-padded)
    key=None,                  # [2] the request's key (temperature > 0)
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    return_logits: bool = False,
    scales: Optional[torch.Tensor] = None,  # [L, P, KV, 2] of an int8 pool
    tp_group=None,             # a tensor-parallel placement's group
):
    """→ first token ``[1]`` (and its logits ``[1, V]`` when asked)."""
    B, Sp = input_ids.shape
    eps = cfg.layer_norm_epsilon
    prompt_len = device_int(prompt_len, input_ids.device)
    positions = torch.arange(Sp, device=input_ids.device)
    h = params["wte"][input_ids.long()] + params["wpe"][positions][None, :, :]
    page_ids = page_ids.long()

    for l in range(cfg.n_layer):
        lp = _layer_params(params, l)
        h = h + _attention_prefill_paged(
            cfg, lp["attn"],
            _layer_norm(h, lp["ln_1"]["scale"], lp["ln_1"]["bias"], eps),
            k_pool, v_pool, page_ids, l, scales, tp_group,
        )
        h = h + _mlp(cfg, lp["mlp"], _layer_norm(h, lp["ln_2"]["scale"], lp["ln_2"]["bias"], eps),
                     tp_group=tp_group)

    logits = _logits(cfg, params, row_at(h, prompt_len - 1))
    first = sample_logits(logits, key, temperature, top_k, top_p)
    return (first, logits) if return_logits else first


# ---------------------------------------------------------------------------
# paged decode step (one token for every slot)
# ---------------------------------------------------------------------------

def _attention_decode_paged(cfg, lp, h, k_pool, v_pool, block_tables, pos, pidx, poff, l,
                            scales=None, tp_group=None):
    """One-token attention per slot against its paged cache (layer ``l``).
    ``pos[b]`` = tokens already cached for slot b = the new token's
    position; the new K/V is written at (page ``pidx[b]``, offset
    ``poff[b]``) before attention reads the pool."""
    B, S, _ = h.shape  # S == 1
    H, D = cfg.n_head, cfg.head_dim
    qkv = _qkv(lp, h)
    q, k_, v = qkv.split(H * D, dim=-1)
    q = q.reshape(B, H, D).contiguous()
    pool_dt = _pool_dtype(k_pool, scales, h.dtype)
    _write_pool_tokens(k_pool, scales, l, pidx, poff, k_.reshape(B, H, D).to(pool_dt), 0)
    _write_pool_tokens(v_pool, scales, l, pidx, poff, v.reshape(B, H, D).to(pool_dt), 1)
    o = paged_cached_attention(
        q, k_pool[l], v_pool[l], block_tables, pos, sm_scale=1.0 / math.sqrt(D),
        scales=scales[l] if scales is not None else None,
    )
    o = o.reshape(B, S, H * D).to(h.dtype)
    return _proj(o, lp["c_proj_w"], lp["c_proj_b"], tp_group)


@torch.no_grad()
def paged_decode_step(
    cfg: GPT2Config,
    params: PyTree,
    tokens: torch.Tensor,        # [B] last emitted token per slot
    seq_lens: torch.Tensor,      # [B] int32 tokens already cached per slot
    k_pool: torch.Tensor,        # [L, P, KV, page, D], written in place
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [B, n] int32
    keys=None,                   # [B, 2] per-slot keys (temperature > 0)
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    return_logits: bool = False,
    scales: Optional[torch.Tensor] = None,  # [L, P, KV, 2] of an int8 pool
    tp_group=None,               # a tensor-parallel placement's group
):
    """→ next tokens ``[B]`` (and the logits ``[B, V]`` when asked). Greedy
    unless ``temperature > 0``; then slot b draws with ``keys[b]``, every
    slot in one draw (an inactive slot's token is never read)."""
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
            k_pool, v_pool, block_tables, seq_lens, pidx, poff, l, scales, tp_group,
        )
        h = h + _mlp(cfg, lp["mlp"], _layer_norm(h, lp["ln_2"]["scale"], lp["ln_2"]["bias"], eps),
                     tp_group=tp_group)

    logits = _logits(cfg, params, h[:, -1])
    nxt = sample_logits(logits, keys, temperature, top_k, top_p)
    return (nxt, logits) if return_logits else nxt


# ---------------------------------------------------------------------------
# multi-token programs: speculative verify and chunked prefill
#
# Both take T tokens per slot in one pass with the decode step's
# update-then-attend order: write the T tokens' K/V into the pool, then
# attend with the per-query mask key <= base + t. The batched matmuls (QKV,
# MLP, logits) are row-independent across the query dim. The verify step
# attends its T queries as T single-token calls of the decode attention, so
# query t's attention is exactly the decode step's at pos = base + t; the
# chunk program attends all its queries in one call of the multi-token
# kernel. Chunking reorders prefill arithmetic, so chunked streams are held
# to token identity, not bits. (On the card the GEMMs of the verify step's
# B*T rows may take another algorithm than the decode step's B rows, so the
# verify stream too is held to token identity there.)
# ---------------------------------------------------------------------------

def _attend_multitoken_paged(cfg, h, q, k_pool_l, v_pool_l, block_tables, base,
                             scales_l=None):
    """Attention of the chunk program: ``q [B, T, H, D]`` against the
    (already written) paged cache, masked per query → ``[B, T, H * D]``;
    the caller applies the output projection."""
    B, T, _ = h.shape
    H, D = cfg.n_head, cfg.head_dim
    o = paged_multitoken_cached_attention(
        q.contiguous(), k_pool_l, v_pool_l, block_tables, base,
        sm_scale=1.0 / math.sqrt(D), scales=scales_l,
    )
    return o.reshape(B, T, H * D).to(h.dtype)


def _verify_write_targets(seq_lens, block_tables, page: int, T: int):
    """→ (pidx [B, T], poff [B, T]) write targets of the tokens at positions
    ``seq_lens + t``. Positions past the block-table row (a draft running
    past the slot's reservation; the scheduler never emits those tokens) go
    to the scratch page, never clamped into a real page, which would
    overwrite live cache entries."""
    B, W = block_tables.shape
    pos = seq_lens.long()[:, None] + torch.arange(T, device=seq_lens.device)[None, :]
    page_i = pos // page
    gathered = block_tables.long().gather(1, page_i.clamp(max=W - 1))
    pidx = torch.where(page_i < W, gathered, torch.zeros_like(gathered))
    return pidx, pos % page


def _attention_verify_paged(cfg, lp, h, k_pool, v_pool, block_tables, base, pidx, poff, l,
                            scales=None, tp_group=None):
    """T-token attention per slot: write every token's K/V to layer ``l`` at
    (``pidx[b, t]``, ``poff[b, t]``), then attend query t at position
    ``base + t`` through the block table with one single-token call each.
    Query t's mask (key <= base + t) hides the K/V already written for the
    queries after it, exactly as it hides any stale cache content, so
    write-all-then-attend equals the sequential write/attend interleaving."""
    B, T, _ = h.shape
    H, D = cfg.n_head, cfg.head_dim
    qkv = _qkv(lp, h)
    q, k_, v = qkv.split(H * D, dim=-1)
    q = q.reshape(B, T, H, D)
    pool_dt = _pool_dtype(k_pool, scales, h.dtype)
    # [B, T, KV, D] values to (pidx[b, t], :, poff[b, t]): the advanced
    # index pair around the head slice puts (B, T) first. int8: a token at
    # a page's offset 0 sets the page's scale and the tokens after it in
    # this step code against it, as T sequential decode steps would
    _write_pool_tokens(k_pool, scales, l, pidx, poff, k_.reshape(B, T, H, D).to(pool_dt), 0)
    _write_pool_tokens(v_pool, scales, l, pidx, poff, v.reshape(B, T, H, D).to(pool_dt), 1)
    scale = 1.0 / math.sqrt(D)
    scales_l = scales[l] if scales is not None else None
    o = torch.cat([
        paged_cached_attention(
            q[:, t].contiguous(), k_pool[l], v_pool[l], block_tables,
            base + t, sm_scale=scale, scales=scales_l,
        ).reshape(B, 1, H * D).to(h.dtype)
        for t in range(T)
    ], dim=1)
    return _proj(o, lp["c_proj_w"], lp["c_proj_b"], tp_group)


@torch.no_grad()
def paged_verify_step(
    cfg: GPT2Config,
    params: PyTree,
    tokens: torch.Tensor,        # [B, T] col 0 = last emitted, cols 1.. = drafts
    seq_lens: torch.Tensor,      # [B] int32 tokens already cached per slot
    k_pool: torch.Tensor,        # [L, P, KV, page, D], written in place
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [B, W] int32
    return_logits: bool = False,
    scales: Optional[torch.Tensor] = None,  # [L, P, KV, 2] of an int8 pool
    tp_group=None,               # a tensor-parallel placement's group
):
    """Self-speculative verify: score T = k+1 tokens per slot in one pass →
    ``greedy [B, T]`` (and the logits ``[B, T, V]`` when asked).

    ``greedy[b, t]`` is the argmax next token after prefix + tokens[b, :t+1],
    what :func:`paged_decode_step` would emit there. The host accepts the
    longest prefix with ``tokens[b, t+1] == greedy[b, t]`` and emits
    ``greedy[b, :accepted+1]``. Rejected drafts leave K/V past the accepted
    length; the next step's writes cover every such position before
    anything attends it (``new_base = base + accepted + 1 <= base + T``)."""
    B, T = tokens.shape
    page = k_pool.shape[3]
    eps = cfg.layer_norm_epsilon
    seq_lens = seq_lens.to(torch.int32).contiguous()
    block_tables = block_tables.to(torch.int32).contiguous()
    # positions past the model's table (past the decode budget) are clamped
    # into it: their queries are never emitted and their writes go to scratch
    positions = (
        seq_lens.long()[:, None] + torch.arange(T, device=tokens.device)[None, :]
    ).clamp(max=cfg.n_positions - 1)
    h = params["wte"][tokens.long()] + params["wpe"][positions]
    pidx, poff = _verify_write_targets(seq_lens, block_tables, page, T)

    for l in range(cfg.n_layer):
        lp = _layer_params(params, l)
        h = h + _attention_verify_paged(
            cfg, lp["attn"],
            _layer_norm(h, lp["ln_1"]["scale"], lp["ln_1"]["bias"], eps),
            k_pool, v_pool, block_tables, seq_lens, pidx, poff, l, scales, tp_group,
        )
        h = h + _mlp(cfg, lp["mlp"], _layer_norm(h, lp["ln_2"]["scale"], lp["ln_2"]["bias"], eps),
                     tp_group=tp_group)

    logits = _logits(cfg, params, h)
    greedy = torch.argmax(logits.float(), dim=-1)
    return (greedy, logits) if return_logits else greedy


@torch.no_grad()
def paged_chunk_prefill(
    cfg: GPT2Config,
    params: PyTree,
    input_ids: torch.Tensor,     # [1, C] one chunk, right-padded past the prompt
    start,                       # position of input_ids[0, 0] (page-aligned): int32 [1]
    prompt_len,                  # the request's true prompt length: int32 [1]
    k_pool: torch.Tensor,        # [L, P, KV, page, D], written in place
    v_pool: torch.Tensor,
    page_ids: torch.Tensor,      # [C // page] this chunk's slot pages (scratch-padded)
    block_tables: torch.Tensor,  # [1, W] int32 the slot's full table row
    key=None,                    # [2] the request's key (temperature > 0)
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    return_logits: bool = False,
    scales: Optional[torch.Tensor] = None,  # [L, P, KV, 2] of an int8 pool
    tp_group=None,               # a tensor-parallel placement's group
):
    """One chunk of an incremental prefill → token ``[1]`` (and its logits
    ``[1, V]`` when asked), sampled at the true last prompt position; only
    the final chunk's token is meaningful.

    Positions ``start .. start+C-1`` run through the model attending the
    slot's cached prefix (positions < start) plus causal intra-chunk; their
    K/V is written page by page to ``page_ids`` before attention reads the
    pool (update-then-attend)."""
    B, C = input_ids.shape
    page = k_pool.shape[3]
    n_cp = C // page
    eps = cfg.layer_norm_epsilon
    H, D = cfg.n_head, cfg.head_dim
    dev = input_ids.device
    start, prompt_len = device_int(start, dev), device_int(prompt_len, dev)
    positions = (start.long() + torch.arange(C, device=dev)).clamp(max=cfg.n_positions - 1)
    h = params["wte"][input_ids.long()] + params["wpe"][positions][None, :, :]
    page_ids = page_ids.long()
    block_tables = block_tables.to(torch.int32).contiguous()
    base = start.expand(B).contiguous()

    for l in range(cfg.n_layer):
        lp = _layer_params(params, l)
        attn = lp["attn"]
        hn = _layer_norm(h, lp["ln_1"]["scale"], lp["ln_1"]["bias"], eps)
        qkv = _qkv(attn, hn)
        q, k_, v = qkv.split(H * D, dim=-1)
        q = q.reshape(B, C, H, D)
        # page-granular write, exactly paged_prefill's (the attention below
        # reads the pool, so an int8 chunk attends its dequantized codes)
        pool_dt = _pool_dtype(k_pool, scales, hn.dtype)
        _write_pool_pages(k_pool, scales, l, page_ids,
                          k_.to(pool_dt).reshape(n_cp, page, H, D).transpose(1, 2), 0)
        _write_pool_pages(v_pool, scales, l, page_ids,
                          v.to(pool_dt).reshape(n_cp, page, H, D).transpose(1, 2), 1)
        o = _attend_multitoken_paged(cfg, hn, q, k_pool[l], v_pool[l], block_tables, base,
                                     scales[l] if scales is not None else None)
        h = h + _proj(o, attn["c_proj_w"], attn["c_proj_b"], tp_group)
        h = h + _mlp(cfg, lp["mlp"], _layer_norm(h, lp["ln_2"]["scale"], lp["ln_2"]["bias"], eps),
                     tp_group=tp_group)

    # the true last prompt position, when it falls inside this chunk
    idx = (prompt_len - 1 - start).clamp(0, C - 1)
    logits = _logits(cfg, params, row_at(h, idx))
    first = sample_logits(logits, key, temperature, top_k, top_p)
    return (first, logits) if return_logits else first
