"""One causal decoder for the HF GPT family: OPT, BLOOM, GPT-J, GPT-Neo,
GPT-NeoX, Megatron GPT, LLaMA and Mistral (counterpart of
``deepspeed_tpu/models/decoder.py``).

The config covers the axes on which these models differ:

- positions: learned (OPT's ``pos_offset``), rope (GPT-J's interleaved
  pairs or NeoX's half split, over ``rotary_dim`` dims, base
  ``rope_theta``), alibi (BLOOM) or none;
- the residual: sequential, or parallel (GPT-J / NeoX), with one shared
  norm when ``use_ln2`` is off (GPT-J);
- the MLP: dense with gelu_new / gelu / relu, or SwiGLU (LLaMA); the norm:
  LayerNorm or RMSNorm; BLOOM's embedding norm;
- attention: ``attn_scale`` (GPT-Neo uses none), per-layer
  ``local_windows`` (0 = global), grouped-query ``n_kv_head``;
- the head: tied to ``wte`` or untied, with an optional bias.

Parameters keep the JAX package's layout (stacked ``blocks`` ``[L, ...]``,
``x @ W`` weights; separate ``wq``/``wk``/``wv``/``wo``; ``fc_in_w``,
``fc_out_w`` and SwiGLU's ``fc_gate_w``), so a tree moves between the two
packages unchanged. Every block weight goes through
``ops.quantizer.maybe_dequantize``, so an int8 tree serves too.

Attention takes JAX's routes (``deepspeed_tpu/models/decoder.py:170-296``):

- a full sequence from position 0 that fills its cache (``hidden``,
  ``forward``), without alibi, goes to ``ops.attention.causal_attention``
  (the flash kernels on the card), with the layer's window when one bites
  and GQA K/V as they are (the kernels read each group's K/V head);
- a single-token step without alibi whose windows cannot bite within the
  cache goes to ``ops.attention.cached_attention`` (the contiguous decode
  kernel on the card), GQA likewise;
- everything else (alibi, a window that bites during decode, a prompt
  shorter than its cache) is plain tensor code, as in the JAX package: a
  grouped einsum that never repeats the KV-headed cache.

``mlp_type="moe_swiglu"`` (Mixtral) waits for the MoE layer: ROADMAP queue
1 item 12d.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import prng
from ..ops.attention import cached_attention, causal_attention
from ..ops.layer_norm import layer_norm, rms_norm
from ..ops.quantizer import maybe_dequantize as _deq
from ..ops.sampling import sample_logits
from ..runtime.config import NotPortedError
from .gpt2 import (GenerateState, KVCache, _sampled, _unstack, device_int,
                   generate_input_shapes, generate_inputs, row_at)

PyTree = Any

__all__ = ["DecoderConfig", "KVCache", "GenerateState", "alibi_slopes", "forward",
           "forward_cached", "generate", "generate_input_shapes", "generate_prefill",
           "generate_step", "hidden", "init_cache", "init_generate_state"]


@dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int
    n_positions: int
    n_embd: int
    n_layer: int
    n_head: int
    ffn_dim: int
    layer_norm_epsilon: float = 1e-5
    pos_emb: str = "learned"  # learned | rope | alibi | none
    rope_style: str = "gptj"  # gptj (interleaved) | neox (half split)
    rotary_dim: int = 0  # 0: the whole head dim
    activation: str = "gelu_new"  # gelu_new | gelu | relu
    parallel_residual: bool = False  # GPT-J / NeoX: h + attn(ln(h)) + mlp(ln(h))
    use_ln2: bool = True  # a parallel residual with one shared norm (GPT-J): False
    tie_embeddings: bool = True
    lm_head_bias: bool = False
    embed_ln: bool = False  # BLOOM's word-embedding norm
    pos_offset: int = 0  # OPT's position offset (2)
    attn_scale: Optional[float] = None  # None: 1/sqrt(head_dim); GPT-Neo: 1.0
    local_windows: Tuple[int, ...] = ()  # per layer, 0 = global
    norm: str = "layernorm"  # layernorm | rmsnorm (scale only)
    mlp_type: str = "dense"  # dense | swiglu | moe_swiglu (item 12d)
    n_kv_head: Optional[int] = None  # grouped-query attention; None: n_head
    rope_theta: float = 10000.0
    moe_experts: int = 0  # > 0 (Mixtral's MoE FFN): item 12d

    def __post_init__(self):
        if self.mlp_type == "moe_swiglu" or self.moe_experts > 0:
            raise NotPortedError(
                f"DecoderConfig(mlp_type={self.mlp_type!r}, moe_experts={self.moe_experts}): "
                "the MoE FFN is not ported to deepspeed_tpu_torch yet (ROADMAP queue 1 "
                "item 12d)")
        for key, allowed in (("pos_emb", ("learned", "rope", "alibi", "none")),
                             ("rope_style", ("gptj", "neox")),
                             ("activation", ("gelu_new", "gelu", "relu")),
                             ("norm", ("layernorm", "rmsnorm")),
                             ("mlp_type", ("dense", "swiglu"))):
            if getattr(self, key) not in allowed:
                raise ValueError(f"DecoderConfig.{key}={getattr(self, key)!r} ({' | '.join(allowed)})")
        if self.local_windows and len(self.local_windows) != self.n_layer:
            raise ValueError(f"local_windows has {len(self.local_windows)} entries for "
                             f"{self.n_layer} layers")
        if self.n_head % self.kv_heads:
            raise ValueError(f"n_kv_head={self.n_kv_head} must divide n_head={self.n_head}")

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def kv_heads(self) -> int:
        return self.n_kv_head or self.n_head

    def window(self, layer: int) -> int:
        return int(self.local_windows[layer]) if self.local_windows else 0


def init_cache(cfg: DecoderConfig, batch_size: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device=None) -> KVCache:
    """The stacked cache ``[L, B, max_len, KV, D]`` (GQA caches its KV heads
    only) and ``pos`` an int32 ``[1]`` tensor at 0, on ``device``."""
    shape = (cfg.n_layer, batch_size, max_len, cfg.kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   pos=torch.zeros(1, dtype=torch.int32, device=device))


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def _norm(cfg: DecoderConfig, x, p, eps):
    if cfg.norm == "rmsnorm":
        return rms_norm(x, p["scale"], eps)
    return layer_norm(x, p["scale"], p["bias"], eps)


def _act(cfg: DecoderConfig, x):
    if cfg.activation == "relu":
        return F.relu(x)
    return F.gelu(x, approximate="tanh" if cfg.activation == "gelu_new" else "none")


def alibi_slopes(n_head: int) -> np.ndarray:
    """ALiBi's slopes (the power-of-two geometric series; BLOOM's formula)."""

    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(np.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if np.log2(n_head).is_integer():
        return np.asarray(pow2_slopes(n_head), np.float32)
    closest = 2 ** int(np.floor(np.log2(n_head)))
    extra = pow2_slopes(2 * closest)[0::2][: n_head - closest]
    return np.asarray(pow2_slopes(closest) + extra, np.float32)


def _rope_angles(cfg: DecoderConfig, positions: torch.Tensor):
    """``(sin, cos)`` ``[S, rot/2]`` f32 of the int ``positions [S]``."""
    rot = cfg.rotary_dim or cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, rot, 2, dtype=torch.float32, device=positions.device) / rot))
    ang = positions.float()[:, None] * inv_freq[None, :]
    return torch.sin(ang), torch.cos(ang)


def _apply_rope(cfg: DecoderConfig, x, sin, cos):
    """Rotate the first ``rotary_dim`` dims of ``x [B, S, H, D]`` by
    ``rope_style``."""
    rot = cfg.rotary_dim or cfg.head_dim
    xr, xp = x[..., :rot], x[..., rot:]
    s, c = sin[None, :, None, :], cos[None, :, None, :]
    if cfg.rope_style == "gptj":  # interleaved pairs (rotate_every_two)
        x1, x2 = xr[..., 0::2], xr[..., 1::2]
        rotated = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).reshape(xr.shape)
    else:  # neox: half split (rotate_half)
        half = rot // 2
        x1, x2 = xr[..., :half], xr[..., half:]
        rotated = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return torch.cat([rotated, xp], dim=-1).to(x.dtype)


def windows_inert(cfg: DecoderConfig, span: int) -> bool:
    """No layer's window can mask anything within ``span`` positions (w ==
    0 is global, w >= span a mask that keeps everything): Mistral's 4096
    at shorter lengths, where the unwindowed routes are exact."""
    return not cfg.local_windows or all(w == 0 or w >= span for w in cfg.local_windows)


def _attention(cfg: DecoderConfig, lp, h, k_cache, v_cache, pos, window: int,
               full_seq: bool):
    """Attention of ``h [B, S, E]`` against one layer's cache ``[B, Smax,
    KV, D]``, written in place at rows ``pos .. pos + S - 1``. ``full_seq``:
    the sequence starts at 0 and fills the cache (``hidden``), ``pos`` then
    unused; otherwise ``pos`` is an int32 ``[1]`` tensor on the device."""
    B, S, E = h.shape
    H, D, KV = cfg.n_head, cfg.head_dim, cfg.kv_heads

    def proj(w, b, nh):
        out = h @ _deq(w, h.dtype)
        return (out + b if b is not None else out).reshape(B, S, nh, D)

    def out_proj(o):
        out = o.reshape(B, S, E).to(h.dtype) @ _deq(lp["wo"], h.dtype)
        return out + lp["bo"] if lp.get("bo") is not None else out

    q = proj(lp["wq"], lp.get("bq"), H)
    k_ = proj(lp["wk"], lp.get("bk"), KV)
    v = proj(lp["wv"], lp.get("bv"), KV)
    if full_seq:
        rows = torch.arange(S, device=h.device)
    else:
        rows = pos.long() + torch.arange(S, device=h.device)
    if cfg.pos_emb == "rope":
        sin, cos = _rope_angles(cfg, rows)
        q = _apply_rope(cfg, q, sin, cos)
        k_ = _apply_rope(cfg, k_, sin, cos)
    scale = cfg.attn_scale if cfg.attn_scale is not None else 1.0 / math.sqrt(D)
    Smax = k_cache.shape[1]

    if full_seq and S == Smax and cfg.pos_emb != "alibi":
        # the flash kernels: GQA reads each group's K/V head, and a window
        # that bites is the kernels' band (blocks outside it skipped)
        w = window if window > 0 and window < S else None
        o = causal_attention(q.contiguous(), k_.contiguous(), v.contiguous(),
                             sm_scale=scale, window=w)
        return out_proj(o)

    k_cache.index_copy_(1, rows, k_.to(k_cache.dtype))
    v_cache.index_copy_(1, rows, v.to(v_cache.dtype))
    if S == 1 and not full_seq and cfg.pos_emb != "alibi" and windows_inert(cfg, Smax):
        # the contiguous decode kernel (RoPE is already in the cache)
        o1 = cached_attention(q[:, 0].contiguous(), k_cache, v_cache, pos, sm_scale=scale)
        return out_proj(o1)

    # plain: grouped scores against the KV-headed cache, never repeated
    rep = H // KV
    qg = q.reshape(B, S, KV, rep, D).float()
    scores = torch.einsum("bsgrd,btgd->bgrst", qg, k_cache.float()) * scale
    j = torch.arange(Smax, device=h.device)
    mask = j[None, :] <= rows[:, None]
    if window > 0:
        mask = mask & (j[None, :] > rows[:, None] - window)
    if cfg.pos_emb == "alibi":
        slopes = torch.from_numpy(alibi_slopes(H)).to(h.device).reshape(KV, rep)
        # a per-row constant shift: slopes * j is slopes * (j - i) under softmax
        scores = scores + slopes[None, :, :, None, None] * j.float()
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    o = torch.einsum("bgrst,btgd->bsgrd", probs, v_cache)
    return out_proj(o)


def _mlp(cfg: DecoderConfig, lp, x):
    if cfg.mlp_type == "swiglu":
        # LLaMA's FFN: silu(x @ gate) * (x @ up) @ down, no biases
        g = F.silu(x @ _deq(lp["fc_gate_w"], x.dtype))
        y = g * (x @ _deq(lp["fc_in_w"], x.dtype))
        return y @ _deq(lp["fc_out_w"], y.dtype)
    y = x @ _deq(lp["fc_in_w"], x.dtype)
    if lp.get("fc_in_b") is not None:
        y = y + lp["fc_in_b"]
    y = _act(cfg, y)
    y = y @ _deq(lp["fc_out_w"], y.dtype)
    if lp.get("fc_out_b") is not None:
        y = y + lp["fc_out_b"]
    return y


def _block(cfg: DecoderConfig, lp, h, k_c, v_c, pos, window: int, full_seq: bool):
    eps = cfg.layer_norm_epsilon
    ln1 = _norm(cfg, h, lp["ln_1"], eps)
    a = _attention(cfg, lp["attn"], ln1, k_c, v_c, pos, window, full_seq)
    if cfg.parallel_residual:
        m = _mlp(cfg, lp["mlp"], _norm(cfg, h, lp["ln_2"], eps) if cfg.use_ln2 else ln1)
        return h + a + m
    h = h + a
    return h + _mlp(cfg, lp["mlp"], _norm(cfg, h, lp["ln_2"], eps))


# ---------------------------------------------------------------------------
# forward paths
# ---------------------------------------------------------------------------

def _embed(cfg: DecoderConfig, params, input_ids, rows):
    h = params["wte"][input_ids.long()]
    if cfg.pos_emb == "learned":
        h = h + params["wpe"].index_select(0, rows + cfg.pos_offset)[None, :, :]
    if cfg.embed_ln:
        h = _norm(cfg, h, params["emb_ln"], cfg.layer_norm_epsilon)
    return h


def _head(cfg: DecoderConfig, params, h):
    if cfg.tie_embeddings:
        return h @ params["wte"].t()
    logits = h @ params["lm_head_w"]
    if cfg.lm_head_bias:
        logits = logits + params["lm_head_b"]
    return logits


@torch.no_grad()
def forward_cached(cfg: DecoderConfig, params: PyTree, input_ids, cache: KVCache,
                   logits_at=None) -> Tuple[torch.Tensor, KVCache]:
    """``input_ids [B, S]`` starting at ``cache.pos`` → (the last token's
    logits ``[B, V]``, the cache advanced by S). Prefill (S = prompt) and
    decode (S = 1); the cache is written in place and ``pos`` is read on
    the device only. ``logits_at``: read the head at this in-chunk
    position instead of the last."""
    S = input_ids.shape[1]
    pos = cache.pos
    rows = pos.long() + torch.arange(S, device=input_ids.device)
    h = _embed(cfg, params, input_ids, rows)
    for l, lp in enumerate(_unstack(params["blocks"], cfg.n_layer)):
        h = _block(cfg, lp, h, cache.k[l], cache.v[l], pos, cfg.window(l), False)
    h = h[:, -1] if logits_at is None else row_at(h, device_int(logits_at, h.device))
    h = _norm(cfg, h, params["ln_f"], cfg.layer_norm_epsilon)
    return _head(cfg, params, h), KVCache(k=cache.k, v=cache.v, pos=cache.pos + S)


def hidden(cfg: DecoderConfig, params: PyTree, input_ids) -> torch.Tensor:
    """The full sequence's final-norm hidden states ``[B, S, E]`` (the
    trunk before the head): attention over the whole sequence from 0, the
    flash kernels' route."""
    B, S = input_ids.shape
    h = _embed(cfg, params, input_ids, torch.arange(S, device=input_ids.device))
    # the cache a full sequence fills, every row rewritten by each layer
    # (only alibi's plain route writes and reads it)
    shape = (B, S, cfg.kv_heads, cfg.head_dim)
    k0, v0 = h.new_empty(shape), h.new_empty(shape)
    for l, lp in enumerate(_unstack(params["blocks"], cfg.n_layer)):
        h = _block(cfg, lp, h, k0, v0, None, cfg.window(l), True)
    return _norm(cfg, h, params["ln_f"], cfg.layer_norm_epsilon)


def forward(cfg: DecoderConfig, params: PyTree, input_ids) -> torch.Tensor:
    """Full-sequence logits ``[B, S, V]`` (no cache)."""
    return _head(cfg, params, hidden(cfg, params, input_ids))


# -- generate's two programs over static buffers (models/gpt2.py's contract) --

def init_generate_state(cfg: DecoderConfig, batch: int, max_len: int, max_new_tokens: int,
                        cache_dtype: torch.dtype, device) -> GenerateState:
    return GenerateState(
        cache=init_cache(cfg, batch, max_len, dtype=cache_dtype, device=device),
        out=torch.zeros((batch, int(max_new_tokens)), dtype=torch.int64, device=device),
        step=torch.zeros(1, dtype=torch.int32, device=device))


def generate_prefill(cfg: DecoderConfig, params: PyTree, state: GenerateState, inputs,
                     temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0) -> None:
    """The prefill program: the prompt into the cache, the head at ``plen
    - 1``, the first token into ``out[:, 0]``; then ``pos = plen`` and
    ``step = 1``."""
    cache = state.cache
    cache.pos.zero_()
    plen = inputs["plen"]
    logits, _ = forward_cached(cfg, params, inputs["ids"], cache, logits_at=plen - 1)
    cache.pos.copy_(plen)
    state.out[:, 0] = sample_logits(logits, inputs["key"] if _sampled(temperature) else None,
                                    temperature, top_k, top_p)
    state.step.fill_(1)


def generate_step(cfg: DecoderConfig, params: PyTree, state: GenerateState, inputs,
                  temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0) -> None:
    """The decode-step program: token ``out[:, step - 1]`` at ``pos`` → the
    next into ``out[:, step]`` (drawn with ``keys[step - 1]``); ``pos`` and
    ``step`` advance on the device."""
    t = state.step.long()
    token = state.out.index_select(1, t - 1)
    logits, _ = forward_cached(cfg, params, token, state.cache)
    key = inputs["keys"].index_select(0, t - 1)[0] if _sampled(temperature) else None
    state.out.index_copy_(1, t, sample_logits(logits, key, temperature, top_k, top_p)[:, None])
    state.cache.pos.add_(1)
    state.step.add_(1)


@torch.no_grad()
def generate(cfg: DecoderConfig, params: PyTree, input_ids, max_new_tokens: int,
             temperature: float = 0.0, rng=None, max_len: Optional[int] = None,
             cache_dtype: torch.dtype = torch.bfloat16, top_k: int = 0,
             top_p: float = 1.0) -> torch.Tensor:
    """Prefill, then ``max_new_tokens - 1`` single-token steps over the
    cache → ``[B, max_new_tokens]`` on the device. Greedy unless
    ``temperature > 0``; then JAX's draws (``models/gpt2.generate``'s key
    schedule). The eager form of the programs ``InferenceEngine.generate``
    captures."""
    B, S = input_ids.shape
    if max_len is None:
        max_len = S + max_new_tokens
    if max_len > cfg.n_positions or max_len < S + max_new_tokens:
        raise ValueError(
            f"prompt ({S}) + max_new_tokens ({max_new_tokens}) needs a cache of "
            f"{S + max_new_tokens} but max_len={max_len} (n_positions={cfg.n_positions}); "
            "a shorter cache would silently overwrite KV entries")
    if rng is None:
        rng = prng.PRNGKey(0)
    state = init_generate_state(cfg, B, max_len, max_new_tokens, cache_dtype, input_ids.device)
    inputs = generate_inputs(input_ids, S, rng, max_new_tokens)
    sample = dict(temperature=temperature, top_k=top_k, top_p=top_p)
    generate_prefill(cfg, params, state, inputs, **sample)
    for _ in range(max_new_tokens - 1):
        generate_step(cfg, params, state, inputs, **sample)
    return state.out
