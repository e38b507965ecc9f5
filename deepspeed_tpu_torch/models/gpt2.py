"""GPT-2: config, presets, parameter initialiser, the block pieces the
serving programs are built from, the training trunk and loss, and
incremental decode over a contiguous KV cache (``forward_cached``,
``generate``).

Counterpart of ``deepspeed_tpu/models/gpt2.py``. Parameters keep the JAX
package's layout: a nested dict with the blocks stacked on a leading
``[L, ...]`` axis and weights in the ``x @ W`` convention (``c_attn_w`` is
``[E, 3E]``), so a tree can move between the two packages unchanged. The
training trunk walks the stacked blocks in a Python loop (the JAX
package's ``lax.scan``), with ``remat`` wrapping each block in
``torch.utils.checkpoint`` (``remat_policy`` "full") or in the selective
checkpoint of ``runtime.activation_checkpointing`` ("attn", "dots");
attention goes through
``ops.attention.causal_attention`` (the flash kernels on the card), or,
with ``attn_impl="sparse"``, through ``ops.sparse_attention`` (the
block-sparse kernels on the card). The
cached decode step's attention goes through ``ops.attention.cached_attention``
(the contiguous decode kernel on the card).

Every weight use goes through ``ops.quantizer.maybe_dequantize``, so one
forward serves a full-precision tree and a weight-only int8 one (the
stacked ``[L, G, I/G, O]`` codes and ``[L, G, 1, O]`` scales sliced per
layer, dequantized into a transient at each use). Training with
``dropout > 0`` draws JAX's masks from JAX's key schedule (the threefry
kernel on the card, ``ops/dropout.py``): the embedding's from
``fold_in(rng, n_layer)``, layer l's from ``split(fold_in(rng, 0),
n_layer)[l]`` split three ways (the attention output's, MoE routing's,
unused here, and the MLP output's). :func:`dropout_key_table` derives all
of a key's dropout keys on the host as one ``[1 + 3 n_layer, 2]`` table;
the training engine uploads each step's tables in one copy and hands the
loss the device table, whose rows the dropout kernel reads where they lie.
``generate`` samples with JAX's keys:
the first token with ``rng``, step t with ``split(fold_in(rng, 1), N -
1)[t - 1]``.

Sequence and tensor parallelism (the ``sp`` and ``tp`` axes of the engine's
mesh, active while its step runs). GSPMD did three
things for the JAX trunk that this one does explicitly under ``sp``: rank r
embeds positions ``[r S_loc, (r + 1) S_loc)``; the labels arrive shifted on
the whole host batch (the engine's ``"__labels__"`` leaf, from
:func:`next_token_labels`), so a shard's last position is labelled by the
next shard's first token; and the loss divides by the global token count.
``attn_impl`` "ring", "ring_flash" and "ulysses" go through
``parallel.sequence.sequence_parallel_attention``. Under ``tp`` each rank
holds its Megatron slices (:func:`logical_axes` under the rules of
``runtime.zero.partitioning``, the fused QKV regrouped so that a slice is
``[Q_r | K_r | V_r]``): the vocab-parallel embedding (a masked lookup,
then an all-reduce) and tied head with its cross-entropy (the max, the
exp-sum and the target logit each reduced over tp), column-parallel
``c_attn`` and ``c_fc`` behind ``comm.copy_to_group``, row-parallel
``c_proj`` reduced by ``comm.reduce_from_group``, attention over the local
heads. ``partition_activations`` keeps each remat block's saved input as
this rank's ``1/tp`` slice of E (all-gathered in backward) and
``cpu_checkpointing`` keeps it in pinned host memory
(``runtime.activation_checkpointing.boundary_checkpoint``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np

import torch
import torch.nn.functional as F

from ..comm.torch import all_gather, all_reduce, copy_to_group, reduce_from_group
from ..ops import block_sparse_attention as bsa
from ..ops import flash_attention as fa
from ..ops import prng
from ..ops.dropout import dropout as _dropout_op
from ..ops.attention import cached_attention, causal_attention
from ..ops.layer_norm import layer_norm
from ..ops import ring_flash_attention as rfa
from ..ops.quantizer import maybe_dequantize
from ..ops.sampling import sample_logits
from ..ops.sparse_attention import FixedSparsityConfig, from_ds_config, sparse_attention
from ..parallel import sequence as seqp
from ..parallel.topology import current_mesh
from ..runtime.activation_checkpointing import (
    POLICIES,
    boundary_checkpoint,
    checkpoint,
    selective_checkpoint,
)
from ..runtime.config import NotPortedError
from ..runtime.module import ModuleSpec
from .lm_loss import head_token_loss, loss_count, next_token_labels

PyTree = Any

_ATTN_IMPLS = ("auto", "pallas", "jnp", "sparse", "ring", "ring_flash", "ulysses")


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
    # (dropout applies when the loss is given a key and train is on)
    dropout: float = 0.0
    remat: bool = False
    remat_policy: str = "full"
    # auto | pallas (both: the CUDA kernels on the card) | jnp (CPU tensors
    # only) | sparse (block-sparse attention under ``sparsity``)
    attn_impl: str = "auto"
    ce_chunk: int = 0
    moe_experts: int = 0
    # for attn_impl="sparse": a SparsityConfig (None: FixedSparsityConfig at
    # n_head), built from a config's ``sparse_attention`` section by
    # get_config(..., sparse_attention=section)
    sparsity: Any = None
    # activation checkpointing (JAX's fields of the same names): under
    # remat, keep each block's saved input as this rank's 1/tp slice of E
    # (all-gathered in backward) and/or in pinned host memory
    partition_activations: bool = False
    cpu_checkpointing: bool = False

    def __post_init__(self):
        if self.moe_experts > 0:
            raise NotPortedError(f"moe_experts={self.moe_experts}: MoE is not ported yet "
                                 "(ROADMAP queue 1 item 12)")
        if self.attn_impl not in _ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}")
        if self.remat_policy not in POLICIES:
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
    """A preset with ``overrides``. ``sparse_attention=section`` (a dict or
    the typed ``SparseAttentionConfig``) turns on block-sparse attention
    with the section's pattern; an explicit ``attn_impl`` wins."""
    base = dict(PRESETS[name])
    base.update(overrides)
    section = base.pop("sparse_attention", None)
    if section is not None:
        base.setdefault("attn_impl", "sparse")
        base["sparsity"] = from_ds_config(section, base.get("n_head", 12))
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


def _dot(ops, x, w):
    """``x @ w`` (``w`` dequantized when it is int8); under a selective
    remat, the policy's ``ops.dot``."""
    w = maybe_dequantize(w, x.dtype)
    return x @ w if ops is None else ops.dot(x, w)


def _dropout(x, rate: float, key, train: bool):
    """JAX's ``_dropout``: ``x`` unchanged unless training at a rate > 0
    with a key."""
    if not train or rate <= 0.0 or key is None:
        return x
    return _dropout_op(x, key, rate)


def _mlp(cfg: GPT2Config, lp, h, ops=None, tp_group=None, par=None):
    """Dense FFN: ``gelu_tanh(h @ c_fc_w + c_fc_b) @ c_proj_w + c_proj_b``
    (the tanh GELU matches ``jax.nn.gelu(approximate=True)``).

    ``tp_group``: a tensor-parallel serving placement's group (JAX's
    ``tp_axis``). The weights are then this rank's column-parallel
    ``c_fc`` and row-parallel ``c_proj`` slices, and the partial product
    is all-reduced over the group in the compute dtype BEFORE the
    replicated bias is added once (a bias added on every rank would count
    tp times). ``par``: the training trunk's :class:`_Parallel`; under tp
    the same slices, with Megatron's differentiable pair around them. None
    for both is the plain graph."""
    if par is not None and par.tp_group is not None:
        h = copy_to_group(h, par.tp_group)
    x = _dot(ops, h, lp["c_fc_w"]) + lp["c_fc_b"]
    x = F.gelu(x, approximate="tanh")
    out = _dot(ops, x, lp["c_proj_w"])
    if tp_group is not None:
        out = all_reduce(out, tp_group)
    if par is not None and par.tp_group is not None:
        out = reduce_from_group(out, par.tp_group)
    return out + lp["c_proj_b"]


# ---------------------------------------------------------------------------
# training trunk
# ---------------------------------------------------------------------------

class _Parallel(NamedTuple):
    """The trunk's view of the mesh: the sp and tp groups (None at size 1
    or without a process group), this rank's coordinates and the sizes."""

    mesh: Any
    sp_group: Any
    sp_rank: int
    sp: int
    tp_group: Any
    tp_rank: int
    tp: int


_SERIAL = _Parallel(None, None, 0, 1, None, 0, 1)


def _parallel(cfg: GPT2Config) -> _Parallel:
    """The sp and tp groups of the mesh the trunk runs in: the engine's,
    active while its step runs (JAX's models read ``cfg.mesh``)."""
    mesh = current_mesh()
    if mesh is None:
        return _SERIAL
    sp_g, tp_g = mesh.group_or_none("sp"), mesh.group_or_none("tp")
    if tp_g is not None:
        for what, n in (("n_head", cfg.n_head), ("4 n_embd", 4 * cfg.n_embd),
                        ("padded_vocab_size", cfg.padded_vocab_size)):
            if n % mesh.size("tp"):
                raise ValueError(f"tp={mesh.size('tp')} must divide {what} ({n})"
                                 + ("; set pad_vocab_multiple" if "vocab" in what else ""))
    return _Parallel(mesh, sp_g, mesh.axis_rank("sp") if sp_g is not None else 0,
                     mesh.size("sp") if sp_g is not None else 1,
                     tp_g, mesh.axis_rank("tp") if tp_g is not None else 0,
                     mesh.size("tp") if tp_g is not None else 1)


def _attention_parts(cfg: GPT2Config, q, par: _Parallel = _SERIAL):
    """The trunk's attention for q's device as ``(forward, backward,
    options)``, which a selective remat calls apart: the flash or
    block-sparse kernels on the card, their plain versions on the CPU; under
    sp the ring of flash steps (of their plain versions on the CPU). None:
    Ulysses, which the remat then recomputes whole."""
    if q.device.type == "cuda" and cfg.attn_impl == "jnp":
        raise ValueError("attn_impl='jnp' (the plain version) does not run on the card")
    if cfg.attn_impl in seqp.IMPLS and par.sp_group is not None:
        impl = seqp.resolve_impl(cfg.attn_impl, q.shape[2], par.sp)
        if impl == "ulysses":
            return None
        if impl == "ring_flash":
            rfa.check_flash_shard(q.shape[1], q.shape[3])
        elif q.is_cuda and q.shape[3] not in fa.HEAD_DIMS:
            raise ValueError(f"ring attention on the card runs the flash kernels, which take "
                             f"D in {fa.HEAD_DIMS} (got D={q.shape[3]})")
        return (rfa._ring_fwd, rfa._ring_bwd,
                (par.sp_group, 1.0 / math.sqrt(q.shape[3]), True))
    if cfg.attn_impl == "sparse":
        B, S, H, D = q.shape
        lists = bsa.index_lists(cfg.sparsity or FixedSparsityConfig(num_heads=H), S, q.device)
        return (*bsa.forward_backward(q.device), (lists, True, 1.0 / math.sqrt(D)))
    return (*fa.forward_backward(q.device), (True, None, None))


def _attention(cfg: GPT2Config, lp, h, ops=None, par: _Parallel = _SERIAL):
    """Causal self-attention of ``h [B, S, E]``: q, k and v are strided
    views of the ``[B, S, 3E]`` projection (no copies on the way into the
    kernel). Under tp, this rank's heads (``[Q_r | K_r | V_r]`` columns)
    and its row slice of ``c_proj``, reduced over tp before the bias."""
    B, S, E = h.shape
    H, D = cfg.n_head // par.tp, cfg.head_dim
    El = H * D
    if par.tp_group is not None:
        h = copy_to_group(h, par.tp_group)
    qkv = _dot(ops, h, lp["c_attn_w"]) + lp["c_attn_b"]
    q, k, v = (x.unflatten(-1, (H, D)) for x in qkv.split(El, dim=-1))
    parts = _attention_parts(cfg, q, par) if ops is not None else None
    if parts is not None:
        # the attention output, kept by every selective policy (JAX: "attn_out")
        o = ops.attention(q, k, v, *parts)
    elif cfg.attn_impl in seqp.IMPLS:
        o = seqp.sequence_parallel_attention(q, k, v, par.mesh, impl=cfg.attn_impl)
    elif cfg.attn_impl == "sparse":
        o = sparse_attention(q, k, v, cfg.sparsity or FixedSparsityConfig(num_heads=H),
                             causal=True)
    else:
        o = causal_attention(q, k, v, impl=cfg.attn_impl)
    out = _dot(ops, o.reshape(B, S, El), lp["c_proj_w"])
    if par.tp_group is not None:
        out = reduce_from_group(out, par.tp_group)
    return out + lp["c_proj_b"]


def _block(cfg: GPT2Config, lp, h, ops=None, key=None, par: _Parallel = _SERIAL):
    """One block; ``key`` (the layer's ``[3, 2]`` split: attention
    dropout, MoE routing, MLP dropout) turns its dropouts on."""
    eps = cfg.layer_norm_epsilon
    r1 = r3 = None
    if key is not None:
        r1, r3 = key[0], key[2]
    a = _attention(cfg, lp["attn"], layer_norm(h, lp["ln_1"]["scale"], lp["ln_1"]["bias"], eps),
                   ops, par)
    h = h + _dropout(a, cfg.dropout, r1, True)
    m = _mlp(cfg, lp["mlp"], layer_norm(h, lp["ln_2"]["scale"], lp["ln_2"]["bias"], eps), ops,
             par=par)
    return h + _dropout(m, cfg.dropout, r3, True)


def _unstack(tree, n: int):
    """The stacked ``[L, ...]`` block tree → a list of L per-layer trees.
    ``unbind`` once (its backward is one stack of the layers' grads) rather
    than indexing per layer (whose backward scatters into a zero copy of
    the whole stack, once per layer)."""
    def unbind(t):
        if isinstance(t, dict):
            return {k: unbind(v) for k, v in t.items()}
        if isinstance(t, tuple):  # a quantized weight: its fields per layer
            return type(t)(*[unbind(v) for v in t])
        return t.unbind(0)

    def pick(t, i):
        if isinstance(t, dict):
            return {k: pick(v, i) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*[pick(v, i) for v in t])
        return t[i]

    u = unbind(tree)
    return [pick(u, i) for i in range(n)]


def dropout_key_table(cfg: GPT2Config, rng) -> np.ndarray:
    """Every dropout key of a forward under ``rng`` (a host ``[2]`` key), as
    JAX derives them (``deepspeed_tpu/models/gpt2.py`` ``_hidden``): row 0
    the embedding's, ``fold_in(rng, n_layer)``; rows ``1 + 3 l .. 3 + 3 l``
    layer l's ``split(split(fold_in(rng, 0), n_layer)[l], 3)`` → uint32
    ``[1 + 3 n_layer, 2]``."""
    L = cfg.n_layer
    layers = prng.split(prng.split(prng.fold_in(rng, 0), L), 3).reshape(3 * L, 2)
    return np.concatenate([prng.fold_in(rng, L)[None], layers]).astype(np.uint32)


def _is_key_table(cfg: GPT2Config, rng) -> bool:
    """A device key table: ``[1 + 3 n_layer, 2]`` int32, or ``[.., 4]``
    / ``[.., 6]`` with each row's shard words (``prng.shard_key``: a
    rank's slice of each draw over the global batch)."""
    if not prng.is_device_key(rng):
        return False
    if rng.dim() != 2 or rng.shape[0] != 1 + 3 * cfg.n_layer or rng.shape[1] not in (2, 4, 6):
        raise ValueError(f"a device key table for {cfg.n_layer} layers is "
                         f"[{1 + 3 * cfg.n_layer}, 2, 4 or 6] int32; got {tuple(rng.shape)}")
    return True


def hidden_with_aux(cfg: GPT2Config, params: PyTree, input_ids, train: bool = False,
                    rng=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``input_ids [B, S]`` → (final-LN hidden states ``[B, S, E]``, the MoE
    aux loss, 0 for a dense model). ``rng`` with ``train`` and ``dropout >
    0`` applies dropout with JAX's keys: a host ``[2]`` key (its table is
    derived and copied up once), or the device table of
    :func:`dropout_key_table` (read where it lies). Remat's recomputation
    draws the same masks from the same device keys."""
    B, S = input_ids.shape
    L = cfg.n_layer
    par = _parallel(cfg)
    if par.sp_group is None and par.tp_group is None:
        h = params["wte"][input_ids] + params["wpe"][:S][None, :, :]
    else:
        # rank r of sp embeds the positions of its columns
        p0 = par.sp_rank * S
        h = _embed(params["wte"], input_ids, par) + params["wpe"][p0:p0 + S][None, :, :]
    keys = [None] * L
    if train and cfg.dropout > 0.0 and rng is not None:
        table = rng if _is_key_table(cfg, rng) else prng.device_keys(
            dropout_key_table(cfg, rng), h.device)
        h = _dropout(h, cfg.dropout, table[0], train)
        keys = list(table[1:].reshape(L, 3, table.shape[1]))  # [L][3, 2, 4 or 6]
    boundary = cfg.remat and (cfg.cpu_checkpointing or (cfg.partition_activations
                                                        and par.tp_group is not None))
    for layer, (lp, key) in enumerate(zip(_unstack(params["blocks"], L), keys)):
        if boundary:
            part = ((par.tp_group, par.tp_rank, par.tp)
                    if cfg.partition_activations and par.tp_group is not None else None)
            h = boundary_checkpoint(functools.partial(_block, cfg, key=key, par=par), lp, h,
                                    partition=part, offload=cfg.cpu_checkpointing,
                                    slot=("gpt2", layer))
        elif cfg.remat and cfg.remat_policy != "full":
            h = selective_checkpoint(functools.partial(_block, cfg, key=key, par=par),
                                     cfg.remat_policy, lp, h)
        elif cfg.remat:
            h = checkpoint(functools.partial(_block, cfg, lp, key=key, par=par), h)
        else:
            h = _block(cfg, lp, h, key=key, par=par)
    h = layer_norm(h, params["ln_f"]["scale"], params["ln_f"]["bias"], cfg.layer_norm_epsilon)
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


def _embed(wte, ids, par: _Parallel):
    """``wte[ids]``; under tp the vocab-parallel lookup: this rank's rows
    ``[r V/tp, (r + 1) V/tp)`` answer the ids they hold, the others give 0,
    and the sum over tp is the embedding."""
    if par.tp_group is None:
        return wte[ids]
    Vl = wte.shape[0]
    local = ids - par.tp_rank * Vl
    inside = (local >= 0) & (local < Vl)
    e = wte[local.clamp(0, Vl - 1)]
    e = torch.where(inside[..., None], e, torch.zeros((), dtype=e.dtype, device=e.device))
    return reduce_from_group(e, par.tp_group)


def forward_with_aux(cfg: GPT2Config, params: PyTree, input_ids, train: bool = False, rng=None):
    """``input_ids [B, S]`` → (logits ``[B, S, V]`` over the logical vocab,
    aux loss); the embedding is tied."""
    h, aux = hidden_with_aux(cfg, params, input_ids, train, rng)
    par = _parallel(cfg)
    if par.tp_group is None:
        return (h @ params["wte"].t())[..., : cfg.vocab_size], aux
    logits = all_gather(h @ params["wte"].t(), par.tp_group, gather_dim=-1)
    return logits[..., : cfg.vocab_size], aux


def forward(cfg: GPT2Config, params: PyTree, input_ids, train: bool = False, rng=None):
    """``input_ids [B, S]`` → logits ``[B, S, V]``; ``rng`` enables dropout
    when ``train``."""
    return forward_with_aux(cfg, params, input_ids, train, rng)[0]


def _head_token_loss(cfg: GPT2Config, wte, h, batch):
    par = _parallel(cfg)
    if par.tp_group is None:
        return head_token_loss(lambda x: x @ wte.t(), h, batch, cfg.ce_chunk,
                               logical_vocab=cfg.vocab_size)
    g = par.tp_group
    return head_token_loss(lambda x: copy_to_group(x, g) @ wte.t(), h, batch, cfg.ce_chunk,
                           logical_vocab=cfg.vocab_size,
                           vocab_parallel=(g, par.tp_rank * wte.shape[0]))


def lm_loss(cfg: GPT2Config, params: PyTree, batch: Dict[str, torch.Tensor], rng, train: bool):
    """Next-token cross-entropy → ``(loss, {"ntokens", "moe_aux"})``. batch:
    ``{"input_ids": [B, S]}`` and optional ``"labels"`` (-100 = ignore) /
    ``"attention_mask"``; ``rng`` the micro-batch's key (dropout)."""
    h, aux = hidden_with_aux(cfg, params, batch["input_ids"], train, rng)
    loss, ntokens = _head_token_loss(cfg, params["wte"], h, batch)
    return loss, {"ntokens": ntokens, "moe_aux": aux}


def logical_axes(cfg: Optional[GPT2Config] = None) -> PyTree:
    """Logical-axis names per parameter (JAX's ``logical_axes``, dense MLP),
    which ``runtime.zero.partitioning.DEFAULT_LOGICAL_RULES`` map onto the
    mesh: vocab, qkv, mlp and heads over tp."""
    return {
        "wte": ("vocab", "embed"),
        "wpe": (None, "embed"),
        "ln_f": {"scale": ("embed",), "bias": ("embed",)},
        "blocks": {
            "ln_1": {"scale": ("layers", "embed"), "bias": ("layers", "embed")},
            "ln_2": {"scale": ("layers", "embed"), "bias": ("layers", "embed")},
            "attn": {
                "c_attn_w": ("layers", "embed", "qkv"),
                "c_attn_b": ("layers", "qkv"),
                "c_proj_w": ("layers", "heads", "embed"),
                "c_proj_b": ("layers", "embed"),
            },
            "mlp": {
                "c_fc_w": ("layers", "embed", "mlp"),
                "c_fc_b": ("layers", "mlp"),
                "c_proj_w": ("layers", "mlp", "embed"),
                "c_proj_b": ("layers", "embed"),
            },
        },
    }


def make_module(cfg: GPT2Config) -> ModuleSpec:
    """GPT-2 as a :class:`ModuleSpec` for ``deepspeed_tpu_torch.initialize``;
    ``init`` draws on the generator's device."""
    return ModuleSpec(
        init=lambda generator: init_params(cfg, generator),
        loss_fn=lambda params, batch, rng, train: lm_loss(cfg, params, batch, rng, train),
        apply_fn=lambda params, batch: forward(cfg, params, batch["input_ids"]),
        key_table=(functools.partial(dropout_key_table, cfg) if cfg.dropout > 0.0 else None),
        loss_norm=lambda batch: np.asarray([max(loss_count(batch), 1.0)], np.float32),
        logical_axes=logical_axes(cfg),
        seq_labels=next_token_labels,
        checkpointing=functools.partial(_with_checkpointing, cfg),
    )


def _with_checkpointing(cfg: GPT2Config, partition_activations: bool,
                        cpu_checkpointing: bool) -> ModuleSpec:
    """GPT-2 under the engine's ``activation_checkpointing`` section: its
    two options turned on beside the config's own fields of the same
    names. They act on the blocks that ``remat`` recomputes."""
    if not cfg.remat:
        raise ValueError("activation_checkpointing: partition_activations and cpu_checkpointing "
                         "act on the blocks GPT-2 recomputes; set the model's remat=True")
    return make_module(dataclasses.replace(
        cfg, partition_activations=cfg.partition_activations or partition_activations,
        cpu_checkpointing=cfg.cpu_checkpointing or cpu_checkpointing))


# ---------------------------------------------------------------------------
# incremental decode with a contiguous KV cache
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    """Per-layer stacked KV cache; ``pos`` is the filled length: an int32
    ``[1]`` tensor on the cache's device (the kernels and every index read
    it there; a captured step advances it in place)."""

    k: torch.Tensor    # [L, B, Smax, H, D]
    v: torch.Tensor    # [L, B, Smax, H, D]
    pos: torch.Tensor  # [1] int32


def init_cache(cfg: GPT2Config, batch_size: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device=None) -> KVCache:
    shape = (cfg.n_layer, batch_size, max_len, cfg.n_head, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   pos=torch.zeros(1, dtype=torch.int32, device=device))


def device_int(x, device) -> torch.Tensor:
    """``x`` (a Python int or a one-element tensor) as an int32 ``[1]``
    tensor on ``device``: an int is filled there (no host copy), a tensor
    is never read on the host."""
    if isinstance(x, torch.Tensor):
        return x.reshape(1).to(device=device, dtype=torch.int32)
    return torch.full((1,), int(x), dtype=torch.int32, device=device)


def row_at(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``h[:, idx]`` for a device index ``idx`` (``[1]``) → ``[B, E]``."""
    return h.index_select(1, idx.long())[:, 0]


def _attention_cached(cfg: GPT2Config, lp, h, k_cache, v_cache, pos: torch.Tensor):
    """Attention of ``h [B, S, E]`` against a layer's cache ``[B, Smax, H,
    D]``: this chunk's K/V is written at rows ``pos .. pos + S - 1`` (in
    place, ``pos`` an int32 ``[1]`` tensor), then query i (at position
    ``pos + i``) attends keys ``<= pos + i``. S is the prompt length at
    prefill (the dense masked einsum with probabilities in the cache dtype,
    as the JAX package computes it outside any kernel) and 1 at decode
    (``cached_attention``: the decode kernel on the card, reading ``pos``
    there)."""
    B, S, E = h.shape
    H, D = cfg.n_head, cfg.head_dim
    qkv = h @ maybe_dequantize(lp["c_attn_w"], h.dtype) + lp["c_attn_b"]
    q, k_, v = qkv.split(E, dim=-1)
    q = q.reshape(B, S, H, D)
    rows = pos.long() + torch.arange(S, device=h.device)  # [S]
    k_cache.index_copy_(1, rows, k_.reshape(B, S, H, D).to(k_cache.dtype))
    v_cache.index_copy_(1, rows, v.reshape(B, S, H, D).to(v_cache.dtype))
    scale = 1.0 / math.sqrt(D)
    # "jnp" names the plain version, which the card never runs:
    # cached_attention refuses it for CUDA tensors
    if S == 1 and (cfg.attn_impl in ("auto", "pallas") or h.device.type == "cuda"):
        # a sparse model decodes densely against its cache, as in the JAX package
        impl = "auto" if cfg.attn_impl == "sparse" else cfg.attn_impl
        o1 = cached_attention(q[:, 0].contiguous(), k_cache, v_cache, pos,
                              impl=impl, sm_scale=scale)
        o = o1.reshape(B, 1, E).to(h.dtype)
    else:
        Smax = k_cache.shape[1]
        scores = torch.einsum("bshd,bthd->bhst", q.float(), k_cache.float()) * scale
        mask = torch.arange(Smax, device=h.device)[None, :] <= rows[:, None]  # [S, Smax]
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
        probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
        o = torch.einsum("bhst,bthd->bshd", probs, v_cache).reshape(B, S, E).to(h.dtype)
    return o @ maybe_dequantize(lp["c_proj_w"], h.dtype) + lp["c_proj_b"]


@torch.no_grad()
def forward_cached(cfg: GPT2Config, params: PyTree, input_ids, cache: KVCache,
                   logits_at=None) -> Tuple[torch.Tensor, KVCache]:
    """``input_ids [B, S]`` (S tokens starting at ``cache.pos``) → (the last
    token's logits ``[B, V]``, the cache advanced by S). One function serves
    prefill (S = prompt) and decode (S = 1); the cache tensors are written
    in place, and the positions, the ``wpe`` rows and the head's row come
    from ``cache.pos`` by device indexing (a tensor ``pos`` is never read
    on the host). ``logits_at``: read the head at this in-chunk position
    instead of the last (the right-padded bucket's true last prompt token;
    a one-element tensor, or an int that :func:`device_int` fills on the
    device)."""
    B, S = input_ids.shape
    pos = cache.pos
    rows = pos.long() + torch.arange(S, device=input_ids.device)
    eps = cfg.layer_norm_epsilon
    h = params["wte"][input_ids.long()] + params["wpe"].index_select(0, rows)[None, :, :]
    for l, lp in enumerate(_unstack(params["blocks"], cfg.n_layer)):
        h = h + _attention_cached(
            cfg, lp["attn"], layer_norm(h, lp["ln_1"]["scale"], lp["ln_1"]["bias"], eps),
            cache.k[l], cache.v[l], pos,
        )
        h = h + _mlp(cfg, lp["mlp"], layer_norm(h, lp["ln_2"]["scale"], lp["ln_2"]["bias"], eps))
    h = h[:, -1] if logits_at is None else row_at(h, device_int(logits_at, h.device))
    h = layer_norm(h, params["ln_f"]["scale"], params["ln_f"]["bias"], eps)
    logits = (h @ params["wte"].t())[..., : cfg.vocab_size]
    return logits, KVCache(k=cache.k, v=cache.v, pos=cache.pos + S)


# -- generate's two programs over static buffers ------------------------------

class GenerateState(NamedTuple):
    """What ``generate``'s programs update in place on the device: the
    cache (``pos`` an int32 ``[1]``), the tokens ``[B, max_new]`` (int64,
    read by the host once at the end) and ``step`` (int32 ``[1]``, the
    tokens made so far)."""

    cache: KVCache
    out: torch.Tensor
    step: torch.Tensor


def generate_input_shapes(batch: int, width: int, max_new_tokens: int):
    """The int32 inputs of ``generate``'s programs, all uploaded with the
    prefill: the right-padded prompt, its true length, the first token's
    key and the decode steps' keys (step t's at row t - 1)."""
    return {"ids": (batch, width), "plen": (1,), "key": (2,),
            "keys": (max(int(max_new_tokens) - 1, 1), 2)}


def init_generate_state(cfg: GPT2Config, batch: int, max_len: int, max_new_tokens: int,
                        cache_dtype: torch.dtype, device) -> GenerateState:
    return GenerateState(
        cache=init_cache(cfg, batch, max_len, dtype=cache_dtype, device=device),
        out=torch.zeros((batch, int(max_new_tokens)), dtype=torch.int64, device=device),
        step=torch.zeros(1, dtype=torch.int32, device=device))


def generate_inputs(input_ids: torch.Tensor, prompt_len: int, rng, max_new_tokens: int):
    """Eager callers' inputs (``generate_input_shapes``) on ``input_ids``'
    device: the host values copied up once."""
    dev = input_ids.device
    keys = prng.split(prng.fold_in(rng, 1), max(max_new_tokens - 1, 1))
    return {"ids": input_ids.to(torch.int32),
            "plen": torch.full((1,), int(prompt_len), dtype=torch.int32, device=dev),
            "key": prng.device_keys(rng, dev), "keys": prng.device_keys(keys, dev)}


def _sampled(temperature: float) -> bool:
    return bool(temperature) and temperature > 0.0


def generate_prefill(cfg: GPT2Config, params: PyTree, state: GenerateState, inputs,
                     temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0) -> None:
    """The prefill program: the prompt ``inputs["ids"]`` (right-padded)
    into rows ``0..width-1`` of the cache, the head at ``plen - 1``, the
    first token into ``out[:, 0]``; then ``pos = plen`` (decode overwrites
    the padding's K/V before attending it) and ``step = 1``."""
    cache = state.cache
    cache.pos.zero_()
    plen = inputs["plen"]
    logits, _ = forward_cached(cfg, params, inputs["ids"], cache, logits_at=plen - 1)
    cache.pos.copy_(plen)
    state.out[:, 0] = sample_logits(logits, inputs["key"] if _sampled(temperature) else None,
                                    temperature, top_k, top_p)
    state.step.fill_(1)


def generate_step(cfg: GPT2Config, params: PyTree, state: GenerateState, inputs,
                  temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0) -> None:
    """The decode-step program: token ``out[:, step - 1]`` at ``pos`` → the
    next into ``out[:, step]`` (drawn with ``keys[step - 1]``); then ``pos``
    and ``step`` advance by one, on the device."""
    t = state.step.long()
    token = state.out.index_select(1, t - 1)  # [B, 1]
    logits, _ = forward_cached(cfg, params, token, state.cache)
    key = inputs["keys"].index_select(0, t - 1)[0] if _sampled(temperature) else None
    state.out.index_copy_(1, t, sample_logits(logits, key, temperature, top_k, top_p)[:, None])
    state.cache.pos.add_(1)
    state.step.add_(1)


@torch.no_grad()
def generate(cfg: GPT2Config, params: PyTree, input_ids, max_new_tokens: int,
             temperature: float = 0.0, rng=None,
             max_len: Optional[int] = None, cache_dtype: torch.dtype = torch.bfloat16,
             top_k: int = 0, top_p: float = 1.0,
             prompt_len: Optional[int] = None) -> torch.Tensor:
    """Autoregressive generation: one prefill, then ``max_new_tokens - 1``
    single-token decode steps over the KV cache → ``[B, max_new_tokens]``
    on the device. Greedy unless ``temperature > 0``; then the draws are
    JAX's: the first token's with ``rng`` (default ``PRNGKey(0)``), step
    t's with ``split(fold_in(rng, 1), max_new_tokens - 1)[t - 1]``. Tokens
    are sampled on the device and stay there (no per-step host read). The
    eager form of the programs ``InferenceEngine.generate`` captures
    (:func:`generate_prefill`, :func:`generate_step`).

    ``prompt_len``: the true prompt length when ``input_ids`` is
    right-padded to a bucket. The prefill runs over the padded rows, the
    head reads position ``prompt_len - 1``, and decode starts writing at
    ``prompt_len``: the padding's K/V is masked until those writes
    overwrite it."""
    B, S = input_ids.shape
    if max_len is None:
        max_len = S + max_new_tokens
    if max_len > cfg.n_positions or max_len < S + max_new_tokens:
        raise ValueError(
            f"prompt ({S}) + max_new_tokens ({max_new_tokens}) needs a cache of "
            f"{S + max_new_tokens} but max_len={max_len} (n_positions={cfg.n_positions}); "
            "a shorter cache would silently overwrite KV entries"
        )
    n = S if prompt_len is None else int(prompt_len)
    if rng is None:
        rng = prng.PRNGKey(0)
    state = init_generate_state(cfg, B, max_len, max_new_tokens, cache_dtype, input_ids.device)
    inputs = generate_inputs(input_ids, n, rng, max_new_tokens)
    sample = dict(temperature=temperature, top_k=top_k, top_p=top_p)
    generate_prefill(cfg, params, state, inputs, **sample)
    for _ in range(max_new_tokens - 1):
        generate_step(cfg, params, state, inputs, **sample)
    return state.out
