"""Tensor-parallel weight mapping for the serving tree (counterpart of
``deepspeed_tpu/module_inject/tp_shard.py``).

Each rank of a ``tp``-way placement keeps ``1/tp`` of every attention and
MLP matrix, chosen so that its slice is a complete set of heads. The one
layout fix is the fused QKV projection: ``c_attn_w`` is ``[L, E, 3E]``
with output columns ``[Q | K | V]``, so the contiguous column block of
rank ``r`` straddles the Q/K/V boundary and mixes heads of different
roles. :func:`permute_qkv_for_tp` reorders the columns from role-major
``(3, tp, Hl*D)`` to rank-major ``(tp, 3, Hl*D)``, so that the contiguous
slice IS ``[Q_r | K_r | V_r]``; ``c_attn_b`` gets the same permutation.

The row-parallel matrices (``attn/c_proj_w``, ``mlp/c_proj_w``) need no
permutation: their input dim is heads-major. The MLP's ``c_fc`` columns
are role-free. Everything else is replicated.

Where the JAX package places the permuted tree with ``NamedSharding``
device_puts, each rank here keeps its own slices: :func:`local_slice` is
the contiguous ``1/tp`` block a rank owns under a spec (a tuple with the
axis name at each sharded dim), the counterpart of one shard of a
``NamedSharding``.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

PyTree = Any


def permute_qkv_for_tp(w: torch.Tensor, b: torch.Tensor, tp: int):
    """Reorder fused-QKV output columns from role-major to rank-major.

    ``w``: ``[L, E, 3E]`` (or ``[E, 3E]``), ``b``: ``[L, 3E]`` (or
    ``[3E]``). Columns regrouped ``(3, tp, Hl*D) -> (tp, 3, Hl*D)`` so the
    contiguous ``tp``-slice ``r`` holds exactly ``[Q_r | K_r | V_r]``.
    Identity at ``tp == 1``. Returns ``(w, b)`` (new tensors at tp > 1)."""
    tp = int(tp)
    if tp <= 1:
        return w, b
    three_e = int(w.shape[-1])
    if three_e % (3 * tp):
        raise ValueError(f"fused QKV width {three_e} not divisible by 3*tp={3 * tp}")
    chunk = three_e // (3 * tp)  # Hl * D: one rank's heads of one role

    def regroup(x):
        lead = tuple(x.shape[:-1])
        n = len(lead)
        return x.reshape(lead + (3, tp, chunk)).transpose(n, n + 1).reshape(lead + (three_e,))

    return regroup(w), regroup(b)


def regroup_qkv(x: torch.Tensor, tp: int, inverse: bool = False) -> torch.Tensor:
    """One tensor's fused-QKV columns (its last dim) regrouped role-major
    ``(3, tp, Hl*D)`` -> rank-major ``(tp, 3, Hl*D)``, or back with
    ``inverse`` (a whole leaf gathered from rank-major slices)."""
    tp = int(tp)
    if tp <= 1:
        return x
    three_e = int(x.shape[-1])
    if three_e % (3 * tp):
        raise ValueError(f"fused QKV width {three_e} not divisible by 3*tp={3 * tp}")
    chunk = three_e // (3 * tp)
    lead = tuple(x.shape[:-1])
    n = len(lead)
    src = (tp, 3, chunk) if inverse else (3, tp, chunk)
    return x.reshape(lead + src).transpose(n, n + 1).reshape(lead + (three_e,))


def tp_shard_serving_params(params: PyTree, tp: int) -> PyTree:
    """The gpt2 serving tree, QKV-permuted for a ``tp``-way placement: a
    layout transform only (values equal up to column order), so the tp = 1
    tree passes through untouched."""
    if int(tp) <= 1:
        return params
    out = dict(params)
    blocks = dict(out["blocks"])
    attn = dict(blocks["attn"])
    attn["c_attn_w"], attn["c_attn_b"] = permute_qkv_for_tp(
        attn["c_attn_w"], attn["c_attn_b"], tp)
    blocks["attn"] = attn
    out["blocks"] = blocks
    return out


def local_slice(x: torch.Tensor, spec: Sequence, rank: int, tp: int,
                axis: str = "tp") -> torch.Tensor:
    """The contiguous ``1/tp`` block of ``x`` that ``rank`` owns under
    ``spec`` (one entry a leading dim, ``axis`` at a sharded dim, ``None``
    or missing entries replicated): at each sharded dim the ``rank``-th of
    ``tp`` equal chunks. A view; raises when a sharded dim is not divisible
    by ``tp``."""
    out = x
    for d, entry in enumerate(spec):
        if entry != axis:
            continue
        n = int(x.shape[d])
        if n % tp:
            raise ValueError(f"dim {d} of {tuple(x.shape)} is not divisible by tp={tp}")
        out = out.narrow(d, rank * (n // tp), n // tp)
    return out
