"""Sequence parallelism: ring attention and Ulysses over the ``sp`` axis.

Counterpart of ``deepspeed_tpu/parallel/sequence.py``. The JAX functions
run under ``shard_map`` on each device's shard; here each rank holds its
shard and calls them on it, with the ``sp`` group of its mesh
(``parallel.topology.ProcessGroups``) where JAX names the axis.

- **Ring** (:func:`_ring_attention_local`): K/V blocks travel the ring
  while each rank keeps its queries; each block's partial output merges
  by its log-sum-exp, so the result is exact, and the backward is a
  second ring against the merged output and log-sum-exp. It is the
  schedule of ``ops/ring_flash_attention.py``: on the card every ring
  step runs the flash kernels (JAX upgrades "ring" to "ring_flash" on the
  TPU when the shard fits; the port's kernels take any shard length, so
  only a head dim they lack raises there), and on the CPU their plain
  versions at any shape. "ring_flash" forced keeps JAX's shard rule
  (``ring_flash_ok``) on either device.
- **Ulysses** (:func:`_ulysses_local`): one differentiable all-to-all
  re-shards heads over sp and gathers the whole sequence, the port's
  attention runs on it (``causal_attention``: the flash kernels on the
  card), and a second all-to-all restores the sequence sharding.

Layout: ``[B, S_loc, H_loc, D]``, the sequence over ``sp`` in rank order,
the batch over ``dp``, heads over ``tp`` (the caller's heads are already
its local ones). :func:`shard_sequence` cuts a host batch into a rank's
rows and sequence columns.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..comm.torch import all_to_all_grad
from ..ops import ring_flash_attention as rfa
from ..ops.attention import bidirectional_attention, causal_attention
from ..utils.logging import warning_once

IMPLS = ("ring", "ring_flash", "ulysses")


def _ring_attention_local(q, k, v, group, sm_scale: Optional[float], causal: bool):
    """Exact blockwise attention with K/V rotating over ``group``'s ring:
    this rank's ``[B, S_loc, H, D]`` shards → ``[B, S_loc, H, D]``."""
    if k.shape[2] != q.shape[2]:
        raise ValueError(f"ring attention needs k/v heads ({k.shape[2]}) == q heads "
                         f"({q.shape[2]})")
    return rfa.ring_attention(q, k, v, group, causal, sm_scale)


def _ulysses_local(q, k, v, group, sm_scale: Optional[float], causal: bool):
    """All-to-all seq <-> heads around the port's attention on the whole
    sequence: ``[B, S_loc, H, D]`` with ``H % sp == 0``."""
    n = dist.get_world_size(group)
    H = q.shape[2]
    if H % n:
        raise ValueError(f"Ulysses needs heads per rank ({H}) divisible by sp ({n})")

    def seq_to_heads(x):  # [B, S_loc, H, D] -> [B, S, H / n, D]
        return all_to_all_grad(x, group, split_dim=2, concat_dim=1)

    def heads_to_seq(x):
        return all_to_all_grad(x, group, split_dim=1, concat_dim=2)

    q, k, v = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    if causal:
        o = causal_attention(q, k, v, sm_scale=sm_scale)
    else:
        o = bidirectional_attention(q, k, v, sm_scale=sm_scale)
    return heads_to_seq(o)


def resolve_impl(impl: str, heads_local: int, sp_size: int) -> str:
    """The implementation a call runs: Ulysses falls back to the ring when
    the local heads do not divide by sp (JAX's warning)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown sequence-parallel impl {impl}")
    if impl == "ulysses" and heads_local % sp_size != 0:
        warning_once(f"Ulysses needs local heads ({heads_local}) divisible by sp ({sp_size}); "
                     "falling back to ring attention")
        impl = "ring"
    return impl


def sequence_parallel_attention(q, k, v, mesh, impl: str = "ring", causal: bool = True,
                                sm_scale: Optional[float] = None, sp_axis: str = "sp"):
    """Sequence-parallel exact attention of this rank's shards ``[B, S_loc,
    H_loc, D]`` over ``mesh``'s ``sp`` group → the same shape. Without an
    sp axis (or at sp 1) it is the dense causal attention of the shard.
    ``impl="ring_flash"`` forced on a shard the kernels do not take
    raises."""
    if impl not in IMPLS:
        raise ValueError(f"unknown sequence-parallel impl {impl}")
    group = mesh.group_or_none(sp_axis) if mesh is not None else None
    if group is None:
        if not causal:
            raise ValueError("sequence_parallel_attention: the non-causal fallback is not "
                             "wired (as in the JAX package)")
        return causal_attention(q, k, v, sm_scale=sm_scale)
    impl = resolve_impl(impl, q.shape[2], dist.get_world_size(group))
    if impl == "ring_flash":
        return rfa.ring_flash_attention(q, k, v, group, causal, sm_scale)
    local = _ring_attention_local if impl == "ring" else _ulysses_local
    return local(q, k, v, group, sm_scale, causal)


def shard_sequence(batch, mesh, seq_dim: int = 1, dp_axis: str = "dp", sp_axis: str = "sp"):
    """This rank's part of a host batch (a tree of arrays or tensors): its
    rows of dim 0 over ``dp`` and its columns of ``seq_dim`` over ``sp``, in
    rank order (JAX's ``NamedSharding`` placement of the same spec)."""
    def cut(x, dim, axis):
        n = mesh.size(axis)
        if n <= 1 or x.ndim <= dim:
            return x
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} is not divisible by {axis}={n}")
        c = x.shape[dim] // n
        r = mesh.axis_rank(axis)
        idx = [slice(None)] * x.ndim
        idx[dim] = slice(r * c, (r + 1) * c)
        return x[tuple(idx)]

    def put(x):
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        return cut(cut(x, 0, dp_axis), seq_dim, sp_axis)

    if isinstance(batch, dict):
        return {k: shard_sequence(v, mesh, seq_dim, dp_axis, sp_axis) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_sequence(v, mesh, seq_dim, dp_axis, sp_axis) for v in batch)
    return put(batch)
