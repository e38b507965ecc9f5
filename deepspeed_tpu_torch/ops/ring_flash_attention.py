"""Ring flash attention: exact attention over a sequence sharded across the
ranks of a group, each ring step's block running the flash kernels.

Counterpart of ``deepspeed_tpu/ops/pallas/ring_flash_attention.py``
(``ring_flash_attention``, :172). It has no kernel of its own: each ring
step runs the flash forward (``ops/flash_attention.py``
:func:`~.flash_attention.flash_attention_fwd`, ``csrc/flash_attention_fwd.cu``)
or backward (:func:`~.flash_attention.flash_attention_bwd`) on the K/V
block it holds, and the partial outputs merge by their log-sum-exp in
plain tensor code (:func:`_merge`, JAX's ``_merge``: XLA code outside
Pallas there too). CPU tensors run the kernels' plain versions
(``flash_attention_fwd_ref`` / ``flash_attention_bwd_ref``) in the same
schedule.

The schedule is JAX's. Rank ``idx`` of ``n`` keeps its query shard; at
step ``j`` it holds the K/V block of rank ``(idx + j) % n`` (each step
sends the block to rank ``idx - 1``: ``comm.ring_shift(x, shift=-1)``).
Under causal attention the block of ``src == idx`` is the diagonal (the
causal kernel), ``src < idx`` is fully visible (the non-causal kernel),
and ``src > idx`` is fully masked: it launches nothing and merges nothing
(a no-op merge in JAX, bit for bit). The forward shifts K/V ``n - 1``
times (JAX's n-th shift only brings them home).

Gradients are exact: the ring is one ``torch.autograd.Function``. The
backward is a second ring: each step runs the flash backward against the
*merged* output and log-sum-exp (``p = exp(s - lse)`` is each block's true
slice of the probabilities, and the kernel's ``delta = rowsum(dO o)`` is
the global one), adds dq locally, and adds the block's dK/dV into f32
accumulators that travel with K/V and arrive home after ``n`` shifts.

:data:`LAUNCHES` ``["ring_flash_attention"]`` counts the flash launches the
ring makes on the card (each also counts under its own kernel's name).
Layout: q ``[B, S_loc, H, D]``, k/v ``[B, S_loc, KV, D]``; lse ``[B, H,
S_loc]`` f32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..comm.torch import ring_shift
from . import flash_attention as fa
from .launches import LAUNCHES, register

KERNELS = register("ring_flash_attention")

NEG_BIG = -1e30


def ring_flash_ok(s_loc: int, d: int, itemsize: Optional[int] = None) -> bool:
    """JAX's ``ring_flash_ok`` read against the port's kernels: each
    shard's length a multiple of the 128-row tile and a head dim the flash
    kernels take (64, 128 or 256). ``itemsize`` is kept for JAX's
    signature."""
    return s_loc > 0 and s_loc % fa.BLOCK == 0 and d in fa.HEAD_DIMS


def _merge(u, m, l, o_j, lse_j):
    """JAX's online merge of one block's normalised ``o_j [B, S, H, D]``
    and ``lse_j [B, H, S]`` into the running unnormalised ``u`` (f32, at
    max ``m``) and mass ``l`` (``[B, H, S]``) → ``(u, m, l)``. The
    all-at-once form of the same merge is ``ops.decode_attention``
    ``merge_partials``."""
    m_new = torch.maximum(m, lse_j)
    m_safe = torch.where(m_new <= NEG_BIG / 2, torch.zeros_like(m_new), m_new)
    alpha = torch.where(m <= NEG_BIG / 2, torch.zeros_like(m), torch.exp(m - m_safe))
    w = torch.where(lse_j <= NEG_BIG / 2, torch.zeros_like(lse_j), torch.exp(lse_j - m_safe))
    t = lambda x: x.transpose(1, 2)[..., None]  # [B, H, S] -> [B, S, H, 1]
    u = u * t(alpha) + o_j.float() * t(w)
    return u, m_new, l * alpha + w


def _step_kind(src: int, idx: int, causal: bool) -> str:
    if not causal:
        return "full"
    return "diag" if src == idx else ("full" if src < idx else "masked")


def _ring_fwd(q, k, v, group, scale: float, causal: bool, fwd=None):
    """The forward ring → ``(o [B, S, H, D] in q.dtype, lse [B, H, S] f32)``.
    ``fwd``: the blocks' forward (default the flash kernels, or their plain
    version on the CPU)."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    kernel = fwd is None
    if kernel:
        fwd, _ = fa.forward_backward(q.device)
    B, S, H, D = q.shape
    u = torch.zeros(B, S, H, D, dtype=torch.float32, device=q.device)
    m = torch.full((B, H, S), NEG_BIG, dtype=torch.float32, device=q.device)
    l = torch.zeros(B, H, S, dtype=torch.float32, device=q.device)
    kb, vb = k, v
    for j in range(n):
        kind = _step_kind((idx + j) % n, idx, causal)
        if kind != "masked":
            o_j, lse_j = fwd(q, kb, vb, kind == "diag", scale)
            if kernel and q.is_cuda:
                LAUNCHES["ring_flash_attention"] += 1
            u, m, l = _merge(u, m, l, o_j, lse_j)
        if j < n - 1:
            kb, vb = ring_shift(kb, group, -1), ring_shift(vb, group, -1)
    l_safe = l.clamp_min(1e-30)
    o = (u / l_safe.transpose(1, 2)[..., None]).to(q.dtype)
    return o, m + torch.log(l_safe)


def _ring_bwd(q, k, v, o, lse, do, group, scale: float, causal: bool, bwd=None):
    """The backward ring → ``(dq, dk, dv)`` in q/k/v's dtypes. ``bwd``: the
    blocks' backward (default the flash kernels, or their plain version on
    the CPU)."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    kernel = bwd is None
    if kernel:
        _, bwd = fa.forward_backward(q.device)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dkb = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dvb = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    kb, vb = k, v
    lse = lse.contiguous()
    for j in range(n):
        kind = _step_kind((idx + j) % n, idx, causal)
        if kind != "masked":
            dq_j, dk_j, dv_j = bwd(q, kb, vb, o, lse, do, kind == "diag", scale)
            if kernel and q.is_cuda:
                LAUNCHES["ring_flash_attention"] += 1
            dq += dq_j.float()
            dkb += dk_j.float()
            dvb += dv_j.float()
        # the block's gradient travels with it and is home after n shifts
        dkb, dvb = ring_shift(dkb, group, -1), ring_shift(dvb, group, -1)
        if j < n - 1:
            kb, vb = ring_shift(kb, group, -1), ring_shift(vb, group, -1)
    return dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype)


class RingFlash(torch.autograd.Function):
    """o = ring attention of the local shards; saves ``(q, k, v, o, lse)``."""

    @staticmethod
    def forward(ctx, q, k, v, group, scale, causal):
        o, lse = _ring_fwd(q, k, v, group, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = (group, scale, causal)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.device.type == "cuda" and not do.is_contiguous():
            do = do.contiguous()  # the layout the kernel reads, not another route
        dq, dk, dv = _ring_bwd(q, k, v, o, lse, do, *ctx.opts)
        return dq, dk, dv, None, None, None


def ring_attention(q, k, v, group=None, causal: bool = True,
                   sm_scale: Optional[float] = None):
    """The ring at any shard length: the flash kernels on the card (they
    mask a ragged edge themselves), their plain versions on the CPU. On the
    card a head dim the kernels lack raises; the plain ring runs on CPU
    tensors only."""
    B, S, H, D = q.shape
    fa.validate_kv_heads(H, k, v)
    scale = float(sm_scale) if sm_scale is not None else 1.0 / (D ** 0.5)
    if q.is_cuda:
        if D not in fa.HEAD_DIMS:
            raise ValueError(f"ring attention on the card runs the flash kernels, which take "
                             f"D in {fa.HEAD_DIMS} (got D={D})")
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return RingFlash.apply(q, k, v, group, scale, bool(causal))


def check_flash_shard(s_loc: int, d: int):
    """Raise when "ring_flash" is forced on a shard the kernels do not
    take (:func:`ring_flash_ok`), as JAX's does."""
    if not ring_flash_ok(s_loc, d):
        raise ValueError(
            f"ring flash needs S_loc % {fa.BLOCK} == 0 and D in {fa.HEAD_DIMS} (got "
            f"S_loc={s_loc}, D={d}); raise sp to shrink the per-rank shard")


def ring_flash_attention(q, k, v, group=None, causal: bool = True,
                         sm_scale: Optional[float] = None):
    """The per-rank entry: this rank's shards ``q [B, S_loc, H, D]``, ``k``
    / ``v`` ``[B, S_loc, KV, D]`` of a sequence laid over ``group``'s ranks
    in rank order → ``[B, S_loc, H, D]``, attending over the whole
    sequence. Raises when the shard does not fit the kernels
    (:func:`ring_flash_ok`), as JAX's does, on either device."""
    check_flash_shard(q.shape[1], q.shape[3])
    return ring_attention(q, k, v, group, causal, sm_scale)
