"""Activation checkpointing (counterpart of
``deepspeed_tpu/runtime/activation_checkpointing`` and of the remat
policies of ``deepspeed_tpu/models/gpt2.py``).

- "full" (:func:`checkpoint`): a block keeps its input and recomputes
  everything in backward, as ``torch.utils.checkpoint`` without
  reentrancy.
- "attn" and "dots" (:func:`selective_checkpoint`): a block keeps its
  input and the attention output with its log-sum-exp (the attention
  backward's own residual), so backward never re-runs the attention
  forward; it recomputes the rest (the layer norms, the q/k/v projection
  the attention backward needs, the MLP). "dots" also keeps every matmul
  output and recomputes only the elementwise ops (layer norms, biases,
  GELU, residual adds). The JAX package names the attention output
  ``attn_out`` for ``save_only_these_names`` and adds ``dots_saveable``
  for "dots".

The block body is written against an ``ops`` object with two methods,
``dot(x, w)`` and ``attention(q, k, v, forward, backward, options)``; the
forward pass records what the policy keeps, the backward pass replays the
body with the kept tensors standing in for the matmuls and the attention.

Partitioned and CPU checkpointing (JAX ``partition_activations``,
``cpu_checkpointing``; the reference's ``checkpointing.py:367, :480``):
:func:`boundary_checkpoint` keeps a block's input, the one tensor full
remat saves, as this rank's ``1/tp`` slice of its last dim (all-gathered
over tp in backward, where the reference calls
``gather_partitioned_activations``) and/or in pinned host memory (copied
back in backward), and recomputes the rest. Either way the gradients are
those of full remat. GPT-2 turns them on from its own config's fields
of the same names, as JAX's does, or from the engine's
``activation_checkpointing`` section (``ModuleSpec.checkpointing``).
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from ..utils.weights import tree_leaves

POLICIES = ("full", "dots", "attn")


def checkpoint(fn, *args):
    """``fn(*args)`` whose activations are recomputed in backward."""
    # no RNG state to stash: dropout draws from threefry keys, and a captured
    # step cannot read the generator's state
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             preserve_rng_state=False)


class _Record:
    """The forward pass: computes, and keeps what the policy saves."""

    def __init__(self, save_dots: bool):
        self.save_dots = save_dots
        self.kept = []

    def dot(self, x, w):
        y = x @ w
        if self.save_dots:
            self.kept.append(y)
        return y

    def attention(self, q, k, v, forward, backward, options):
        o, lse = forward(q, k, v, *options)
        self.kept += [o, lse]
        return o


class _Replay:
    """The backward pass's recomputation: the kept tensors stand in for the
    matmuls (under "dots") and the attention, with their own backward."""

    def __init__(self, save_dots: bool, kept):
        self.save_dots = save_dots
        self.kept = iter(kept)

    def dot(self, x, w):
        if self.save_dots:
            return _KeptDot.apply(x, w, next(self.kept))
        return x @ w

    def attention(self, q, k, v, forward, backward, options):
        o, lse = next(self.kept), next(self.kept)
        return _KeptAttention.apply(q, k, v, o, lse, backward, options)


class _KeptDot(torch.autograd.Function):
    """``y = x @ w`` with ``y`` given: the backward of the product."""

    @staticmethod
    def forward(ctx, x, w, y):
        ctx.save_for_backward(x, w)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dy @ w.t()
        dw = x.reshape(-1, x.shape[-1]).t() @ dy.reshape(-1, dy.shape[-1])
        return dx, dw, None


class _KeptAttention(torch.autograd.Function):
    """``o = attention(q, k, v)`` with ``o`` and its log-sum-exp given: the
    attention backward (a kernel on the card), no forward."""

    @staticmethod
    def forward(ctx, q, k, v, o, lse, backward, options):
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.backward_fn, ctx.options = backward, options
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.device.type == "cuda" and not do.is_contiguous():
            do = do.contiguous()  # the layout the kernels read, not another route
        dq, dk, dv = ctx.backward_fn(q, k, v, o, lse, do, *ctx.options)
        return dq, dk, dv, None, None, None, None


def _rebuild(tree, leaves):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


class _SelectiveRemat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, body, save_dots, h, *leaves):
        rec = _Record(save_dots)
        out = body(rec, h, *leaves)
        ctx.body, ctx.save_dots, ctx.n = body, save_dots, len(leaves)
        ctx.save_for_backward(h, *leaves, *rec.kept)
        return out

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors
        n = 1 + ctx.n
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in saved[:n]]
            out = ctx.body(_Replay(ctx.save_dots, saved[n:]), *inputs)
        grads = torch.autograd.grad(out, inputs, dout, allow_unused=True)
        return (None, None, *grads)


def selective_checkpoint(fn, policy: str, params, h):
    """``fn(params, h, ops)`` (``params`` a nested dict of tensors) under the
    remat ``policy`` "attn" or "dots": the kept tensors are the
    attention's output and log-sum-exp, and under "dots" every
    ``ops.dot`` output; the rest is recomputed in backward."""
    if policy not in ("attn", "dots"):
        raise ValueError(f"selective_checkpoint: policy {policy!r} is not 'attn' or 'dots'")
    leaves = tree_leaves(params)

    def body(ops, h, *ls):
        return fn(_rebuild(params, iter(ls)), h, ops)

    return _SelectiveRemat.apply(body, policy == "dots", h, *leaves)


# ---------------------------------------------------------------------------
# partitioned and CPU checkpointing of a block's saved input
# ---------------------------------------------------------------------------

# (device, shape, dtype, slot) -> the pinned host buffer a slot's saved
# input lives in between its forward and backward. Made at the slot's first
# use (a captured step's eager first run), then reused: a capture records
# only the copies. A micro-batch's backward reads its slots before the
# next forward writes them, on one stream.
_HOST_SLOTS = {}


def _host_buffer(like: torch.Tensor, slot) -> torch.Tensor:
    if slot is None or not like.is_cuda:
        return torch.empty(like.shape, dtype=like.dtype, pin_memory=like.is_cuda)
    key = (like.device, tuple(like.shape), like.dtype, slot)
    buf = _HOST_SLOTS.get(key)
    if buf is None:
        buf = _HOST_SLOTS[key] = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
    return buf


class _Boundary(torch.autograd.Function):
    """Full remat of ``body(h, *leaves)`` whose saved ``h`` is kept as
    :func:`boundary_checkpoint` says."""

    @staticmethod
    def forward(ctx, body, partition, offload, slot, h, *leaves):
        with torch.no_grad():
            out = body(h, *leaves)
        kept = h.detach()
        if partition is not None:
            group, rank, n = partition
            c = kept.shape[-1] // n
            kept = kept.narrow(-1, rank * c, c)
        if offload:
            host = _host_buffer(kept, slot)
            host.copy_(kept, non_blocking=kept.is_cuda)
            kept = host
        else:
            kept = kept.contiguous()
        ctx.body, ctx.partition, ctx.device, ctx.n = body, partition, h.device, len(leaves)
        ctx.kept = kept
        ctx.save_for_backward(*leaves)
        return out

    @staticmethod
    def backward(ctx, dout):
        from ..comm.torch import all_gather

        h = ctx.kept.to(ctx.device, non_blocking=True)
        if ctx.partition is not None:
            h = all_gather(h, ctx.partition[0], gather_dim=-1)
        ctx.kept = None
        leaves = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [h.detach().requires_grad_(True)] + [
                t.detach().requires_grad_(t.requires_grad) for t in leaves]
            out = ctx.body(*inputs)
        want = [x for x in inputs if x.requires_grad]
        got = iter(torch.autograd.grad(out, want, dout, allow_unused=True))
        grads = [next(got) if x.requires_grad else None for x in inputs]
        return (None, None, None, None, *grads)


def boundary_checkpoint(fn, params, h, partition=None, offload: bool = False, slot=None):
    """``fn(params, h)`` (``params`` a nested dict of tensors) under full
    remat, its saved input ``h [..., E]`` kept as this rank's slice
    ``[r E/n, (r + 1) E/n)`` of the last dim when ``partition`` is ``(tp
    group, r, n)`` (gathered over the group in backward) and in pinned host
    memory when ``offload`` (on the card in the pinned buffer of ``slot``,
    a hashable the caller keeps distinct for each block of a forward, e.g.
    the layer index; None: a new buffer each call)."""
    if partition is not None and h.shape[-1] % partition[2]:
        raise ValueError(f"partition_activations: the last dim {h.shape[-1]} of the block "
                         f"input is not divisible by tp={partition[2]}")
    leaves = tree_leaves(params)

    def body(h, *ls):
        return fn(_rebuild(params, iter(ls)), h)

    return _Boundary.apply(body, partition, bool(offload), slot, h, *leaves)
