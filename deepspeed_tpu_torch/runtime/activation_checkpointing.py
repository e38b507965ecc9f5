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
Partitioned and CPU checkpointing are not ported.
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
