"""Fused AdamW and LAMB: the CUDA kernel's wrappers and their plain versions
(counterpart of ``deepspeed_tpu/ops/fused_adam.py``).

The kernel (``csrc/fused_adam.cu``) replaces the Pallas kernels
``_adam_kernel`` (``fused_adamw_flat``, ``fused_adamw_tree``) and
``_lamb_stage1_kernel`` (``fused_lamb_flat``, whose trust ratio and apply
the JAX function computes outside its kernel). One launch updates every
tensor of a list (at most :data:`MAX_TENSORS` a launch), in place:

- :func:`multi_tensor_adam_`: Adam in one of three modes, ``"decoupled"``
  (AdamW: ``u + wd * p``), ``"l2"`` (``g + wd * p`` before the moments) or
  ``"none"``, with one weight decay per tensor (0 where the mask keeps a
  leaf undecayed);
- :func:`multi_tensor_lamb_`: LAMB, ``u = m^ / (sqrt(v^) + eps) + wd * p``
  and ``p - lr * trust * u`` with ``trust = ||p|| / ||u||`` per tensor (1
  when either norm is 0), clamped to ``[min_trust, max_trust]`` when they
  are given; two launches. Under ZeRO a rank holds shards of some tensors:
  a :class:`NormReduce` sums their norms' partial sums over the ranks
  between the two launches, so each trust ratio is the whole tensor's.

The ``*_ref_`` functions are the plain versions, optax's f32 arithmetic as
PyTorch ops in the same order. The dispatchers take them for CPU tensors;
CUDA tensors go to the kernel, which launches or raises; any other device
raises.

The per-step scalars live on the device, so a captured training step reads
nothing on the host and replays with the current values: ``step`` (the
1-based update count) is an int32 tensor, ``lr`` an f32 tensor and
``skip`` (the fp16 overflow flag) a bool tensor, all on the operands'
device (a Python ``step`` / ``lr`` is made into one first). Both the
kernel and the plain version read them through one f32 ``[4]`` device
block, ``{lr, 1 - b1^step, 1 - b2^step, skip}`` (:func:`device_block`):
the bias corrections are a one-element torch op on the count before the
launch, the same op for both. On ``skip`` the kernel writes nothing, and
the plain version writes back the values it read: parameters and moments
stay bit for bit. The betas, eps, decays and trust bounds are fixed for a
run and go by value.

``fused_adamw_flat``, ``fused_adamw_tree`` and ``fused_lamb_flat`` keep the
JAX entries' signatures and defaults and return new tensors.
"""

from __future__ import annotations

import ctypes
import math
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from ..utils.weights import tree_leaves, tree_map
from .launches import LAUNCHES, register

# its launches in the registry (the main path's proof that it ran here);
# LAMB launches twice a call
KERNELS = register("fused_adamw", "fused_lamb")

MAX_TENSORS = 48  # tensors a launch takes (csrc/fused_adam.cu kMaxTensors)
CHUNK = 65536     # elements a block updates (kChunk): LAMB's partial sums
MODES = {"none": 0, "decoupled": 1, "l2": 2}
GRAD_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _scalar(x, dtype, device, what):
    """``x`` as a 0-d ``dtype`` tensor on ``device``: a Python number is
    filled there (no host copy); a tensor must already be one."""
    if isinstance(x, torch.Tensor):
        if x.dtype != dtype or x.device != device or x.numel() != 1:
            raise TypeError(f"{what} must be a Python number or a one-element {dtype} tensor "
                            f"on {device} (got {x.dtype}, {tuple(x.shape)} on {x.device})")
        return x.reshape(())
    return torch.full((), x, dtype=dtype, device=device)


def device_block(step, lr, skip, betas, device) -> torch.Tensor:
    """The kernel's f32 ``[4]`` block on ``device``: ``{lr, 1 - b1^step, 1 -
    b2^step, skip}``. ``step``: the 1-based count (int or int32 tensor),
    ``lr``: float or f32 tensor, ``skip``: None or a bool tensor. Device
    ops only: nothing is read on the host."""
    device = torch.device(device)
    if not isinstance(step, torch.Tensor) and int(step) < 1:
        raise ValueError(f"step {step} must be >= 1 (the 1-based update count)")
    count = _scalar(step, torch.int32, device, "step").to(torch.float32)
    lr = _scalar(lr, torch.float32, device, "lr")
    skip = (torch.zeros((), dtype=torch.float32, device=device) if skip is None
            else _scalar(skip, torch.bool, device, "skip").to(torch.float32))
    bc1 = 1 - torch.pow(float(betas[0]), count)
    bc2 = 1 - torch.pow(float(betas[1]), count)
    return torch.stack([lr, bc1, bc2, skip])


def _check_lists(name, params, grads, mus, nus, weight_decays):
    n = len(params)
    if not (len(grads) == len(mus) == len(nus) == len(weight_decays) == n):
        raise ValueError(f"{name}: lists of {len(params)} params, {len(grads)} grads, "
                         f"{len(mus)} m, {len(nus)} v, {len(weight_decays)} decays")
    for i, (p, g, m, v) in enumerate(zip(params, grads, mus, nus)):
        if not (p.shape == g.shape == m.shape == v.shape):
            raise ValueError(f"{name}: tensor {i} shapes {tuple(p.shape)}, {tuple(g.shape)}, "
                             f"{tuple(m.shape)}, {tuple(v.shape)} differ")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _keep(skip, old, new):
    """``new``, or ``old`` where the step is skipped (the same bits back)."""
    return new if skip is None else torch.where(skip, old, new)


@torch.no_grad()
def multi_tensor_adam_ref_(params, grads, mus, nus, step, lr, betas=(0.9, 0.999),
                           eps: float = 1e-8, weight_decays: Optional[Sequence[float]] = None,
                           mode: str = "decoupled", skip=None) -> None:
    """Plain Adam over the lists, in place (optax's ``adam``, ``adamw``
    and ``chain(add_decayed_weights, adam)``), reading lr and the bias
    corrections from the device block; nothing changes where ``skip``."""
    weight_decays = [0.0] * len(params) if weight_decays is None else list(weight_decays)
    _check_lists("multi_tensor_adam_ref_", params, grads, mus, nus, weight_decays)
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r} ({'|'.join(MODES)})")
    if not params:
        return
    blk = device_block(step, lr, skip, betas, params[0].device)
    lr, bc1, bc2 = blk[0], blk[1], blk[2]
    sk = None if skip is None else blk[3] != 0
    b1, b2, eps = float(betas[0]), float(betas[1]), float(eps)
    for p, g, mu, nu, wd in zip(params, grads, mus, nus, weight_decays):
        g = g.float()
        decay = mode != "none" and wd != 0.0
        if decay and mode == "l2":
            g = g + wd * p
        m2 = mu * b1 + g * (1 - b1)
        v2 = nu * b2 + g * g * (1 - b2)
        u = (m2 / bc1) / ((v2 / bc2).sqrt() + eps)
        if decay and mode == "decoupled":
            u = u + wd * p
        p.copy_(_keep(sk, p, p + u * -lr))
        mu.copy_(_keep(sk, mu, m2))
        nu.copy_(_keep(sk, nu, v2))


@torch.no_grad()
def multi_tensor_lamb_ref_(params, grads, mus, nus, step, lr, betas=(0.9, 0.999),
                           eps: float = 1e-6, weight_decays: Optional[Sequence[float]] = None,
                           min_trust: Optional[float] = None,
                           max_trust: Optional[float] = None, skip=None,
                           norm_reduce: Optional["NormReduce"] = None) -> None:
    """Plain LAMB over the lists, in place (optax's ``lamb``: the trust
    ratio per tensor, unclamped when ``min_trust``/``max_trust`` are None),
    from the device block; nothing changes where ``skip``. With
    ``norm_reduce``, the norms of the tensors it marks sharded are the
    square roots of their f64 sums of squares summed over the ranks."""
    weight_decays = [0.0] * len(params) if weight_decays is None else list(weight_decays)
    _check_lists("multi_tensor_lamb_ref_", params, grads, mus, nus, weight_decays)
    if not params:
        return
    blk = device_block(step, lr, skip, betas, params[0].device)
    lr, bc1, bc2 = blk[0], blk[1], blk[2]
    sk = None if skip is None else blk[3] != 0
    b1, b2, eps = float(betas[0]), float(betas[1]), float(eps)
    sharded = [False] * len(params) if norm_reduce is None else list(norm_reduce.sharded)
    updates = []
    for p, g, mu, nu, wd in zip(params, grads, mus, nus, weight_decays):
        g = g.float()
        m2 = mu * b1 + g * (1 - b1)
        v2 = nu * b2 + g * g * (1 - b2)
        updates.append((m2, v2, (m2 / bc1) / ((v2 / bc2).sqrt() + eps) + wd * p))
    norms = [None] * len(params)
    if any(sharded):
        idx = [i for i, s in enumerate(sharded) if s]
        sq = torch.stack([torch.stack([params[i].double().square().sum(),
                                       updates[i][2].double().square().sum()]) for i in idx])
        norm_reduce.fn(sq)
        for j, i in enumerate(idx):
            norms[i] = sq[j].sqrt().float()
    for i, (p, mu, nu) in enumerate(zip(params, mus, nus)):
        m2, v2, u = updates[i]
        if norms[i] is None:
            pn, un = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
        else:
            pn, un = norms[i][0], norms[i][1]
        ratio = pn / un
        if min_trust is not None or max_trust is not None:
            ratio = ratio.clamp(min_trust, max_trust)
        trust = torch.where((pn > 0) & (un > 0), ratio, torch.ones_like(ratio))
        p.copy_(_keep(sk, p, p + u * trust * -lr))
        mu.copy_(_keep(sk, mu, m2))
        nu.copy_(_keep(sk, nu, v2))


class NormReduce:
    """LAMB over shards (ZeRO): ``sharded[i]`` marks the tensors that are
    this rank's shards of larger ones, whose norms are their sums of squares
    summed over the ranks by ``fn`` (an in-place SUM all-reduce of a f64
    tensor). Tensors not marked are whole on every rank and keep their own
    norms: summing them too would count them once a rank."""

    def __init__(self, fn: Callable[[torch.Tensor], Any], sharded: Sequence[bool]):
        self.fn = fn
        self.sharded = list(sharded)


# ---------------------------------------------------------------------------
# the kernel's wrappers
# ---------------------------------------------------------------------------

def _check_cuda(name, params, grads, mus, nus):
    dev = params[0].device
    gdt = grads[0].dtype
    for i, (p, g, m, v) in enumerate(zip(params, grads, mus, nus)):
        for what, t in (("p", p), ("g", g), ("m", m), ("v", v)):
            if t.device != dev:
                raise ValueError(f"{name}: {what}[{i}] is on {t.device}, expected every "
                                 f"operand on {dev}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: {what}[{i}] must be contiguous")
        if p.dtype != torch.float32 or m.dtype != torch.float32 or v.dtype != torch.float32:
            raise TypeError(f"{name}: p, m, v [{i}] must be float32 (got {p.dtype}, "
                            f"{m.dtype}, {v.dtype})")
        if g.dtype not in GRAD_DTYPES or g.dtype != gdt:
            raise TypeError(f"{name}: grads must share one dtype of float32, float16 or "
                            f"bfloat16 (got {g.dtype} at {i}, {gdt} at 0)")
    return dev, GRAD_DTYPES[gdt]


def _tables(params, grads, mus, nus, weight_decays):
    k = len(params)
    ptrs = [(ctypes.c_void_p * k)(*[t.data_ptr() for t in ts]) for ts in (params, grads, mus, nus)]
    n = (ctypes.c_longlong * k)(*[t.numel() for t in params])
    wd = (ctypes.c_float * k)(*[float(w) for w in weight_decays])
    return ptrs, n, wd


def _groups(k: int):
    return [(i, min(i + MAX_TENSORS, k)) for i in range(0, k, MAX_TENSORS)]


def multi_tensor_adam(params, grads, mus, nus, step, lr, betas=(0.9, 0.999),
                      eps: float = 1e-8, weight_decays: Optional[Sequence[float]] = None,
                      mode: str = "decoupled", skip=None) -> None:
    """Launch the AdamW kernel on ``torch.cuda.current_stream()``: every
    tensor of the lists updated in place (none where ``skip``), one launch
    for each :data:`MAX_TENSORS` of them, reading lr, the bias corrections
    and the skip flag from the device block. p, m, v float32 and the grads
    float32, float16 or bfloat16 (one dtype), all contiguous on one CUDA
    device. Raises on anything else."""
    weight_decays = [0.0] * len(params) if weight_decays is None else list(weight_decays)
    _check_lists("multi_tensor_adam", params, grads, mus, nus, weight_decays)
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r} ({'|'.join(MODES)})")
    if not params:
        return
    dev, gcode = _check_cuda("multi_tensor_adam", params, grads, mus, nus)
    if dev.type != "cuda":
        raise ValueError(f"multi_tensor_adam: the kernel takes CUDA tensors, not {dev}")
    blk = device_block(step, lr, skip, betas, dev)
    b1, b2 = float(betas[0]), float(betas[1])
    from .op_builder import load

    lib = load("fused_adam")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for lo, hi in _groups(len(params)):
        (p, g, m, v), n, wd = _tables(params[lo:hi], grads[lo:hi], mus[lo:hi], nus[lo:hi],
                                      weight_decays[lo:hi])
        err = lib.fused_adam_launch(p, g, m, v, n, wd, hi - lo, gcode, MODES[mode], b1, b2,
                                    1 - b1, 1 - b2, float(eps), blk.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"multi_tensor_adam: kernel launch failed, CUDA error {err}")
        LAUNCHES["fused_adamw"] += 1


def multi_tensor_lamb(params, grads, mus, nus, step, lr, betas=(0.9, 0.999),
                      eps: float = 1e-6, weight_decays: Optional[Sequence[float]] = None,
                      min_trust: Optional[float] = None,
                      max_trust: Optional[float] = None, skip=None,
                      norm_reduce: Optional[NormReduce] = None) -> None:
    """Launch the LAMB kernel's two stages on ``torch.cuda.current_stream()``
    (two launches for each :data:`MAX_TENSORS` tensors), in place, from the
    device block; the operands as :func:`multi_tensor_adam`'s. The partial
    sums of the norms go to a workspace of one double pair per
    :data:`CHUNK` elements. With ``norm_reduce`` the tensors it marks
    sharded go first in each launch's table, and between the two launches
    ``norm_reduce.fn`` sums their partials (a prefix of the workspace) over
    the ranks, so that stage 2 takes the whole tensors' norms."""
    weight_decays = [0.0] * len(params) if weight_decays is None else list(weight_decays)
    _check_lists("multi_tensor_lamb", params, grads, mus, nus, weight_decays)
    if not params:
        return
    dev, gcode = _check_cuda("multi_tensor_lamb", params, grads, mus, nus)
    if dev.type != "cuda":
        raise ValueError(f"multi_tensor_lamb: the kernel takes CUDA tensors, not {dev}")
    blk = device_block(step, lr, skip, betas, dev)
    b1, b2 = float(betas[0]), float(betas[1])
    lo_t = 0.0 if min_trust is None else float(min_trust)
    hi_t = math.inf if max_trust is None else float(max_trust)
    sharded = [False] * len(params) if norm_reduce is None else list(norm_reduce.sharded)
    # the sharded tensors first (a stable order): their chunks are a
    # prefix of each launch's workspace
    order = sorted(range(len(params)), key=lambda i: not sharded[i])
    params, grads, mus, nus = ([ts[i] for i in order] for ts in (params, grads, mus, nus))
    weight_decays = [weight_decays[i] for i in order]
    sharded = [sharded[i] for i in order]
    from .op_builder import load

    lib = load("fused_adam")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for lo, hi in _groups(len(params)):
        chunks = sum(-(-t.numel() // CHUNK) for t in params[lo:hi])
        shard_chunks = sum(-(-t.numel() // CHUNK) for t, s in zip(params[lo:hi], sharded[lo:hi])
                           if s)
        work = torch.empty(max(chunks, 1) * 2, dtype=torch.float64, device=dev)
        (p, g, m, v), n, wd = _tables(params[lo:hi], grads[lo:hi], mus[lo:hi], nus[lo:hi],
                                      weight_decays[lo:hi])
        args = (p, g, m, v, n, wd, hi - lo, gcode, b1, b2, 1 - b1, 1 - b2, float(eps), lo_t,
                hi_t, blk.data_ptr(), work.data_ptr(), max(chunks, 1))
        err = lib.fused_lamb_stage1_launch(*args, stream)
        if err == 0:
            if shard_chunks:
                norm_reduce.fn(work[:2 * shard_chunks])
            err = lib.fused_lamb_stage2_launch(*args, stream)
        if err != 0:
            raise RuntimeError(f"multi_tensor_lamb: kernel launch failed, CUDA error {err}")
        LAUNCHES["fused_lamb"] += 2


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def _route(params, kernel, plain, name):
    dev = params[0].device if params else torch.device("cpu")
    if dev.type == "cuda":
        return kernel
    if dev.type == "cpu":
        return plain
    raise ValueError(f"{name}: no implementation for device {dev}")


def multi_tensor_adam_(params, grads, mus, nus, step, lr, betas=(0.9, 0.999),
                       eps: float = 1e-8, weight_decays: Optional[Sequence[float]] = None,
                       mode: str = "decoupled", skip=None) -> None:
    """Adam over the lists, in place: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    fn = _route(params, multi_tensor_adam, multi_tensor_adam_ref_, "multi_tensor_adam_")
    fn(params, grads, mus, nus, step, lr, betas, eps, weight_decays, mode, skip)


def multi_tensor_lamb_(params, grads, mus, nus, step, lr, betas=(0.9, 0.999),
                       eps: float = 1e-6, weight_decays: Optional[Sequence[float]] = None,
                       min_trust: Optional[float] = None,
                       max_trust: Optional[float] = None, skip=None,
                       norm_reduce: Optional[NormReduce] = None) -> None:
    """LAMB over the lists, in place: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    fn = _route(params, multi_tensor_lamb, multi_tensor_lamb_ref_, "multi_tensor_lamb_")
    fn(params, grads, mus, nus, step, lr, betas, eps, weight_decays, min_trust, max_trust,
       skip, norm_reduce)


# ---------------------------------------------------------------------------
# the JAX package's entries
# ---------------------------------------------------------------------------

def _fresh(*ts):
    return [t.detach().clone(memory_format=torch.contiguous_format) for t in ts]


def fused_adamw_flat(p, g, m, v, step: int, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                     weight_decay: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One AdamW step on a flat f32 shard (grads f32, f16 or bf16) →
    ``(p', m', v')``, new tensors; ``step`` is the 1-based step count."""
    if p.dim() != 1:
        raise ValueError("flat shards only (ravel the leaf)")
    p2, m2, v2 = _fresh(p, m, v)
    multi_tensor_adam_([p2], [g], [m2], [v2], step, lr, betas, eps, [weight_decay], "decoupled")
    return p2, m2, v2


def fused_adamw_tree(params, grads, mu, nu, step: int, lr: float, betas=(0.9, 0.999),
                     eps: float = 1e-8, weight_decay: float = 0.0):
    """AdamW over a tree (every leaf decayed by ``weight_decay``) → new
    ``(params, mu, nu)`` trees; one launch for the leaves on the card."""
    new_p, new_m, new_v = (tree_map(lambda t: _fresh(t)[0], x) for x in (params, mu, nu))
    leaves = tree_leaves(new_p)
    multi_tensor_adam_(leaves, tree_leaves(grads), tree_leaves(new_m),
                       tree_leaves(new_v), step, lr, betas, eps, [weight_decay] * len(leaves),
                       "decoupled")
    return new_p, new_m, new_v


def fused_lamb_flat(p, g, m, v, step: int, lr: float, betas=(0.9, 0.999), eps: float = 1e-6,
                    weight_decay: float = 0.0, min_trust: float = 0.01,
                    max_trust: float = 10.0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One LAMB step on a flat f32 shard (the trust ratio clamped to
    ``[min_trust, max_trust]``) → ``(p', m', v')``, new tensors."""
    if p.dim() != 1:
        raise ValueError("flat shards only (ravel the leaf)")
    p2, m2, v2 = _fresh(p, m, v)
    multi_tensor_lamb_([p2], [g], [m2], [v2], step, lr, betas, eps, [weight_decay],
                       min_trust, max_trust)
    return p2, m2, v2
