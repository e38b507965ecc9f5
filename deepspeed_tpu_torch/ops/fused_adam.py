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
  are given; two launches.

The ``*_ref_`` functions are the plain versions, optax's f32 arithmetic as
PyTorch ops in the same order. The dispatchers take them for CPU tensors;
CUDA tensors go to the kernel, which launches or raises; any other device
raises. ``step`` (1-based), ``lr`` and the hyperparameters are Python
numbers, so an update reads nothing back from the card.

``fused_adamw_flat``, ``fused_adamw_tree`` and ``fused_lamb_flat`` keep the
JAX entries' signatures and defaults and return new tensors.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

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


def bias_corrections(betas: Tuple[float, float], step: int) -> Tuple[float, float]:
    """``(1 - b1**step, 1 - b2**step)`` in f32, as optax computes them."""
    f32 = torch.float32
    return tuple(float(1 - torch.tensor(float(b), dtype=f32) ** int(step)) for b in betas)


def _scalars(step, lr, betas, eps):
    if isinstance(step, torch.Tensor) or isinstance(lr, torch.Tensor):
        raise TypeError("step and lr must be Python numbers (no device read per update)")
    if int(step) < 1:
        raise ValueError(f"step {step} must be >= 1 (the 1-based update count)")
    b1, b2 = float(betas[0]), float(betas[1])
    bc1, bc2 = bias_corrections((b1, b2), step)
    return float(lr), b1, b2, float(eps), bc1, bc2


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

@torch.no_grad()
def multi_tensor_adam_ref_(params, grads, mus, nus, step: int, lr: float,
                           betas=(0.9, 0.999), eps: float = 1e-8,
                           weight_decays: Optional[Sequence[float]] = None,
                           mode: str = "decoupled") -> None:
    """Plain Adam over the lists, in place (optax's ``adam``, ``adamw``
    and ``chain(add_decayed_weights, adam)``)."""
    weight_decays = [0.0] * len(params) if weight_decays is None else list(weight_decays)
    _check_lists("multi_tensor_adam_ref_", params, grads, mus, nus, weight_decays)
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r} ({'|'.join(MODES)})")
    lr, b1, b2, eps, bc1, bc2 = _scalars(step, lr, betas, eps)
    for p, g, mu, nu, wd in zip(params, grads, mus, nus, weight_decays):
        g = g.float()
        decay = mode != "none" and wd != 0.0
        if decay and mode == "l2":
            g = g + wd * p
        mu.mul_(b1).add_(g * (1 - b1))
        nu.mul_(b2).add_(g * g * (1 - b2))
        u = (mu / bc1) / ((nu / bc2).sqrt() + eps)
        if decay and mode == "decoupled":
            u = u + wd * p
        p.add_(u * -lr)


@torch.no_grad()
def multi_tensor_lamb_ref_(params, grads, mus, nus, step: int, lr: float,
                           betas=(0.9, 0.999), eps: float = 1e-6,
                           weight_decays: Optional[Sequence[float]] = None,
                           min_trust: Optional[float] = None,
                           max_trust: Optional[float] = None) -> None:
    """Plain LAMB over the lists, in place (optax's ``lamb``: the trust
    ratio per tensor, unclamped when ``min_trust``/``max_trust`` are None)."""
    weight_decays = [0.0] * len(params) if weight_decays is None else list(weight_decays)
    _check_lists("multi_tensor_lamb_ref_", params, grads, mus, nus, weight_decays)
    lr, b1, b2, eps, bc1, bc2 = _scalars(step, lr, betas, eps)
    for p, g, mu, nu, wd in zip(params, grads, mus, nus, weight_decays):
        g = g.float()
        mu.mul_(b1).add_(g * (1 - b1))
        nu.mul_(b2).add_(g * g * (1 - b2))
        u = (mu / bc1) / ((nu / bc2).sqrt() + eps) + wd * p
        pn = torch.linalg.vector_norm(p)
        un = torch.linalg.vector_norm(u)
        ratio = pn / un
        if min_trust is not None or max_trust is not None:
            ratio = ratio.clamp(min_trust, max_trust)
        trust = torch.where((pn > 0) & (un > 0), ratio, torch.ones_like(ratio))
        p.add_(u * trust * -lr)


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


def multi_tensor_adam(params, grads, mus, nus, step: int, lr: float, betas=(0.9, 0.999),
                      eps: float = 1e-8, weight_decays: Optional[Sequence[float]] = None,
                      mode: str = "decoupled") -> None:
    """Launch the AdamW kernel on ``torch.cuda.current_stream()``: every
    tensor of the lists updated in place, one launch for each
    :data:`MAX_TENSORS` of them. p, m, v float32 and the grads float32,
    float16 or bfloat16 (one dtype), all contiguous on one CUDA device.
    Raises on anything else."""
    weight_decays = [0.0] * len(params) if weight_decays is None else list(weight_decays)
    _check_lists("multi_tensor_adam", params, grads, mus, nus, weight_decays)
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r} ({'|'.join(MODES)})")
    if not params:
        return
    dev, gcode = _check_cuda("multi_tensor_adam", params, grads, mus, nus)
    if dev.type != "cuda":
        raise ValueError(f"multi_tensor_adam: the kernel takes CUDA tensors, not {dev}")
    lr, b1, b2, eps, bc1, bc2 = _scalars(step, lr, betas, eps)
    from .op_builder import load

    lib = load("fused_adam")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for lo, hi in _groups(len(params)):
        (p, g, m, v), n, wd = _tables(params[lo:hi], grads[lo:hi], mus[lo:hi], nus[lo:hi],
                                      weight_decays[lo:hi])
        err = lib.fused_adam_launch(p, g, m, v, n, wd, hi - lo, gcode, MODES[mode], lr, b1, b2,
                                    1 - b1, 1 - b2, eps, bc1, bc2, stream)
        if err != 0:
            raise RuntimeError(f"multi_tensor_adam: kernel launch failed, CUDA error {err}")
        LAUNCHES["fused_adamw"] += 1


def multi_tensor_lamb(params, grads, mus, nus, step: int, lr: float, betas=(0.9, 0.999),
                      eps: float = 1e-6, weight_decays: Optional[Sequence[float]] = None,
                      min_trust: Optional[float] = None,
                      max_trust: Optional[float] = None) -> None:
    """Launch the LAMB kernel's two stages on ``torch.cuda.current_stream()``
    (two launches for each :data:`MAX_TENSORS` tensors), in place; the
    operands as :func:`multi_tensor_adam`'s. The partial sums of the norms
    go to a workspace of one double pair per :data:`CHUNK` elements."""
    weight_decays = [0.0] * len(params) if weight_decays is None else list(weight_decays)
    _check_lists("multi_tensor_lamb", params, grads, mus, nus, weight_decays)
    if not params:
        return
    dev, gcode = _check_cuda("multi_tensor_lamb", params, grads, mus, nus)
    if dev.type != "cuda":
        raise ValueError(f"multi_tensor_lamb: the kernel takes CUDA tensors, not {dev}")
    lr, b1, b2, eps, bc1, bc2 = _scalars(step, lr, betas, eps)
    lo_t = 0.0 if min_trust is None else float(min_trust)
    hi_t = math.inf if max_trust is None else float(max_trust)
    from .op_builder import load

    lib = load("fused_adam")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for lo, hi in _groups(len(params)):
        chunks = sum(-(-t.numel() // CHUNK) for t in params[lo:hi])
        work = torch.empty(max(chunks, 1) * 2, dtype=torch.float64, device=dev)
        (p, g, m, v), n, wd = _tables(params[lo:hi], grads[lo:hi], mus[lo:hi], nus[lo:hi],
                                      weight_decays[lo:hi])
        err = lib.fused_lamb_launch(p, g, m, v, n, wd, hi - lo, gcode, lr, b1, b2, 1 - b1,
                                    1 - b2, eps, bc1, bc2, lo_t, hi_t, work.data_ptr(),
                                    max(chunks, 1), stream)
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


def multi_tensor_adam_(params, grads, mus, nus, step: int, lr: float, betas=(0.9, 0.999),
                       eps: float = 1e-8, weight_decays: Optional[Sequence[float]] = None,
                       mode: str = "decoupled") -> None:
    """Adam over the lists, in place: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    fn = _route(params, multi_tensor_adam, multi_tensor_adam_ref_, "multi_tensor_adam_")
    fn(params, grads, mus, nus, step, lr, betas, eps, weight_decays, mode)


def multi_tensor_lamb_(params, grads, mus, nus, step: int, lr: float, betas=(0.9, 0.999),
                       eps: float = 1e-6, weight_decays: Optional[Sequence[float]] = None,
                       min_trust: Optional[float] = None,
                       max_trust: Optional[float] = None) -> None:
    """LAMB over the lists, in place: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    fn = _route(params, multi_tensor_lamb, multi_tensor_lamb_ref_, "multi_tensor_lamb_")
    fn(params, grads, mus, nus, step, lr, betas, eps, weight_decays, min_trust, max_trust)


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
