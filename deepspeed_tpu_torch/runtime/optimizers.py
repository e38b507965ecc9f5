"""Optimizer registry: config ``optimizer.type`` → an optimizer over the
parameter tree (counterpart of ``deepspeed_tpu/runtime/optimizers.py``).

Each optimizer updates the fp32 master in place with optax's math and reads
the learning rate from the schedule's tensor form
(``lr_schedules.tensor_form``) at its own update count, which starts at 0.
The count is an int32 scalar on the parameters' device, as optax's is an
array in the optimizer state: an update reads nothing on the host, so it
runs inside the engine's captured step. ``step(..., skip=)`` takes the fp16
overflow flag (a device bool): a skipped update leaves parameters, moments
and the count bit for bit as they were, as the JAX step's
``_tree_select(~overflow, ...)``.

- Adam, AdamW, FusedAdam, DeepSpeedCPUAdam: optax ``adamw`` with the decay
  masked to leaves with ``ndim >= 2``, ``chain(add_decayed_weights, adam)``
  (L2 decay folded into the gradient) when ``adam_w_mode`` is false, or
  ``adam`` without decay. CUDA masters update through the fused kernel
  (``ops.fused_adam``), one launch a step; CPU masters through its plain
  version.
- Lamb, FusedLamb: optax ``lamb`` (eps 1e-8 unless given, decay on every
  leaf, the trust ratio per leaf and unclamped): the fused kernel's two
  launches a step on the card, the plain version on the CPU.
- Adagrad, DeepSpeedCPUAdagrad: optax ``adagrad`` (accumulator from 0.1),
  and SGD: optax ``sgd`` (a trace, with decay 0 when ``momentum`` is 0),
  as plain tensor ops on either device.

OneBitAdam, ZeroOneAdam and OneBitLamb are the 1-bit optimizers of
``runtime/fp16/onebit/`` in the JAX engine, which compress momentum; they
are not ported and raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Union

import torch

from ..ops import fused_adam
from ..utils.weights import tree_leaves, tree_map
from .config import NotPortedError
from .lr_schedules import tensor_form

PyTree = Any
Schedule = Union[float, Callable[[int], float]]

_ADAM_NAMES = ("adam", "adamw", "fusedadam", "deepspeedcpuadam")
_LAMB_NAMES = ("lamb", "fusedlamb")
_ADAGRAD_NAMES = ("adagrad", "deepspeedcpuadagrad")
_ONEBIT_NAMES = ("onebitadam", "zerooneadam", "onebitlamb")


@dataclass
class AdamState:
    count: torch.Tensor  # int32 []: applied updates (optax's count)
    mu: PyTree
    nu: PyTree


@dataclass
class AdagradState:
    count: torch.Tensor
    sum_of_squares: PyTree


@dataclass
class SGDState:
    count: torch.Tensor
    trace: PyTree


def _count(params: PyTree) -> torch.Tensor:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    return torch.zeros((), dtype=torch.int32, device=dev)


def _advance(count: torch.Tensor, skip) -> None:
    """count + 1 in place, unless the step is skipped."""
    if skip is None:
        count.add_(1)
    else:
        count.copy_(torch.where(skip, count, count + 1))


def _keep(skip, old, new):
    return new if skip is None else torch.where(skip, old, new)


class _Optimizer:
    """The learning rate, read at the optimizer's own device count."""

    def __init__(self, learning_rate: Schedule):
        self.learning_rate = learning_rate
        self._lr = tensor_form(learning_rate)

    def lr_at(self, count: torch.Tensor) -> torch.Tensor:
        """The schedule at the int32 ``count`` → an f32 0-d tensor there."""
        return self._lr(count)


class Adam(_Optimizer):
    """optax ``adam`` / ``adamw`` (masked) / ``chain(add_decayed_weights,
    adam)`` in place on a tree of fp32 tensors."""

    def __init__(self, learning_rate: Schedule, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0, decoupled: bool = True):
        super().__init__(learning_rate)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.weight_decay = float(weight_decay)
        self.decoupled = bool(decoupled)

    @property
    def mode(self) -> str:
        if not self.weight_decay:
            return "none"
        return "decoupled" if self.decoupled else "l2"

    def init(self, params: PyTree) -> AdamState:
        return AdamState(count=_count(params), mu=tree_map(torch.zeros_like, params),
                         nu=tree_map(torch.zeros_like, params))

    def step(self, params: PyTree, grads: List[torch.Tensor], state: AdamState,
             skip: Optional[torch.Tensor] = None) -> None:
        """One update of every leaf of ``params`` (in place) from ``grads``
        (in ``tree_leaves`` order); advances ``state``. Nothing changes where
        ``skip`` (a device bool) is true."""
        leaves = tree_leaves(params)
        # the decay mask of the JAX registry (_default_wd_mask): ndim >= 2
        wds = [self.weight_decay if p.ndim >= 2 else 0.0 for p in leaves]
        fused_adam.multi_tensor_adam_(leaves, grads, tree_leaves(state.mu),
                                      tree_leaves(state.nu), state.count + 1,
                                      self.lr_at(state.count), (self.b1, self.b2), self.eps,
                                      wds, self.mode, skip)
        _advance(state.count, skip)


class Lamb(_Optimizer):
    """optax ``lamb`` in place: decay on every leaf, the trust ratio
    ``||p|| / ||u||`` per leaf without a clamp."""

    def __init__(self, learning_rate: Schedule, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-6, weight_decay: float = 0.0):
        super().__init__(learning_rate)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.weight_decay = float(weight_decay)

    init = Adam.init

    def step(self, params: PyTree, grads: List[torch.Tensor], state: AdamState,
             skip: Optional[torch.Tensor] = None,
             norm_reduce: Optional[fused_adam.NormReduce] = None) -> None:
        """``norm_reduce``: the leaves that are this rank's ZeRO shards, whose
        trust-ratio norms are summed over the ranks (``ops.fused_adam``)."""
        leaves = tree_leaves(params)
        fused_adam.multi_tensor_lamb_(leaves, grads, tree_leaves(state.mu),
                                      tree_leaves(state.nu), state.count + 1,
                                      self.lr_at(state.count), (self.b1, self.b2), self.eps,
                                      [self.weight_decay] * len(leaves), skip=skip,
                                      norm_reduce=norm_reduce)
        _advance(state.count, skip)


class Adagrad(_Optimizer):
    """optax ``adagrad``: ``t += g * g`` (``t`` from
    ``initial_accumulator_value``), ``p -= lr * where(t > 0, rsqrt(t + eps),
    0) * g``."""

    def __init__(self, learning_rate: Schedule, eps: float = 1e-7,
                 initial_accumulator_value: float = 0.1):
        super().__init__(learning_rate)
        self.eps = float(eps)
        self.initial_accumulator_value = float(initial_accumulator_value)

    def init(self, params: PyTree) -> AdagradState:
        return AdagradState(count=_count(params), sum_of_squares=tree_map(
            lambda p: torch.full_like(p, self.initial_accumulator_value), params))

    @torch.no_grad()
    def step(self, params: PyTree, grads: List[torch.Tensor], state: AdagradState,
             skip: Optional[torch.Tensor] = None) -> None:
        neg_lr = -self.lr_at(state.count)
        for p, g, t in zip(tree_leaves(params), grads, tree_leaves(state.sum_of_squares)):
            g = g.float()
            t2 = t + g * g
            scale = torch.where(t2 > 0, torch.rsqrt(t2 + self.eps), torch.zeros_like(t2))
            p.copy_(_keep(skip, p, p + scale * g * neg_lr))
            t.copy_(_keep(skip, t, t2))
        _advance(state.count, skip)


class SGD(_Optimizer):
    """optax ``sgd``: ``trace = g + momentum * trace``; the update is the
    trace, or ``g + momentum * trace`` with ``nesterov``; ``p -= lr * u``."""

    def __init__(self, learning_rate: Schedule, momentum: float = 0.0, nesterov: bool = False):
        super().__init__(learning_rate)
        self.momentum = float(momentum)
        self.nesterov = bool(nesterov)

    def init(self, params: PyTree) -> SGDState:
        return SGDState(count=_count(params), trace=tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def step(self, params: PyTree, grads: List[torch.Tensor], state: SGDState,
             skip: Optional[torch.Tensor] = None) -> None:
        neg_lr = -self.lr_at(state.count)
        for p, g, tr in zip(tree_leaves(params), grads, tree_leaves(state.trace)):
            g = g.float()
            tr2 = tr * self.momentum + g
            u = g + self.momentum * tr2 if self.nesterov else tr2
            p.copy_(_keep(skip, p, p + u * neg_lr))
            tr.copy_(_keep(skip, tr, tr2))
        _advance(state.count, skip)


def _tree_paths(tree: PyTree, prefix: str) -> List[tuple]:
    """``(prefix/path, leaf)`` of a nested dict in sorted key order (a
    pytree's flatten order)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _tree_paths(tree[k], f"{prefix}/{k}")
        return out
    return [(prefix, tree)]


def optax_state_paths(opt: _Optimizer, state) -> List[tuple]:
    """The optimizer state as ``(path, tensor)`` under the names optax's
    chain gives the JAX engine's ``opt_state`` (``tree_flatten_with_path``
    order, ``opt_state/`` omitted): ``adam`` is ``chain(scale_by_adam,
    scale_by_learning_rate)``, ``adamw`` puts the masked decay between them
    (an empty state), L2 Adam is ``chain(add_decayed_weights, adam)``,
    ``lamb`` is ``chain(scale_by_adam, add_decayed_weights,
    scale_by_trust_ratio, scale_by_learning_rate)``, ``adagrad``
    ``chain(scale_by_rss, ...)`` and ``sgd`` ``chain(trace, ...)``. The
    schedule's own count (present when the learning rate is a schedule)
    is the same tensor as the optimizer's count: both advance on every
    applied update."""
    sched = callable(opt.learning_rate)
    if isinstance(opt, (Adam, Lamb)):
        if isinstance(opt, Lamb):
            base, sched_slot = "0", "3"
        elif opt.mode == "l2":
            base, sched_slot = "1/0", "1/1"
        else:
            base, sched_slot = "0", "2" if opt.mode == "decoupled" else "1"
        out = [(f"{base}/count", state.count)]
        out += _tree_paths(state.mu, f"{base}/mu") + _tree_paths(state.nu, f"{base}/nu")
    elif isinstance(opt, Adagrad):
        out, sched_slot = _tree_paths(state.sum_of_squares, "0/sum_of_squares"), "1"
    else:
        out, sched_slot = _tree_paths(state.trace, "0/trace"), "1"
    if sched:
        out.append((f"{sched_slot}/count", state.count))
    return out


def build_optimizer(opt_type: Optional[str], params_cfg: Optional[Dict[str, Any]] = None,
                    learning_rate: Optional[Schedule] = None) -> _Optimizer:
    """The optimizer of a DeepSpeed ``optimizer`` config section."""
    p = dict(params_cfg or {})
    name = (opt_type or "Adam").lower()
    lr = learning_rate if learning_rate is not None else p.get("lr", 1e-3)
    betas = tuple(p.get("betas", (0.9, 0.999)))
    eps = float(p.get("eps", 1e-8))
    wd = float(p.get("weight_decay", 0.0))
    if name in _ADAM_NAMES:
        decoupled = bool(p.get("adam_w_mode", True)) or name == "adamw"
        return Adam(lr, betas[0], betas[1], eps, wd, decoupled)
    if name in _LAMB_NAMES:
        return Lamb(lr, betas[0], betas[1], eps, wd)
    if name in _ADAGRAD_NAMES:
        return Adagrad(lr, eps=float(p.get("eps", 1e-10)))
    if name == "sgd":
        return SGD(lr, momentum=float(p.get("momentum", 0.0)),
                   nesterov=bool(p.get("nesterov", False)))
    if name in _ONEBIT_NAMES:
        raise NotPortedError(
            f"optimizer {opt_type!r} is a 1-bit optimizer (runtime/fp16/onebit/ in the JAX "
            "engine, which compresses momentum) and is not ported to deepspeed_tpu_torch yet "
            "(ROADMAP queue 1 item 13)"
        )
    raise ValueError(f"unknown optimizer type: {opt_type}")
