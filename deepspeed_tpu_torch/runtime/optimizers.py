"""Optimizer registry: config ``optimizer.type`` → an optimizer over the
parameter tree (counterpart of ``deepspeed_tpu/runtime/optimizers.py``).

The Adam family (Adam, AdamW, FusedAdam, DeepSpeedCPUAdam) is ported with
optax's math, as plain tensor ops that update the fp32 master in place:
bias-corrected moments, ``eps`` outside the square root, decoupled weight
decay masked to leaves with ``ndim >= 2`` (L2 decay folded into the
gradient when ``adam_w_mode`` is false), and the learning rate read from the
schedule at the optimizer's own update count, which starts at 0. Lamb,
Adagrad and SGD are not ported yet and raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Union

import torch

from ..utils.weights import tree_leaves, tree_map
from .config import NotPortedError

PyTree = Any
Schedule = Union[float, Callable[[int], float]]

_ADAM_NAMES = ("adam", "adamw", "fusedadam", "deepspeedcpuadam")
_NOT_PORTED = ("lamb", "fusedlamb", "onebitlamb", "adagrad", "deepspeedcpuadagrad", "sgd",
               "onebitadam", "zerooneadam")


@dataclass
class AdamState:
    count: int  # applied updates (optax's count)
    mu: PyTree
    nu: PyTree


class Adam:
    """optax ``adam`` / ``adamw`` (masked) / ``chain(add_decayed_weights,
    adam)`` in place on a tree of fp32 tensors."""

    def __init__(self, learning_rate: Schedule, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0, decoupled: bool = True):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.weight_decay = float(weight_decay)
        self.decoupled = bool(decoupled)

    def lr_at(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def init(self, params: PyTree) -> AdamState:
        return AdamState(count=0, mu=tree_map(torch.zeros_like, params),
                         nu=tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def step(self, params: PyTree, grads: List[torch.Tensor], state: AdamState) -> None:
        """One update of every leaf of ``params`` (in place) from ``grads``
        (f32, in ``tree_leaves`` order); advances ``state``."""
        b1, b2, eps, wd = self.b1, self.b2, self.eps, self.weight_decay
        lr = self.lr_at(state.count)
        count = state.count + 1
        # bias corrections in f32, as optax computes them
        f32 = torch.float32
        bc1 = float(1 - torch.tensor(b1, dtype=f32) ** count)
        bc2 = float(1 - torch.tensor(b2, dtype=f32) ** count)
        for p, g, mu, nu in zip(tree_leaves(params), grads, tree_leaves(state.mu),
                                tree_leaves(state.nu)):
            decay = wd and p.ndim >= 2
            if decay and not self.decoupled:
                g = g + wd * p
            mu.mul_(b1).add_(g * (1 - b1))
            nu.mul_(b2).add_(g * g * (1 - b2))
            u = (mu / bc1) / ((nu / bc2).sqrt() + eps)
            if decay and self.decoupled:
                u = u + wd * p
            p.add_(u * -lr)
        state.count = count


def build_optimizer(opt_type: Optional[str], params_cfg: Optional[Dict[str, Any]] = None,
                    learning_rate: Optional[Schedule] = None) -> Adam:
    """The optimizer of a DeepSpeed ``optimizer`` config section."""
    p = dict(params_cfg or {})
    name = (opt_type or "Adam").lower()
    lr = learning_rate if learning_rate is not None else p.get("lr", 1e-3)
    if name in _ADAM_NAMES:
        betas = tuple(p.get("betas", (0.9, 0.999)))
        wd = float(p.get("weight_decay", 0.0))
        decoupled = bool(p.get("adam_w_mode", True)) or name == "adamw"
        return Adam(lr, betas[0], betas[1], float(p.get("eps", 1e-8)), wd, decoupled)
    if name in _NOT_PORTED:
        raise NotPortedError(
            f"optimizer {opt_type!r} is not ported to deepspeed_tpu_torch yet (the Adam "
            "family is; ROADMAP queue 1 item 5)"
        )
    raise ValueError(f"unknown optimizer type: {opt_type}")
