"""Static and dynamic loss scaling (counterpart of
``deepspeed_tpu/runtime/fp16/loss_scaler.py``).

The state is four host scalars; the engine reads the overflow flag on the
host (one sync per fp16 step) and skips the update on overflow. Dynamic
scaling has the reference's hysteresis: an overflow first spends
hysteresis, and the scale halves (not below ``min_scale``) once it is
exhausted; ``scale_window`` clean iterations since the last overflow
double it.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import torch

from ...utils.weights import tree_leaves


@dataclass(frozen=True)
class LossScaleState:
    cur_scale: float
    cur_hysteresis: int
    last_overflow_iter: int
    iteration: int


def create(static_loss_scale: float = 1.0, dynamic: bool = False,
           initial_scale_power: int = 16, hysteresis: int = 2) -> LossScaleState:
    init = float(2 ** initial_scale_power) if dynamic else float(static_loss_scale)
    return LossScaleState(cur_scale=init, cur_hysteresis=int(hysteresis),
                          last_overflow_iter=-1, iteration=0)


def from_config(fp16_cfg) -> LossScaleState:
    """From an ``fp16`` section."""
    if not fp16_cfg.enabled:
        return create(1.0, dynamic=False)
    if fp16_cfg.dynamic_loss_scale:
        return create(dynamic=True, initial_scale_power=fp16_cfg.initial_scale_power,
                      hysteresis=fp16_cfg.hysteresis)
    return create(static_loss_scale=fp16_cfg.loss_scale, dynamic=False)


def has_inf_or_nan(tree: Any) -> torch.Tensor:
    """Global overflow flag (a bool tensor on the leaves' device) over a
    gradient tree or list: any leaf whose f32 sum is not finite."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.tensor(False)
    return torch.stack([~torch.isfinite(leaf.float().sum()) for leaf in leaves]).any()


def update(state: LossScaleState, overflow: bool, dynamic: bool = True,
           scale_window: int = 1000, min_scale: float = 1.0) -> LossScaleState:
    """One loss-scale transition (reference DynamicLossScaler.update_scale),
    by a factor of 2."""
    scale_factor = 2.0
    if not dynamic:
        return replace(state, iteration=state.iteration + 1)
    if overflow:
        exhausted = state.cur_hysteresis <= 1
        state = replace(
            state,
            cur_scale=max(state.cur_scale / scale_factor, min_scale) if exhausted
            else state.cur_scale,
            cur_hysteresis=state.cur_hysteresis if exhausted else state.cur_hysteresis - 1,
            last_overflow_iter=state.iteration,
        )
    elif (state.iteration - state.last_overflow_iter) % scale_window == scale_window - 1:
        state = replace(state, cur_scale=state.cur_scale * scale_factor)
    return replace(state, iteration=state.iteration + 1)
