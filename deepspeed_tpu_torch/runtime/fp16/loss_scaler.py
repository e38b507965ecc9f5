"""Static and dynamic loss scaling (counterpart of
``deepspeed_tpu/runtime/fp16/loss_scaler.py``).

The state is four device scalars, as the JAX package's is four arrays in
the train state: ``cur_scale`` f32, ``cur_hysteresis``,
``last_overflow_iter`` and ``iteration`` int32. :func:`update` is tensor
ops on a device bool (the step's overflow flag), step for step the JAX
transition, so a training step reads nothing back on the host and the
engine's captured program carries the scale from step to step. Dynamic
scaling has the reference's hysteresis: an overflow first spends
hysteresis, and the scale halves (not below ``min_scale``) once it is
exhausted; ``scale_window`` clean iterations since the last overflow
double it.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any

import torch

from ...utils.weights import tree_leaves


@dataclass(frozen=True)
class LossScaleState:
    cur_scale: torch.Tensor           # f32 []
    cur_hysteresis: torch.Tensor      # int32 []
    last_overflow_iter: torch.Tensor  # int32 []
    iteration: torch.Tensor           # int32 []


def create(static_loss_scale: float = 1.0, dynamic: bool = False,
           initial_scale_power: int = 16, hysteresis: int = 2,
           device="cpu") -> LossScaleState:
    init = float(2 ** initial_scale_power) if dynamic else float(static_loss_scale)

    def i32(v):
        return torch.tensor(int(v), dtype=torch.int32, device=device)

    return LossScaleState(cur_scale=torch.tensor(init, dtype=torch.float32, device=device),
                          cur_hysteresis=i32(hysteresis), last_overflow_iter=i32(-1),
                          iteration=i32(0))


def from_config(fp16_cfg, device="cpu") -> LossScaleState:
    """From an ``fp16`` section, on ``device``."""
    if not fp16_cfg.enabled:
        return create(1.0, dynamic=False, device=device)
    if fp16_cfg.dynamic_loss_scale:
        return create(dynamic=True, initial_scale_power=fp16_cfg.initial_scale_power,
                      hysteresis=fp16_cfg.hysteresis, device=device)
    return create(static_loss_scale=fp16_cfg.loss_scale, dynamic=False, device=device)


def has_inf_or_nan(tree: Any) -> torch.Tensor:
    """Global overflow flag (a bool tensor on the leaves' device) over a
    gradient tree or list: any leaf whose f32 sum is not finite."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.tensor(False)
    return torch.stack([~torch.isfinite(leaf.float().sum()) for leaf in leaves]).any()


def update(state: LossScaleState, overflow, dynamic: bool = True,
           scale_window: int = 1000, min_scale: float = 1.0) -> LossScaleState:
    """One loss-scale transition (reference DynamicLossScaler.update_scale),
    by a factor of 2, as new tensors: ``overflow`` a bool tensor on the
    state's device (a Python bool is taken too)."""
    scale_factor = 2.0
    it = state.iteration + 1
    if not dynamic:
        return LossScaleState(state.cur_scale, state.cur_hysteresis, state.last_overflow_iter,
                              it)
    ov = torch.as_tensor(overflow, device=state.cur_scale.device)
    exhausted = state.cur_hysteresis <= 1
    on_overflow = torch.where(
        exhausted, torch.clamp_min(state.cur_scale / scale_factor, float(min_scale)),
        state.cur_scale)
    grow = torch.remainder(state.iteration - state.last_overflow_iter,
                           scale_window) == scale_window - 1
    on_success = torch.where(grow, state.cur_scale * scale_factor, state.cur_scale)
    return LossScaleState(
        cur_scale=torch.where(ov, on_overflow, on_success),
        cur_hysteresis=torch.where(ov & ~exhausted, state.cur_hysteresis - 1,
                                   state.cur_hysteresis),
        last_overflow_iter=torch.where(ov, state.iteration, state.last_overflow_iter),
        iteration=it,
    )


def assign(dst: LossScaleState, src: LossScaleState) -> None:
    """Copy ``src``'s values into ``dst``'s tensors (in place: a captured
    step keeps reading and writing the same four scalars)."""
    for f in fields(LossScaleState):
        getattr(dst, f.name).copy_(getattr(src, f.name))
