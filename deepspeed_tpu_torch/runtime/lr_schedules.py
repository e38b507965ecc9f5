"""LR schedules: LRRangeTest / OneCycle / WarmupLR / WarmupDecayLR /
CosineAnnealing (counterpart of ``deepspeed_tpu/runtime/lr_schedules.py``).

Each schedule is a plain Python function ``step -> lr`` with the JAX
package's formulas, keyed by the same config ``type`` strings; the
optimizer reads it at its own update count, which starts at 0. Each also
has a tensor form (its ``tensor`` attribute, or :func:`tensor_form` of any
schedule): an int32 count tensor → an f32 0-d tensor on the count's
device, the f32 operations in the order of the JAX schedule as optax
evaluates it inside the jitted step. The training step reads its learning
rate through the tensor form from the optimizer's device count, so no
step reads the count on the host.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
COSINE_ANNEALING = "CosineAnnealing"

VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR, COSINE_ANNEALING]

Schedule = Callable[[int], float]


def _clip(x: float, lo: float, hi: float) -> float:
    return min(max(x, lo), hi)


def _f32(count: torch.Tensor) -> torch.Tensor:
    return count.to(torch.float32)


def _const(like: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full_like(like, float(value), dtype=torch.float32)


def _with_tensor(schedule, tensor):
    schedule.tensor = tensor
    return schedule


def lr_range_test(lr_range_test_min_lr: float = 1e-3, lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0, lr_range_test_staircase: bool = False,
                  **_: Any) -> Schedule:
    """LR sweep for tuning: min_lr * (1 + interval * rate)."""

    def schedule(step):
        interval = float(step) / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = math.floor(interval)
        return lr_range_test_min_lr * (1.0 + interval * lr_range_test_step_rate)

    def tensor(count):
        interval = _f32(count) / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = torch.floor(interval)
        return lr_range_test_min_lr * (1.0 + interval * lr_range_test_step_rate)

    return _with_tensor(schedule, tensor)


def one_cycle(cycle_min_lr: float, cycle_max_lr: float, decay_lr_rate: float = 0.0,
              cycle_first_step_size: int = 2000, cycle_second_step_size: Optional[int] = None,
              decay_step_size: int = 0, **_: Any) -> Schedule:
    """1cycle: linear up over the first step size, down over the second,
    then ``min_lr / (1 + rate * floor(post / decay_step_size))``."""
    second = cycle_second_step_size if cycle_second_step_size is not None else cycle_first_step_size
    total_cycle = cycle_first_step_size + second

    def schedule(step):
        step = float(step)
        if step < total_cycle:
            if step < cycle_first_step_size:
                frac = _clip(step / max(cycle_first_step_size, 1), 0.0, 1.0)
                return cycle_min_lr + (cycle_max_lr - cycle_min_lr) * frac
            frac = _clip((step - cycle_first_step_size) / max(second, 1), 0.0, 1.0)
            return cycle_max_lr - (cycle_max_lr - cycle_min_lr) * frac
        decay = 1.0
        if decay_lr_rate > 0.0 and decay_step_size > 0:
            decay = 1.0 / (1.0 + decay_lr_rate * math.floor((step - total_cycle) / decay_step_size))
        return cycle_min_lr * decay

    def tensor(count):
        step = _f32(count)
        up_frac = torch.clamp(step / max(cycle_first_step_size, 1), 0.0, 1.0)
        down_frac = torch.clamp((step - cycle_first_step_size) / max(second, 1), 0.0, 1.0)
        up_lr = cycle_min_lr + (cycle_max_lr - cycle_min_lr) * up_frac
        down_lr = cycle_max_lr - (cycle_max_lr - cycle_min_lr) * down_frac
        cyc_lr = torch.where(step < cycle_first_step_size, up_lr, down_lr)
        post = torch.clamp_min(step - total_cycle, 0.0)
        if decay_lr_rate > 0.0 and decay_step_size > 0:
            tail = cycle_min_lr * (1.0 / (1.0 + decay_lr_rate
                                          * torch.floor(post / decay_step_size)))
        else:
            tail = _const(step, cycle_min_lr * 1.0)
        return torch.where(step < total_cycle, cyc_lr, tail)

    return _with_tensor(schedule, tensor)


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
              warmup_num_steps: int = 1000, warmup_type: str = "log", **_: Any) -> Schedule:
    """Warm up (log or linear in (step + 1) / warmup_num_steps), then hold."""

    def schedule(step):
        frac = _clip((float(step) + 1) / max(warmup_num_steps, 1), 0.0, 1.0)
        gamma = math.log(frac * (math.e - 1.0) + 1.0) if warmup_type == "log" else frac
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * gamma

    def tensor(count):
        frac = torch.clamp((_f32(count) + 1) / max(warmup_num_steps, 1), 0.0, 1.0)
        gamma = torch.log(frac * (math.e - 1.0) + 1.0) if warmup_type == "log" else frac
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * gamma

    return _with_tensor(schedule, tensor)


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                    warmup_type: str = "log", **_: Any) -> Schedule:
    """Warm up, then decay linearly to 0 at ``total_num_steps``."""
    base = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type)

    def schedule(step):
        if step < warmup_num_steps:
            return base(step)
        decay = _clip((total_num_steps - float(step))
                      / max(float(total_num_steps - warmup_num_steps), 1.0), 0.0, 1.0)
        return warmup_max_lr * decay

    def tensor(count):
        step = _f32(count)
        decay = torch.clamp((total_num_steps - step)
                            / max(float(total_num_steps - warmup_num_steps), 1.0), 0.0, 1.0)
        return torch.where(step < warmup_num_steps, base.tensor(step), warmup_max_lr * decay)

    return _with_tensor(schedule, tensor)


def cosine_annealing(total_num_steps: int, warmup_num_steps: int = 0,
                     warmup_max_lr: float = 1e-3, warmup_min_lr: float = 0.0,
                     cosine_min_ratio: float = 0.1, **_: Any) -> Schedule:
    """Linear warmup, then cosine from max_lr down to ``cosine_min_ratio`` of it."""

    def schedule(step):
        step = float(step)
        if step < warmup_num_steps:
            frac = _clip((step + 1) / max(warmup_num_steps, 1), 0.0, 1.0)
            return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * frac
        prog = _clip((step - warmup_num_steps) / max(total_num_steps - warmup_num_steps, 1),
                     0.0, 1.0)
        cos = cosine_min_ratio + (1 - cosine_min_ratio) * 0.5 * (1 + math.cos(math.pi * prog))
        return warmup_max_lr * cos

    def tensor(count):
        step = _f32(count)
        warm_frac = torch.clamp((step + 1) / max(warmup_num_steps, 1), 0.0, 1.0)
        warm = warmup_min_lr + (warmup_max_lr - warmup_min_lr) * warm_frac
        prog = torch.clamp((step - warmup_num_steps) / max(total_num_steps - warmup_num_steps, 1),
                           0.0, 1.0)
        cos = cosine_min_ratio + (1 - cosine_min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup_num_steps, warm, warmup_max_lr * cos)

    return _with_tensor(schedule, tensor)


_REGISTRY: Dict[str, Callable[..., Schedule]] = {
    LR_RANGE_TEST: lr_range_test,
    ONE_CYCLE: one_cycle,
    WARMUP_LR: warmup_lr,
    WARMUP_DECAY_LR: warmup_decay_lr,
    COSINE_ANNEALING: cosine_annealing,
}


def get_lr_schedule(name: Optional[str], params: Optional[Dict[str, Any]] = None,
                    fallback_lr: float = 1e-3) -> Schedule:
    """The schedule of a ``scheduler: {type, params}`` section; no scheduler
    → the optimizer's constant lr."""
    if name is None:
        return _with_tensor(lambda step: float(fallback_lr),
                            lambda count: _const(count, fallback_lr))
    if name not in _REGISTRY:
        raise ValueError(f"unknown scheduler type {name}; valid: {VALID_LR_SCHEDULES}")
    return _REGISTRY[name](**(params or {}))


def tensor_form(schedule) -> Callable[[torch.Tensor], torch.Tensor]:
    """``schedule`` (a number, a schedule of this module or any callable)
    as ``count -> f32 0-d tensor on the count's device``. A callable
    without a tensor form is called with the count tensor itself, as optax
    calls a schedule with its traced count: to run inside a captured step
    it must be written in tensor operations (a Python branch on the count
    reads it on the host)."""
    if not callable(schedule):
        lr = float(schedule)
        return lambda count: _const(count, lr)
    form = getattr(schedule, "tensor", None)
    if form is not None:
        return form

    def call(count):
        out = schedule(count)
        if isinstance(out, torch.Tensor):
            return out.to(torch.float32)
        return _const(count, out)

    return call
