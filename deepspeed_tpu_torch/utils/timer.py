"""Wall-clock and throughput timers (counterpart of
``deepspeed_tpu/utils/timer.py``: ``SynchronizedWallClockTimer``,
``ThroughputTimer``, the same timer names and telemetry families).

The JAX timers synchronise with ``jax.block_until_ready`` on the arrays a
timed region produced; here the synchronisation point is an event recorded
on the current stream after the tensors of ``sync_tree`` were produced,
waited for on the host (the card runs asynchronously, as XLA does). On
the CPU there is nothing to wait for.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import torch

from .logging import log_dist

FORWARD_MICRO_TIMER = "fwd_microstep"
FORWARD_GLOBAL_TIMER = "fwd"
BACKWARD_MICRO_TIMER = "bwd_microstep"
BACKWARD_GLOBAL_TIMER = "bwd"
STEP_MICRO_TIMER = "step_microstep"
STEP_GLOBAL_TIMER = "step"
TRAIN_BATCH_TIMER = "train_batch"


def _cuda_device(tree: Any) -> Optional[torch.device]:
    if isinstance(tree, torch.Tensor):
        return tree.device if tree.device.type == "cuda" else None
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            dev = _cuda_device(v)
            if dev is not None:
                return dev
    return None


def sync(tree: Any = None) -> None:
    """Wait until the card has produced the tensors of ``tree`` (an event
    on the current stream of their device); nothing for CPU tensors."""
    dev = _cuda_device(tree) if tree is not None else None
    if dev is not None:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()


class _Timer:
    def __init__(self, name: str):
        self.name = name
        self.started = False
        self.start_time = 0.0
        self.elapsed_ = 0.0
        self.last_elapsed_ = 0.0
        self.count = 0

    def start(self, sync_tree: Any = None) -> None:
        sync(sync_tree)
        self.start_time = time.perf_counter()
        self.started = True

    def stop(self, sync_tree: Any = None, record: bool = True) -> None:
        if not self.started:
            return
        sync(sync_tree)
        if record:
            self.last_elapsed_ = time.perf_counter() - self.start_time
            self.elapsed_ += self.last_elapsed_
            self.count += 1
        self.started = False

    def last(self) -> float:
        """Duration of the most recent recorded interval (seconds)."""
        return self.last_elapsed_

    def elapsed(self, reset: bool = True) -> float:
        value = self.elapsed_
        if reset:
            self.reset()
        return value

    def mean(self) -> float:
        return self.elapsed_ / self.count if self.count else 0.0

    def reset(self) -> None:
        self.elapsed_ = 0.0
        self.count = 0
        self.started = False


class SynchronizedWallClockTimer:
    """Group of named timers (reference ``timer.py:31``)."""

    def __init__(self):
        self.timers: Dict[str, _Timer] = {}

    def __call__(self, name: str) -> _Timer:
        if name not in self.timers:
            self.timers[name] = _Timer(name)
        return self.timers[name]

    def has_timer(self, name: str) -> bool:
        return name in self.timers

    def log(self, names: List[str], normalizer: float = 1.0, reset: bool = True,
            ranks: Optional[List[int]] = None) -> None:
        assert normalizer > 0.0
        parts = []
        for name in names:
            if name in self.timers:
                ms = self.timers[name].elapsed(reset=reset) * 1000.0 / normalizer
                parts.append(f"{name}: {ms:.2f}")
        if parts:
            log_dist("time (ms) | " + " | ".join(parts), ranks=ranks)

    def get_mean(self, names: List[str], normalizer: float = 1.0) -> Dict[str, float]:
        return {name: self.timers[name].mean() * 1000.0 / normalizer
                for name in names if name in self.timers}

    def export_telemetry(self, registry) -> None:
        """Every timer's running mean and last interval into a
        MetricsRegistry (gauges ``timer_mean_ms`` / ``timer_last_ms``,
        labelled by timer name). Nothing is reset."""
        mean_g = registry.gauge("timer_mean_ms", "wall-clock timer running mean",
                                labelnames=("name",))
        last_g = registry.gauge("timer_last_ms", "wall-clock timer last interval",
                                labelnames=("name",))
        for name, t in self.timers.items():
            if t.count:
                mean_g.set(t.mean() * 1e3, name=name)
                last_g.set(t.last() * 1e3, name=name)


class ThroughputTimer:
    """Samples/sec meter (reference ``timer.py:135``): from ``start_step``
    on, each ``stop`` waits for the step's outputs before it reads the
    clock, so the rate counts the card's time, not the dispatch's."""

    def __init__(self, batch_size: int, start_step: int = 2, steps_per_output: int = 50,
                 monitor_memory: bool = False, logging_fn=None):
        self.batch_size = max(1, batch_size)
        self.start_step = start_step
        self.steps_per_output = steps_per_output
        self.logging = logging_fn or log_dist
        self.initialized = False
        self.global_step_count = 0
        self.total_elapsed_time = 0.0
        self.step_elapsed_time = 0.0
        self.start_time = 0.0
        self.started = False

    def update_epoch_count(self) -> None:
        self.initialized = False

    def start(self) -> None:
        self.started = True
        if self.global_step_count >= self.start_step:
            self.start_time = time.perf_counter()

    def stop(self, global_step: bool = True, report_speed: bool = True,
             sync_tree: Any = None) -> None:
        if not self.started:
            return
        self.started = False
        if global_step:
            self.global_step_count += 1
        if self.start_time and self.global_step_count > self.start_step:
            sync(sync_tree)
            duration = time.perf_counter() - self.start_time
            self.total_elapsed_time += duration
            self.step_elapsed_time += duration
            if global_step and report_speed and self.global_step_count % self.steps_per_output == 0:
                window_s = max(self.step_elapsed_time, 1e-9)
                window = self.steps_per_output * self.batch_size / window_s
                self.logging(
                    f"step={self.global_step_count}, "
                    f"samples/sec (avg): {self.avg_samples_per_sec():.2f}, "
                    f"samples/sec (window): {window:.2f}"
                )
                self.step_elapsed_time = 0.0

    def avg_samples_per_sec(self) -> float:
        if self.global_step_count > self.start_step and self.total_elapsed_time > 0:
            steps = self.global_step_count - self.start_step
            return steps * self.batch_size / self.total_elapsed_time
        return 0.0

    def export_telemetry(self, registry) -> None:
        """The meter into a MetricsRegistry (gauges
        ``throughput_samples_per_sec`` and ``throughput_steps``)."""
        registry.gauge("throughput_samples_per_sec",
                       "running average samples/sec").set(self.avg_samples_per_sec())
        registry.gauge("throughput_steps",
                       "steps seen by the throughput meter").set(self.global_step_count)
