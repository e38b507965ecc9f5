"""Compile-pipeline statistics: the JAX package's five ``jit_*`` families
(``deepspeed_tpu/telemetry/compile_stats.py``), fed by this package's own
compiles.

PyTorch has no monitoring bus like ``jax.monitoring``; what compiles here
is a CUDA graph capture and an ``nvcc`` build, so the families count these:

- ``jit_compiles_total``            CUDA graph captures
  (``utils/graphs.py`` ``CapturedProgram._capture``)
- ``jit_compile_seconds_total``     summed capture wall time
- ``jit_trace_seconds_total``       summed wall time of the eager warm-up
  step that precedes a capture (``CapturedProgram._warm_up``: the step's
  first run, which builds what the graph will read)
- ``jit_cache_hits_total``          kernel libraries ``ops/op_builder.build``
  found already built
- ``jit_cache_misses_total``        kernel libraries it compiled with nvcc

The sources call :func:`note_capture`, :func:`note_warmup` and
:func:`note_build`; each fans out to every installed registry (a WeakSet:
compiles are process-global, so every live engine's registry sees them and
a dropped engine's registry falls out). With no registry installed a note
is an empty loop.
"""

from __future__ import annotations

import threading
import weakref

from .registry import MetricsRegistry

_lock = threading.Lock()
_sinks: "weakref.WeakSet[MetricsRegistry]" = weakref.WeakSet()

FAMILIES = (
    ("jit_compiles_total", "CUDA graph captures"),
    ("jit_compile_seconds_total", "summed CUDA graph capture wall time"),
    ("jit_trace_seconds_total", "summed eager warm-up wall time before a capture"),
    ("jit_cache_hits_total", "kernel libraries found already built"),
    ("jit_cache_misses_total", "kernel libraries compiled with nvcc"),
)


def _inc(name: str, amount: float = 1.0) -> None:
    with _lock:
        sinks = list(_sinks)
    for reg in sinks:
        reg.counter(name).inc(amount)


def note_capture(seconds: float) -> None:
    """One CUDA graph captured in ``seconds``."""
    _inc("jit_compiles_total")
    _inc("jit_compile_seconds_total", seconds)


def note_warmup(seconds: float) -> None:
    """The eager warm-up step before a capture took ``seconds``."""
    _inc("jit_trace_seconds_total", seconds)


def note_build(hit: bool) -> None:
    """A kernel library found built (``hit``) or compiled."""
    _inc("jit_cache_hits_total" if hit else "jit_cache_misses_total")


def install(registry: MetricsRegistry) -> None:
    """Subscribe ``registry``. Declares the counters eagerly so a scrape
    before the first compile still sees the families at 0."""
    with _lock:
        for name, help in FAMILIES:
            registry.counter(name, help)
        _sinks.add(registry)


def uninstall() -> None:
    """Detach every registry."""
    with _lock:
        _sinks.clear()
