"""Unified telemetry plane: metrics registry + step tracer + exporters
(counterpart of ``deepspeed_tpu/telemetry/__init__.py``).

One :class:`Telemetry` object per engine bundles:

- :class:`~.registry.MetricsRegistry` — named counters/gauges/histograms fed
  by the serving engine, ``generate`` records, the card's allocator
  counters (``device_hbm_stats``) and the compile counters
  (``compile_stats``: CUDA graph captures and kernel builds);
- :class:`~.tracer.StepTracer` — one structured JSONL record per sampled
  inference step (span tree, scalars, HBM);
- the serving planes the scheduler picks up: :class:`RequestTracer`
  (``request_trace``), :class:`KVHeatTracer` (``kv_heat``),
  :class:`MetricsJournal` (``timeseries``) and the
  :class:`AnomalyWatchdog` (``watchdog``; the straggler detector);
- exporters — Prometheus textfile snapshots and the MonitorBridge fan-out.

Everything is opt-in via the ``telemetry`` config section
(:class:`~deepspeed_tpu_torch.runtime.config.TelemetryConfig`); a disabled
config constructs nothing — the engine holds ``telemetry=None`` and pays
only a None check per step. ``telemetry.introspection.enabled`` (the HLO
cost / MFU analyzer) is not ported (ROADMAP queue 1 item 15) and raises.
The training engine records its sampled steps (``train_step`` records)
and drives the watchdog from ``train_batch``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

from . import compile_stats
from . import watchdog as watchdog_mod
from .exporters import MonitorBridge, PrometheusTextfileExporter
from .kv_heat import KVHeatLedger, KVHeatTracer
from .registry import Counter, Gauge, Histogram, MetricsRegistry
from .request_trace import RequestTracer
from .timeseries import MetricsJournal
from .tracer import Span, StepTracer, aggregate_scalars, spans_to_tree
from .watchdog import AnomalyError, AnomalyWatchdog

__all__ = [
    "AnomalyError", "AnomalyWatchdog",
    "Counter", "Gauge", "Histogram", "KVHeatLedger", "KVHeatTracer",
    "MetricsJournal", "MetricsRegistry", "MonitorBridge",
    "PrometheusTextfileExporter",
    "RequestTracer", "Span", "StepTracer", "Telemetry",
    "aggregate_scalars", "device_hbm_stats", "from_config",
    "spans_to_tree",
]

# histogram buckets for step latency (seconds): tighter than the generic
# defaults around the 10ms-10s band where train/decode steps live
STEP_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0, 60.0,
)


def device_hbm_stats(device=None) -> Dict[str, int]:
    """The card's memory in the JAX package's keys, read from the caching
    allocator's counters (no device synchronisation): ``bytes_in_use``
    (allocated, current), ``peak_bytes_in_use`` (allocated, peak) and
    ``bytes_limit`` (the card's total memory). Zeros on the CPU, as the
    JAX package reports for backends without memory stats."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0}
    stats = torch.cuda.memory_stats(dev)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(dev).total_memory),
    }


class Telemetry:
    """Per-engine telemetry bundle; construct via :func:`from_config`."""

    def __init__(self, config, process_index: Optional[int] = None):
        self.config = config
        self.registry = MetricsRegistry()
        self.tracer = (
            StepTracer(
                config.trace_path,
                flush_interval=config.flush_interval,
                sample_every=config.sample_every,
                process_index=process_index,
                max_bytes=int(getattr(config, "trace_max_mb", 0) or 0) * 2**20,
            )
            if config.trace_path
            else None
        )
        self.prometheus = (
            PrometheusTextfileExporter(self.registry, config.prometheus_path)
            if config.prometheus_path
            else None
        )
        self.monitor_bridge: Optional[MonitorBridge] = None
        self._records_since_export = 0
        # the anomaly watchdog is constructed iff enabled (the
        # introspection section is refused by the config while enabled)
        self.introspection = getattr(config, "introspection", None)
        self.watchdog: Optional[AnomalyWatchdog] = watchdog_mod.from_config(
            getattr(config, "watchdog", None),
            registry=self.registry,
            tracer=self.tracer,
        )
        # request-lifecycle tracing — picked up by ServingEngine
        # (the scheduler is the event source; nothing here is per-step)
        self.request_tracer: Optional[RequestTracer] = None
        rt = getattr(config, "request_trace", None)
        if rt is not None and getattr(rt, "enabled", False):
            self.request_tracer = RequestTracer(
                rt.path or os.path.join(config.trace_path or ".", "requests.jsonl"),
                flush_interval=int(rt.flush_interval),
                max_bytes=int(rt.max_mb) * 2**20,
                max_events_per_request=int(rt.max_events_per_request),
                process_index=process_index,
            )
        # page-lifetime / session-heat tracing — picked up by
        # ServingEngine (the scheduler attaches per-placement pool ledgers)
        self.kv_heat_tracer: Optional[KVHeatTracer] = None
        kh = getattr(config, "kv_heat", None)
        if kh is not None and getattr(kh, "enabled", False):
            self.kv_heat_tracer = KVHeatTracer(
                kh.path or os.path.join(config.trace_path or ".", "kv_heat.jsonl"),
                flush_interval=int(kh.flush_interval),
                max_bytes=int(kh.max_mb) * 2**20,
                segment_events=int(kh.segment_events),
                idle_thresholds_s=tuple(kh.idle_thresholds_s),
                process_index=process_index,
            )
        # metrics time-series journal — picked up by ServingEngine (it
        # drives maybe_snapshot off the engine clock)
        self.metrics_journal: Optional[MetricsJournal] = None
        ts = getattr(config, "timeseries", None)
        if ts is not None and getattr(ts, "enabled", False):
            self.metrics_journal = MetricsJournal(
                ts.path or os.path.join(config.trace_path or ".", "metrics_tsdb.jsonl"),
                registry=self.registry,
                interval_s=float(ts.interval_s),
                flush_interval=int(ts.flush_interval),
                max_bytes=int(ts.max_mb) * 2**20,
                retention_s=float(ts.retention_s) or 3600.0,
                process_index=process_index,
            )
        compile_stats.install(self.registry)

    # -- wiring --------------------------------------------------------
    def attach_monitor(self, monitor) -> None:
        """Route the full registry through MonitorMaster's backends."""
        self.monitor_bridge = MonitorBridge(self.registry, monitor)

    # -- sampling ------------------------------------------------------
    def should_sample(self, step: int) -> bool:
        if self.tracer is not None:
            return self.tracer.should_sample(step)
        return step % max(1, self.config.sample_every) == 0

    def force_sample(self) -> None:
        if self.tracer is not None:
            self.tracer.force_next()

    # -- recording -----------------------------------------------------
    def record_step(
        self,
        kind: str,
        step: int,
        duration_s: float,
        scalars: Optional[Dict[str, float]] = None,
        spans: Optional[List[Span]] = None,
        hbm: Optional[Dict[str, int]] = None,
        comm_bytes: Optional[Dict[str, float]] = None,
        comm_wire_bytes: Optional[Dict[str, float]] = None,
        extra: Optional[Dict[str, Any]] = None,
        aggregate: bool = False,
    ) -> Dict[str, Any]:
        """Fold one step into the registry and append its JSONL record.

        ``kind`` labels the step family (``train`` / ``inference``);
        ``scalars`` are step-level floats (loss, lr, …); ``spans`` a flat
        (name, ms) list of host-side phases; ``comm_bytes`` per-mesh-axis
        collective byte totals of the compiled step (HLO-derived — already
        wire precision); ``comm_wire_bytes`` the compressed layer's own
        on-wire totals, whose quotient against
        ``extra["comm_compression"][axis]["logical_bytes"]`` is exported as
        the ``comm_compression_ratio`` gauge.
        """
        scalars = scalars or {}
        self.registry.counter(
            "steps_total", "executed steps", labelnames=("kind",)
        ).inc(kind=kind)
        self.registry.histogram(
            "step_seconds", "end-to-end step latency", labelnames=("kind",),
            buckets=STEP_BUCKETS,
        ).observe(duration_s, kind=kind)
        for k, v in scalars.items():
            try:
                self.registry.gauge(f"{kind}_{k}", f"last sampled {k}").set(float(v))
            except (TypeError, ValueError):
                pass
        if hbm:
            for k, v in hbm.items():
                self.registry.gauge(f"hbm_{k}", "device 0 HBM (memory_stats)").set(v)
        if comm_bytes:
            g = self.registry.gauge(
                "comm_bytes_per_step",
                "collective payload per compiled step, by mesh axis",
                labelnames=("axis",),
            )
            for axis, b in comm_bytes.items():
                g.set(b, axis=axis)
        if comm_wire_bytes:
            gw = self.registry.gauge(
                "comm_wire_bytes_per_step",
                "actual on-wire collective bytes per compiled step (compressed "
                "collectives), by mesh axis",
                labelnames=("axis",),
            )
            gr = self.registry.gauge(
                "comm_compression_ratio",
                "logical/wire byte ratio of compressed collectives, by mesh axis",
                labelnames=("axis",),
            )
            for axis, w in comm_wire_bytes.items():
                gw.set(w, axis=axis)
                # logical comes ONLY from the compressed layer's own stats
                # (extra["comm_compression"]) — comm_bytes is HLO-derived and
                # already wire precision (an int8 collective counts 1 B/elem),
                # so dividing by it would report ~1x for compressed runs
                logical = (
                    (extra or {}).get("comm_compression", {}).get(axis, {}).get("logical_bytes")
                )
                if logical and w:
                    gr.set(logical / w, axis=axis)

        dur_ms = duration_s * 1e3
        record: Dict[str, Any] = {
            "kind": f"{kind}_step",
            "step": int(step),
            "dur_ms": round(dur_ms, 3),
            **{k: _as_float(v) for k, v in scalars.items()},
            "spans": spans_to_tree(spans or [], dur_ms),
            "hbm": hbm or {},
            "comm_bytes": comm_bytes or {},
        }
        if comm_wire_bytes:
            record["comm_wire_bytes"] = comm_wire_bytes
        if extra:
            record.update(extra)
        if self.tracer is not None:
            self.tracer.emit(record)
            if aggregate:
                agg = aggregate_scalars(
                    {k: v for k, v in scalars.items() if _is_num(v)}
                )
                if agg is not None:
                    self.tracer.emit_aggregate(
                        {"kind": f"{kind}_step_aggregate", "step": int(step), **agg}
                    )
        self._maybe_export()
        return record

    def record_event(
        self, kind: str, duration_s: float, extra: Optional[Dict[str, Any]] = None
    ) -> None:
        """Non-step events (checkpoint save/load, comms measurement, …):
        a counter + summed-duration counter + one JSONL record."""
        self.registry.counter(f"{kind}_total", f"{kind} events").inc()
        self.registry.counter(
            f"{kind}_seconds_total", f"summed {kind} wall time"
        ).inc(duration_s)
        if self.tracer is not None:
            self.tracer.emit(
                {"kind": kind, "dur_ms": round(duration_s * 1e3, 3), **(extra or {})}
            )

    # -- export --------------------------------------------------------
    def _maybe_export(self) -> None:
        self._records_since_export += 1
        if self._records_since_export >= max(1, self.config.flush_interval):
            self._records_since_export = 0
            if self.prometheus is not None:
                self.prometheus.export()

    def export_monitor(self, step: int) -> int:
        """Fan the registry's scalar samples to the Monitor backends; returns
        the event count (0 when no monitor attached)."""
        if self.monitor_bridge is None:
            return 0
        return self.monitor_bridge.export(step)

    def flush(self) -> None:
        if self.tracer is not None:
            self.tracer.flush()
        if self.request_tracer is not None:
            self.request_tracer.flush()
        if self.kv_heat_tracer is not None:
            self.kv_heat_tracer.flush()
        if self.metrics_journal is not None:
            self.metrics_journal.flush()
        if self.prometheus is not None:
            self.prometheus.export()

    def close(self) -> None:
        self.flush()
        if self.tracer is not None:
            self.tracer.close()
        if self.request_tracer is not None:
            self.request_tracer.close()
        if self.kv_heat_tracer is not None:
            self.kv_heat_tracer.close()
        if self.metrics_journal is not None:
            self.metrics_journal.close()


def _is_num(v) -> bool:
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False


def _as_float(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


def from_config(config, monitor=None, process_index: Optional[int] = None) -> Optional[Telemetry]:
    """``TelemetryConfig`` → :class:`Telemetry`, or None when disabled (the
    zero-overhead contract: nothing is constructed, no listener installed,
    no file touched)."""
    if config is None or not getattr(config, "enabled", False):
        return None
    tel = Telemetry(config, process_index=process_index)
    if monitor is not None and getattr(monitor, "enabled", False):
        tel.attach_monitor(monitor)
    return tel
