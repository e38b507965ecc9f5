"""Registry exporters: Prometheus textfile snapshots + Monitor fan-out.

Two sinks for one :class:`~deepspeed_tpu_torch.telemetry.registry.MetricsRegistry`:

- :class:`PrometheusTextfileExporter` renders the registry to the text
  exposition format and atomically replaces a ``.prom`` file that a
  node-exporter textfile collector (or any file-scraping agent) picks up.
- :class:`MonitorBridge` converts every scalar sample into the Monitor
  ``(tag, value, step)`` event tuples and hands them to any object with a
  ``write_events(events)`` method (the reference MonitorMaster contract,
  monitor/monitor.py; the port's TensorBoard / W&B / CSV backends are not
  written yet, so the caller brings the sink).

Counterpart of ``deepspeed_tpu/telemetry/exporters.py``.
"""

from __future__ import annotations

from typing import List, Tuple

from .registry import MetricsRegistry


class PrometheusTextfileExporter:
    def __init__(self, registry: MetricsRegistry, path: str):
        self.registry = registry
        self.path = path

    def export(self) -> str:
        return self.registry.write_textfile(self.path)


def _tag(sample_name: str) -> str:
    """``comm_bytes_per_step{axis="dp",op="all_reduce"}`` →
    ``comm_bytes_per_step/axis=dp,op=all_reduce`` — TensorBoard rejects
    braces/quotes in tags; '/' groups families into one dashboard section."""
    if "{" not in sample_name:
        return sample_name
    base, labels = sample_name.split("{", 1)
    labels = labels.rstrip("}").replace('"', "")
    return f"{base}/{labels}"


class MonitorBridge:
    def __init__(self, registry: MetricsRegistry, monitor, prefix: str = "Telemetry/"):
        self.registry = registry
        self.monitor = monitor
        self.prefix = prefix

    def events(self, step: int) -> List[Tuple[str, float, int]]:
        return [
            (self.prefix + _tag(name), value, step)
            for name, value in self.registry.scalar_samples()
        ]

    def export(self, step: int) -> int:
        events = self.events(step)
        if events:
            self.monitor.write_events(events)
        return len(events)
