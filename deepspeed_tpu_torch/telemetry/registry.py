"""Process-local metrics registry: counters / gauges / histograms with labels
(counterpart of ``deepspeed_tpu/telemetry/registry.py``, the same families,
text format and quantile interpolation).

The single metrics plane every subsystem reports through.
The reference DeepSpeed scatters its numbers across ``SynchronizedWallClockTimer``
log lines, the flops profiler's stdout table, ``comms_logging`` summaries and
the Monitor fan-out; here they all land in ONE registry that renders to
Prometheus text format (``to_prometheus`` / ``write_textfile`` for the
node-exporter textfile collector) and fans out to the Monitor backends via
:class:`~deepspeed_tpu_torch.telemetry.exporters.MonitorBridge`.

Thread-safety: a single coarse lock guards every mutation — the compile
counters (compile_stats) and background writer threads may report from off
the main thread.
"""

from __future__ import annotations

import math
import os
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

# default histogram buckets (seconds): spans sub-ms host ops to multi-minute
# compiles
DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    30.0, 60.0, 120.0, 300.0,
)

_INF = float("inf")


def quantile_from_buckets(buckets, counts, n, q):
    """The Prometheus ``histogram_quantile`` estimator over CUMULATIVE
    bucket ``counts`` (``counts[i]`` = observations <= ``buckets[i]``):
    linear interpolation inside the landing bucket; the +Inf bucket
    clamps to its lower edge. The ONE shared implementation —
    ``Histogram.quantile`` and ``telemetry.request_trace`` both call it,
    which is what keeps trace-derived quantiles equal to ``stats()``."""
    if n == 0:
        return None
    rank = q * n
    prev_bound, prev_cum = 0.0, 0
    for bound, cum in zip(buckets, counts):
        if cum >= rank:
            if bound == _INF:
                return prev_bound
            if cum == prev_cum:
                return bound
            frac = (rank - prev_cum) / (cum - prev_cum)
            return prev_bound + (bound - prev_bound) * frac
        prev_bound, prev_cum = (0.0 if bound == _INF else bound), cum
    return prev_bound


def _escape_label(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _label_str(labelnames: Sequence[str], labelvalues: Sequence[str]) -> str:
    if not labelnames:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(v)}"' for k, v in zip(labelnames, labelvalues)
    )
    return "{" + inner + "}"


class _Metric:
    """One metric family: a name plus per-label-value children."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str], lock: threading.Lock):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock
        self._children: Dict[Tuple[str, ...], float] = {}

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared {sorted(self.labelnames)}"
            )
        return tuple(str(labels[k]) for k in self.labelnames)

    def samples(self) -> Iterator[Tuple[str, str, float]]:
        """(name, label_str, value) triples for the text exposition.
        Snapshots under the lock: off-thread inc() during an export must not
        mutate the dict mid-iteration."""
        with self._lock:
            items = sorted(self._children.items())
        for key, value in items:
            yield self.name, _label_str(self.labelnames, key), value

    def value(self, **labels) -> float:
        return self._children.get(self._key(labels), 0.0)


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up (got {amount})")
        key = self._key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + amount


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._children[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + amount


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, labelnames, lock, buckets: Optional[Sequence[float]] = None):
        super().__init__(name, help, labelnames, lock)
        bs = tuple(sorted(buckets if buckets is not None else DEFAULT_BUCKETS))
        if not bs or bs[-1] != _INF:
            bs = bs + (_INF,)
        self.buckets = bs
        # per-label-key: (bucket counts, sum, count)
        self._hist: Dict[Tuple[str, ...], Tuple[List[int], float, int]] = {}

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            counts, total, n = self._hist.get(
                key, ([0] * len(self.buckets), 0.0, 0)
            )
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            self._hist[key] = (counts, total + float(value), n + 1)

    def samples(self):
        with self._lock:  # deep-copy: observe() mutates counts in place
            snapshot = [
                (k, (list(c), t, n)) for k, (c, t, n) in sorted(self._hist.items())
            ]
        for key, (counts, total, n) in snapshot:
            for b, c in zip(self.buckets, counts):
                le = "+Inf" if b == _INF else repr(b)
                yield (
                    self.name + "_bucket",
                    _label_str(self.labelnames + ("le",), key + (le,)),
                    float(c),
                )
            yield self.name + "_sum", _label_str(self.labelnames, key), total
            yield self.name + "_count", _label_str(self.labelnames, key), float(n)

    def stats(self, **labels) -> Tuple[float, int]:
        """(sum, count) for one label set."""
        with self._lock:
            _, total, n = self._hist.get(self._key(labels), ([], 0.0, 0))
        return total, n

    def quantile(self, q: float, **labels) -> Optional[float]:
        """Estimate the q-quantile (0 < q < 1) from the bucket counts by
        linear interpolation inside the landing bucket — the standard
        Prometheus ``histogram_quantile`` estimator, so dashboards and
        these in-process summaries agree. Returns None with no
        observations; the +Inf bucket clamps to its lower edge (the
        estimator cannot extrapolate past the last finite bound)."""
        if not 0.0 < q < 1.0:
            raise ValueError(f"{self.name}: quantile q must be in (0, 1), got {q}")
        with self._lock:
            counts, _, n = self._hist.get(
                self._key(labels), ([0] * len(self.buckets), 0.0, 0)
            )
            counts = list(counts)  # buckets are cumulative (observe() adds
        return quantile_from_buckets(self.buckets, counts, n, q)

    def value(self, **labels) -> float:
        raise TypeError(
            f"{self.name}: histograms have no single value — use stats() "
            "for (sum, count) or samples() for buckets"
        )


class MetricsRegistry:
    """Named metric families; idempotent declaration (same name + kind returns
    the existing family, a kind clash raises)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    # -- declaration ---------------------------------------------------
    def _declare(self, cls, name: str, help: str, labelnames: Sequence[str], **kw) -> _Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or existing.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already declared as {existing.kind} "
                        f"with labels {existing.labelnames}"
                    )
                return existing
            m = cls(name, help, labelnames, self._lock, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Counter:
        return self._declare(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Gauge:
        return self._declare(Gauge, name, help, labelnames)

    def histogram(
        self, name: str, help: str = "", labelnames: Sequence[str] = (),
        buckets: Optional[Sequence[float]] = None,
    ) -> Histogram:
        return self._declare(Histogram, name, help, labelnames, buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    # -- export --------------------------------------------------------
    def _families(self) -> List[_Metric]:
        with self._lock:  # _declare can insert concurrently
            return sorted(self._metrics.values(), key=lambda m: m.name)

    def scalar_samples(self) -> List[Tuple[str, float]]:
        """Flat ("name{labels}", value) pairs for counters and gauges —
        what the MonitorBridge fans out to TensorBoard/W&B/CSV (histograms
        export their _sum/_count)."""
        out = []
        for m in self._families():
            if isinstance(m, Histogram):
                with self._lock:
                    hist = sorted((k, (t, n)) for k, (_, t, n) in m._hist.items())
                for key, (total, n) in hist:
                    ls = _label_str(m.labelnames, key)
                    out.append((m.name + "_sum" + ls, total))
                    out.append((m.name + "_count" + ls, float(n)))
            else:
                for name, ls, v in m.samples():
                    out.append((name + ls, v))
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format v0.0.4."""
        lines = []
        for m in self._families():
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for name, ls, v in m.samples():
                # NaN/±Inf are legal exposition values (Go ParseFloat forms,
                # which repr() matches) — a diverged loss must not crash the
                # exporter observing it
                if math.isfinite(v) and v == int(v) and abs(v) < 2**53:
                    lines.append(f"{name}{ls} {int(v)}")
                else:
                    lines.append(f"{name}{ls} {v}")
        return "\n".join(lines) + ("\n" if lines else "")

    def write_textfile(self, path: str) -> str:
        """Atomic snapshot for the node-exporter textfile collector: write to
        a temp file in the target directory, then rename (a scraper never
        sees a torn file)."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = path + f".tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            fh.write(self.to_prometheus())
        os.replace(tmp, path)
        return path
