"""Metrics time-series journal: the serving engine's history (counterpart
of ``deepspeed_tpu/telemetry/timeseries.py``; the same ``dstpu-tsdb-v1``
records).

Every registry signal — gauges, SLO counters, heat occupancy — is
*instantaneous*: the registry holds the current value and nothing else.
This module gives the control plane a time axis: a
:class:`MetricsJournal` snapshots the whole
:class:`~deepspeed_tpu_torch.telemetry.registry.MetricsRegistry` (counters,
gauges, full histogram bucket vectors) on a configurable cadence off the
engine's **injectable clock** into a schema-versioned (``dstpu-tsdb-v1``)
delta-encoded JSONL ring, reusing the StepTracer machinery — buffered
appends, size-capped atomic ``<file>.1`` rotation, locking.

Design rules, in the kv-heat discipline:

- **no wall-clock fields**: every timestamp is the engine clock's value,
  so a seeded virtual-clock replay produces a byte-identical journal
  (acceptance-pinned);
- **delta-encoded, absolute values**: a snapshot records only series
  whose value changed since the previous snapshot, but records the
  ABSOLUTE value (never a diff) — a lost or rotated-away record degrades
  resolution, never correctness, and ``rate()`` stays counter-reset
  tolerant by construction;
- **self-contained generations**: after a size-capped rotation the next
  snapshot re-emits the meta records and a full baseline, so each file
  generation can be read alone;
- **one quantile estimator**: ``quantile_over_time()`` feeds windowed
  bucket-count differences through the same
  :func:`~deepspeed_tpu_torch.telemetry.registry.quantile_from_buckets` that
  ``Histogram.quantile`` uses — a full-range journal quantile reproduces
  the live ``stats()`` quantile *exactly* (acceptance-pinned).

Record kinds::

    {"kind": "tsdb_meta", "schema": "dstpu-tsdb-v1", "interval_s": ...}
    {"kind": "tsdb_hist_meta", "name": <family>, "buckets": [finite...]}
    {"kind": "tsdb", "t": <clock>, "seq": N,
     "set": {"<name>{labels}": value, ...},                 # scalars
     "h": {"<name>{labels}": {"c": [...], "s": S, "n": N}}} # histograms
    {"kind": "slo_alert", ...}   # events appended via emit_event()

Consumers: ``ServingEngine`` (step-cadence ``maybe_snapshot`` hook +
journal-backed windowed goodput), ``telemetry/slo_budget.py`` (error
budget / burn-rate alerting over the in-memory mirror), the fleet router
(``serving/fleet.py``: its per-replica gauges, one snapshot a fleet step)
and ``tools/fleet_dash.py`` (offline :func:`load_journal` + the query
API).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

from .registry import Histogram, MetricsRegistry, _label_str, quantile_from_buckets
from .tracer import StepTracer

SCHEMA = "dstpu-tsdb-v1"

_INF = float("inf")


class TimeseriesError(ValueError):
    """Unreadable / wrong-schema journal (CLI consumers exit 2 on it)."""


def _bisect_le(samples: List[tuple], t: float) -> int:
    """Index of the LAST sample with ``sample[0] <= t``, or -1. Binary
    search over the (time, ...) tuples — windows over hours of samples
    must not pay a linear scan per query."""
    lo, hi = 0, len(samples)
    while lo < hi:
        mid = (lo + hi) // 2
        if samples[mid][0] <= t:
            lo = mid + 1
        else:
            hi = mid
    return lo - 1


class SeriesStore:
    """In-memory mirror of a journal: per-series absolute-value sample
    lists plus the query API. The live :class:`MetricsJournal` maintains
    one (retention-trimmed) for burn-rate / windowed-goodput queries;
    :func:`load_journal` builds one offline from the JSONL files."""

    def __init__(self):
        # sid ("name{labels}") -> [(t, value), ...] ascending by t
        self.scalars: Dict[str, List[Tuple[float, float]]] = {}
        # sid -> [(t, cumulative bucket counts, sum, count), ...]
        self.hists: Dict[str, List[tuple]] = {}
        # histogram family name -> bucket bounds (incl. trailing +Inf)
        self.hist_buckets: Dict[str, tuple] = {}
        self.meta: Dict[str, Any] = {}
        self.events: List[dict] = []  # non-snapshot records (slo_alert, ...)
        self.records = 0              # tsdb snapshot records ingested

    # -- ingest --------------------------------------------------------
    def add_scalar(self, t: float, sid: str, value: float) -> None:
        samples = self.scalars.setdefault(sid, [])
        if samples and samples[-1][0] == t:  # rotation re-baseline at one t
            samples[-1] = (t, float(value))
        else:
            samples.append((t, float(value)))

    def add_hist(self, t: float, sid: str, counts: List[int], total: float,
                 n: int) -> None:
        samples = self.hists.setdefault(sid, [])
        if samples and samples[-1][0] == t:
            samples[-1] = (t, tuple(counts), total, n)
        else:
            samples.append((t, tuple(counts), total, n))

    def trim(self, cutoff: float) -> None:
        """Drop samples before ``cutoff``, always keeping the last one at
        or before it — the baseline ``increase()`` subtracts from."""
        for table in (self.scalars, self.hists):
            for sid, samples in table.items():
                idx = _bisect_le(samples, cutoff)
                if idx > 0:
                    table[sid] = samples[idx:]

    # -- discovery -----------------------------------------------------
    def sids(self, name: str) -> List[str]:
        """Every stored series id of one metric family (exact name, any
        label set)."""
        out = [
            sid for sid in self.scalars
            if sid == name or sid.startswith(name + "{")
        ]
        out += [
            sid for sid in self.hists
            if sid == name or sid.startswith(name + "{")
        ]
        return sorted(out)

    def span(self) -> Tuple[Optional[float], Optional[float]]:
        """(first, last) sample time across every series, or (None, None)."""
        t0: Optional[float] = None
        t1: Optional[float] = None
        for table in (self.scalars, self.hists):
            for samples in table.values():
                if samples:
                    t0 = samples[0][0] if t0 is None else min(t0, samples[0][0])
                    t1 = samples[-1][0] if t1 is None else max(t1, samples[-1][0])
        return t0, t1

    # -- queries -------------------------------------------------------
    def range(self, sid: str, t0: Optional[float] = None,
              t1: Optional[float] = None) -> List[Tuple[float, float]]:
        """Scalar samples with ``t0 <= t <= t1`` (either bound optional)."""
        samples = self.scalars.get(sid, [])
        lo = 0 if t0 is None else _bisect_le(samples, t0 - 1e-12) + 1
        hi = len(samples) if t1 is None else _bisect_le(samples, t1) + 1
        return list(samples[lo:hi])

    def latest(self, sid: str, t: Optional[float] = None) -> Optional[float]:
        """Last scalar value at or before ``t`` (default: newest)."""
        samples = self.scalars.get(sid)
        if not samples:
            return None
        if t is None:
            return samples[-1][1]
        idx = _bisect_le(samples, t)
        return samples[idx][1] if idx >= 0 else None

    def increase(self, sid: str, t0: float, t1: float) -> float:
        """Counter increase over ``(t0, t1]``, tolerant of counter resets:
        sum the positive sample-to-sample deltas; a NEGATIVE delta means
        the counter restarted from zero, so the new absolute value *is*
        the increase since the reset. Baseline is the last sample at or
        before ``t0`` (a counter unseen before ``t0`` baselines at 0 —
        counters start at 0). Unknown series → 0.0."""
        samples = self.scalars.get(sid)
        if not samples:
            return 0.0
        idx0 = _bisect_le(samples, t0)
        prev = samples[idx0][1] if idx0 >= 0 else 0.0
        total = 0.0
        for i in range(idx0 + 1, len(samples)):
            t, v = samples[i]
            if t > t1:
                break
            delta = v - prev
            total += delta if delta >= 0.0 else v
            prev = v
        return total

    def rate(self, sid: str, t0: float, t1: float) -> float:
        """Per-second increase over the window (0.0 on an empty window)."""
        dur = t1 - t0
        if dur <= 0.0:
            return 0.0
        return self.increase(sid, t0, t1) / dur

    def hist_window(self, sid: str, t0: Optional[float],
                    t1: Optional[float]) -> Optional[tuple]:
        """(bucket-count diff, sum diff, count diff) between the histogram
        states at ``t1`` and ``t0``, or None without data."""
        samples = self.hists.get(sid)
        if not samples:
            return None
        idx1 = len(samples) - 1 if t1 is None else _bisect_le(samples, t1)
        if idx1 < 0:
            return None
        _, c1, s1, n1 = samples[idx1]
        c0: Optional[tuple] = None
        s0, n0 = 0.0, 0
        if t0 is not None:
            idx0 = _bisect_le(samples, t0)
            if idx0 >= 0:
                _, c0, s0, n0 = samples[idx0]
        if c0 is None:
            return list(c1), s1, n1
        if len(c0) != len(c1):
            raise TimeseriesError(
                f"{sid}: bucket layout changed mid-journal "
                f"({len(c0)} -> {len(c1)} buckets)"
            )
        return [a - b for a, b in zip(c1, c0)], s1 - s0, n1 - n0

    def quantile_over_time(self, sid: str, q: float,
                           t0: Optional[float] = None,
                           t1: Optional[float] = None) -> Optional[float]:
        """The q-quantile of one histogram series over a window, via the
        SAME estimator ``Histogram.quantile`` uses over the windowed
        cumulative-count difference — a full-range query reproduces the
        live ``stats()`` quantile exactly."""
        win = self.hist_window(sid, t0, t1)
        if win is None:
            return None
        counts, _, n = win
        if n <= 0:
            return None
        family = sid.split("{", 1)[0]
        buckets = self.hist_buckets.get(family)
        if buckets is None or len(buckets) != len(counts):
            return None
        return quantile_from_buckets(buckets, counts, n, q)


class MetricsJournal:
    """Cadenced registry → JSONL snapshot writer plus the live query
    mirror. Single-writer by design: ``maybe_snapshot`` runs on the
    engine's step path (the StepTracer underneath serializes the actual
    file appends). Construct standalone or let
    :class:`~deepspeed_tpu_torch.telemetry.Telemetry` build one from the
    ``telemetry.timeseries`` config section."""

    def __init__(
        self,
        path: str,
        registry: Optional[MetricsRegistry] = None,
        clock=time.monotonic,
        interval_s: float = 1.0,
        flush_interval: int = 20,
        max_bytes: int = 0,
        retention_s: float = 3600.0,
        process_index: Optional[int] = None,
    ):
        self._tracer = StepTracer(
            path, flush_interval=flush_interval, sample_every=1,
            process_index=process_index, max_bytes=max_bytes,
        )
        self.registry = registry
        self.clock = clock
        self.interval_s = float(interval_s)
        self.retention_s = float(retention_s)
        self.store = SeriesStore()
        self.last_t: Optional[float] = None  # time of the last snapshot()
        self.snapshots = 0       # snapshot() calls (incl. no-change ones)
        self.records_emitted = 0  # tsdb records actually written
        self.encode_error: Optional[str] = None
        self._seq = 0
        self._last_scalar: Dict[str, float] = {}
        self._last_hist: Dict[str, tuple] = {}
        self._meta_emitted = False
        self._hist_meta_done: set = set()
        self._rot_seen = 0

    # -- wiring --------------------------------------------------------
    def bind(self, registry: Optional[MetricsRegistry] = None,
             clock=None) -> None:
        """Late-bind the registry and/or rebind the clock (the kv-heat
        ``pool()`` idiom: an engine attaching the journal installs its own
        injectable clock so replayed timestamps stay virtual)."""
        if registry is not None:
            self.registry = registry
        if clock is not None:
            self.clock = clock

    def ensure_retention(self, window_s: float) -> None:
        """Grow the in-memory retention to cover ``window_s`` — the SLO
        budget engine calls this with its widest alert window."""
        self.retention_s = max(self.retention_s, float(window_s))

    # -- snapshotting --------------------------------------------------
    def maybe_snapshot(self, now: Optional[float] = None) -> bool:
        """Snapshot iff ``interval_s`` has elapsed since the last one (the
        engine's per-step hook — one float compare when it is not time)."""
        if now is None:
            now = self.clock()
        if self.last_t is not None and now - self.last_t < self.interval_s:
            return False
        self.snapshot(now)
        return True

    def snapshot(self, now: Optional[float] = None) -> int:
        """Record every changed series at ``now``; returns the changed
        series count. Emits nothing when nothing changed (an idle engine
        journals zero bytes)."""
        if self.registry is None:
            return 0
        if now is None:
            now = self.clock()
        n = self._write_changed(now)
        if self._tracer.rotations != self._rot_seen:
            # this snapshot's own emit rolled the live file (rotation
            # happens inside the tracer's flush, after the size check):
            # re-baseline NOW so the fresh generation carries its meta and
            # full values even if the process stops before the next tick
            n = max(n, self._write_changed(now))
        self.last_t = now
        self.snapshots += 1
        if self.retention_s > 0.0:
            self.store.trim(now - self.retention_s)
        return n

    def _write_changed(self, now: float) -> int:
        tr = self._tracer
        if tr.rotations != self._rot_seen:
            # the live file just rolled to <file>.1: re-baseline so the
            # fresh generation is self-contained (meta + full values)
            self._rot_seen = tr.rotations
            self._meta_emitted = False
            self._hist_meta_done.clear()
            self._last_scalar.clear()
            self._last_hist.clear()
        if not self._meta_emitted:
            tr.emit_serialized(json.dumps(
                {"interval_s": self.interval_s, "kind": "tsdb_meta",
                 "schema": SCHEMA},
                sort_keys=True,
            ))
            self._meta_emitted = True
        set_d: Dict[str, float] = {}
        hist_d: Dict[str, dict] = {}
        for fam in self.registry._families():
            if isinstance(fam, Histogram):
                if fam.name not in self._hist_meta_done:
                    # +Inf is not valid JSON: persist the finite bounds,
                    # load_journal re-appends the +Inf bucket
                    tr.emit_serialized(json.dumps(
                        {"buckets": [b for b in fam.buckets if b != _INF],
                         "kind": "tsdb_hist_meta", "name": fam.name},
                        sort_keys=True,
                    ))
                    self._hist_meta_done.add(fam.name)
                    self.store.hist_buckets[fam.name] = tuple(fam.buckets)
                with fam._lock:  # deep-copy: observe() mutates in place
                    items = [
                        (k, (list(c), t, n))
                        for k, (c, t, n) in sorted(fam._hist.items())
                    ]
                for key, (counts, total, n) in items:
                    sid = fam.name + _label_str(fam.labelnames, key)
                    cur = (tuple(counts), total, n)
                    if self._last_hist.get(sid) != cur:
                        self._last_hist[sid] = cur
                        hist_d[sid] = {"c": counts, "n": n, "s": total}
                        self.store.add_hist(now, sid, counts, total, n)
            else:
                for name, ls, v in fam.samples():
                    sid = name + ls
                    v = float(v)
                    if self._last_scalar.get(sid) != v:
                        self._last_scalar[sid] = v
                        set_d[sid] = v
                        self.store.add_scalar(now, sid, v)
        if set_d or hist_d:
            rec: Dict[str, Any] = {"kind": "tsdb", "seq": self._seq, "t": now}
            if set_d:
                rec["set"] = set_d
            if hist_d:
                rec["h"] = hist_d
            try:
                tr.emit_serialized(json.dumps(rec, sort_keys=True))
                self.records_emitted += 1
                self.store.records += 1
            except (TypeError, ValueError) as e:  # never crash the step path
                self.encode_error = f"{type(e).__name__}: {e}"
            self._seq += 1
        return len(set_d) + len(hist_d)

    def emit_event(self, record: Dict[str, Any]) -> None:
        """Append one non-snapshot event record (``slo_alert``, …) through
        the same buffered/rotating writer, byte-deterministically (sorted
        keys, caller supplies the clock-derived ``t``)."""
        self._tracer.emit_serialized(json.dumps(record, sort_keys=True))
        self.store.events.append(record)

    # -- query passthroughs (live, retention-bounded) -------------------
    def range(self, sid, t0=None, t1=None):
        return self.store.range(sid, t0, t1)

    def latest(self, sid, t=None):
        return self.store.latest(sid, t)

    def increase(self, sid, t0, t1):
        return self.store.increase(sid, t0, t1)

    def rate(self, sid, t0, t1):
        return self.store.rate(sid, t0, t1)

    def quantile_over_time(self, sid, q, t0=None, t1=None):
        return self.store.quantile_over_time(sid, q, t0, t1)

    def sids(self, name):
        return self.store.sids(name)

    # -- lifecycle ------------------------------------------------------
    def flush(self) -> None:
        self._tracer.flush()

    def close(self) -> None:
        # final snapshot: counters that moved since the last interval tick
        # (completion counts, end-of-run gauges) would otherwise never land
        self.snapshot()
        self._tracer.close()

    @property
    def file_path(self) -> str:
        return self._tracer.file_path

    @property
    def rotations(self) -> int:
        return self._tracer.rotations


def load_journal(path: str) -> SeriesStore:
    """Offline reader: ``<path>.1`` (the rolled generation) first, then the
    live file. Tolerates ONE torn line at a file's tail (a crash
    mid-append); any other undecodable line, a missing file, or a schema
    mismatch raises :class:`TimeseriesError` (CLI consumers exit 2)."""
    paths = [p for p in (path + ".1", path) if os.path.exists(p)]
    if not paths:
        raise TimeseriesError(f"no journal at {path}")
    store = SeriesStore()
    saw_meta = False
    for p in paths:
        with open(p) as fh:
            lines = fh.read().splitlines()
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                if i == len(lines) - 1:
                    continue  # torn tail: the crash-truncated final append
                raise TimeseriesError(f"{p}:{i + 1}: undecodable record")
            kind = rec.get("kind")
            if kind == "tsdb_meta":
                if rec.get("schema") != SCHEMA:
                    raise TimeseriesError(
                        f"{p}: schema {rec.get('schema')!r} != {SCHEMA!r}"
                    )
                saw_meta = True
                store.meta = rec
            elif kind == "tsdb_hist_meta":
                store.hist_buckets[rec["name"]] = (
                    tuple(float(b) for b in rec["buckets"]) + (_INF,)
                )
            elif kind == "tsdb":
                t = float(rec["t"])
                store.records += 1
                for sid, v in (rec.get("set") or {}).items():
                    store.add_scalar(t, sid, float(v))
                for sid, hv in (rec.get("h") or {}).items():
                    store.add_hist(
                        t, sid, [int(c) for c in hv["c"]],
                        float(hv["s"]), int(hv["n"]),
                    )
            else:
                store.events.append(rec)
    if not saw_meta:
        raise TimeseriesError(
            f"{path}: no tsdb_meta record (not a {SCHEMA} journal)"
        )
    return store
