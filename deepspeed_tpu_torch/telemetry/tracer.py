"""Structured step traces: one JSONL record per train/inference step
(counterpart of ``deepspeed_tpu/telemetry/tracer.py``, the same records and
files).

Each record is a self-contained JSON object (span tree + scalars + HBM +
per-axis comm bytes) appended to a per-process file under ``trace_path``.
Buffered writes (``flush_interval`` records per fsync-able append) keep the
hot loop free of per-step filesystem syscalls; ``sample_every`` thins the
record stream for long runs.

Rank-0 aggregation: :func:`aggregate_scalars` returns a record's scalar
fields as they are on one process (this package runs on one card), which
the tracer appends to ``trace-aggregate.jsonl``.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

Span = Tuple[str, float]  # (name, duration_ms); flat span list, parents first


def _jsonable(v: Any) -> Any:
    """Scalars only: numpy types and 0-d arrays → python floats/ints."""
    try:
        import numpy as np

        if isinstance(v, (np.generic,)):
            return v.item()
        if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
            return v.item()
    except Exception:
        pass
    return v


def spans_to_tree(spans: List[Span], total_ms: float) -> Dict[str, Any]:
    """Flat (name, ms) list → {name: ms} child map under a root span, with the
    unattributed remainder reported as ``other`` (the span tree is one level
    deep: a captured step leaves no host-visible fwd/bwd boundary, so the
    host-side phases — prepare/dispatch/sync — are the children)."""
    children = {name: round(ms, 3) for name, ms in spans}
    accounted = sum(ms for _, ms in spans)
    if total_ms > accounted:
        children["other"] = round(total_ms - accounted, 3)
    return {"total_ms": round(total_ms, 3), "children": children}


def aggregate_scalars(scalars: Dict[str, float]) -> Optional[Dict[str, float]]:
    """A record's scalar fields for the rank-0 aggregate: on one process
    (the only layout this package runs) the input unchanged."""
    return dict(scalars)


def _process_index() -> int:
    """This process's rank in ``torch.distributed`` when it is initialised,
    else 0."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except ImportError:
        pass
    return 0


class StepTracer:
    """Append-only JSONL step-trace writer (per-host file)."""

    def __init__(
        self,
        trace_path: str,
        flush_interval: int = 20,
        sample_every: int = 1,
        process_index: Optional[int] = None,
        max_bytes: int = 0,
    ):
        self.trace_path = trace_path
        self.flush_interval = max(1, int(flush_interval))
        self.sample_every = max(1, int(sample_every))
        # size-capped rotation (telemetry.trace_max_mb): at the cap the live
        # file atomically rolls to <file>.1 and a fresh file starts — a
        # long run's disk use stays bounded at ~2x the cap. 0 = unbounded.
        self.max_bytes = max(0, int(max_bytes))
        self._bytes_written: Optional[int] = None  # lazily from getsize
        self.rotations = 0
        self._buffer: List[str] = []
        self._force_next = False
        self._closed = False
        # emit() is called from the step path, the watchdog trip path and
        # the request/heat tracers' encoder threads — buffer appends, the
        # size-capped rotation and close() must serialize or a roll can
        # tear/drop records mid-append
        self._lock = self._new_lock()
        if process_index is None:
            process_index = _process_index()
        self.process_index = process_index
        if trace_path.endswith(".jsonl"):
            root, name = os.path.split(trace_path)
            self._dir = root or "."
            # explicit file: keep the name on host 0, suffix other hosts
            self._file = (
                os.path.join(self._dir, name)
                if process_index == 0
                else os.path.join(self._dir, f"{name[:-6]}-{process_index:05d}.jsonl")
            )
        else:
            self._dir = trace_path
            self._file = os.path.join(trace_path, f"trace-{process_index:05d}.jsonl")
        self._agg_file = os.path.join(self._dir, "trace-aggregate.jsonl")
        self._dir_made = False  # lazily: a tracer that never emits writes nothing
        atexit.register(self.close)

    @staticmethod
    def _new_lock():
        return threading.Lock()

    # -- sampling ------------------------------------------------------
    def should_sample(self, step: int) -> bool:
        if self._force_next:
            return True
        return step % self.sample_every == 0

    def force_next(self) -> None:
        """Make the next step emit a record regardless of ``sample_every``
        (a timed loop that records one step)."""
        self._force_next = True

    # -- emission ------------------------------------------------------
    def emit(self, record: Dict[str, Any]) -> None:
        if str(record.get("kind", "")).endswith("_step"):
            # only a step record consumes a pending force_next — an
            # interleaved event (checkpoint save, …) must not cancel it
            self._force_next = False
        record.setdefault("ts", time.time())
        record.setdefault("host", self.process_index)
        clean = {k: _jsonable(v) for k, v in record.items()}
        line = json.dumps(clean, default=str)
        with self._lock:
            self._buffer.append(line)
            if len(self._buffer) >= self.flush_interval:
                self._flush_locked()

    def emit_serialized(self, line: str) -> None:
        """Append one ALREADY-SERIALIZED JSONL line, skipping the
        ``_jsonable`` sanitize + re-encode of :meth:`emit`. For callers
        that construct records JSON-native end to end (RequestTracer's
        terminal records): the defensive per-record sanitize
        pass was the request-tracing plane's single biggest hot-path cost.
        Same buffering, flush cadence and size-capped rotation as emit."""
        with self._lock:
            self._buffer.append(line)
            if len(self._buffer) >= self.flush_interval:
                self._flush_locked()

    def emit_aggregate(self, record: Dict[str, Any]) -> None:
        """Rank-0-only aggregated record (caller runs aggregate_scalars)."""
        clean = {k: _jsonable(v) for k, v in record.items()}
        with self._lock:
            self._ensure_dir()
            # the append IS the serialized section: aggregate records are
            # rare (rank-0, once per sampled step) and the file must not
            # interleave with a concurrent rotation of the live trace
            with open(self._agg_file, "a") as fh:
                fh.write(json.dumps(clean, default=str) + "\n")

    def _ensure_dir(self) -> None:
        if not self._dir_made:
            os.makedirs(self._dir, exist_ok=True)
            self._dir_made = True

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        """Buffer → file append (+ size-capped roll); caller holds _lock."""
        if not self._buffer:
            return
        data = "\n".join(self._buffer) + "\n"
        self._ensure_dir()
        if self.max_bytes:
            if self._bytes_written is None:  # resumed run: adopt on-disk size
                try:
                    self._bytes_written = os.path.getsize(self._file)
                except OSError:
                    self._bytes_written = 0
            if self._bytes_written and self._bytes_written + len(data) > self.max_bytes:
                # atomic roll: the live file becomes the (single) rolled
                # generation; a concurrent reader sees either whole file,
                # never a torn one
                os.replace(self._file, self._file + ".1")
                self._bytes_written = 0
                self.rotations += 1
        with open(self._file, "a") as fh:
            fh.write(data)
        if self._bytes_written is not None:
            self._bytes_written += len(data)
        self._buffer = []

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._flush_locked()
            self._closed = True
        atexit.unregister(self.close)  # don't pin closed tracers for life

    @property
    def file_path(self) -> str:
        return self._file
