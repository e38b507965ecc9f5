"""Async integrity-checked checkpoint writer (counterpart of
``deepspeed_tpu/resilience/writer.py``).

The step path pays only the device-to-host snapshot
(:func:`snapshot_to_host`: it must complete before the next training step,
a captured program that updates the same tensors in place, runs), and the
disk write (serialization, checksums, fsync, atomic rename) runs on a
background thread while training proceeds. The writer only ever touches
host bytes. The format and commit protocol live in :mod:`.manifest`; this
module owns the threading, the telemetry and the fault-injection crash
hook.

One writer per (engine, save_dir). ``save(..., blocking=True)`` bypasses the
worker and writes in the caller's thread: the PreemptionGuard's forced
fresh snapshot when an in-flight async write overruns the grace window, or
died.

The ``latest`` pointer moves in the order the jobs were saved, not the
order their writes end: a job commits its tag, then swaps ``latest`` only
if no later job (by ``save``'s ordinal) has swapped it already, under the
writer's lock. So an async write that lands after a later blocking save
(the guard's ``preempt-final``) leaves ``latest`` on the later tag. A
failed later write never swaps, and the walk-back still finds the older
good tag.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any, Dict, Optional

import torch

from ..utils.logging import log_dist, logger
from . import manifest as mf

# checkpoint write-duration histogram buckets (seconds)
WRITE_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                 10.0, 30.0, 60.0, 120.0)


def snapshot_to_host(leaves: Dict[str, torch.Tensor], extra: Optional[Dict[str, Any]] = None,
                     out: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, Any]:
    """``{path: tensor}`` (the engine's state leaves under the JAX
    ``TrainState`` path names) → ``{path: host copy}``, then ``extra``.
    Device leaves land in pinned host tensors (``out``'s, when it holds a
    buffer of the same shape and dtype for a name, else new ones) by
    asynchronous copies on the current stream, and one synchronisation
    waits for all of them: when this returns, a later step may update the
    device tensors in place."""
    host: Dict[str, Any] = {}
    cuda = None
    for name, t in leaves.items():
        t = t.detach()
        if t.device.type == "cpu":
            host[name] = t.clone()
            continue
        cuda = t.device
        buf = out.get(name) if out is not None else None
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        host[name] = buf
    if cuda is not None:
        torch.cuda.current_stream(cuda).synchronize()
    host.update(extra or {})
    return host


class AsyncCheckpointWriter:
    """Background checkpoint writer with the atomic, checksummed commit
    protocol. Construct once per save directory; ``save()`` enqueues,
    ``wait()`` drains (the preemption grace-window flush), ``close()``
    drains and stops the worker. A failed write never passes silently:
    ``last_error`` holds it (and ``errors`` the last 16), and a blocking
    save raises it."""

    def __init__(self, save_dir: str, fingerprint: str = "", registry=None, injector=None,
                 telemetry=None):
        self.save_dir = save_dir
        self.fingerprint = fingerprint
        self.injector = injector
        self.telemetry = telemetry
        self._q: "queue.Queue" = queue.Queue()
        self._idle = threading.Event()
        self._idle.set()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.saves_started = 0  # the checkpoint_crash injection index
        self._latest_ordinal = 0  # the newest job that swapped ``latest``
        self.saves_committed = 0
        self.errors: list = []  # (tag, exception), newest last
        if registry is not None:
            self._h_write = registry.histogram(
                "checkpoint_write_seconds",
                "background checkpoint write duration (snapshot excluded)",
                buckets=WRITE_BUCKETS,
            )
            self._c_writes = registry.counter(
                "checkpoint_writes_total", "committed checkpoint writes")
            self._c_failures = registry.counter(
                "checkpoint_write_failures_total",
                "checkpoint writes that died before commit (incl. injected)",
            )
            self._g_inflight = registry.gauge(
                "checkpoint_writes_in_flight", "queued + running async writes")
        else:
            self._h_write = self._c_writes = self._c_failures = None
            self._g_inflight = None

    def save(self, tag: str, arrays: Dict[str, Any],
             client_state: Optional[Dict[str, Any]] = None, step: int = 0,
             save_latest: bool = True, blocking: bool = False) -> str:
        """Commit ``arrays`` (host arrays) under ``tag``. Non-blocking by
        default: the job is queued for the worker and the expected final
        path returns at once (``wait()`` / ``last_error`` report the
        outcome). ``blocking=True`` writes in this thread; failures
        raise."""
        with self._lock:
            self.saves_started += 1
            ordinal = self.saves_started
        job = (tag, arrays, dict(client_state or {}), int(step), save_latest, ordinal)
        if blocking:
            return self._write(*job)
        self._ensure_worker()
        self._idle.clear()
        self._q.put(job)
        if self._g_inflight is not None:
            self._g_inflight.set(self.in_flight)
        return os.path.join(os.path.abspath(self.save_dir), str(tag))

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until every queued write committed (or failed). True when
        drained inside the timeout: the grace-window contract (False means
        an in-flight save may be torn and the caller should force a fresh
        blocking snapshot before exiting)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._q.empty() and self._idle.is_set():
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return self._q.empty() and self._idle.is_set()
            time.sleep(0.005)

    @property
    def in_flight(self) -> int:
        return self._q.qsize() + (0 if self._idle.is_set() else 1)

    @property
    def last_error(self) -> Optional[BaseException]:
        with self._lock:
            return self.errors[-1][1] if self.errors else None

    def close(self, timeout: Optional[float] = None) -> bool:
        ok = self.wait(timeout)
        t = self._thread
        if t is not None:
            self._q.put(None)
            t.join(timeout=5.0)
            self._thread = None
        return ok

    def _ensure_worker(self) -> None:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._run, name="ckpt-writer",
                                                daemon=True)
                self._thread.start()

    def _run(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                self._idle.set()
                return
            self._idle.clear()
            try:
                self._write(*job)
            except Exception as e:  # recorded in errors; must not kill the run
                logger.warning(f"async checkpoint write of tag {job[0]!r} failed: "
                               f"{type(e).__name__}: {e}")
            finally:
                if self._q.empty():
                    self._idle.set()
                if self._g_inflight is not None:
                    self._g_inflight.set(self.in_flight)

    def _swap_latest(self, tag, ordinal: int) -> None:
        """Point ``latest`` at ``tag`` unless a later job already did (the
        swap is monotone in the jobs' order)."""
        with self._lock:
            if ordinal <= self._latest_ordinal:
                return
            mf.atomic_write_text(os.path.join(os.path.abspath(self.save_dir), mf.LATEST_FILE),
                                 str(tag))
            self._latest_ordinal = ordinal

    def _write(self, tag, arrays, client_state, step, save_latest, ordinal) -> str:
        crash = bool(self.injector is not None
                     and self.injector.fire("checkpoint_crash", ordinal))
        t0 = time.perf_counter()
        try:
            path = mf.write_tag(self.save_dir, tag, arrays, client_state=client_state,
                                fingerprint=self.fingerprint, step=step,
                                save_latest=False, crash_before_manifest=crash)
            if save_latest:
                self._swap_latest(tag, ordinal)
        except BaseException as e:
            # _write runs on the worker AND (blocking) on the caller's
            # thread: the error ledger mutates under the lock
            with self._lock:
                self.errors.append((tag, e))
                del self.errors[:-16]
            if self._c_failures is not None:
                self._c_failures.inc()
            raise
        dt = time.perf_counter() - t0
        with self._lock:
            self.saves_committed += 1
        if self._h_write is not None:
            self._h_write.observe(dt)
            self._c_writes.inc()
        if self.telemetry is not None:
            self.telemetry.record_event("checkpoint_write", dt,
                                        {"step": step, "tag": str(tag), "path": path})
        log_dist(f"checkpoint committed: {path} ({dt * 1e3:.1f} ms)")
        return path
