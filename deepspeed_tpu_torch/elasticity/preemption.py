"""Preemption-aware checkpointing (counterpart of
``deepspeed_tpu/elasticity/preemption.py``).

A maintenance event or a spot reclaim arrives in-process as SIGTERM with a
grace window. :class:`PreemptionGuard` turns that into a clean
checkpoint-then-exit at the next step boundary: the captured step itself is
never interrupted mid-launch.

Usage::

    with PreemptionGuard(engine, save_dir) as guard:   # installs handlers
        for batch in loader:
            engine.train_batch(batch)
            if guard.should_stop():                    # signal seen?
                guard.checkpoint_and_log()             # save + grace flush
                break
    # handlers restored on exit: no leak across tests / callers

or the engine-integrated form: callers poll ``engine.preempted`` when a
guard is attached.

Resilience semantics:

- ``checkpoint_and_log`` flushes any in-flight *async* checkpoint write
  inside ``grace_window_s`` (``resilience.grace_window_s`` when the engine
  carries a resilience config); an overrun, or a write that died, forces a
  fresh BLOCKING snapshot under ``<tag>-final`` so the process never exits
  with only a torn write on disk.
- a SECOND termination signal while the final save is running escalates to
  immediate exit (flushed log line, exit code 128+signum) instead of
  re-entering the save: the platform is done waiting, and re-entering
  would corrupt the write it interrupts.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Optional

from ..utils.logging import log_dist

# SIGTERM is what a maintenance event or a reclaim delivers. SIGINT is NOT a default:
# its prior handler raises KeyboardInterrupt, which would unwind the loop
# before the step-boundary checkpoint this class exists for.
_DEFAULT_SIGNALS = ("SIGTERM",)


class PreemptionGuard:
    """Installs signal handlers that request a graceful stop.

    Handlers chain to any previously installed handler (the launcher's
    tree-kill propagation still works). Thread-safe: the flag is a simple
    event set from the signal context. Usable as a context manager —
    ``__exit__`` uninstalls, so handler chains don't leak across tests.
    """

    def __init__(
        self,
        engine=None,
        save_dir: Optional[str] = None,
        signals=_DEFAULT_SIGNALS,
        install: bool = True,
        grace_window_s: Optional[float] = None,
    ):
        self.engine = engine
        self.save_dir = save_dir
        self._stop = threading.Event()
        self._prev = {}
        self._signals = []
        self._in_final_save = False
        # injectable for tests: escalation must really exit in production
        # (os._exit — a raise from a signal frame could be swallowed), but a
        # test asserting the escalation can't survive that
        self._exit = os._exit
        if grace_window_s is None:
            rcfg = getattr(getattr(engine, "config", None), "resilience", None)
            grace_window_s = float(getattr(rcfg, "grace_window_s", 30.0))
        self.grace_window_s = float(grace_window_s)
        if install:
            self.install(signals)
        if engine is not None:
            # engine.preempted polls this guard (DeepSpeedEngine property)
            engine._preemption_guard = self

    def __enter__(self) -> "PreemptionGuard":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.uninstall()
        return False

    def install(self, signals=_DEFAULT_SIGNALS) -> None:
        for name in signals:
            sig = getattr(signal, name, None)
            if sig is None:
                continue
            if signal.getsignal(sig) == self._handler:
                # already armed — re-storing would self-chain (== not `is`:
                # each self._handler access builds a fresh bound method)
                continue
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
                self._signals.append(sig)
            except (ValueError, OSError):  # non-main thread / unsupported
                continue

    def uninstall(self) -> None:
        for sig in self._signals:
            try:
                signal.signal(sig, self._prev.get(sig) or signal.SIG_DFL)
            except (ValueError, OSError):
                pass
        self._signals.clear()
        if self.engine is not None and getattr(self.engine, "_preemption_guard", None) is self:
            self.engine._preemption_guard = None

    def _handler(self, signum, frame):
        name = signal.Signals(signum).name
        if self._stop.is_set() and self._in_final_save:
            # double-signal during the final save: the platform's grace
            # window is over. Re-entering the save would corrupt the write
            # it interrupts — flush one log line and go. The committed (or
            # walked-back) previous tag is the recovery point.
            # logging from a handler is formally signal-unsafe, but these
            # are the process's deliberate last words before _exit: CPython
            # delivers signals between bytecodes on the main thread, and a
            # rare deadlocked log here loses nothing (the exit was already
            # the outcome)
            log_dist(
                f"second {name} during preemption checkpoint — exiting "
                "immediately (previous committed tag is the recovery point)"
            )
            self._flush_logs()
            self._exit(128 + signum)
            return  # only reached when _exit is stubbed (tests)
        self._stop.set()
        # the graceful path sets only the Event flag for correctness; the
        # log line is for the operator
        log_dist(
            f"preemption signal {name} received — "
            "will checkpoint at the next step boundary"
        )
        # dict.get allocates nothing and touches handler-local state only
        prev = self._prev.get(signum)
        # chain, except to handlers that raise (default SIGINT raises
        # KeyboardInterrupt — that would defeat the graceful checkpoint).
        # Chaining preserves the launcher's tree-kill semantics.
        if callable(prev) and prev is not signal.default_int_handler:
            prev(signum, frame)

    @staticmethod
    def _flush_logs() -> None:
        import logging
        import sys

        for h in logging.getLogger().handlers + logging.getLogger("deepspeed_tpu_torch").handlers:
            try:
                h.flush()
            except Exception:
                pass
        try:
            sys.stderr.flush()
            sys.stdout.flush()
        except Exception:
            pass

    def request_stop(self) -> None:
        """Programmatic trigger (tests; cooperative shutdown)."""
        self._stop.set()

    def should_stop(self) -> bool:
        return self._stop.is_set()

    def checkpoint_and_log(self, tag: Optional[str] = None) -> Optional[str]:
        """Save via the attached engine (no-op without one), then flush any
        in-flight async write inside the grace window; an overrun forces a
        fresh BLOCKING save under ``<tag>-final``. Returns the path."""
        if self.engine is None or self.save_dir is None:
            return None
        self._in_final_save = True
        try:
            path = self.engine.save_checkpoint(self.save_dir, tag=tag)
            flush = getattr(self.engine, "flush_checkpoints", None)
            flushed = flush(timeout=self.grace_window_s) if callable(flush) else True
            # `flushed` only proves the queue drained — a write that DIED
            # also drains. The committed tag directory exists iff the
            # atomic rename happened (a torn write leaves only <tag>.tmp),
            # so probe the path before trusting the async save.
            if not flushed or not os.path.isdir(str(path)):
                log_dist(
                    "async checkpoint did not commit "
                    + ("within the grace window" if not flushed else "(write failed)")
                    + " — forcing a fresh blocking snapshot"
                )
                final_tag = f"{tag}-final" if tag else "preempt-final"
                path = self.engine.save_checkpoint(
                    self.save_dir, tag=final_tag, blocking=True
                )
            log_dist(f"preemption checkpoint saved: {path}")
            return path
        finally:
            self._in_final_save = False
