"""Deterministic fault injection: recovery paths are tested, not hoped for
(counterpart of ``deepspeed_tpu/resilience/faults.py``; the same sites,
schedules and chaos draws).

:class:`FaultInjector` turns the ``resilience.fault_injection`` config into
seeded, reproducible fault decisions at four sites:

- ``nan_loss``    — poison the step's loss scalar after ``train_batch``
                    (indices = the 1-based ``train_batch`` invocation
                    ordinal, monotonic, NOT ``global_steps``, which a
                    rollback rewinds): trips the watchdog's non-finite
                    detector → the rollback/kill policy paths.
- ``sigterm``     — deliver a real SIGTERM to this process after a step
                    (same ordinal; only when a handler is installed): the
                    PreemptionGuard's grace-window flush.
- ``checkpoint_crash`` — abort a checkpoint write after the array files but
                    before the manifest and rename (indices = the writer's
                    1-based save ordinal): leaves the torn ``<tag>.tmp`` a
                    mid-write process death would, which the walk-back
                    loader must skip.
- ``serving_stall`` — mark the Nth admitted serving request (1-based) to
                    fail transiently mid-decode: slot eviction and
                    retry-with-backoff.

Explicit index schedules are the test-friendly mode; ``probability`` adds a
chaos mode where each (site, index) fires independently with probability
p, from sha256 of ``"{seed}:{site}:{index}"``: the same seed injects the
same faults across restarts, processes and both packages.
"""

from __future__ import annotations

import hashlib
import os
import signal
from typing import Dict, List

from ..utils.logging import log_dist, logger

SITES = ("nan_loss", "sigterm", "checkpoint_crash", "serving_stall")


class FaultInjected(RuntimeError):
    """Raised at an injection site that simulates a crash."""


class FaultInjector:
    """Seeded, deterministic fault decisions; one per engine.

    ``fire(site, index)`` is pure given (config, site, index): a restarted
    run re-injects the same faults."""

    def __init__(self, config):
        self.config = config
        self.seed = int(getattr(config, "seed", 0))
        self.probability = float(getattr(config, "probability", 0.0))
        self._sched: Dict[str, set] = {
            "nan_loss": set(getattr(config, "nan_loss_steps", ()) or ()),
            "sigterm": set(getattr(config, "sigterm_steps", ()) or ()),
            "checkpoint_crash": set(getattr(config, "crash_saves", ()) or ()),
            "serving_stall": set(getattr(config, "stall_requests", ()) or ()),
        }
        self.fired: Dict[str, List[int]] = {}

    def _chaos(self, site: str, index: int) -> bool:
        if self.probability <= 0.0:
            return False
        blob = f"{self.seed}:{site}:{index}".encode()
        h = int.from_bytes(hashlib.sha256(blob).digest()[:8], "big")
        return (h / 2**64) < self.probability

    def fire(self, site: str, index: int) -> bool:
        """Should fault ``site`` fire at occurrence ``index``? Records and
        logs every hit."""
        if site not in self._sched:
            raise ValueError(f"unknown fault site {site!r} (know {SITES})")
        hit = index in self._sched[site] or self._chaos(site, index)
        if hit:
            self.fired.setdefault(site, []).append(index)
            log_dist(f"fault injection: {site} fires at index {index}")
        return hit

    def counts(self) -> Dict[str, int]:
        return {site: len(ix) for site, ix in self.fired.items()}

    def deliver_sigterm(self) -> bool:
        """Send this process a real SIGTERM, but only when a handler is
        installed (a PreemptionGuard, a launcher): process death injected
        into an unguarded runner tests no recovery."""
        cur = signal.getsignal(signal.SIGTERM)
        if cur in (signal.SIG_DFL, signal.SIG_IGN, None):
            logger.warning(
                "fault injection: sigterm scheduled but no handler installed "
                "(install a PreemptionGuard); skipping delivery"
            )
            return False
        os.kill(os.getpid(), signal.SIGTERM)
        return True


def from_config(config) -> "FaultInjector | None":
    if config is None or not getattr(config, "enabled", False):
        return None
    return FaultInjector(config)
