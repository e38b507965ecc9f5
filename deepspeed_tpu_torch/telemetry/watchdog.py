"""Anomaly watchdog: a production run surfaces its own pathologies
(counterpart of ``deepspeed_tpu/telemetry/watchdog.py``, the same detectors,
events and counters).

Detectors
---------
- **non-finite**: NaN/Inf in the step's loss or grad-norm (``flags`` bits,
  or the host check on the scalars).
- **spike**: EMA z-score on watched scalars (loss, grad_norm, step time).
  Each signal keeps an exponentially-weighted mean/variance; after
  ``warmup_steps`` observations, ``(x - mean) / std > zscore`` trips.
  One-sided by design — for every watched signal UP is the pathology, and a
  two-sided test fires on healthy fast-descending loss. The std is floored
  at ``min_rel_std``·|mean| so a near-constant signal (variance ≈ 0) needs
  a material relative jump, not an epsilon. The EMA only absorbs an
  observation AFTER it was judged (spikes clamped to the trip boundary),
  so one spike cannot mask itself or drag the baseline.
- **straggler** (serving): a request resident in a decode slot far beyond
  its expected budget (``straggler_factor`` × max_new_tokens × EMA decode
  step time) — see ``ServingEngine.step``.

The serving engine drives the straggler detector; the training engine
calls ``observe_step`` in ``train_batch`` with the step's loss, gradient
norm and time on the ``check_every`` cadence, and with the in-step
``anomaly_flags`` (``nan_check``) every step.

On trip
-------
1. a structured ``anomaly`` event lands in the step trace (kind, signal,
   value, z-score, step) and ``anomalies_total{kind}`` increments;
2. a ``torch.profiler`` capture of the NEXT executed step is scheduled
   into ``capture_dir/anomaly-step-<N>`` (:meth:`start_capture` /
   :meth:`stop_capture` around the step) — the anomalous step itself
   already ran, so the capture records the (usually persistent) pathology
   right after detection. The directory is bounded: ``max_captures``
   total, oldest pruned;
3. ``policy`` decides what happens to the run: ``"continue"`` (default —
   log and keep going), ``"kill"`` (raise :class:`AnomalyError`), or
   ``"rollback"`` (the training engine restores the last clean-step host
   snapshot in place and skips the poisoned batch: the watchdog only
   detects and records; the restore lives in ``runtime/engine.py`` and
   ``resilience/recovery.py``).

A disabled watchdog config constructs nothing: the engine holds
``watchdog=None`` and the step path pays one ``None`` check.
"""

from __future__ import annotations

import math
import os
import shutil
import time
from typing import Any, Dict, List, Optional

# bit layout of the anomaly_flags a step may pass to observe_step
FLAG_LOSS_NONFINITE = 1
FLAG_GRAD_NONFINITE = 2


class AnomalyError(RuntimeError):
    """Raised by policy="kill" after the anomaly event is recorded."""


class _EmaStat:
    """EWMA mean/variance with an observation count for warmup gating."""

    def __init__(self, alpha: float, min_rel_std: float = 0.02):
        self.alpha = alpha
        self.min_rel_std = min_rel_std
        self.mean = 0.0
        self.var = 0.0
        self.count = 0

    def _std(self) -> float:
        """EWMA std, floored at ``min_rel_std``·|mean|: a near-constant
        signal must jump by a material fraction to register as a spike."""
        return max(
            math.sqrt(max(self.var, 0.0)),
            self.min_rel_std * abs(self.mean),
            1e-12,
        )

    def zscore(self, x: float) -> Optional[float]:
        """z of ``x`` against the CURRENT estimate (pre-update)."""
        if self.count == 0:
            return None
        return (x - self.mean) / self._std()

    def update(self, x: float) -> None:
        if self.count == 0:
            self.mean = x
        else:
            d = x - self.mean
            self.mean += self.alpha * d
            self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        self.count += 1


class AnomalyWatchdog:
    """Host-side detector + capture scheduler. One per engine; the serving
    scheduler shares the engine's instance for straggler events."""

    WATCHED = ("loss", "grad_norm", "step_time_s")

    def __init__(self, config, registry=None, tracer=None):
        self.config = config
        self.registry = registry
        self.tracer = tracer
        self.policy = str(getattr(config, "policy", "continue")).lower()
        self.zscore = float(config.zscore)
        self.warmup = int(config.warmup_steps)
        self.check_every = max(1, int(config.check_every))
        self.capture_dir = str(config.capture_dir)
        self.max_captures = max(0, int(config.max_captures))
        self._stats: Dict[str, _EmaStat] = {}
        self._captures_started = 0
        self._capture_pending = False
        self._capture_active: Optional[str] = None
        self._profiler = None
        self.anomalies: List[Dict[str, Any]] = []  # bounded ring, newest last
        self._flagged_stragglers: set = set()
        if registry is not None:
            # declare eagerly so a scrape before the first trip sees zeros
            self._c_anom = registry.counter(
                "anomalies_total", "watchdog trips by kind", labelnames=("kind",)
            )
            self._c_capt = registry.counter(
                "anomaly_captures_total", "profiler captures written by the watchdog"
            )
        else:
            self._c_anom = self._c_capt = None

    # -- detection -----------------------------------------------------
    def observe_step(
        self,
        step: int,
        scalars: Dict[str, float],
        flags: Optional[int] = None,
    ) -> List[Dict[str, Any]]:
        """Judge one step's scalars; returns the anomalies tripped (possibly
        empty). Raises :class:`AnomalyError` under policy="kill" AFTER every
        anomaly of the step is recorded."""
        tripped: List[Dict[str, Any]] = []
        if flags:
            if flags & FLAG_LOSS_NONFINITE:
                tripped.append(self._trip(step, "nonfinite", "loss",
                                          scalars.get("loss"), None))
            if flags & FLAG_GRAD_NONFINITE:
                tripped.append(self._trip(step, "nonfinite", "grad_norm",
                                          scalars.get("grad_norm"), None))
        for name in self.WATCHED:
            v = scalars.get(name)
            if v is None:
                continue
            v = float(v)
            if not math.isfinite(v):
                # host fallback for paths without the in-graph flag; don't
                # double-report a signal the flags already tripped
                if not any(a["signal"] == name and a["anomaly_kind"] == "nonfinite"
                           for a in tripped):
                    tripped.append(self._trip(step, "nonfinite", name, v, None))
                continue
            st = self._stats.setdefault(
                name,
                _EmaStat(
                    float(self.config.ema_alpha),
                    float(getattr(self.config, "min_rel_std", 0.02)),
                ),
            )
            z = st.zscore(v)
            # one-sided: UP is the pathology for every watched signal (a
            # fast-improving loss must not trip)
            if z is not None and st.count >= self.warmup and z > self.zscore:
                tripped.append(self._trip(step, "spike", name, v, z))
                # a judged spike must not drag the baseline toward itself:
                # clamp the absorbed value to the trip boundary
                v = st.mean + self.zscore * st._std()
            st.update(v)
        if tripped and self.policy == "kill":
            a = tripped[0]
            raise AnomalyError(
                f"watchdog[kill]: {a['anomaly_kind']} on {a['signal']} at step {step} "
                f"(value={a['value']}, z={a['z']}) — anomaly event recorded"
                + (f", capture pending in {self.capture_dir}" if self._capture_pending else "")
            )
        return tripped

    def observe_straggler(self, step: int, request_id: int, detail: str) -> bool:
        """Serving-slot straggler: trip once per request."""
        if request_id in self._flagged_stragglers:
            return False
        self._flagged_stragglers.add(request_id)
        self._trip(step, "straggler", f"request_{request_id}", None, None,
                   detail=detail, schedule_capture=False)
        return True

    def _trip(self, step, kind, signal, value, z, detail: str = "",
              schedule_capture: bool = True) -> Dict[str, Any]:
        rec = {
            "kind": "anomaly",
            "anomaly_kind": kind,
            "signal": signal,
            "step": int(step),
            "value": None if value is None or not math.isfinite(float(value)) else float(value),
            "z": round(float(z), 3) if z is not None else None,
            "policy": self.policy,
            "ts": time.time(),
        }
        if detail:
            rec["detail"] = detail
        if self._c_anom is not None:
            self._c_anom.inc(kind=kind)
        if self.tracer is not None:
            self.tracer.emit(rec)
            self.tracer.flush()  # an anomaly must hit disk even if the run dies
        self.anomalies.append(rec)
        del self.anomalies[:-64]
        if schedule_capture and self._captures_started < self.max_captures:
            self._capture_pending = True
        return rec

    # -- profiler capture (driven by the engine's step loop) -----------
    @property
    def capture_pending(self) -> bool:
        return self._capture_pending

    def start_capture(self, step: int) -> Optional[str]:
        """Begin a bounded ``torch.profiler`` capture for the step about to
        run. Returns the capture directory (None when the budget is spent or
        the profiler is unavailable)."""
        if not self._capture_pending or self._capture_active is not None:
            return None
        self._capture_pending = False
        if self._captures_started >= self.max_captures:
            return None
        target = os.path.join(self.capture_dir, f"anomaly-step-{int(step):08d}")
        try:
            self._prune_captures(keep=self.max_captures - 1)
            os.makedirs(target, exist_ok=True)
            import torch.profiler as _prof

            acts = [_prof.ProfilerActivity.CPU]
            import torch

            if torch.cuda.is_available():
                acts.append(_prof.ProfilerActivity.CUDA)
            prof = _prof.profile(activities=acts)
            prof.__enter__()
        except Exception:
            return None  # capture is best-effort; never sink the step
        self._profiler = prof
        self._capture_active = target
        self._captures_started += 1
        return target

    def stop_capture(self) -> Optional[str]:
        if self._capture_active is None:
            return None
        target, self._capture_active = self._capture_active, None
        prof, self._profiler = self._profiler, None
        try:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(os.path.join(target, "trace.json"))
        except Exception:
            return None
        if self._c_capt is not None:
            self._c_capt.inc()
        if self.tracer is not None:
            self.tracer.emit({"kind": "anomaly_capture", "path": target})
        return target

    def _prune_captures(self, keep: int) -> None:
        """Keep the capture directory bounded: newest ``keep`` survive."""
        try:
            entries = sorted(
                e for e in os.listdir(self.capture_dir)
                if e.startswith("anomaly-step-")
            )
        except OSError:
            return
        for e in entries[: max(0, len(entries) - max(0, keep))]:
            shutil.rmtree(os.path.join(self.capture_dir, e), ignore_errors=True)


def from_config(config, registry=None, tracer=None) -> Optional[AnomalyWatchdog]:
    """``WatchdogConfig`` → watchdog, or None when disabled (nothing
    constructed, no counters declared — the zero-overhead contract)."""
    if config is None or not getattr(config, "enabled", False):
        return None
    return AnomalyWatchdog(config, registry=registry, tracer=tracer)
