"""SLO error-budget accounting + multi-window burn-rate alerting
(counterpart of ``deepspeed_tpu/telemetry/slo_budget.py``).

The classic SRE construction over the metrics journal: with an
attainment ``objective`` (say 0.99), the **error budget** is the
``1 - objective`` fraction of requests allowed to miss; the **burn rate**
over a window is ``(observed miss fraction) / (budget fraction)`` — 1.0
spends the budget exactly at the allowed pace, 14.4 exhausts a 3-day
budget in 5 hours. Two rules evaluate per SLO class:

- **fast** (default 5m/1h short/long at 14.4x): catches cliffs within
  minutes; the long window de-flaps it — a single bad scrape cannot fire;
- **slow** (default 6h/3d at 1.0x): catches slow grinds the fast rule's
  threshold never sees.

A rule's condition is ``burn(short) >= threshold AND burn(long) >=
threshold``. Windows are **virtual-timebase seconds** read off the
journal's clock — tests compress them exactly like the heat plane's idle
thresholds, the state machine neither knows nor cares.

Per (class, rule) the alert runs ``inactive → pending → firing →
resolved``: the condition starts a pending dwell (``for_s``; 0 promotes
immediately), sustained condition fires, condition clearing resolves (one
evaluation in ``resolved`` then back to ``inactive``). Transitions to
firing/resolved emit deterministic ``slo_alert`` records into the journal
and bump ``slo_alerts_total{slo_class,rule,state}``; every evaluation
refreshes ``slo_error_budget_remaining{slo_class}`` and
``slo_burn_rate{slo_class,window}`` gauges.

The fleet hook: :meth:`SLOBudgetEngine.firing` feeds
``serving/fleet.py``'s ``FleetRouter._should_shed`` when
``serving.fleet.slo_alerts.backpressure`` is on, and the router's step
calls :meth:`maybe_evaluate`; the engine also runs standalone over a
journal.

Counter sources (written by the scheduler's ``_req_terminal`` funnel):
``serving_slo_evaluated_total{slo_class}`` /
``serving_slo_met_total{slo_class}`` — monotone counters, so the journal's
reset-tolerant ``increase()`` is exact over any window.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from .timeseries import MetricsJournal

EVALUATED = "serving_slo_evaluated_total"
MET = "serving_slo_met_total"

# gauge window label values, in (rule, position) order
WINDOW_LABELS = ("fast_short", "fast_long", "slow_short", "slow_long")


def _class_sid(name: str, slo_class: str) -> str:
    """The journal series id the scheduler's labeled counter lands under
    (must mirror registry._label_str's escaping)."""
    esc = (
        str(slo_class).replace("\\", r"\\").replace('"', r"\"")
        .replace("\n", r"\n")
    )
    return f'{name}{{slo_class="{esc}"}}'


def _class_of_sid(sid: str) -> Optional[str]:
    """Inverse of :func:`_class_sid` for discovery (single-label series)."""
    pre = '{slo_class="'
    i = sid.find(pre)
    if i < 0 or not sid.endswith('"}'):
        return None
    raw = sid[i + len(pre):-2]
    return (
        raw.replace(r"\n", "\n").replace(r"\"", '"').replace(r"\\", "\\")
    )


class SLOBudgetEngine:
    """Error budget + burn-rate alerts over one :class:`MetricsJournal`.

    ``evaluate()`` is cheap (a few windowed ``increase()`` queries per
    class) but still gated to journal-snapshot cadence via
    :meth:`maybe_evaluate` — the fleet calls that once per step."""

    def __init__(self, journal: MetricsJournal, config, registry=None,
                 clock=None):
        self.journal = journal
        self.cfg = config
        self.clock = clock if clock is not None else journal.clock
        # the in-memory mirror must hold the widest window we will query
        journal.ensure_retention(config.max_window_s())
        self.rules: List[Tuple[str, float, float, float]] = [
            ("fast", float(config.fast_short_s), float(config.fast_long_s),
             float(config.fast_burn_threshold)),
            ("slow", float(config.slow_short_s), float(config.slow_long_s),
             float(config.slow_burn_threshold)),
        ]
        # (slo_class, rule) -> state dict
        self._states: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self.alerts_fired = 0
        self.alerts_resolved = 0
        self._last_eval_t: Optional[float] = None
        self._g_budget = self._g_burn = self._c_alerts = None
        if registry is not None:
            self.bind_registry(registry)

    # -- wiring --------------------------------------------------------
    def bind_registry(self, registry) -> None:
        """Idempotent gauge/counter declaration on the shared registry."""
        self._g_budget = registry.gauge(
            "slo_error_budget_remaining",
            "fraction of the per-class error budget left (1 = untouched, "
            "0 = spent, negative = overspent) at the configured objective",
            labelnames=("slo_class",),
        )
        self._g_burn = registry.gauge(
            "slo_burn_rate",
            "error-budget burn rate per class and alert window "
            "(1.0 = spending exactly the budget over the objective period)",
            labelnames=("slo_class", "window"),
        )
        self._c_alerts = registry.counter(
            "slo_alerts_total",
            "burn-rate alert transitions by class, rule and new state",
            labelnames=("slo_class", "rule", "state"),
        )

    # -- math ----------------------------------------------------------
    def classes(self) -> List[str]:
        """SLO classes observed in the journal (from the evaluated-counter
        series ids)."""
        out = []
        for sid in self.journal.sids(EVALUATED):
            cls = _class_of_sid(sid)
            if cls is not None:
                out.append(cls)
        return sorted(set(out))

    def burn_rate(self, slo_class: str, window_s: float, now: float) -> float:
        """(bad fraction over the trailing window) / (1 - objective)."""
        ev = self.journal.increase(
            _class_sid(EVALUATED, slo_class), now - window_s, now
        )
        if ev <= 0.0:
            return 0.0
        met = self.journal.increase(
            _class_sid(MET, slo_class), now - window_s, now
        )
        bad = max(0.0, ev - met) / ev
        return bad / (1.0 - float(self.cfg.objective))

    def budget_remaining(self, slo_class: str,
                         now: Optional[float] = None) -> float:
        """Cumulative budget left: 1 - bad_total / (evaluated_total *
        (1 - objective)). 1.0 with nothing evaluated; negative =
        overspent."""
        ev = self.journal.latest(_class_sid(EVALUATED, slo_class), now) or 0.0
        if ev <= 0.0:
            return 1.0
        met = self.journal.latest(_class_sid(MET, slo_class), now) or 0.0
        bad = max(0.0, ev - met)
        return 1.0 - bad / (ev * (1.0 - float(self.cfg.objective)))

    # -- the state machine ---------------------------------------------
    def maybe_evaluate(self) -> List[dict]:
        """Evaluate at the journal's last snapshot time, once per snapshot
        (the fleet's per-step call — a no-op between snapshots)."""
        lt = self.journal.last_t
        if lt is None or lt == self._last_eval_t:
            return []
        self._last_eval_t = lt
        return self.evaluate(lt)

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """One alerting pass: refresh burn/budget gauges for every class,
        advance each (class, rule) state machine, emit ``slo_alert``
        journal events on firing/resolved transitions. Returns the
        transition records."""
        if now is None:
            now = self.clock()
        transitions: List[dict] = []
        for cls in self.classes():
            for rule, short_s, long_s, threshold in self.rules:
                bs = self.burn_rate(cls, short_s, now)
                bl = self.burn_rate(cls, long_s, now)
                cond = bs >= threshold and bl >= threshold
                st = self._states.setdefault((cls, rule), {
                    "state": "inactive", "t_pending": None,
                    "t_fired": None, "t_resolved": None,
                })
                if cond:
                    if st["state"] in ("inactive", "resolved"):
                        st["state"] = "pending"
                        st["t_pending"] = now
                    if (st["state"] == "pending"
                            and now - st["t_pending"] >= float(self.cfg.for_s)):
                        st["state"] = "firing"
                        st["t_fired"] = now
                        self.alerts_fired += 1
                        transitions.append(self._transition(
                            cls, rule, "firing", bs, bl, threshold, now
                        ))
                else:
                    if st["state"] == "firing":
                        st["state"] = "resolved"
                        st["t_resolved"] = now
                        self.alerts_resolved += 1
                        transitions.append(self._transition(
                            cls, rule, "resolved", bs, bl, threshold, now
                        ))
                    elif st["state"] == "pending":
                        st["state"] = "inactive"
                        st["t_pending"] = None
                    elif st["state"] == "resolved":
                        st["state"] = "inactive"
                st["burn_short"] = bs
                st["burn_long"] = bl
                if self._g_burn is not None:
                    self._g_burn.set(bs, slo_class=cls, window=f"{rule}_short")
                    self._g_burn.set(bl, slo_class=cls, window=f"{rule}_long")
            if self._g_budget is not None:
                self._g_budget.set(self.budget_remaining(cls, now),
                                   slo_class=cls)
        return transitions

    def _transition(self, cls: str, rule: str, state: str, bs: float,
                    bl: float, threshold: float, now: float) -> dict:
        rec = {
            "burn_long": round(bl, 6),
            "burn_short": round(bs, 6),
            "kind": "slo_alert",
            "rule": rule,
            "slo_class": cls,
            "state": state,
            "t": now,
            "threshold": threshold,
        }
        self.journal.emit_event(rec)
        if self._c_alerts is not None:
            self._c_alerts.inc(slo_class=cls, rule=rule, state=state)
        return rec

    # -- consumers ------------------------------------------------------
    def firing(self) -> bool:
        """True while ANY (class, rule) alert is in the firing state — the
        fleet's backpressure signal. Pending never counts."""
        return any(st["state"] == "firing" for st in self._states.values())

    def firing_classes(self) -> List[str]:
        return sorted({
            cls for (cls, _r), st in self._states.items()
            if st["state"] == "firing"
        })

    def states(self) -> Dict[str, Any]:
        """Per-class alert/budget summary for ``stats()`` and the
        dashboard."""
        out: Dict[str, Any] = {}
        for (cls, rule), st in sorted(self._states.items()):
            ent = out.setdefault(cls, {
                "budget_remaining": self.budget_remaining(cls),
                "rules": {},
            })
            ent["rules"][rule] = {
                "state": st["state"],
                "burn_short": st.get("burn_short", 0.0),
                "burn_long": st.get("burn_long", 0.0),
                "t_fired": st.get("t_fired"),
                "t_resolved": st.get("t_resolved"),
            }
        return out
