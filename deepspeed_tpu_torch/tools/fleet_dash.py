"""``fleet_dash`` — terminal capacity/trend dashboard over a metrics
time-series journal (the JAX package's CLI, ported: the same report,
JSON, gates and exit codes).

    python -m deepspeed_tpu_torch.tools.fleet_dash METRICS_TSDB.jsonl \
        [--bins N] [--watch SECS [--iterations N]] \
        [--diff B.jsonl --threshold-pct 10] \
        [--min-budget F] [--max-burn X] [--min-goodput T] [--json]

Consumes the schema-versioned ``dstpu-tsdb-v1`` JSONL a
:class:`~deepspeed_tpu_torch.telemetry.timeseries.MetricsJournal` writes
(``load_journal`` reads the rolled ``.1`` generation first, so the full
history survives rotation) and renders:

- **per-replica rows** (fleets): goodput / occupancy / queue-depth as
  ASCII sparklines over the journal span, latest value alongside — the
  "is this replica degrading?" answer at a glance;
- **fleet events**: migration outcome counts, moved bytes, blackout
  p50/p99 over the whole journal (``quantile_over_time`` over the
  ``fleet_migration_blackout_seconds`` buckets — the same estimator the
  live gauges use), plus the ``slo_alert`` firing/resolved history;
- **SLO budget**: per-class error-budget-remaining and burn-rate gauges
  (latest + sparkline);
- **capacity forecast**: a linear least-squares fit over the trailing
  occupancy series per replica → projected time to saturation
  (occupancy 1.0), and over each class's budget-remaining series →
  projected time to budget exhaustion. Flat or improving trends report
  no horizon.

``--watch`` re-reads and re-renders every SECS (``--iterations`` bounds
the loop for CI); ``--diff`` compares headline metrics against a second
journal and flags worse-than-threshold regressions; the gate flags turn
the latest budget/burn/goodput values into CI assertions.

Exit codes (request-trace CLI contract): 0 clean, 1 a gate tripped or a
``--diff`` regression, 2 unreadable/wrong-schema journal or usage error.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

from ..telemetry.timeseries import SeriesStore, TimeseriesError, load_journal

_SHADES = " .:-=+*#%@"

# headline metrics --diff compares: (name, higher_is_better)
_DIFF_METRICS = (
    ("goodput_tokens_per_sec", True),
    ("occupancy_peak", False),
    ("queue_depth_peak", False),
    ("migration_blackout_p99_s", False),
    ("alerts_fired", False),
    ("budget_remaining_min", True),
)


def _label_of(sid: str, key: str) -> Optional[str]:
    """Value of one label inside a series id (no unescaping beyond the
    common case — replica ids / class names never carry quotes)."""
    pre = f'{key}="'
    i = sid.find(pre)
    if i < 0:
        return None
    j = sid.find('"', i + len(pre))
    return sid[i + len(pre):j] if j >= 0 else None


def _sparkline(samples: List[Tuple[float, float]], bins: int,
               t0: float, t1: float, vmax: Optional[float] = None) -> str:
    """Time-bucketed shade ramp: each cell is the last sample value in its
    bin (carried forward across empty bins — gauges hold their value
    between snapshots), scaled to the series (or given) max."""
    if not samples or t1 <= t0:
        return "-" * bins
    if vmax is None:
        vmax = max(v for _t, v in samples)
    cells = []
    si = 0
    cur: Optional[float] = None
    for b in range(bins):
        edge = t0 + (t1 - t0) * (b + 1) / bins
        while si < len(samples) and samples[si][0] <= edge:
            cur = samples[si][1]
            si += 1
        if cur is None:
            cells.append(" ")
        elif vmax <= 0:
            cells.append(_SHADES[0])
        else:
            frac = min(1.0, max(0.0, cur / vmax))
            cells.append(_SHADES[round(frac * (len(_SHADES) - 1))])
    return "".join(cells)


def _linfit(samples: List[Tuple[float, float]]) -> Optional[Tuple[float, float]]:
    """Least-squares (slope, intercept) of value over time, or None with
    fewer than 3 samples / zero time spread."""
    if len(samples) < 3:
        return None
    n = len(samples)
    mt = sum(t for t, _v in samples) / n
    mv = sum(v for _t, v in samples) / n
    den = sum((t - mt) ** 2 for t, _v in samples)
    if den <= 0.0:
        return None
    slope = sum((t - mt) * (v - mv) for t, v in samples) / den
    return slope, mv - slope * mt


def _horizon(samples: List[Tuple[float, float]], target: float,
             rising: bool) -> Optional[float]:
    """Seconds (from the last sample) until the linear fit crosses
    ``target`` — rising series toward a ceiling, falling toward a floor.
    None when the trend points away or is flat."""
    fit = _linfit(samples)
    if fit is None:
        return None
    slope, intercept = fit
    if (rising and slope <= 0.0) or (not rising and slope >= 0.0):
        return None
    t_cross = (target - intercept) / slope
    dt = t_cross - samples[-1][0]
    return dt if dt > 0.0 else 0.0


def dash_report(store: SeriesStore, bins: int = 32) -> Dict[str, Any]:
    """Fold one journal into the dashboard's data model (the ``--json``
    output; the text renderer formats this)."""
    t0, t1 = store.span()
    out: Dict[str, Any] = {
        "span_s": (t1 - t0) if t0 is not None else 0.0,
        "t0": t0, "t1": t1, "bins": bins,
        "replicas": {}, "fleet": {}, "slo": {}, "alerts": [], "forecast": {},
    }
    if t0 is None:
        return out

    # -- per-replica series (absent on solo-engine journals) -----------
    rep_series = {
        "goodput_tokens_per_sec": "fleet_replica_goodput_tokens_per_sec",
        "occupancy": "fleet_replica_occupancy",
        "queue_depth": "fleet_replica_queue_depth",
    }
    for short, fam in rep_series.items():
        for sid in store.sids(fam):
            rid = _label_of(sid, "replica")
            if rid is None:
                continue
            samples = store.range(sid)
            rep = out["replicas"].setdefault(rid, {})
            rep[short] = {
                "latest": samples[-1][1] if samples else None,
                "series": samples,
            }

    # -- fleet-level headline ------------------------------------------
    def _latest(name: str) -> Optional[float]:
        return store.latest(name)

    occ_sids = store.sids("fleet_replica_occupancy") or ["serving_kv_page_occupancy"]
    q_sids = store.sids("fleet_replica_queue_depth") or ["serving_queue_depth"]
    occ_all = [v for sid in occ_sids for _t, v in store.range(sid)]
    q_all = [v for sid in q_sids for _t, v in store.range(sid)]
    out["fleet"] = {
        "replicas": _latest("fleet_replicas"),
        "goodput_tokens_per_sec": _latest("serving_goodput_tokens_per_sec"),
        "occupancy_peak": max(occ_all) if occ_all else None,
        "queue_depth_peak": max(q_all) if q_all else None,
        "migrations": {
            (_label_of(sid, "status") or "?"): store.latest(sid)
            for sid in store.sids("fleet_migrations_total")
        },
        "migration_bytes": _latest("fleet_migration_bytes_total"),
        "migration_blackout_p50_s": store.quantile_over_time(
            "fleet_migration_blackout_seconds", 0.5
        ),
        "migration_blackout_p99_s": store.quantile_over_time(
            "fleet_migration_blackout_seconds", 0.99
        ),
        "rejections": _latest("fleet_rejections_total"),
    }

    # -- SLO budget plane ----------------------------------------------
    for sid in store.sids("slo_error_budget_remaining"):
        cls = _label_of(sid, "slo_class") or "?"
        samples = store.range(sid)
        out["slo"][cls] = {
            "budget_remaining": samples[-1][1] if samples else None,
            "budget_series": samples,
            "burn": {},
        }
    for sid in store.sids("slo_burn_rate"):
        cls = _label_of(sid, "slo_class") or "?"
        win = _label_of(sid, "window") or "?"
        if cls in out["slo"]:
            out["slo"][cls]["burn"][win] = store.latest(sid)
    out["alerts"] = [e for e in store.events if e.get("kind") == "slo_alert"]
    out["fleet"]["alerts_fired"] = sum(
        1 for e in out["alerts"] if e.get("state") == "firing"
    )

    # -- forecasts ------------------------------------------------------
    half = (t0 + t1) / 2.0  # fit the trailing half: trend, not history
    sat: Dict[str, Any] = {}
    for sid in store.sids("fleet_replica_occupancy"):
        rid = _label_of(sid, "replica") or "?"
        sat[rid] = _horizon(store.range(sid, half), 1.0, rising=True)
    if not sat:
        sat["engine"] = _horizon(
            store.range("serving_kv_page_occupancy", half), 1.0, rising=True
        )
    exhaustion = {
        cls: _horizon(ent["budget_series"][len(ent["budget_series"]) // 2:],
                      0.0, rising=False)
        for cls, ent in out["slo"].items()
    }
    out["forecast"] = {
        "occupancy_saturation_s": sat,
        "budget_exhaustion_s": exhaustion,
    }
    return out


def _headline(report: Dict[str, Any]) -> Dict[str, Optional[float]]:
    """The scalar metrics --diff compares."""
    fl = report["fleet"]
    budgets = [
        ent["budget_remaining"] for ent in report["slo"].values()
        if ent.get("budget_remaining") is not None
    ]
    return {
        "goodput_tokens_per_sec": fl.get("goodput_tokens_per_sec"),
        "occupancy_peak": fl.get("occupancy_peak"),
        "queue_depth_peak": fl.get("queue_depth_peak"),
        "migration_blackout_p99_s": fl.get("migration_blackout_p99_s"),
        "alerts_fired": float(fl.get("alerts_fired") or 0),
        "budget_remaining_min": min(budgets) if budgets else None,
    }


def diff_reports(a: Dict[str, Optional[float]], b: Dict[str, Optional[float]],
                 threshold_pct: float = 10.0) -> Dict[str, Any]:
    """Flag metrics where B is worse than A by more than the threshold
    (relative when A is nonzero, absolute otherwise)."""
    rows, regressions = [], []
    for name, higher_better in _DIFF_METRICS:
        va, vb = a.get(name), b.get(name)
        row = {"metric": name, "a": va, "b": vb, "regressed": False}
        if va is not None and vb is not None:
            worse = (vb - va) if not higher_better else (va - vb)
            limit = abs(va) * threshold_pct / 100.0
            if worse > max(limit, 1e-12):
                row["regressed"] = True
                regressions.append(name)
        rows.append(row)
    return {"rows": rows, "regressions": regressions,
            "threshold_pct": threshold_pct}


def _fmt_eta(v: Optional[float]) -> str:
    if v is None:
        return "stable"
    if v >= 3600.0:
        return f"{v / 3600.0:.1f}h"
    if v >= 60.0:
        return f"{v / 60.0:.1f}m"
    return f"{v:.1f}s"


def _fmt(v: Optional[float], spec: str = ".2f") -> str:
    return "-" if v is None else format(v, spec)


def render(report: Dict[str, Any]) -> str:
    """The terminal view of one :func:`dash_report`."""
    bins = report["bins"]
    t0, t1 = report["t0"], report["t1"]
    lines = [
        f"fleet_dash  span={report['span_s']:.1f}s  "
        f"[{_fmt(t0)} .. {_fmt(t1)}]",
        "",
    ]
    if report["replicas"]:
        lines.append(f"{'replica':<9} {'metric':<12} "
                     f"{'history':<{bins}}  latest")
        for rid in sorted(report["replicas"]):
            rep = report["replicas"][rid]
            for short, ent in sorted(rep.items()):
                vmax = 1.0 if short == "occupancy" else None
                lines.append(
                    f"{rid:<9} {short[:12]:<12} "
                    f"{_sparkline(ent['series'], bins, t0, t1, vmax)}  "
                    f"{_fmt(ent['latest'])}"
                )
        lines.append("")
    fl = report["fleet"]
    lines.append(
        f"fleet: goodput={_fmt(fl.get('goodput_tokens_per_sec'))} tok/s  "
        f"occ_peak={_fmt(fl.get('occupancy_peak'))}  "
        f"queue_peak={_fmt(fl.get('queue_depth_peak'), '.0f')}  "
        f"rejections={_fmt(fl.get('rejections'), '.0f')}"
    )
    if fl.get("migrations"):
        mig = "  ".join(f"{k}={v:.0f}" for k, v in sorted(fl["migrations"].items()))
        lines.append(
            f"migrations: {mig}  bytes={_fmt(fl.get('migration_bytes'), '.0f')}  "
            f"blackout p50={_fmt(fl.get('migration_blackout_p50_s'), '.4f')}s "
            f"p99={_fmt(fl.get('migration_blackout_p99_s'), '.4f')}s"
        )
    if report["slo"]:
        lines.append("")
        lines.append(f"{'slo_class':<12} {'budget':<{bins}}  remaining  "
                     "burn fast(s/l) slow(s/l)")
        for cls, ent in sorted(report["slo"].items()):
            burn = ent["burn"]
            lines.append(
                f"{cls:<12} "
                f"{_sparkline(ent['budget_series'], bins, t0, t1, 1.0)}  "
                f"{_fmt(ent['budget_remaining'], '.3f'):<9}  "
                f"{_fmt(burn.get('fast_short'))}/{_fmt(burn.get('fast_long'))} "
                f"{_fmt(burn.get('slow_short'))}/{_fmt(burn.get('slow_long'))}"
            )
    if report["alerts"]:
        lines.append("")
        lines.append(f"alerts ({len(report['alerts'])}):")
        for e in report["alerts"][-8:]:
            lines.append(
                f"  t={e.get('t', 0):.2f} {e.get('slo_class')}/{e.get('rule')} "
                f"-> {e.get('state')} (burn {e.get('burn_short')}/"
                f"{e.get('burn_long')} thr {e.get('threshold')})"
            )
    fc = report["forecast"]
    if fc:
        lines.append("")
        sat = "  ".join(
            f"{rid}={_fmt_eta(v)}"
            for rid, v in sorted(fc.get("occupancy_saturation_s", {}).items())
        )
        lines.append(f"forecast: saturation {sat or '-'}")
        exh = fc.get("budget_exhaustion_s", {})
        if exh:
            lines.append("          budget exhaustion " + "  ".join(
                f"{cls}={_fmt_eta(v)}" for cls, v in sorted(exh.items())
            ))
    return "\n".join(lines)


def _gates(report: Dict[str, Any], args) -> List[str]:
    """Evaluate the CI gate flags against the latest values; returns the
    tripped-gate descriptions."""
    tripped: List[str] = []
    if args.min_budget is not None:
        for cls, ent in sorted(report["slo"].items()):
            rem = ent.get("budget_remaining")
            if rem is not None and rem < args.min_budget:
                tripped.append(
                    f"budget_remaining[{cls}]={rem:.4f} < {args.min_budget}"
                )
    if args.max_burn is not None:
        for cls, ent in sorted(report["slo"].items()):
            for win, v in sorted(ent["burn"].items()):
                if v is not None and v > args.max_burn:
                    tripped.append(
                        f"burn_rate[{cls},{win}]={v:.3f} > {args.max_burn}"
                    )
    if args.min_goodput is not None:
        gp = report["fleet"].get("goodput_tokens_per_sec")
        if gp is None or gp < args.min_goodput:
            tripped.append(
                f"goodput={_fmt(gp)} < {args.min_goodput}"
            )
    return tripped


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="fleet_dash",
        description="capacity/trend dashboard over a dstpu-tsdb-v1 journal",
    )
    p.add_argument("journal", help="metrics journal (JSONL from MetricsJournal)")
    p.add_argument("--bins", type=int, default=32,
                   help="sparkline width in time buckets")
    p.add_argument("--watch", type=float, default=None, metavar="SECS",
                   help="re-read and re-render every SECS")
    p.add_argument("--iterations", type=int, default=0, metavar="N",
                   help="stop --watch after N renders (0 = forever)")
    p.add_argument("--diff", default=None, metavar="B_JSONL",
                   help="compare headline metrics against a second journal; "
                        "regressions exit 1")
    p.add_argument("--threshold-pct", type=float, default=10.0,
                   help="--diff regression threshold (%% worse than A)")
    p.add_argument("--min-budget", type=float, default=None, metavar="F",
                   help="gate: any class's budget remaining below F exits 1")
    p.add_argument("--max-burn", type=float, default=None, metavar="X",
                   help="gate: any burn-rate gauge above X exits 1")
    p.add_argument("--min-goodput", type=float, default=None, metavar="T",
                   help="gate: fleet goodput below T tok/s exits 1")
    p.add_argument("--json", action="store_true", help="emit JSON")
    args = p.parse_args(argv)
    if args.bins < 1:
        print("fleet_dash: --bins must be >= 1", file=sys.stderr)
        return 2
    if args.watch is not None and args.watch <= 0:
        print("fleet_dash: --watch must be > 0", file=sys.stderr)
        return 2
    try:
        renders = 0
        while True:
            store = load_journal(args.journal)
            report = dash_report(store, bins=args.bins)
            if args.diff is not None:
                dr = diff_reports(
                    _headline(report),
                    _headline(dash_report(load_journal(args.diff),
                                          bins=args.bins)),
                    threshold_pct=args.threshold_pct,
                )
                if args.json:
                    print(json.dumps(dr, indent=1))
                else:
                    for row in dr["rows"]:
                        flag = "  REGRESSED" if row["regressed"] else ""
                        print(f"{row['metric']:<28} A={_fmt(row['a'], '.4f')} "
                              f"B={_fmt(row['b'], '.4f')}{flag}")
                return 1 if dr["regressions"] else 0
            tripped = _gates(report, args)
            if args.json:
                report = dict(report)
                report["gates_tripped"] = tripped
                # series lists are big; the JSON view keeps them (that IS
                # the export), sparklines are the text view's concern
                print(json.dumps(report, indent=1, default=str))
            else:
                print(render(report))
                for g in tripped:
                    print(f"GATE TRIPPED: {g}")
            if tripped:
                return 1
            renders += 1
            if args.watch is None or (args.iterations and
                                      renders >= args.iterations):
                return 0
            time.sleep(args.watch)
    except (OSError, TimeseriesError) as e:
        print(f"fleet_dash: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
