"""``request_trace`` — waterfall / SLO / goodput reporting over request traces.

    python -m deepspeed_tpu_torch.tools.request_trace REQUESTS.jsonl \
        [--waterfall N | --request ID] [--bins N] [--by tenant] \
        [--min-attainment PCT] [--diff B.jsonl --threshold-pct 10] [--json]

Consumes the schema-versioned JSONL the RequestTracer emits
(telemetry/request_trace.py; one record per terminal request, either
package's) and renders (the JAX package's CLI, ported: the same reports,
JSON and exit codes):

- the **aggregate report** (default): request counts by terminal status,
  TTFT / streaming-TPOT / queue-wait quantiles (the same histogram-bucket
  interpolation as ``ServingEngine.stats()``, so the numbers cross-check
  against the live engine), and per-SLO-class goodput + attainment;
- a per-request **waterfall** (``--waterfall`` / ``--request``): the
  queue → prefill → decode timeline as a scaled bar, with retries and the
  cause-attributed admission waits;
- a **time-binned breakdown** (``--bins``): arrivals and mean phase split
  per submit-time window — the bursty replay workload's load/latency shape;
- a **diff** (``--diff``): aggregate metrics of two runs compared, worse-
  than-threshold deltas flagged.

Exit codes (CI-gateable): 0 clean, 1 a gate tripped (``--min-attainment``
below target, or any ``--diff`` regression), 2 usage/parse errors.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from ..telemetry.request_trace import (
    RequestTraceError,
    load_request_records,
    request_phases,
    score_requests,
    time_binned,
)

# aggregate metrics --diff compares: (name, higher_is_better)
_DIFF_METRICS = (
    ("ttft_p50_s", False),
    ("ttft_p99_s", False),
    ("tpot_p50_s", False),
    ("tpot_p99_s", False),
    ("queue_wait_p99_s", False),
    ("goodput_tokens_per_sec", True),
    ("throughput_tokens_per_sec", True),
    ("slo_attainment", True),
)


def _fmt_s(v: Optional[float]) -> str:
    if v is None:
        return "-"
    return f"{v * 1e3:.2f}ms" if v < 1.0 else f"{v:.3f}s"


def _overall_metrics(
    records: List[Dict[str, Any]],
    score: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """One flat dict of run-level metrics (the --diff comparison axis):
    overall latency quantiles + goodput/attainment. Pass an existing
    ``score_requests`` result to avoid re-scoring (the overall block is
    grouping-key-independent)."""
    if score is None:
        score = score_requests(records)
    ov = score["overall"] or {}
    return {
        "requests": len(records),
        "ttft_p50_s": ov.get("ttft_p50_s"),
        "ttft_p99_s": ov.get("ttft_p99_s"),
        "tpot_p50_s": ov.get("tpot_p50_s"),
        "tpot_p99_s": ov.get("tpot_p99_s"),
        "queue_wait_p50_s": ov.get("queue_wait_p50_s"),
        "queue_wait_p99_s": ov.get("queue_wait_p99_s"),
        "goodput_tokens_per_sec": ov.get("goodput_tokens_per_sec"),
        "throughput_tokens_per_sec": ov.get("throughput_tokens_per_sec"),
        "slo_attainment": ov.get("slo_attainment"),
    }


def _group_key(by: str):
    """Record → group-name accessor for ``--by``. ``replica`` groups by the
    fleet replica that FINISHED the request (the router restamps on
    migration) — records from pre-fleet traces land in ``(none)``."""
    if by == "tenant":
        return lambda r: r.get("tenant") or ""
    if by == "replica":
        return lambda r: r.get("replica") or "(none)"
    return lambda r: r.get("slo_class") or ""


def build_report(
    records: List[Dict[str, Any]], by: str = "slo_class", bins: int = 0
) -> Dict[str, Any]:
    key = _group_key(by)
    score = score_requests(records, key=key)
    report = {
        "records": len(records),
        "by": by,
        "overall": _overall_metrics(records, score=score),
        "score": score,
    }
    if bins:
        report["bins"] = time_binned(records, bins=bins)
    return report


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

def _format_report(report: Dict[str, Any]) -> str:
    ov = report["overall"]
    score = report["score"]
    lines = [
        f"requests: {report['records']}   wall: {score['wall_s']:.3f}s",
        f"ttft p50/p99: {_fmt_s(ov['ttft_p50_s'])} / {_fmt_s(ov['ttft_p99_s'])}   "
        f"tpot p50/p99: {_fmt_s(ov['tpot_p50_s'])} / {_fmt_s(ov['tpot_p99_s'])}   "
        f"queue p50/p99: {_fmt_s(ov['queue_wait_p50_s'])} / {_fmt_s(ov['queue_wait_p99_s'])}",
        f"throughput: {ov['throughput_tokens_per_sec']:.1f} tok/s   "
        f"goodput: {ov['goodput_tokens_per_sec']:.1f} tok/s   "
        + (
            f"SLO attainment: {100.0 * ov['slo_attainment']:.1f}%"
            if ov["slo_attainment"] is not None else "SLO: not configured"
        ),
        "",
        f"{'group (' + report['by'] + ')':<22} {'reqs':>5} {'tokens':>8} "
        f"{'attain%':>8} {'goodput':>9} {'ttft p99':>10} {'queue p99':>10}  statuses",
        "-" * 96,
    ]
    for name, g in score["groups"].items():
        att = (
            f"{100.0 * g['slo_attainment']:.1f}"
            if g["slo_attainment"] is not None else "-"
        )
        statuses = ",".join(f"{k}:{v}" for k, v in sorted(g["by_status"].items()))
        lines.append(
            f"{(name or '(none)'):<22} {g['requests']:>5} {g['tokens']:>8} "
            f"{att:>8} {g['goodput_tokens_per_sec']:>9.1f} "
            f"{_fmt_s(g['ttft_p99_s']):>10} {_fmt_s(g['queue_wait_p99_s']):>10}  {statuses}"
        )
    for b in report.get("bins", []):
        if "bins" in report and b is report["bins"][0]:
            lines += [
                "",
                f"{'window':<18} {'arrivals':>8} {'queue':>10} {'prefill':>10} {'decode':>10}",
                "-" * 62,
            ]
        lines.append(
            f"[{b['t_start']:.2f}, {b['t_end']:.2f})  {b['arrivals']:>8} "
            f"{_fmt_s(b['queue_mean_s']):>10} {_fmt_s(b['prefill_mean_s']):>10} "
            f"{_fmt_s(b['decode_mean_s']):>10}"
        )
    return "\n".join(lines)


def _waterfall(rec: Dict[str, Any], width: int = 48) -> str:
    """One request's timeline as a scaled bar: ``.`` queue wait, ``#``
    prefill (admission → first token), ``=`` decode."""
    ph = request_phases(rec)
    total = ph["total_s"]
    head = (
        f"req {rec['id']:<5} tenant={rec.get('tenant') or '-':<10} "
        f"class={rec.get('slo_class') or '-':<12} {rec['status']:<10}"
    )
    if total is None or total <= 0:
        return f"{head} (no timeline: {rec.get('detail') or rec['status']})"
    def seg(v):  # noqa: E306
        return int(round((v or 0.0) / total * width))
    nq, npf = seg(ph["queue_s"]), seg(ph["prefill_s"])
    nd = max(0, width - nq - npf) if ph["decode_s"] is not None else 0
    bar = "." * nq + "#" * npf + "=" * nd
    slo = rec.get("slo") or {}
    met = slo.get("met")
    mark = "" if met is None else ("  SLO:met" if met else "  SLO:MISS")
    waits = rec.get("waits") or {}
    wtxt = (
        "  waited[" + ",".join(f"{k}:{v}" for k, v in sorted(waits.items())) + "]"
        if waits else ""
    )
    retry = f"  retries={rec['retries']}" if rec.get("retries") else ""
    return (
        f"{head} |{bar:<{width}}| queue {_fmt_s(ph['queue_s'])} "
        f"prefill {_fmt_s(ph['prefill_s'])} decode {_fmt_s(ph['decode_s'])} "
        f"({rec['n_tokens']} tok){mark}{wtxt}{retry}"
    )


# ---------------------------------------------------------------------------
# diff
# ---------------------------------------------------------------------------

def diff_reports(
    a: Dict[str, Any], b: Dict[str, Any], threshold_pct: float = 10.0
) -> Dict[str, Any]:
    """Compare two runs' overall metrics; B worse than A by more than
    ``threshold_pct`` on any axis is a regression."""
    rows, regressions = [], []
    for name, higher_better in _DIFF_METRICS:
        ma, mb = a.get(name), b.get(name)
        if ma is None or mb is None:
            continue
        delta = mb - ma
        pct = (delta / abs(ma) * 100.0) if ma else (0.0 if not delta else float("inf"))
        worse = -pct if higher_better else pct
        regressed = worse > threshold_pct
        row = {
            "metric": name, "a": ma, "b": mb,
            "delta_pct": None if pct == float("inf") else round(pct, 2),
            "regressed": regressed,
        }
        rows.append(row)
        if regressed:
            regressions.append(row)
    return {"threshold_pct": threshold_pct, "rows": rows, "regressions": regressions}


def _format_diff(report: Dict[str, Any]) -> str:
    lines = [
        f"{'metric':<28} {'A':>12} {'B':>12} {'delta %':>9}  flag",
        "-" * 70,
    ]
    for row in report["rows"]:
        pct = row["delta_pct"]
        lines.append(
            f"{row['metric']:<28} {row['a']:>12.5g} {row['b']:>12.5g} "
            f"{(f'{pct:+.1f}' if pct is not None else 'new'):>9}  "
            f"{'REGRESSED' if row['regressed'] else ''}"
        )
    n = len(report["regressions"])
    lines.append("-" * 70)
    lines.append(
        f"{n} regression(s) above {report['threshold_pct']:.1f}%"
        if n else "no regressions"
    )
    return "\n".join(lines)


# ---------------------------------------------------------------------------

def _attainment_gate(groups: Dict[str, Any], min_pct: float) -> int:
    """The --min-attainment gate over the WHOLE trace (applied in every
    mode, including --request / --diff): exit 1 when any group attains
    below ``min_pct``. Takes the already-computed score groups so one CLI
    invocation scores the record set exactly once."""
    below = {
        name: g["slo_attainment"]
        for name, g in groups.items()
        if g["slo_attainment"] is not None
        and g["slo_attainment"] * 100.0 < min_pct
    }
    if below:
        print(
            f"request_trace: attainment below {min_pct:.1f}%: "
            + ", ".join(f"{k}={100 * v:.1f}%" for k, v in below.items()),
            file=sys.stderr,
        )
        return 1
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.tools.request_trace",
        description="per-request waterfalls + SLO/goodput reports over "
                    "request-trace JSONL; exit 1 on a tripped gate",
    )
    p.add_argument("trace", help="request trace (JSONL from RequestTracer)")
    p.add_argument("--waterfall", type=int, default=0, metavar="N",
                   help="render the first N request timelines")
    p.add_argument("--request", type=int, default=None, metavar="ID",
                   help="render one request's timeline by id")
    p.add_argument("--bins", type=int, default=0,
                   help="time-binned queue/prefill/decode breakdown")
    p.add_argument("--by", choices=("slo_class", "tenant", "replica"),
                   default="slo_class",
                   help="grouping dimension of the aggregate report "
                        "(replica: the fleet replica that finished each "
                        "request)")
    p.add_argument("--min-attainment", type=float, default=None, metavar="PCT",
                   help="gate: exit 1 if any SLO class attains below PCT%%")
    p.add_argument("--diff", default=None, metavar="B_JSONL",
                   help="compare against a second trace; regressions exit 1")
    p.add_argument("--threshold-pct", type=float, default=10.0,
                   help="--diff regression threshold (%% worse than A)")
    p.add_argument("--json", action="store_true", help="emit JSON")
    args = p.parse_args(argv)
    try:
        records = load_request_records(args.trace)
    except (OSError, RequestTraceError) as e:
        print(f"request_trace: {e}", file=sys.stderr)
        return 2
    if not records:
        print(f"request_trace: {args.trace}: no request records", file=sys.stderr)
        return 2

    key = _group_key(args.by)

    def gate_early() -> int:
        """--min-attainment for the side modes (--request / --diff), which
        don't build the aggregate report: score once, gate on it."""
        if args.min_attainment is None:
            return 0
        return _attainment_gate(
            score_requests(records, key=key)["groups"], args.min_attainment
        )

    if args.request is not None:
        gate = gate_early()
        sel = [r for r in records if r.get("id") == args.request]
        if not sel:
            print(f"request_trace: no record with id {args.request}", file=sys.stderr)
            return 2
        print(json.dumps(sel[0], indent=1) if args.json else _waterfall(sel[0]))
        return gate

    if args.diff is not None:
        try:
            records_b = load_request_records(args.diff)
        except (OSError, RequestTraceError) as e:
            print(f"request_trace: {e}", file=sys.stderr)
            return 2
        if not records_b:
            print(f"request_trace: {args.diff}: no request records", file=sys.stderr)
            return 2
        report = diff_reports(
            _overall_metrics(records), _overall_metrics(records_b),
            threshold_pct=args.threshold_pct,
        )
        print(json.dumps(report, indent=1) if args.json else _format_diff(report))
        # evaluate the gate unconditionally: its stderr diagnostic (which
        # classes missed) must reach CI logs even when the diff already
        # fails the invocation
        gate = gate_early()
        return 1 if (report["regressions"] or gate) else 0

    report = build_report(records, by=args.by, bins=args.bins)
    out_lines = []
    if args.waterfall:
        out_lines += [_waterfall(r) for r in records[: args.waterfall]] + [""]
    if args.json:
        if out_lines:
            report["waterfalls"] = [ln for ln in out_lines if ln]
        print(json.dumps(report, indent=1))
    else:
        print("\n".join(out_lines) + _format_report(report))

    # the aggregate report already scored the records — gate on its groups
    return (
        _attainment_gate(report["score"]["groups"], args.min_attainment)
        if args.min_attainment is not None else 0
    )


if __name__ == "__main__":
    raise SystemExit(main())
