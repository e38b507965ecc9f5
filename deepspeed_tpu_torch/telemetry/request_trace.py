"""Request-lifecycle tracing: one span-structured JSONL record per serving
request (counterpart of ``deepspeed_tpu/telemetry/request_trace.py``; the
same ``dstpu-reqtrace-v1`` records, so either package's tools read the
other's files).

The serving engine (serving/scheduler.py) can see a *step*; until this plane
it could not see a *request* — three timestamps on the Request and
engine-wide histogram quantiles, no queue-wait attribution, no tenant
dimension, no causality between "this slot stalled" and "that request's
TTFT blew its SLO". The :class:`RequestTracer` records the full timeline:

- ``submit`` — arrival, with tenant / SLO class / prompt length,
- admission waits, attributed by cause (``page_budget`` — the KV pool gated
  the head of line; ``backoff`` — a retried request inside its backoff
  window; ``no_free_slot`` — all slots busy, i.e. queue depth),
- ``admit`` — queue wait ends; prefix-cache outcome (hit kind, shared
  tokens, copy-on-write fork) and pages allocated,
- ``prefill`` / ``prefill_chunk`` — whole-prompt or per-chunk prefill,
- ``first_token`` — TTFT (chunked prefill: the FIRST SAMPLED token, which
  the last chunk emits — not the last chunk's dispatch),
- ``decode`` / ``verify`` — one entry per slot per batched step, keyed by
  ``(step, slot)`` so entries correlate across requests sharing a batched
  step and with engine step records. Plain decode advances (1 token each)
  are a columnar ``[t, step, slot]`` series on the record — the
  highest-frequency span gets the leanest shape; verify events are full
  spans carrying emitted (up to k+1 at one instant) and drafted/accepted
  counts,
- ``retry`` — a transient failure evicted the slot and re-queued the
  request (deadline timeouts and drain preemptions emit no event; they
  land as the terminal record's ``status``),
- ``migration`` — the fleet moved a live decode session between
  replicas (``serving/fleet.py``): ``src``, ``dst``, ``pages``, ``bytes``
  and ``blackout_s`` when it landed; ``src``, ``dst`` ("" with no peer),
  ``status`` (``crc_failed`` | ``no_capacity``) and ``reason`` when it
  failed and the session restarted,
- ``requeue`` — the fleet restarted (or rerouted) the request on a peer:
  ``cause`` and the adopting ``replica``; ``cause`` alone when no replica
  could take it and it went PREEMPTED,
- ``kv_handoff`` — disaggregated serving (not ported yet; the JAX
  package's records may carry it): the prompt KV copied from the prefill
  placement's pool into the decode placement's,
- one terminal record per request: the event list plus derived summaries
  (queue wait, TTFT, per-emission timestamps → streaming-client inter-token
  gaps) and the SLO verdict against the request's class targets.

Records are schema-versioned (:data:`SCHEMA`) and emitted through the
existing :class:`~deepspeed_tpu_torch.telemetry.tracer.StepTracer` machinery, so
they inherit buffered appends, the size-capped atomic rotation
(``<file>.1``) and its locking. All recording is host-side list appends
on values the scheduler already holds on the host — no device reads, no
tensor ops — cheap enough to run always-on.

Scoring (:func:`score_requests`) turns a set of records into per-tenant /
per-SLO-class **goodput** (tokens from SLO-met requests per second of wall
clock) and **SLO attainment** (fraction of completed requests meeting both
TTFT and TPOT targets). The CLI (``tools/request_trace.py``, with
:func:`request_phases` and :func:`time_binned`)
renders waterfalls, aggregate reports and diffs from the same records.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from .registry import quantile_from_buckets
from .tracer import StepTracer

SCHEMA = "dstpu-reqtrace-v1"

# TTFT/TPOT/queue-wait histogram bucket bounds (seconds). The serving
# engine's latency histograms use EXACTLY these buckets
# (serving/scheduler.py imports them), so quantiles recomputed from a trace
# via histogram_quantile() reproduce ServingEngine.stats() — the acceptance
# cross-check the CLI and tests pin.
LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0,
)

# admission-wait causes the scheduler attributes (span catalog,
# docs/REQUEST_TRACING.md); backoff and kv_restore belong to serving
# retries and the host KV tier, which this package does not have yet
WAIT_CAUSES = ("no_free_slot", "page_budget", "backoff", "kv_restore")


class RequestTraceError(Exception):
    """A request-trace file that cannot be used: wrong schema or corrupt.
    The CLI exits 2 with the message instead of a traceback."""


class RequestTracer:
    """Per-request timeline recorder over the StepTracer JSONL machinery.

    Host-side buffering: live requests accumulate plain-python event dicts
    in ``_live``; a terminal request folds them into ONE record and hands it
    to the underlying :class:`StepTracer` (buffered append + size-capped
    atomic rotation).

    JSON encoding happens on a background daemon thread: a terminal record
    is ~2 timestamps per token and float dtoa dominates its encode cost, so
    ``finish()`` only appends the raw record and the serializer thread
    encodes it while the scheduler waits on the card (the GIL is released
    while it waits). ``flush()`` drains the
    thread; ``close()`` joins it.
    """

    def __init__(
        self,
        path: str,
        flush_interval: int = 20,
        max_bytes: int = 64 * 2**20,
        max_events_per_request: int = 4096,
        process_index: Optional[int] = None,
    ):
        if not path.endswith(".jsonl"):
            path = os.path.join(path, "requests.jsonl")
        self._writer = StepTracer(
            path,
            flush_interval=flush_interval,
            sample_every=1,
            process_index=process_index,
            max_bytes=max_bytes,
        )
        self.max_events_per_request = max(1, int(max_events_per_request))
        # main-thread-only state (the ServingEngine scheduler is single-
        # threaded by contract and is the sole event source): _live and the
        # ledger counters are written by the recording hooks and read by
        # stats() on the same thread — the hot per-step hooks are therefore
        # LOCK-FREE. The serializer thread touches none of this.
        # req id -> {"events": [...], "waits": {cause: steps}, "dropped": n}
        self._live: Dict[int, Dict[str, Any]] = {}
        self.status_counts: Dict[str, int] = {}
        self.records_emitted = 0
        self.events_dropped = 0
        # cross-thread state (under the lock): raw terminal records
        # awaiting background encode; _inflight counts a batch the
        # serializer popped but has not yet handed to the writer (flush()
        # must wait for those too).
        self._lock = StepTracer._new_lock()
        self._pending: List[Dict[str, Any]] = []
        self._inflight = 0
        self._closed = False
        self._draining = False
        # records dropped because encoding/writing failed (disk full, dir
        # removed) or because _pending hit its memory backstop
        self.records_lost = 0
        self._encode_error: Optional[str] = None
        # records per encode burst: the thread sleeps until this many are
        # pending (or a flush/close), then drains — not per-record wakes
        self._encode_batch = max(1, int(flush_interval))
        self._wake = threading.Event()
        self._thread = threading.Thread(
            target=self._serialize_loop, name="request-trace-serializer",
            daemon=True,
        )
        self._thread.start()

    # -- recording (scheduler-facing) ----------------------------------
    def submit(self, req, t: float) -> None:
        ev = {
            "e": "submit", "t": t,
            "prompt_len": req.prompt_len,
            "max_new_tokens": req.max_new_tokens,
        }
        # "room" counts event slots left under max_events_per_request: a
        # countdown int keeps the per-step cap check at one compare
        # instead of two len() calls (hot-path, every slot every step)
        self._live[req.id] = {
            "events": [ev], "decode": [], "waits": {}, "dropped": 0,
            "room": self.max_events_per_request - 1,
        }

    def note_wait(self, req, cause: str) -> None:
        """One scheduler step during which ``req`` stayed queued for
        ``cause`` (page_budget | backoff | no_free_slot). Aggregated as
        counts, not events — a long wait is one dict entry, not a record
        per step."""
        buf = self._live.get(req.id)
        if buf is not None:
            buf["waits"][cause] = buf["waits"].get(cause, 0) + 1

    def event(self, req, kind: str, t: float, **fields) -> None:
        # reuse the kwargs dict as the event record — one dict per event,
        # not two (this is a per-step hot path under a sub-ms step budget)
        fields["e"] = kind
        fields["t"] = t
        buf = self._live.get(req.id)
        if buf is None:
            return
        if buf["room"] <= 0:
            buf["dropped"] += 1
            self.events_dropped += 1
            return
        buf["room"] -= 1
        buf["events"].append(fields)

    def step_events(self, pairs: Sequence) -> None:
        """Batched ingestion of one scheduler step's verify events:
        ``pairs`` is ``[(request_id, event_dict), ...]`` with each event
        dict already in final ``{"e", "t", ...}`` shape — the scheduler
        builds dict literals straight into the batch, so the per-step
        tracer cost is a handful of appends."""
        live = self._live
        for rid, ev in pairs:
            buf = live.get(rid)
            if buf is None:
                continue
            if buf["room"] <= 0:
                buf["dropped"] += 1
                self.events_dropped += 1
                continue
            buf["room"] -= 1
            buf["events"].append(ev)

    def decode_events(self, pairs: Sequence) -> None:
        """Batched ingestion of one scheduler step's plain decode
        advances: ``pairs`` is ``[(request_id, (t, step, slot)), ...]``.
        Stored as the record's columnar ``decode`` series (one compact
        JSON triple per step, ``emitted`` is always 1) instead of an
        ``events[]`` dict per step — this is the hottest tracer path in
        the engine AND the bulk of a terminal record's encode cost, so it
        gets the leanest possible shape on both sides."""
        live = self._live
        for rid, tup in pairs:
            buf = live.get(rid)
            if buf is None:
                continue
            if buf["room"] <= 0:
                buf["dropped"] += 1
                self.events_dropped += 1
                continue
            buf["room"] -= 1
            buf["decode"].append(tup)

    def finish(self, req, t: float, slo: Optional[Dict[str, Any]] = None) -> None:
        """Terminal transition: fold the live buffer into one schema-v1
        record and emit it. ``slo`` is the scheduler's verdict block
        (targets + met flag), embedded so scoring needs no config."""
        buf = self._live.pop(
            req.id, {"events": [], "decode": [], "waits": {}, "dropped": 0}
        )
        self.status_counts[req.status] = self.status_counts.get(req.status, 0) + 1
        self.records_emitted += 1
        rec: Dict[str, Any] = {
            "kind": "request",
            "schema": SCHEMA,
            "id": req.id,
            "tenant": req.tenant,
            "slo_class": req.slo_class,
            # fleet replica that finished the request ("" = no fleet): the
            # router stamps it when it routes and restamps it on migration
            "replica": req.replica,
            "status": req.status,
            "detail": req.detail,
            "prompt_len": req.prompt_len,
            "max_new_tokens": req.max_new_tokens,
            "n_tokens": len(req.tokens),
            "retries": req.retries,
            "t_submit": req.t_submit,
            "t_admit": req.t_admit,
            "t_requeue": req.t_requeue,
            "t_first_token": req.t_first_token,
            "t_finish": t,
            "queue_wait_s": req.queue_wait_s,
            "ttft_s": req.ttft_s,
            "tpot_mean_s": req.tpot_s,
            "emissions": list(req.t_emissions),
            "prefix": {
                "shared_tokens": req.prefix_shared_tokens,
                "cow": bool(req.cow_forked),
            },
            "waits": buf["waits"],
            "events_dropped": buf["dropped"],
            "events": buf["events"],
            # plain decode advances, columnar: [[t, step, slot], ...] — one
            # entry per decode step, one token emitted at each
            "decode": buf["decode"],
        }
        if slo is not None:
            rec["slo"] = slo
        rec["ts"] = time.time()
        rec["host"] = self._writer.process_index
        # hand the RAW record to the serializer thread: the scheduler pays
        # one list append, not the float-heavy json encode. The thread is
        # only woken once a full encode batch piles up — low duty cycle, so
        # serving steps don't share cores with dtoa (flush() drains the
        # remainder). The backstop cap bounds memory if encoding can't
        # keep up (or the thread died): drop-oldest, counted.
        with self._lock:
            self._pending.append(rec)
            if len(self._pending) > 16 * self._encode_batch:
                del self._pending[0]
                self.records_lost += 1
            wake = len(self._pending) >= self._encode_batch
        if wake:
            self._wake.set()

    def _serialize_loop(self) -> None:
        """Background encoder: drain ``_pending`` batches, json-encode each
        record OUTSIDE the lock (the scheduler must never wait on a dumps)
        and hand the lines to the StepTracer. Every field is JSON-native by
        construction (the scheduler gives the tracer host scalars, never
        device arrays), so the StepTracer's defensive sanitize pass is
        skipped; ``default=str`` is the safety net."""
        # pending count at the previous idle-timeout check: a timeout only
        # drains when this is unchanged (the server went quiet). Waking on
        # a bare timeout would encode mid-burst and steal scheduler cores
        # whenever a serving span outlives the timeout window
        stale_pending = -1
        while True:
            # the timeout is only the durability backstop for a sub-batch
            # tail on an idle server (worst case two windows); every other
            # drain is event-driven (batch threshold, flush, close)
            timed_out = not self._wake.wait(timeout=2.0)
            self._wake.clear()
            while True:
                with self._lock:
                    # take only FULL batches while the server is live —
                    # nibbling records as they arrive would keep this
                    # thread hot for the whole run, contending for cores
                    # with the step; a flush/close/idle-drain takes the
                    # sub-batch tail
                    n = len(self._pending)
                    take = n > 0 and (
                        n >= self._encode_batch
                        or self._draining or self._closed
                        or (timed_out and n == stale_pending)
                    )
                    if take:
                        batch = self._pending
                        self._pending = []
                        self._inflight += len(batch)
                    elif self._closed:
                        return
                    else:
                        break
                handed = 0
                try:
                    for rec in batch:
                        self._writer.emit_serialized(
                            json.dumps(rec, default=str)
                        )
                        handed += 1
                except Exception as e:  # noqa: BLE001 — daemon must survive
                    # a full disk / vanished trace dir must not silently
                    # kill the serializer (finish() would then grow
                    # _pending forever while flush() reports success);
                    # count the unhanded tail lost (records already in the
                    # writer buffer may still reach disk) and keep serving
                    with self._lock:
                        self.records_lost += len(batch) - handed
                        self._encode_error = f"{type(e).__name__}: {e}"
                finally:
                    with self._lock:
                        self._inflight -= len(batch)
            if timed_out:
                with self._lock:
                    stale_pending = len(self._pending)
            else:
                # an event-driven wake means the server is live again;
                # require a fresh full quiet window before an idle drain
                stale_pending = -1

    # -- plumbing ------------------------------------------------------
    def flush(self) -> None:
        """Blocks until every record handed to :meth:`finish` is encoded
        and buffered in the writer, then flushes the writer to disk."""
        with self._lock:
            self._draining = True
        try:
            while self._thread.is_alive():
                with self._lock:
                    if not self._pending and self._inflight == 0:
                        break
                self._wake.set()
                time.sleep(0.0005)
        finally:
            with self._lock:
                self._draining = False
        self._writer.flush()

    def close(self) -> None:
        with self._lock:
            self._closed = True
        self._wake.set()
        self._thread.join(timeout=5.0)
        self._writer.close()

    @property
    def file_path(self) -> str:
        return self._writer.file_path

    @property
    def rotations(self) -> int:
        return self._writer.rotations

    @property
    def live_requests(self) -> int:
        with self._lock:
            return len(self._live)

    @property
    def encode_error(self) -> Optional[str]:
        """Last serializer failure ("Type: message"), None when healthy —
        the why behind a nonzero ``records_lost``."""
        with self._lock:
            return self._encode_error


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------

def load_request_records(path: str) -> List[Dict[str, Any]]:
    """The ``kind == "request"`` records of one JSONL trace, in file order.

    Same tolerance contract as the JAX package's ``tools/trace_diff.py``:
    one torn TAIL line
    (killed run, mid-rotation) is fine; torn lines elsewhere, binary
    garbage, or records claiming an unknown schema raise
    :class:`RequestTraceError`. A rolled generation (``<file>.1``) is read
    first when present, so a rotated run scores over its full history.

    One path = one logical stream: the writer APPENDS (StepTracer
    contract), so pointing a fresh run at a used path concatenates runs —
    in the main file and the rolled generation alike. Give each run a
    fresh path (or clear the directory) when runs
    must score separately."""
    paths = [p for p in (path + ".1", path) if os.path.exists(p)]
    if not paths:
        raise RequestTraceError(f"{path}: no such trace file")
    out: List[Dict[str, Any]] = []
    for p in paths:
        torn: List[int] = []
        try:
            with open(p, encoding="utf-8") as fh:
                lines = fh.readlines()
        except UnicodeDecodeError as e:
            raise RequestTraceError(
                f"{p}: not a text JSONL trace ({e.reason} at byte {e.start})"
            ) from e
        for lineno, line in enumerate(lines, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                torn.append(lineno)
                continue
            if not isinstance(rec, dict):
                raise RequestTraceError(
                    f"{p}:{lineno}: JSON line is {type(rec).__name__}, not "
                    "an object — this is not a request trace"
                )
            if rec.get("kind") != "request":
                continue  # step/event records share the telemetry dir
            schema = rec.get("schema")
            if schema != SCHEMA:
                raise RequestTraceError(
                    f"{p}:{lineno}: schema {schema!r} != {SCHEMA!r} — trace "
                    "written by an incompatible version"
                )
            out.append(rec)
        if torn and torn != [len(lines)]:
            raise RequestTraceError(
                f"{p}: {len(torn)} undecodable line(s) (first at line "
                f"{torn[0]}) — truncated or corrupt beyond a torn tail"
            )
    return out


# ---------------------------------------------------------------------------
# derived latencies + quantiles
# ---------------------------------------------------------------------------

def inter_token_gaps(emissions: Sequence[float]) -> List[float]:
    """Streaming-client inter-token deltas from per-emission timestamps.
    Tokens emitted by one speculative verify step share a timestamp, so
    their gaps are 0 — the client really does receive them at once."""
    return [emissions[i] - emissions[i - 1] for i in range(1, len(emissions))]


def queue_waits(rec: Dict[str, Any]) -> List[float]:
    """EVERY admission's queue wait for one record. A retried request is
    admitted more than once and ``serving_queue_wait_seconds`` observed
    each admission; the summary ``queue_wait_s`` field keeps only the
    final one, but the ``admit`` events carry them all — scoring from
    these keeps trace-derived quantiles equal to ``stats()`` under
    retries."""
    waits = [
        e["queue_wait_s"] for e in rec.get("events") or []
        if e.get("e") == "admit" and e.get("queue_wait_s") is not None
    ]
    if waits:
        return waits
    qw = rec.get("queue_wait_s")
    return [qw] if qw is not None else []


def ttfts(rec: Dict[str, Any]) -> List[float]:
    """EVERY attempt's TTFT for one record — the retry twin of
    :func:`queue_waits`: an attempt that emitted a first token before a
    transient failure observed ``serving_ttft_seconds`` and cannot
    un-observe, and its ``first_token`` event carries that ``ttft_s``; the
    summary field keeps only the final attempt's."""
    vals = [
        e["ttft_s"] for e in rec.get("events") or []
        if e.get("e") == "first_token" and e.get("ttft_s") is not None
    ]
    if vals:
        return vals
    tt = rec.get("ttft_s")
    return [tt] if tt is not None else []


def histogram_quantile(
    values: Sequence[float], q: float,
    buckets: Sequence[float] = LATENCY_BUCKETS,
) -> Optional[float]:
    """The Prometheus ``histogram_quantile`` estimator over ``values``
    bucketed into ``buckets`` — literally
    :func:`telemetry.registry.quantile_from_buckets`, the same code
    :meth:`~telemetry.registry.Histogram.quantile` runs, so trace-derived
    quantiles reproduce the engine's own ``stats()``."""
    if not values:
        return None
    bs = list(buckets)
    if not bs or bs[-1] != float("inf"):
        bs = bs + [float("inf")]
    counts = [0] * len(bs)
    for v in values:
        for i, b in enumerate(bs):
            if v <= b:
                counts[i] += 1
    return quantile_from_buckets(bs, counts, len(values), q)


def request_phases(rec: Dict[str, Any]) -> Dict[str, Optional[float]]:
    """One record's queue / prefill / decode phase durations (seconds).
    ``prefill`` = admission → first sampled token (chunked prefill included:
    every chunk is prefill work); ``decode`` = first token → finish. A
    retried request's queue phase measures from its re-queue (the failed
    attempt's service time is not admission pressure — the phases then sum
    short of ``total_s`` by exactly that attempt's span)."""
    ts, ta = rec.get("t_submit"), rec.get("t_admit")
    tf, te = rec.get("t_first_token"), rec.get("t_finish")
    tq = rec.get("t_requeue")
    q0 = tq if tq is not None else ts
    return {
        "queue_s": (ta - q0) if ta is not None and q0 is not None else None,
        "prefill_s": (tf - ta) if tf is not None and ta is not None else None,
        "decode_s": (te - tf) if te is not None and tf is not None else None,
        "total_s": (te - ts) if te is not None and ts is not None else None,
    }


def slo_met(rec: Dict[str, Any]) -> Optional[bool]:
    """The record's embedded SLO verdict; None when the run had no SLO
    config (nothing to attain) or the request never completed cleanly."""
    slo = rec.get("slo")
    if not slo:
        return None
    return slo.get("met")


# ---------------------------------------------------------------------------
# scoring: goodput + SLO attainment
# ---------------------------------------------------------------------------

def score_requests(
    records: Sequence[Dict[str, Any]],
    key: Callable[[Dict[str, Any]], str] = lambda r: r.get("slo_class") or "",
) -> Dict[str, Any]:
    """Aggregate a set of request records into goodput / SLO-attainment /
    latency summaries, grouped by ``key`` (default: SLO class; pass
    ``lambda r: r["tenant"]`` for the tenant view).

    Definitions (docs/REQUEST_TRACING.md):

    - **attainment** — SLO-met requests / SLO-evaluated requests. A
      request is evaluated when it reached ANY terminal status and its
      class declared targets; only FINISHED requests can meet, so
      rejections/timeouts/failures count as misses (capacity pressure IS
      an SLO breach — matching ``ServingEngine._slo_verdict``).
    - **goodput** — tokens of SLO-met requests / wall-clock span of the
      whole record set (first submit → last finish). Tokens from late or
      failed requests are throughput, not goodput.
    - latency quantiles use :func:`histogram_quantile`, matching
      ``ServingEngine.stats()``.
    """
    if not records:
        return {"wall_s": 0.0, "groups": {}, "overall": None}
    t0 = min(r["t_submit"] for r in records if r.get("t_submit") is not None)
    t1 = max(r["t_finish"] for r in records if r.get("t_finish") is not None)
    wall = max(t1 - t0, 1e-12)
    groups: Dict[str, Dict[str, Any]] = {}
    for rec in records:
        g = groups.setdefault(str(key(rec)), {
            "requests": 0, "by_status": {}, "tokens": 0,
            "evaluated": 0, "met": 0, "good_tokens": 0,
            "_ttft": [], "_tpot_gaps": [], "_qwait": [],
        })
        g["requests"] += 1
        g["by_status"][rec["status"]] = g["by_status"].get(rec["status"], 0) + 1
        g["tokens"] += int(rec.get("n_tokens") or 0)
        g["_ttft"].extend(ttfts(rec))
        g["_qwait"].extend(queue_waits(rec))
        # FAILED records keep their partial attempt's emissions in the
        # trace, but the engine only observes inter-token gaps on the
        # _finish_slot path (finished/truncated/deadline-preempted) —
        # skip them here so trace-derived TPOT reproduces stats()
        if rec["status"] != "failed":
            g["_tpot_gaps"].extend(
                inter_token_gaps(rec.get("emissions") or [])
            )
        met = slo_met(rec)
        if met is not None:
            g["evaluated"] += 1
            if met:
                g["met"] += 1
                g["good_tokens"] += int(rec.get("n_tokens") or 0)
    out_groups = {}
    tot_eval = tot_met = tot_good = tot_tokens = 0
    all_ttft: List[float] = []
    all_gaps: List[float] = []
    all_qwait: List[float] = []
    for name, g in sorted(groups.items()):
        entry = {
            "requests": g["requests"],
            "by_status": g["by_status"],
            "tokens": g["tokens"],
            "slo_evaluated": g["evaluated"],
            "slo_met": g["met"],
            "slo_attainment": (g["met"] / g["evaluated"]) if g["evaluated"] else None,
            "goodput_tokens_per_sec": g["good_tokens"] / wall,
            "throughput_tokens_per_sec": g["tokens"] / wall,
        }
        for metric, vals in (
            ("ttft", g["_ttft"]), ("tpot", g["_tpot_gaps"]), ("queue_wait", g["_qwait"]),
        ):
            entry[f"{metric}_p50_s"] = histogram_quantile(vals, 0.5)
            entry[f"{metric}_p99_s"] = histogram_quantile(vals, 0.99)
        out_groups[name] = entry
        tot_eval += g["evaluated"]
        tot_met += g["met"]
        tot_good += g["good_tokens"]
        tot_tokens += g["tokens"]
        all_ttft.extend(g["_ttft"])
        all_gaps.extend(g["_tpot_gaps"])
        all_qwait.extend(g["_qwait"])
    overall = {
        "requests": len(records),
        "tokens": tot_tokens,
        "slo_evaluated": tot_eval,
        "slo_met": tot_met,
        "slo_attainment": (tot_met / tot_eval) if tot_eval else None,
        "goodput_tokens_per_sec": tot_good / wall,
        "throughput_tokens_per_sec": tot_tokens / wall,
    }
    # run-level latency quantiles ride along so callers (CLI report/diff)
    # score the record set ONCE instead of re-walking every record
    for metric, vals in (
        ("ttft", all_ttft), ("tpot", all_gaps), ("queue_wait", all_qwait),
    ):
        overall[f"{metric}_p50_s"] = histogram_quantile(vals, 0.5)
        overall[f"{metric}_p99_s"] = histogram_quantile(vals, 0.99)
    return {
        "wall_s": wall,
        "groups": out_groups,
        "overall": overall,
    }


def time_binned(
    records: Sequence[Dict[str, Any]], bins: int = 10
) -> List[Dict[str, Any]]:
    """Bin records by submit time into ``bins`` equal windows; per bin the
    mean queue/prefill/decode split and the arrival count — the bursty
    replay workload's load/latency shape at a glance."""
    recs = [r for r in records if r.get("t_submit") is not None]
    if not recs:
        return []
    t0 = min(r["t_submit"] for r in recs)
    t1 = max(r["t_submit"] for r in recs)
    width = max((t1 - t0) / max(1, bins), 1e-12)
    out = []
    for b in range(bins):
        lo, hi = t0 + b * width, t0 + (b + 1) * width
        # the last bin is closed above by ">= lo" alone: recomputing its
        # upper edge as t0 + bins*width can land a float ulp BELOW the true
        # max submit time, which would silently drop the latest arrival
        last = b == bins - 1
        sel = [
            r for r in recs
            if (r["t_submit"] >= lo if last else lo <= r["t_submit"] < hi)
        ]
        phases = [request_phases(r) for r in sel]

        def _mean(k):
            vals = [p[k] for p in phases if p[k] is not None]
            return (sum(vals) / len(vals)) if vals else None
        out.append({
            "t_start": lo,
            "t_end": hi,
            "arrivals": len(sel),
            "queue_mean_s": _mean("queue_s"),
            "prefill_mean_s": _mean("prefill_s"),
            "decode_mean_s": _mean("decode_s"),
        })
    return out
