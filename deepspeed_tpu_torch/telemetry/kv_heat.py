"""Page-lifetime & session-heat tracing: the memory measurement plane for
KV tiering (counterpart of ``deepspeed_tpu/telemetry/kv_heat.py``; the same
``dstpu-kvheat-v1`` records, so either package's replay reads the other's
files).

The host KV tier (``serving/tiering.py``) needs a signal nothing else
measures: which pages are *hot*, which sessions are *idle*, and how big the
true working set is versus the resident set. This module records a per-page
lifecycle event stream and derives the cold-fraction / idle-age curves the
tier ships against.

Architecture — one :class:`KVHeatLedger` per pool (placement), composed by
one :class:`KVHeatTracer` per engine:

- The **ledger** is the lock-free main-thread half. ``PageAllocator`` /
  ``PrefixCache`` / the scheduler each hold it as an optional ``heat``
  attribute (one None check when tracing is off) and
  call plain-append hooks: ``alloc``/``retain``/``free`` from the
  allocator, ``register``/``hit``/``evict`` from the prefix index,
  ``session_start``/``session_end``/``touch_step`` from the scheduler.
  Each hook both appends a compact event tuple to the segment buffer AND
  updates derived state (a refcount mirror, the prefix-held set, per-page
  last-touch, per-slot session activity) — so live gauges need no trace
  round-trip and the fuzz harness can :meth:`~KVHeatLedger.reconcile` the
  mirror bit-exactly against ``PageAllocator.check_consistent()`` state
  after every op.
- The **tracer** owns the JSONL emission: sealed segments ride the
  existing :class:`~deepspeed_tpu_torch.telemetry.tracer.StepTracer` machinery
  (buffered appends, size-capped atomic rotation to ``<file>.1``,
  locking) and a background daemon thread does the ``json.dumps`` — the
  scheduler pays list appends, never dtoa (the RequestTracer serializer
  pattern).

Event encoding (schema :data:`SCHEMA`). Per-pool ``kv_heat`` records carry
two columnar series:

- ``events`` — low-frequency lifecycle tuples::

      ["A", t, [pages...]]                  alloc (refcount 1 each)
      ["R", t, [pages...]]                  retain (+1 ref each)
      ["F", t, [pages...]]                  free (-1 ref each)
      ["G", t, [pages...]]                  prefix index registered pages
      ["H", t, [pages...], kind]            prefix lookup hit (full/partial)
      ["E", t, page]                        prefix index evicted page
      ["S", t, slot, rid, tenant, [pages]]  session start (block-table order)
      ["X", t, slot]                        session end
      ["B", t, [[page, refs]...], [prefix]] attach-time state snapshot

- ``touches`` — the hottest hook gets the leanest shape (the request
  trace's columnar decode series rule): one ``[t, step, [[slot, write_page, n_pages]...]]`` entry
  per decode step, one inner triple per active slot. ``write_page`` is the
  page the step's KV write landed in; ``n_pages`` the slot's attended
  block-table prefix length — with the session's ``S`` page list this
  reconstructs the full per-page touch set offline without serializing it
  per step.

All timestamps come from the engine's injectable clock, and the records
carry NO wall-clock field — the same traffic under a stepped clock produces
a byte-deterministic stream.

Offline, :func:`load_heat_records` (same tolerance contract as the request
trace: rolled ``.1`` generation first, one torn tail line forgiven) feeds
:func:`replay_heat` — which reconstructs a ledger at any point in trace
time — and :func:`evaluate_spill_policies`, the **what-if evaluator**: the
recorded stream replayed against a hypothetically smaller resident set
under candidate eviction policies (idle-age LRU / prefix-aware /
slot-priority), reporting the restore stalls and host traffic each policy
would have cost. The JAX package's CLI (``tools/kv_heat.py``) renders
reports, page timelines, pool heatmaps, diffs and gates from the same
records. The host tier emits its events through the hooks: ``D`` (a page
demoted to a host handle, before the page's F/E pair), ``U`` (a handle
restored into a page) and ``V`` (a handle dropped from the host).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from .registry import quantile_from_buckets
from .tracer import StepTracer

SCHEMA = "dstpu-kvheat-v1"

# default idle-age thresholds (seconds) for the cold-page-fraction gauges —
# configurable via telemetry.kv_heat.idle_thresholds_s
IDLE_THRESHOLDS_S = (1.0, 5.0, 30.0)

# page-lifetime histogram bounds (seconds): lifetimes span request service
# times, the same band the serving latency buckets cover
LIFETIME_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0,
)

SPILL_POLICIES = ("idle_lru", "prefix_aware", "slot_priority")


class KVHeatError(Exception):
    """A heat-trace file that cannot be used: wrong schema or corrupt.
    The CLI exits 2 with the message instead of a traceback."""


# ---------------------------------------------------------------------------
# the per-pool ledger: lock-free hooks + derived mirror state
# ---------------------------------------------------------------------------


class KVHeatLedger:
    """One pool's heat state: event buffer + derived accounting mirror.

    Main-thread only (the ServingEngine scheduler is single-threaded by
    contract and is the sole event source) — every hook is plain dict/list
    work, no locks, no device syncs. A ledger is usable standalone (the
    lockstep fuzz drives one with ``sink=None``: derived state updates,
    nothing buffers); under a :class:`KVHeatTracer` sink, full segments are
    sealed into the tracer's encode queue.
    """

    def __init__(
        self,
        pool: str,
        capacity: int,
        *,
        clock: Callable[[], float] = time.monotonic,
        page_bytes: int = 0,
        page_size: int = 0,
        sink: Optional["KVHeatTracer"] = None,
        segment_events: int = 256,
    ):
        self.pool = str(pool)
        self.capacity = int(capacity)
        self.page_bytes = int(page_bytes)
        self.page_size = int(page_size)
        self._clock = clock
        self._sink = sink
        self._segment_events = max(1, int(segment_events))
        # -- derived mirror (reconciles against PageAllocator/PrefixCache) --
        self.refs: Dict[int, int] = {}          # page -> refcount
        self.prefix_pages: Set[int] = set()     # pages the prefix index holds
        self.page_alloc_t: Dict[int, float] = {}  # page -> current lease start
        self.page_last: Dict[int, float] = {}   # page -> last direct touch
        self.owner: Dict[int, int] = {}         # page -> owning slot
        # slot -> {"rid", "tenant", "t0", "last"}
        self.sessions: Dict[int, Dict[str, Any]] = {}
        # -- counters -------------------------------------------------------
        self.allocs = 0
        self.frees = 0
        self.retains = 0
        self.prefix_registered = 0
        self.prefix_hits = 0
        self.prefix_evictions = 0
        self.touch_steps = 0
        self.sessions_started = 0
        self.sessions_ended = 0
        # -- host-tier mirror ------------------------------------------------
        # live host handles (reconciles against HostPageStore.handles())
        self.host_handles: Set[int] = set()
        self.demotions = 0
        self.restores_up = 0
        self.host_drops = 0
        # -- segment buffers (sealed into the sink) -------------------------
        self._events: List[Tuple] = []
        self._touches: List[Tuple] = []
        self._seq = 0

    # -- internal ------------------------------------------------------
    def _ev(self, ev: Tuple) -> None:
        if self._sink is None:
            return
        self._events.append(ev)
        if len(self._events) + len(self._touches) >= self._segment_events:
            self._sink._seal(self)

    # -- attach-time seeding -------------------------------------------
    def seed(self, refs: Dict[int, int], prefix_pages: Sequence[int],
             t: float) -> None:
        """Snapshot the pool's CURRENT state into the mirror (and the
        stream, as a ``B`` event) — attaching mid-run must reconcile from
        the first event, and an offline replay must start from the same
        point the live ledger did."""
        self.refs = {int(p): int(c) for p, c in refs.items()}
        self.prefix_pages = {int(p) for p in prefix_pages}
        for p in self.refs:
            self.page_alloc_t[p] = t
            self.page_last[p] = t
        self._ev((
            "B", t, sorted([p, c] for p, c in self.refs.items()),
            sorted(self.prefix_pages),
        ))

    # -- allocator-facing hooks (PageAllocator.heat) -------------------
    def alloc(self, pages: Sequence[int]) -> None:
        t = self._clock()
        refs, at, last = self.refs, self.page_alloc_t, self.page_last
        for p in pages:
            refs[p] = 1
            at[p] = t
            last[p] = t
        self.allocs += len(pages)
        self._ev(("A", t, list(pages)))

    def retain(self, pages: Sequence[int]) -> None:
        t = self._clock()
        refs, last = self.refs, self.page_last
        for p in pages:
            p = int(p)
            refs[p] = refs.get(p, 0) + 1
            last[p] = t
        self.retains += len(pages)
        self._ev(("R", t, [int(p) for p in pages]))

    def free(self, pages: Sequence[int]) -> None:
        t = self._clock()
        refs = self.refs
        ids = []
        for p in pages:
            p = int(p)
            ids.append(p)
            c = refs.get(p)
            if c is None:
                # a pool freeing pages leased before this ledger attached
                # (no B snapshot covered them) — tolerated, not mirrored
                continue
            if c > 1:
                refs[p] = c - 1
            else:
                del refs[p]
                t0 = self.page_alloc_t.pop(p, None)
                self.page_last.pop(p, None)
                self.owner.pop(p, None)
                self.prefix_pages.discard(p)
                if self._sink is not None and t0 is not None:
                    self._sink._observe_lifetime(self.pool, t - t0)
        self.frees += len(ids)
        self._ev(("F", t, ids))

    # -- prefix-index-facing hooks (PrefixCache.heat) ------------------
    def register(self, pages: Sequence[int]) -> None:
        t = self._clock()
        self.prefix_pages.update(int(p) for p in pages)
        self.prefix_registered += len(pages)
        self._ev(("G", t, [int(p) for p in pages]))

    def hit(self, pages: Sequence[int], kind: str) -> None:
        t = self._clock()
        last = self.page_last
        for p in pages:
            last[int(p)] = t
        self.prefix_hits += 1
        self._ev(("H", t, [int(p) for p in pages], kind))

    def evict(self, page: int) -> None:
        t = self._clock()
        self.prefix_pages.discard(int(page))
        self.prefix_evictions += 1
        self._ev(("E", t, int(page)))

    # -- host-tier-facing hooks (the KV tier's ledger) ----------------------
    def demote(self, page: int, hid: int) -> None:
        """Device page ``page`` is spilling to host handle ``hid``. Emitted
        BEFORE the device-side free's F/E pair (PrefixCache._evict_one), so
        every trace prefix shows the page owned by at least one tier."""
        t = self._clock()
        self.host_handles.add(int(hid))
        self.demotions += 1
        self._ev(("D", t, int(page), int(hid)))

    def restore_up(self, hid: int, page: int) -> None:
        """Host handle ``hid`` restored into freshly allocated device page
        ``page`` — the host copy retires (exactly-one-tier)."""
        t = self._clock()
        self.host_handles.discard(int(hid))
        self.page_last[int(page)] = t
        self.restores_up += 1
        self._ev(("U", t, int(hid), int(page)))

    def host_drop(self, hid: int) -> None:
        """Host handle ``hid`` evicted from the host tier (LRU pressure) —
        the page now lives in NEITHER tier; a future hit is a cold miss."""
        t = self._clock()
        self.host_handles.discard(int(hid))
        self.host_drops += 1
        self._ev(("V", t, int(hid)))

    # -- scheduler-facing hooks ----------------------------------------
    def session_start(self, t: float, slot: int, rid: int, tenant: str,
                      pages: Sequence[int]) -> None:
        """A request took a slot: ``pages`` is its reservation in
        block-table order (the touch series' ``n_pages`` prefix indexes
        into it offline)."""
        pages = [int(p) for p in pages]
        self.sessions[slot] = {"rid": rid, "tenant": tenant, "t0": t, "last": t}
        owner = self.owner
        for p in pages:
            owner[p] = slot
        self.sessions_started += 1
        self._ev(("S", t, int(slot), rid, tenant, pages))

    def session_end(self, t: float, slot: int) -> None:
        self.sessions.pop(slot, None)
        self.sessions_ended += 1
        self._ev(("X", t, int(slot)))

    def touch_step(self, t: float, step: int, batch: Sequence[Tuple]) -> None:
        """One decode step's write/attend touches, columnar:
        ``batch = [(slot, write_page, n_pages), ...]``. The hottest hook in
        the plane — per step it costs one tuple append plus two dict writes
        per active slot."""
        sessions, last = self.sessions, self.page_last
        for slot, wp, _n in batch:
            ss = sessions.get(slot)
            if ss is not None:
                ss["last"] = t
            last[wp] = t
        self.touch_steps += 1
        if self._sink is not None:
            # shallow copy only: the per-slot tuples are immutable and
            # JSON-serialize exactly like lists (the hot hook — every
            # decode step pays this line)
            self._touches.append((t, step, list(batch)))
            if len(self._events) + len(self._touches) >= self._segment_events:
                self._sink._seal(self)

    # -- derived views -------------------------------------------------
    @property
    def pages_in_use(self) -> int:
        return len(self.refs)

    @property
    def free_count(self) -> int:
        return self.capacity - len(self.refs)

    def occupancy(self, now: float,
                  thresholds: Sequence[float] = IDLE_THRESHOLDS_S) -> Dict[str, Any]:
        """The pool's occupancy split + heat summary at ``now``:
        ``pages`` by category (``active`` — owned by a live session;
        ``prefix`` — else held by the prefix index; ``shared`` — else
        refcount > 1; ``other`` — in use, unattributed; ``free``),
        ``cold_fraction`` per idle threshold (a page is hot if its owning
        session was active, or it was directly touched, within the
        threshold) and free-list ``fragmentation``."""
        refs = self.refs
        sessions = self.sessions
        cat = {"active": 0, "prefix": 0, "shared": 0, "other": 0}
        cold = {th: 0 for th in thresholds}
        last = self.page_last
        owner = self.owner
        for p, c in refs.items():
            slot = owner.get(p)
            ss = sessions.get(slot) if slot is not None else None
            if ss is not None:
                cat["active"] += 1
            elif p in self.prefix_pages:
                cat["prefix"] += 1
            elif c > 1:
                cat["shared"] += 1
            else:
                cat["other"] += 1
            hot_t = ss["last"] if ss is not None else None
            pl = last.get(p)
            if pl is not None and (hot_t is None or pl > hot_t):
                hot_t = pl
            age = now - hot_t if hot_t is not None else float("inf")
            for th in thresholds:
                if age > th:
                    cold[th] += 1
        in_use = len(refs)
        return {
            "pages": {**cat, "free": self.capacity - in_use},
            "pages_in_use": in_use,
            "capacity": self.capacity,
            "cold_fraction": {
                str(th): (cold[th] / in_use) if in_use else None
                for th in thresholds
            },
            "fragmentation": self.fragmentation(),
            "sessions": len(sessions),
        }

    def fragmentation(self) -> float:
        """1 − (longest run of consecutive free page ids / free pages): 0.0
        when the free ids form one contiguous block (or the pool is full) —
        the page granularity makes this advisory (any page serves any
        request), but a scattered free set is exactly what a future
        contiguous host-spill DMA would pay for."""
        in_use = self.refs
        free = [p for p in range(1, self.capacity + 1) if p not in in_use]
        if not free:
            return 0.0
        longest = run = 1
        for i in range(1, len(free)):
            run = run + 1 if free[i] == free[i - 1] + 1 else 1
            if run > longest:
                longest = run
        return 1.0 - longest / len(free)

    def session_idle_ages(self, now: float) -> List[float]:
        return [now - ss["last"] for ss in self.sessions.values()]

    def reconcile(self, allocator, prefix_cache=None,
                  host_store=None) -> Optional[str]:
        """Bit-exact cross-check of the derived mirror against the live
        allocator (and prefix index): the lockstep acceptance.
        Returns None when they agree, else a one-line mismatch."""
        err = allocator.check_consistent()
        if err is not None:
            return f"allocator corrupt: {err}"
        theirs = allocator.refcounts()
        if self.refs != theirs:
            diff = {
                p: (self.refs.get(p), theirs.get(p))
                for p in set(self.refs) | set(theirs)
                if self.refs.get(p) != theirs.get(p)
            }
            return f"refcount mirror diverged: {dict(sorted(diff.items())[:4])}"
        if self.free_count != allocator.free_pages:
            return (
                f"free accounting diverged: ledger {self.free_count} != "
                f"allocator {allocator.free_pages}"
            )
        if prefix_cache is not None:
            held = {int(p) for p in prefix_cache.held_pages}
            if self.prefix_pages != held:
                return (
                    f"prefix-held mirror diverged: ledger "
                    f"{sorted(self.prefix_pages)[:6]} != index {sorted(held)[:6]}"
                )
        if host_store is not None:
            theirs = host_store.handles()
            if self.host_handles != theirs:
                return (
                    f"host-handle mirror diverged: ledger "
                    f"{sorted(self.host_handles)[:6]} != store "
                    f"{sorted(theirs)[:6]}"
                )
        return None

    def ledger_bytes(self) -> int:
        """Rough host-side footprint of the mirror + segment buffers — the
        heat plane's own entry in the host-metadata budget (satellite 1)."""
        total = 0
        for d in (self.refs, self.page_alloc_t, self.page_last, self.owner):
            total += sys.getsizeof(d) + 56 * len(d)
        total += sys.getsizeof(self.prefix_pages) + 28 * len(self.prefix_pages)
        total += sys.getsizeof(self.host_handles) + 28 * len(self.host_handles)
        total += sys.getsizeof(self.sessions) + 256 * len(self.sessions)
        total += sys.getsizeof(self._events) + 96 * len(self._events)
        total += sys.getsizeof(self._touches) + 96 * len(self._touches)
        return total


# ---------------------------------------------------------------------------
# the tracer: pools + background JSONL emission
# ---------------------------------------------------------------------------


class KVHeatTracer:
    """Per-engine heat-event emitter over the StepTracer JSONL machinery.

    Owns one :class:`KVHeatLedger` per pool (placement) and the encode
    pipeline: sealed segments queue under a lock and a daemon thread
    json-encodes them (the RequestTracer serializer pattern — the
    scheduler never waits on a dumps; a drop-oldest backstop bounds memory
    and counts ``records_lost``). ``bind_registry`` wires the derived
    gauges; the scheduler refreshes them through :meth:`refresh_gauges`.
    """

    def __init__(
        self,
        path: str,
        flush_interval: int = 20,
        max_bytes: int = 64 * 2**20,
        segment_events: int = 256,
        idle_thresholds_s: Sequence[float] = IDLE_THRESHOLDS_S,
        process_index: Optional[int] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if not path.endswith(".jsonl"):
            path = os.path.join(path, "kv_heat.jsonl")
        self._writer = StepTracer(
            path,
            flush_interval=flush_interval,
            sample_every=1,
            process_index=process_index,
            max_bytes=max_bytes,
        )
        self.clock = clock
        self.idle_thresholds_s = tuple(float(t) for t in idle_thresholds_s)
        self._segment_events = max(1, int(segment_events))
        self._ledgers: Dict[str, KVHeatLedger] = {}
        self.records_emitted = 0
        # registry families (bind_registry); None until an engine attaches
        self._g_pages = None
        self._g_cold = None
        self._g_frag = None
        self._g_idle = None
        self._g_bytes = None
        self._h_lifetime = None
        # (pool, dt) lifetime observations deferred out of the free() hook
        # — drained into the histogram at gauge-refresh/flush cadence
        self._pending_lifetimes: List[Tuple[str, float]] = []
        # cross-thread encode queue (under the lock)
        self._lock = StepTracer._new_lock()
        self._pending: List[Dict[str, Any]] = []
        self._inflight = 0
        self._closed = False
        self._draining = False
        self.records_lost = 0
        self._encode_error: Optional[str] = None
        self._encode_batch = max(1, int(flush_interval))
        self._wake = threading.Event()
        self._thread = threading.Thread(
            target=self._serialize_loop, name="kv-heat-serializer", daemon=True,
        )
        self._thread.start()

    # -- pools ---------------------------------------------------------
    def pool(self, name: str, capacity: int, *, page_size: int = 0,
             page_bytes: int = 0,
             clock: Optional[Callable[[], float]] = None) -> KVHeatLedger:
        """Create (or return) the ledger for pool ``name``; first creation
        emits the pool's ``kv_heat_meta`` record (capacity, page geometry —
        what the offline evaluator sizes its hypothetical resident set
        against)."""
        led = self._ledgers.get(name)
        if led is not None:
            return led
        if clock is not None:
            self.clock = clock
        led = KVHeatLedger(
            name, capacity, clock=clock or self.clock, page_bytes=page_bytes,
            page_size=page_size, sink=self, segment_events=self._segment_events,
        )
        self._ledgers[name] = led
        self._enqueue({
            "kind": "kv_heat_meta", "schema": SCHEMA, "pool": name,
            "capacity": int(capacity), "page_size": int(page_size),
            "page_bytes": int(page_bytes),
            "idle_thresholds_s": list(self.idle_thresholds_s),
        })
        return led

    @property
    def ledgers(self) -> Dict[str, KVHeatLedger]:
        return self._ledgers

    # -- emission ------------------------------------------------------
    def _seal(self, ledger: KVHeatLedger) -> None:
        """Package a ledger's buffered events into one segment record and
        queue it for background encode. Called from the hooks at the
        segment threshold and from :meth:`flush` — always the scheduler
        thread, so the swap needs no lock."""
        if not ledger._events and not ledger._touches:
            return
        events, ledger._events = ledger._events, []
        touches, ledger._touches = ledger._touches, []
        rec = {
            "kind": "kv_heat", "schema": SCHEMA, "pool": ledger.pool,
            "seq": ledger._seq, "events": events, "touches": touches,
        }
        ledger._seq += 1
        self._enqueue(rec)

    def _enqueue(self, rec: Dict[str, Any]) -> None:
        self.records_emitted += 1
        with self._lock:
            self._pending.append(rec)
            if len(self._pending) > 16 * self._encode_batch:
                del self._pending[0]
                self.records_lost += 1
            wake = len(self._pending) >= self._encode_batch
        if wake:
            self._wake.set()

    def _serialize_loop(self) -> None:
        """Background encoder — the RequestTracer drain discipline: take
        only full batches while the server is live, drain sub-batch tails
        on flush/close or after a quiet idle window, and survive write
        failures (count ``records_lost``, keep serving)."""
        stale_pending = -1
        while True:
            timed_out = not self._wake.wait(timeout=2.0)
            self._wake.clear()
            while True:
                with self._lock:
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
                stale_pending = -1

    # -- derived gauges ------------------------------------------------
    def bind_registry(self, registry) -> None:
        """Declare the derived gauge/histogram families on ``registry``
        (idempotent — get-or-create semantics both here and in the
        registry)."""
        if self._g_pages is not None:
            return
        self._g_pages = registry.gauge(
            "serving_kv_heat_pages",
            "pool occupancy split: active (live-session-owned) / prefix "
            "(index-held) / shared (multi-ref, unattributed) / other / free",
            labelnames=("pool", "category"),
        )
        self._g_cold = registry.gauge(
            "serving_kv_heat_cold_fraction",
            "fraction of in-use pages idle beyond the threshold (seconds) — "
            "the working-set-vs-resident-set signal KV tiering spills by",
            labelnames=("pool", "threshold"),
        )
        self._g_frag = registry.gauge(
            "serving_kv_heat_fragmentation",
            "1 - longest contiguous free run / free pages (0 = one block)",
            labelnames=("pool",),
        )
        self._g_idle = registry.gauge(
            "serving_kv_heat_session_idle_age_seconds",
            "live-session idle-age quantiles (time since last touch)",
            labelnames=("q",),
        )
        self._g_bytes = registry.gauge(
            "serving_kv_heat_ledger_bytes",
            "host-side footprint of the heat ledgers (mirror + buffers)",
        )
        self._h_lifetime = registry.histogram(
            "serving_kv_page_lifetime_seconds",
            "page lease lifetime, alloc to final free (per pool)",
            labelnames=("pool",),
            buckets=LIFETIME_BUCKETS,
        )

    def _observe_lifetime(self, pool: str, dt: float) -> None:
        # called from free() — the hot path stays a list append; the
        # histogram bisect + label resolution runs at drain cadence
        if self._h_lifetime is not None:
            self._pending_lifetimes.append((pool, dt))

    def _drain_lifetimes(self) -> None:
        if not self._pending_lifetimes:
            return
        obs, self._pending_lifetimes = self._pending_lifetimes, []
        h = self._h_lifetime
        for pool, dt in obs:
            h.observe(dt, pool=pool)

    def refresh_gauges(self, now: Optional[float] = None) -> None:
        """Recompute the derived gauges from the ledgers — O(pages), called
        at the scheduler's stats cadence, never per step."""
        if self._g_pages is None:
            return
        self._drain_lifetimes()
        now = self.clock() if now is None else now
        ages: List[float] = []
        for led in self._ledgers.values():
            occ = led.occupancy(now, self.idle_thresholds_s)
            for catg, n in occ["pages"].items():
                self._g_pages.set(n, pool=led.pool, category=catg)
            for th, frac in occ["cold_fraction"].items():
                if frac is not None:
                    self._g_cold.set(frac, pool=led.pool, threshold=th)
            self._g_frag.set(occ["fragmentation"], pool=led.pool)
            ages.extend(led.session_idle_ages(now))
        if ages:
            ages.sort()
            for q, label in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                self._g_idle.set(
                    ages[min(len(ages) - 1, int(q * len(ages)))], q=label
                )
        self._g_bytes.set(self.ledger_bytes())

    def ledger_bytes(self) -> int:
        return sum(led.ledger_bytes() for led in self._ledgers.values())

    # -- plumbing ------------------------------------------------------
    def flush(self) -> None:
        """Seal every ledger's buffered tail, block until all queued
        segments are encoded + buffered in the writer, then flush the
        writer to disk."""
        self._drain_lifetimes()
        for led in self._ledgers.values():
            self._seal(led)
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
        self.flush()
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
    def encode_error(self) -> Optional[str]:
        with self._lock:
            return self._encode_error


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------


def load_heat_records(path: str) -> List[Dict[str, Any]]:
    """The ``kv_heat`` / ``kv_heat_meta`` records of one JSONL trace, in
    file order — the same tolerance contract as
    ``telemetry.request_trace.load_request_records``: a rolled ``.1``
    generation is read first, one torn TAIL line (killed run) is forgiven,
    anything else corrupt or claiming an unknown schema raises
    :class:`KVHeatError`."""
    paths = [p for p in (path + ".1", path) if os.path.exists(p)]
    if not paths:
        raise KVHeatError(f"{path}: no such trace file")
    out: List[Dict[str, Any]] = []
    for p in paths:
        torn: List[int] = []
        try:
            with open(p, encoding="utf-8") as fh:
                lines = fh.readlines()
        except UnicodeDecodeError as e:
            raise KVHeatError(
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
                raise KVHeatError(
                    f"{p}:{lineno}: JSON line is {type(rec).__name__}, not "
                    "an object — this is not a KV heat trace"
                )
            if rec.get("kind") not in ("kv_heat", "kv_heat_meta"):
                continue  # request/step records share the telemetry dir
            schema = rec.get("schema")
            if schema != SCHEMA:
                raise KVHeatError(
                    f"{p}:{lineno}: schema {schema!r} != {SCHEMA!r} — trace "
                    "written by an incompatible version"
                )
            out.append(rec)
        if torn and torn != [len(lines)]:
            raise KVHeatError(
                f"{p}: {len(torn)} undecodable line(s) (first at line "
                f"{torn[0]}) — truncated or corrupt beyond a torn tail"
            )
    return out


def pools_in(records: Sequence[Dict[str, Any]]) -> List[str]:
    """Pool names present in a record set, meta-record order first."""
    seen: List[str] = []
    for rec in records:
        pl = rec.get("pool")
        if pl is not None and pl not in seen:
            seen.append(pl)
    return seen


# ---------------------------------------------------------------------------
# offline replay: reconstruct ledger state from a trace
# ---------------------------------------------------------------------------


class _TraceClock:
    """Settable clock for offline replay: ledger hooks read the timestamp
    of the event currently being applied."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def iter_pool_events(records: Sequence[Dict[str, Any]], pool: str):
    """One pool's merged event stream in time order: yields
    ``("touch", t, step, batch)`` and ``(op, t, *payload)`` lifecycle
    tuples, merged from the segment records' two columnar series."""
    merged: List[Tuple[float, int, Tuple]] = []
    for rec in records:
        if rec.get("kind") != "kv_heat" or rec.get("pool") != pool:
            continue
        for ev in rec.get("events") or ():
            merged.append((float(ev[1]), 0, tuple(ev)))
        for tch in rec.get("touches") or ():
            merged.append((float(tch[0]), 1, ("touch", *tch)))
    # stable by (time, lifecycle-before-touch): events within one segment
    # are already ordered; the sort only interleaves the two series
    merged.sort(key=lambda x: (x[0], x[1]))
    for _t, _k, ev in merged:
        yield ev


def replay_heat(
    records: Sequence[Dict[str, Any]],
    pool: str,
    on_event: Optional[Callable[[Tuple, KVHeatLedger], None]] = None,
) -> KVHeatLedger:
    """Rebuild a :class:`KVHeatLedger` (sink-less: derived state only) by
    replaying one pool's recorded stream. ``on_event(ev, ledger)`` fires
    after each applied event — the hook the cold-fraction curves and the
    lockstep tests sample through. Returns the end-of-trace ledger."""
    meta = next(
        (r for r in records
         if r.get("kind") == "kv_heat_meta" and r.get("pool") == pool),
        None,
    )
    if meta is None:
        raise KVHeatError(f"pool {pool!r}: no kv_heat_meta record in trace")
    clk = _TraceClock()
    led = KVHeatLedger(
        pool, int(meta["capacity"]), clock=clk,
        page_bytes=int(meta.get("page_bytes") or 0),
        page_size=int(meta.get("page_size") or 0),
    )
    for ev in iter_pool_events(records, pool):
        op = ev[0]
        clk.t = float(ev[1])
        if op == "touch":
            _, t, step, batch = ev
            led.touch_step(float(t), int(step), [tuple(b) for b in batch])
        elif op == "A":
            led.alloc(ev[2])
        elif op == "R":
            led.retain(ev[2])
        elif op == "F":
            led.free(ev[2])
        elif op == "G":
            led.register(ev[2])
        elif op == "H":
            led.hit(ev[2], ev[3] if len(ev) > 3 else "")
        elif op == "E":
            led.evict(ev[2])
        elif op == "D":
            led.demote(ev[2], ev[3])
        elif op == "U":
            led.restore_up(ev[2], ev[3])
        elif op == "V":
            led.host_drop(ev[2])
        elif op == "S":
            led.session_start(float(ev[1]), int(ev[2]), ev[3], ev[4], ev[5])
        elif op == "X":
            led.session_end(float(ev[1]), int(ev[2]))
        elif op == "B":
            led.seed({int(p): int(c) for p, c in ev[2]}, ev[3], float(ev[1]))
        if on_event is not None:
            on_event(ev, led)
    return led


def cold_fraction_curve(
    records: Sequence[Dict[str, Any]],
    pool: str,
    threshold_s: float,
    bins: int = 10,
) -> List[Dict[str, Any]]:
    """The pool's cold-page fraction sampled at ``bins`` equal windows of
    trace time — the cold fraction against load."""
    times = [
        float(ev[1]) for ev in iter_pool_events(records, pool)
    ]
    if not times:
        return []
    t0, t1 = min(times), max(times)
    width = max((t1 - t0) / max(1, bins), 1e-12)
    edges = [t0 + (b + 1) * width for b in range(bins)]
    out: List[Dict[str, Any]] = []
    state = {"i": 0}

    def sample(now: float, led: KVHeatLedger) -> None:
        occ = led.occupancy(now, (threshold_s,))
        out.append({
            "t": now,
            "pages_in_use": occ["pages_in_use"],
            "cold_fraction": occ["cold_fraction"][str(threshold_s)],
            "sessions": occ["sessions"],
        })

    def on_event(ev: Tuple, led: KVHeatLedger) -> None:
        t = float(ev[1])
        while state["i"] < len(edges) and t >= edges[state["i"]]:
            sample(edges[state["i"]], led)
            state["i"] += 1

    led = replay_heat(records, pool, on_event=on_event)
    while state["i"] < len(edges):
        sample(edges[state["i"]], led)
        state["i"] += 1
    return out


# ---------------------------------------------------------------------------
# the what-if spill evaluator
# ---------------------------------------------------------------------------


def evaluate_spill_policies(
    records: Sequence[Dict[str, Any]],
    pool: str,
    resident_fraction: float = 0.5,
    policies: Sequence[str] = SPILL_POLICIES,
) -> Dict[str, Any]:
    """Replay one pool's recorded heat stream against a hypothetical
    resident set of ``resident_fraction × capacity`` pages under each
    candidate eviction policy, and report what the run WOULD have cost:

    - ``spills`` / ``spilled_bytes`` — pages pushed to host when the
      resident set overflowed (host write traffic),
    - ``restore_stalls`` — events (an admission's page reuse, or a decode
      step-slot touch) that found a needed page spilled and would have
      stalled on the restore,
    - ``restored_bytes`` — host read traffic bringing those pages back.

    Policies (the ROADMAP item 2 candidates):

    - ``idle_lru`` — spill the page with the oldest direct touch.
    - ``prefix_aware`` — spill non-prefix-held pages first (index pages
      are the ones future admissions re-hit), idle-age LRU within a class.
    - ``slot_priority`` — spill pages of idle/ended sessions before pages
      of recently-active ones (session recency, then page idle age).

    Deterministic: pure function of the recorded stream (ties break on
    page id), so the same recorded stream always gives the same
    comparison."""
    meta = next(
        (r for r in records
         if r.get("kind") == "kv_heat_meta" and r.get("pool") == pool),
        None,
    )
    if meta is None:
        raise KVHeatError(f"pool {pool!r}: no kv_heat_meta record in trace")
    capacity = int(meta["capacity"])
    page_bytes = int(meta.get("page_bytes") or 0)
    cap = max(1, int(capacity * float(resident_fraction)))
    results: Dict[str, Any] = {}
    for policy in policies:
        if policy not in SPILL_POLICIES:
            raise KVHeatError(
                f"unknown spill policy {policy!r} (one of {SPILL_POLICIES})"
            )
        results[policy] = _simulate_policy(
            records, pool, policy, cap, page_bytes
        )
    return {
        "pool": pool,
        "capacity": capacity,
        "resident_cap": cap,
        "resident_fraction": float(resident_fraction),
        "page_bytes": page_bytes,
        "policies": results,
    }


def _simulate_policy(
    records: Sequence[Dict[str, Any]],
    pool: str,
    policy: str,
    cap: int,
    page_bytes: int,
) -> Dict[str, Any]:
    # simulator state beside the ledger: which in-use pages are resident
    resident: Set[int] = set()
    spilled: Set[int] = set()
    stats = {"spills": 0, "restore_stalls": 0}
    st = {"led": None}

    def victim_key(p: int, led: KVHeatLedger, now: float):
        age = now - led.page_last.get(p, now)
        if policy == "idle_lru":
            return (-age, p)
        if policy == "prefix_aware":
            # non-prefix pages first (False < True), then oldest
            return (p in led.prefix_pages, -age, p)
        # slot_priority: pages of live recently-active sessions last
        slot = led.owner.get(p)
        ss = led.sessions.get(slot) if slot is not None else None
        sess_last = ss["last"] if ss is not None else -float("inf")
        return (ss is not None, sess_last, -age, p)

    def make_room(n: int, led: KVHeatLedger, now: float,
                  pinned: Set[int]) -> None:
        while len(resident) + n > cap:
            candidates = [p for p in resident if p not in pinned]
            if not candidates:
                break  # everything resident is pinned by the current event
            victim = min(candidates, key=lambda p: victim_key(p, led, now))
            resident.discard(victim)
            spilled.add(victim)
            stats["spills"] += 1

    def admit(pages: Sequence[int], led: KVHeatLedger, now: float) -> None:
        pages = [int(p) for p in pages]
        new = [p for p in pages if p not in resident]
        if not new:
            return
        make_room(len(new), led, now, pinned=set(pages))
        for p in new:
            spilled.discard(p)
            resident.add(p)

    def require(pages: Sequence[int], led: KVHeatLedger, now: float) -> int:
        """Touched pages must be resident: restore any spilled ones;
        returns the number restored (0 = no stall)."""
        need = [int(p) for p in pages if int(p) in spilled]
        if not need:
            return 0
        make_room(len(need), led, now, pinned={int(p) for p in pages})
        for p in need:
            spilled.discard(p)
            resident.add(p)
        return len(need)

    restored_pages = 0

    def on_event(ev: Tuple, led: KVHeatLedger) -> None:
        nonlocal restored_pages
        op = ev[0]
        now = float(ev[1])
        if op == "A":
            admit(ev[2], led, now)
        elif op == "B":
            admit([p for p, _c in ev[2]], led, now)
        elif op in ("R", "H"):
            n = require(ev[2], led, now)
            if n:
                stats["restore_stalls"] += 1
                restored_pages += n
        elif op == "F":
            for p in ev[2]:
                p = int(p)
                if p not in led.refs:  # final free: page left the pool
                    resident.discard(p)
                    spilled.discard(p)
        elif op == "touch":
            _, t, _step, batch = ev
            sess = led.sessions
            stalls = 0
            for slot, wp, n_pages in batch:
                # reconstruct the slot's attended prefix from its session's
                # block-table-ordered page list
                ss = sess.get(slot)
                if ss is not None and "pages" in ss:
                    pages = ss["pages"][: int(n_pages)]
                else:
                    pages = [int(wp)]
                n = require(pages, led, float(t))
                if n:
                    stalls += 1
                    restored_pages += n
            stats["restore_stalls"] += stalls
        elif op == "S":
            # stash the block-table-ordered reservation on the session so
            # touch events can expand their attended prefixes
            ss = led.sessions.get(int(ev[2]))
            if ss is not None:
                ss["pages"] = [int(p) for p in ev[5]]
            admit(ev[5], led, now)

    replay_heat(records, pool, on_event=on_event)
    return {
        "spills": stats["spills"],
        "spilled_bytes": stats["spills"] * page_bytes,
        "restore_stalls": stats["restore_stalls"],
        "restored_pages": restored_pages,
        "restored_bytes": restored_pages * page_bytes,
    }


# ---------------------------------------------------------------------------
# aggregate report (CLI)
# ---------------------------------------------------------------------------


def lifetime_quantile(lifetimes: Sequence[float], q: float) -> Optional[float]:
    """Prometheus-style quantile over lifetimes bucketed into
    :data:`LIFETIME_BUCKETS` — the estimator the registry histogram runs,
    so trace-derived numbers reproduce the exported metric."""
    if not lifetimes:
        return None
    bs = list(LIFETIME_BUCKETS) + [float("inf")]
    counts = [0] * len(bs)
    for v in lifetimes:
        for i, b in enumerate(bs):
            if v <= b:
                counts[i] += 1
    return quantile_from_buckets(bs, counts, len(lifetimes), q)


def heat_report(records: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate one trace into the per-pool heat summary: event counts,
    occupancy + cold fractions + fragmentation at end-of-trace, page
    lifetime quantiles (completed leases), session stats."""
    if not records:
        raise KVHeatError("empty trace: no kv_heat records")
    out: Dict[str, Any] = {"schema": SCHEMA, "pools": {}}
    for pool in pools_in(records):
        meta = next(
            (r for r in records
             if r.get("kind") == "kv_heat_meta" and r.get("pool") == pool),
            None,
        )
        if meta is None:
            continue
        lifetimes: List[float] = []
        leases = {}

        def on_event(ev, led, _lt=lifetimes, _ls=leases):
            op = ev[0]
            if op == "A":
                for p in ev[2]:
                    _ls[int(p)] = float(ev[1])
            elif op == "F":
                for p in ev[2]:
                    p = int(p)
                    if p not in led.refs and p in _ls:
                        _lt.append(float(ev[1]) - _ls.pop(p))

        led = replay_heat(records, pool, on_event=on_event)
        times = [float(ev[1]) for ev in iter_pool_events(records, pool)]
        t_end = max(times) if times else 0.0
        occ = led.occupancy(t_end, tuple(meta.get("idle_thresholds_s")
                                         or IDLE_THRESHOLDS_S))
        ages = sorted(led.session_idle_ages(t_end))
        out["pools"][pool] = {
            "capacity": led.capacity,
            "page_bytes": led.page_bytes,
            "span_s": (t_end - min(times)) if times else 0.0,
            "allocs": led.allocs,
            "frees": led.frees,
            "retains": led.retains,
            "prefix_registered": led.prefix_registered,
            "prefix_hits": led.prefix_hits,
            "prefix_evictions": led.prefix_evictions,
            "touch_steps": led.touch_steps,
            "sessions_started": led.sessions_started,
            "sessions_ended": led.sessions_ended,
            "demotions": led.demotions,
            "restores_up": led.restores_up,
            "host_drops": led.host_drops,
            "host_handles": len(led.host_handles),
            "occupancy": occ,
            "page_lifetime_s": {
                "count": len(lifetimes),
                "mean": (sum(lifetimes) / len(lifetimes)) if lifetimes else None,
                "p50": lifetime_quantile(lifetimes, 0.5),
                "p99": lifetime_quantile(lifetimes, 0.99),
            },
            "session_idle_age_p50_s": (
                ages[len(ages) // 2] if ages else None
            ),
        }
    if not out["pools"]:
        raise KVHeatError("trace holds no kv_heat_meta record for any pool")
    return out
