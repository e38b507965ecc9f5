"""Tiered KV cache: a host-DRAM second tier for cold pages (counterpart of
``deepspeed_tpu/serving/tiering.py``).

The device pool holds only the hot working set: a prefix-index page evicted
as the index's last reference spills to a pinned host buffer instead of
being dropped, and a later prompt that re-hits the demoted prefix restores
the page (one width-1 scatter program, ``serving_kv_restore``) instead of
recomputing it: a cold prefix hit becomes a warm-from-host hit.

Layout: the host store holds ``budget_pages`` slots, each one page of every
layer, ``[P, L, KV, page, D]`` (slot-major, so a page is one contiguous
pinned span that one asynchronous copy fills; the JAX store is ``[L, P,
KV, page, D]``), with the per-page scale sidecar ``[P, L, KV, 2]`` when the
pool is int8: codes and scales spill as they are, so the int8 pool's
halved bytes carry over to the host tier.

Overlap: ``demote_begin`` copies the page (on the card: from the device
pool into its pinned host slot, asynchronously on the current stream, then
an event) BEFORE the caller frees the device page, so every later program
that may rewrite the page runs after the copy in stream order; a
background worker waits for the event and computes the crc off the step
path. Restores run at admission (the slot is about to attend those pages)
and are bounded per step by ``serving.tiering.prefetch_depth``.

Integrity: every spilled buffer carries a crc32 (``serving.tiering.crc``);
a mismatch on restore is a cold miss (the entry is dropped and the
scheduler recomputes the prefix), never silent corruption. A restore
program that fails raises: only a miss recomputes.

Ownership across tiers is checked: the heat ledger records the tier's
demote / restore / host-drop events (``D``/``U``/``V``), and
``ServingEngine.check_no_leaks`` reconciles the ledger's handles against
the live store. :func:`policy_victim_key` is the SINGLE definition of the
spill-victim order: the live engine, the prefix cache's leaf choice and
:func:`replay_live_tier` rank through it, and it mirrors the what-if
simulator (``telemetry.kv_heat._simulate_policy``).
"""

from __future__ import annotations

import threading
import time
import zlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

# mirror of telemetry.kv_heat.SPILL_POLICIES (runtime.config validates
# against the same literal without importing the telemetry plane)
TIERING_POLICIES = ("idle_lru", "prefix_aware", "slot_priority")


class HostTierError(RuntimeError):
    """Host-tier protocol violation (duplicate key, reserve past budget)."""


def policy_victim_key(policy: str, p: int, led: Any, now: float):
    """Spill-victim sort key for page ``p`` under ``policy``: the what-if
    simulator's ``victim_key``, so live behaviour and offline prediction
    rank victims the same way (ties break on page id). ``led`` is a
    :class:`~..telemetry.kv_heat.KVHeatLedger` (or anything with
    ``page_last`` / ``prefix_pages`` / ``owner`` / ``sessions``)."""
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


def _crc(t: torch.Tensor) -> int:
    """crc32 of a contiguous CPU tensor's bytes."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return zlib.crc32(t.numpy())


class _HostEntry:
    __slots__ = ("slot", "hid", "origin_page", "crc_k", "crc_v", "crc_s", "ready", "failed")

    def __init__(self, slot: int, hid: int, origin_page: int):
        self.slot = slot
        self.hid = hid
        self.origin_page = origin_page
        self.crc_k = 0
        self.crc_v = 0
        self.crc_s = 0
        self.ready = threading.Event()
        self.failed = False


class HostPageStore:
    """Host buffers holding spilled KV pages, keyed by prefix key
    (pinned when ``pin``: the card's asynchronous copies need it).

    ``budget_pages`` slots of ``[L, KV, page, D]`` codes x2 (and the ``[L,
    KV, 2]`` scale sidecar when ``quantized``). Entry order is spill order:
    the host tier's own LRU, evicted by :meth:`drop_lru` when a demotion
    finds the store full.

    Thread contract: ``reserve`` / ``drop`` / ``get`` / bookkeeping run on
    the scheduler thread; ``seal`` / ``abandon`` on the spill worker. The
    entry's ``ready`` event is the only cross-thread handshake: ``drop``
    and ``get`` wait on it before touching the slot, so a slot is never
    recycled under an in-flight copy."""

    def __init__(self, budget_pages: int, *, n_layer: int, n_kv_head: int, page_size: int,
                 head_dim: int, dtype: torch.dtype, quantized: bool = False, crc: bool = True,
                 pin: bool = False):
        if budget_pages <= 0:
            raise HostTierError(f"HostPageStore needs a positive page budget, got {budget_pages}")
        self.budget_pages = int(budget_pages)
        self.quantized = bool(quantized)
        self.crc = bool(crc)
        shape = (self.budget_pages, n_layer, n_kv_head, page_size, head_dim)
        self.k_codes = torch.zeros(shape, dtype=dtype, pin_memory=pin)
        self.v_codes = torch.zeros(shape, dtype=dtype, pin_memory=pin)
        self.scales = (torch.zeros((self.budget_pages, n_layer, n_kv_head, 2),
                                   dtype=torch.float32, pin_memory=pin)
                       if self.quantized else None)
        self._free: List[int] = list(range(self.budget_pages - 1, -1, -1))
        self._entries: "OrderedDict[Any, _HostEntry]" = OrderedDict()
        self._by_hid: Dict[int, _HostEntry] = {}
        self._hid = 0
        self.crc_failures = 0

    def __contains__(self, key: Any) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def page_bytes(self) -> int:
        """Host bytes a spilled page takes (codes x2 + the scale sidecar)."""
        per = self.k_codes[0].nbytes + self.v_codes[0].nbytes
        if self.scales is not None:
            per += self.scales[0].nbytes
        return per

    def host_bytes(self) -> int:
        """The whole buffer footprint (allocated up front, not per entry)."""
        return self.page_bytes * self.budget_pages

    def used_bytes(self) -> int:
        return self.page_bytes * len(self._entries)

    def handles(self) -> Set[int]:
        """Live host handles: what the heat ledger reconciles against."""
        return set(self._by_hid)

    # -- spill side ----------------------------------------------------

    def reserve(self, key: Any, origin_page: int) -> int:
        """Claim a host slot for ``key`` → the host handle. The contents
        arrive later (:meth:`slot_views`, then :meth:`seal`)."""
        if key in self._entries:
            raise HostTierError(f"host tier already holds key {key!r}")
        if not self._free:
            raise HostTierError("host tier full (evict before reserving)")
        self._hid += 1
        ent = _HostEntry(self._free.pop(), self._hid, int(origin_page))
        self._entries[key] = ent
        self._by_hid[ent.hid] = ent
        return ent.hid

    def slot_views(self, hid: int):
        """The reserved slot's ``(k, v, scales or None)`` host views."""
        s = self._by_hid[int(hid)].slot
        return (self.k_codes[s], self.v_codes[s],
                self.scales[s] if self.scales is not None else None)

    def seal(self, hid: int) -> None:
        """Worker side, once the slot's copy has landed: checksum it and
        mark the entry ready."""
        ent = self._by_hid.get(int(hid))
        if ent is None:  # dropped while the copy was in flight
            return
        try:
            if self.crc:
                s = ent.slot
                ent.crc_k = _crc(self.k_codes[s])
                ent.crc_v = _crc(self.v_codes[s])
                if self.scales is not None:
                    ent.crc_s = _crc(self.scales[s])
        except Exception:
            ent.failed = True
        finally:
            ent.ready.set()

    def fill(self, hid: int, k: Any, v: Any, scales: Optional[Any] = None) -> None:
        """Copy a page (host arrays ``[L, KV, page, D]``) into the reserved
        slot and seal it."""
        ent = self._by_hid.get(int(hid))
        if ent is None:
            return
        try:
            kd, vd, sd = self.slot_views(hid)
            kd.copy_(torch.as_tensor(k))
            vd.copy_(torch.as_tensor(v))
            if sd is not None:
                sd.copy_(torch.as_tensor(scales))
        except Exception:
            self.abandon(hid)
            return
        self.seal(hid)

    def put(self, key: Any, origin_page: int, k: Any, v: Any,
            scales: Optional[Any] = None) -> int:
        """Synchronous reserve + fill (tests, the replay cross-check)."""
        hid = self.reserve(key, origin_page)
        self.fill(hid, k, v, scales)
        return hid

    def abandon(self, hid: int) -> None:
        """Worker side: mark an in-flight copy failed, so a waiting
        ``get`` / ``drop`` cannot hang on the ready event."""
        ent = self._by_hid.get(int(hid))
        if ent is not None:
            ent.failed = True
            ent.ready.set()

    # -- restore side --------------------------------------------------

    def get(self, key: Any) -> Optional[Tuple[torch.Tensor, torch.Tensor,
                                              Optional[torch.Tensor]]]:
        """The page payload for ``key`` (views of its slot), or None on a
        miss, a failed copy or a crc mismatch (the entry is dropped: the
        caller recomputes)."""
        ent = self._entries.get(key)
        if ent is None:
            return None
        ent.ready.wait()
        bad = ent.failed
        s = ent.slot
        if not bad and self.crc:
            bad = (_crc(self.k_codes[s]) != ent.crc_k or _crc(self.v_codes[s]) != ent.crc_v
                   or (self.scales is not None and _crc(self.scales[s]) != ent.crc_s))
            if bad:
                self.crc_failures += 1
        if bad:
            self.drop(key)
            return None
        return (self.k_codes[s], self.v_codes[s],
                self.scales[s] if self.scales is not None else None)

    def drop(self, key: Any) -> Optional[int]:
        """Forget ``key`` and recycle its slot → its host handle (None on a
        miss). Waits out an in-flight copy first."""
        ent = self._entries.pop(key, None)
        if ent is None:
            return None
        ent.ready.wait(timeout=30.0)
        self._by_hid.pop(ent.hid, None)
        self._free.append(ent.slot)
        return ent.hid

    def drop_lru(self) -> Optional[Tuple[Any, int]]:
        """Evict the oldest (first-spilled) entry → ``(key, hid)`` or None."""
        if not self._entries:
            return None
        key = next(iter(self._entries))
        return key, self.drop(key)

    def clear(self) -> None:
        for key in list(self._entries):
            self.drop(key)

    def check_consistent(self) -> None:
        """Slot bookkeeping invariants (the free list and the entries
        partition the budget; the handle index agrees). Raises
        AssertionError on a violation."""
        used = {e.slot for e in self._entries.values()}
        assert len(used) == len(self._entries), "host slot double-booked"
        assert used.isdisjoint(self._free), "host slot both free and used"
        assert len(used) + len(self._free) == self.budget_pages, (
            f"host slots leaked: {len(used)} used + {len(self._free)} free "
            f"!= {self.budget_pages}"
        )
        assert {e.hid for e in self._entries.values()} == set(self._by_hid), (
            "host hid index out of sync"
        )


class KVTieringEngine:
    """Spill / restore engine between one pool set and a HostPageStore.

    ``pset`` has ``k_pool`` / ``v_pool`` ``[L, P, KV, page, D]`` (and
    ``scales`` ``[L, P, KV, 2]`` for int8). The scheduler wires
    :meth:`demote_begin` in as the PrefixCache's ``demote_sink`` and
    :meth:`select_leaf` as its ``victim_order``, binds the restore program
    with :meth:`bind_restore_exec`, and drives restores from admission
    (``ServingEngine._tier_prefetch``). The worker thread only waits for
    the spill copies and checksums them."""

    def __init__(self, store: HostPageStore, pset: Any, *, policy: str = "idle_lru",
                 prefetch_depth: int = 4, clock=time.monotonic):
        if policy not in TIERING_POLICIES:
            raise HostTierError(f"unknown tiering policy {policy!r}; pick from {TIERING_POLICIES}")
        self.store = store
        self.pset = pset
        self.policy = policy
        self.prefetch_depth = int(prefetch_depth)
        self.clock = clock
        # wired by ServingEngine: the heat ledger and the restore program
        self.ledger: Optional[Any] = None
        self._restore_exec = None
        # device-index residency (the scheduler wires
        # ``prefix_cache._entries.__contains__``): lets the tier drop host
        # entries whose parent chain link left BOTH tiers; None disables
        # the eager sweep
        self.device_resident = None
        # counters (stats()["kv_tiering"])
        self.spills = 0
        self.restores = 0
        self.restore_misses = 0
        self.host_evictions = 0
        self.orphan_drops = 0
        self.spilled_bytes = 0
        self.restored_bytes = 0
        self._lock = threading.Lock()
        self._queue: List[Tuple[int, Any]] = []
        self._wake = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._closed = False
        self._worker = threading.Thread(target=self._spill_loop, name="kv-tier-spill",
                                        daemon=True)
        self._worker.start()

    # -- worker --------------------------------------------------------

    def _spill_loop(self) -> None:
        while True:
            self._wake.wait()
            with self._lock:
                if self._closed and not self._queue:
                    return
                batch, self._queue = self._queue, []
                if not self._closed:
                    # once closed the wake stays set, so the loop drains
                    # what close() found queued and returns; clearing it
                    # here would leave the worker waiting for a wake that
                    # close() already spent
                    self._wake.clear()
            for hid, event in batch:
                try:
                    if event is not None:
                        event.synchronize()
                    self.store.seal(hid)
                except Exception:
                    self.store.abandon(hid)
            with self._lock:
                if not self._queue:
                    self._idle.set()

    def flush(self, timeout: float = 30.0) -> None:
        """Block until every queued spill has landed in the host store."""
        self._wake.set()
        self._idle.wait(timeout)

    def close(self) -> None:
        with self._lock:
            self._closed = True
        self._wake.set()
        self._worker.join(timeout=5.0)

    # -- spill side ----------------------------------------------------

    def select_leaf(self, leaves: Sequence[Tuple[Any, int]]):
        """PrefixCache ``victim_order`` hook: the evictable leaf the policy
        ranks first (the first leaf, LRU, before a ledger is attached)."""
        if not leaves:
            return None
        led = self.ledger
        if led is None:
            return leaves[0]
        now = float(self.clock())
        return min(leaves, key=lambda kp: policy_victim_key(self.policy, kp[1], led, now))

    def demote_begin(self, key: Any, pid: int) -> Optional[int]:
        """PrefixCache ``demote_sink`` hook: copy device page ``pid`` toward
        the host tier → the host handle (None if the key is already
        host-held). Called BEFORE the caller frees the device page: the
        ledger's ``D`` event lands before the F/E pair, and the copy is
        queued before any later program can overwrite the freed page."""
        if key in self.store:
            return None
        while self.store.free_slots == 0:
            dropped = self.store.drop_lru()
            if dropped is None:
                return None
            self.host_evictions += 1
            if self.ledger is not None:
                self.ledger.host_drop(dropped[1])
        # the orphan sweep BEFORE the D event: any V events it makes precede
        # D, never split a D→F→E triple. ``key`` is mid-demotion and counts
        # as resident, so its own host children survive
        self.drop_orphans(keep=key)
        hid = self.store.reserve(key, pid)
        kd, vd, sd = self.store.slot_views(hid)
        pset = self.pset
        cuda = pset.k_pool.device.type == "cuda"
        kd.copy_(pset.k_pool[:, pid], non_blocking=cuda)
        vd.copy_(pset.v_pool[:, pid], non_blocking=cuda)
        scales = getattr(pset, "scales", None)
        if sd is not None:
            sd.copy_(scales[:, pid], non_blocking=cuda)
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(pset.k_pool.device))
        with self._lock:
            self._queue.append((hid, event))
            self._idle.clear()
        self._wake.set()
        self.spills += 1
        self.spilled_bytes += self.store.page_bytes
        if self.ledger is not None:
            self.ledger.demote(pid, hid)
        return hid

    def drop_orphans(self, keep: Any = None) -> int:
        """Drop host entries whose parent chain link left BOTH tiers (a
        chained key is reachable only through its parent, so such an entry
        can never be restored), each with a ledger ``V`` event, to a
        fixpoint. ``keep`` names a key mid-transition that counts as
        resident. → entries dropped (0 without a ``device_resident``
        predicate)."""
        if self.device_resident is None:
            return 0
        dropped_n = 0
        changed = True
        while changed:
            changed = False
            for key in list(self.store._entries):
                parent = key[0] if isinstance(key, tuple) and key else None
                # only proper chain parents are links: roots (parent None)
                # and foreign key shapes have nothing to sever
                if not isinstance(parent, tuple) or parent == keep:
                    continue
                if parent in self.store or self.device_resident(parent):
                    continue
                hid = self.store.drop(key)
                if hid is not None:
                    self.orphan_drops += 1
                    dropped_n += 1
                    changed = True
                    if self.ledger is not None:
                        self.ledger.host_drop(hid)
        return dropped_n

    # -- restore side --------------------------------------------------

    def bind_restore_exec(self, fn) -> None:
        """Install the restore program: ``fn(k, v, scales or None, pid)``
        writes one page (host arrays ``[L, KV, page, D]``) into device page
        ``pid``."""
        self._restore_exec = fn

    def restore(self, key: Any, pid: int) -> bool:
        """Copy ``key``'s host page back into freshly allocated device page
        ``pid``. False on a cold miss (absent, failed copy, crc mismatch):
        the caller recomputes the prefix. A failing restore program
        raises."""
        ent = self.store._entries.get(key)
        payload = self.store.get(key)  # waits out an in-flight spill
        if payload is None:
            self.restore_misses += 1
            if ent is not None and self.ledger is not None:
                # get() dropped a failed or crc-mismatched entry: the ledger
                # hears of it as of any host drop (the JAX tier omits this
                # V event, and its ledger then keeps a handle the store
                # does not hold)
                self.ledger.host_drop(ent.hid)
            # a crc-mismatch drop inside get() severs the chain below
            # ``key``: sweep its now-unreachable host descendants
            self.drop_orphans()
            return False
        if self._restore_exec is None:
            raise HostTierError("restore program not bound (restore through ServingEngine)")
        k, v, s = payload
        self._restore_exec(k, v, s, int(pid))
        hid = self.store.drop(key)  # exactly one tier: the host copy retires
        self.restores += 1
        self.restored_bytes += self.store.page_bytes
        if self.ledger is not None and hid is not None:
            self.ledger.restore_up(hid, pid)
        return True

    # -- audit ---------------------------------------------------------

    def check_consistent(self, prefix_cache: Optional[Any] = None) -> Optional[str]:
        """Cross-tier invariants → a one-line mismatch or None."""
        try:
            self.store.check_consistent()
        except AssertionError as e:
            return str(e)
        if self.ledger is not None:
            got = self.store.handles()
            want = self.ledger.host_handles
            if got != want:
                return f"host handles diverge: store={sorted(got)} ledger={sorted(want)}"
        if prefix_cache is not None:
            both = [k for k in prefix_cache._entries if k in self.store]
            if both:
                return f"keys in BOTH tiers (device index + host): {both[:4]}"
        return None

    def stats(self) -> Dict[str, Any]:
        return {
            "policy": self.policy,
            "host_budget_pages": self.store.budget_pages,
            "host_pages": len(self.store),
            "host_bytes": self.store.host_bytes(),
            "host_used_bytes": self.store.used_bytes(),
            "spills": self.spills,
            "restores": self.restores,
            "restore_misses": self.restore_misses,
            "host_evictions": self.host_evictions,
            "orphan_drops": self.orphan_drops,
            "crc_failures": self.store.crc_failures,
            "spilled_bytes": self.spilled_bytes,
            "restored_bytes": self.restored_bytes,
        }


def replay_live_tier(records: Sequence[Dict[str, Any]], pool: str, policy: str = "idle_lru",
                     resident_fraction: float = 0.5) -> Dict[str, Any]:
    """Replay a recorded heat trace against the LIVE tier: victims ranked
    by :func:`policy_victim_key`, every spill and restore through a real
    :class:`HostPageStore` (synthetic page payloads, crc checked on every
    restore) → the stats dict of ``telemetry.kv_heat.evaluate_spill_policies``,
    so the two can be compared field by field: any difference means the
    simulator and the engine no longer agree on victim order or
    residency."""
    from ..telemetry.kv_heat import KVHeatError, replay_heat

    if policy not in TIERING_POLICIES:
        raise HostTierError(f"unknown tiering policy {policy!r}; pick from {TIERING_POLICIES}")
    meta = next((r for r in records
                 if r.get("kind") == "kv_heat_meta" and r.get("pool") == pool), None)
    if meta is None:
        raise KVHeatError(f"pool {pool!r}: no kv_heat_meta record in trace")
    capacity = int(meta["capacity"])
    page_bytes = int(meta.get("page_bytes") or 0)
    cap = max(1, int(capacity * float(resident_fraction)))

    store = HostPageStore(max(1, capacity), n_layer=1, n_kv_head=1, page_size=4, head_dim=2,
                          dtype=torch.float32, crc=True)

    def spill(p: int) -> None:
        store.put(("page", p), p, np.full((1, 1, 4, 2), float(p), np.float32),
                  np.full((1, 1, 4, 2), float(p) + 0.5, np.float32))

    def unspill(p: int) -> bool:
        payload = store.get(("page", p))
        if payload is None:
            return False
        k, v, _ = payload
        ok = float(k[0, 0, 0, 0]) == float(p) and float(v[0, 0, 0, 0]) == float(p) + 0.5
        store.drop(("page", p))
        return ok

    resident: Set[int] = set()
    spilled: Set[int] = set()
    stats = {"spills": 0, "restore_stalls": 0, "restored_pages": 0}

    def make_room(n: int, led, now: float, pinned: Set[int]) -> None:
        while len(resident) + n > cap:
            candidates = [p for p in resident if p not in pinned]
            if not candidates:
                break
            victim = min(candidates, key=lambda p: policy_victim_key(policy, p, led, now))
            resident.discard(victim)
            spilled.add(victim)
            spill(victim)
            stats["spills"] += 1

    def admit(pages: Sequence[int], led, now: float) -> None:
        pages = [int(p) for p in pages]
        new = [p for p in pages if p not in resident]
        if not new:
            return
        make_room(len(new), led, now, pinned=set(pages))
        for p in new:
            if p in spilled:
                spilled.discard(p)
                unspill(p)
            resident.add(p)

    def require(pages: Sequence[int], led, now: float) -> int:
        need = [int(p) for p in pages if int(p) in spilled]
        if not need:
            return 0
        make_room(len(need), led, now, pinned={int(p) for p in pages})
        for p in need:
            spilled.discard(p)
            if not unspill(p):
                raise HostTierError(f"live-tier restore lost page {p}")
            resident.add(p)
        return len(need)

    def on_event(ev: Tuple, led) -> None:
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
                stats["restored_pages"] += n
        elif op == "F":
            for p in ev[2]:
                p = int(p)
                if p not in led.refs:  # final free: the page left the pool
                    resident.discard(p)
                    if p in spilled:
                        spilled.discard(p)
                        store.drop(("page", p))
        elif op == "touch":
            _, t, _step, batch = ev
            sess = led.sessions
            stalls = 0
            for slot, wp, n_pages in batch:
                ss = sess.get(slot)
                if ss is not None and "pages" in ss:
                    pages = ss["pages"][: int(n_pages)]
                else:
                    pages = [int(wp)]
                n = require(pages, led, float(t))
                if n:
                    stalls += 1
                    stats["restored_pages"] += n
            stats["restore_stalls"] += stalls
        elif op == "S":
            ss = led.sessions.get(int(ev[2]))
            if ss is not None:
                ss["pages"] = [int(p) for p in ev[5]]
            admit(ev[5], led, now)

    replay_heat(records, pool, on_event=on_event)
    store.check_consistent()
    return {
        "spills": stats["spills"],
        "spilled_bytes": stats["spills"] * page_bytes,
        "restore_stalls": stats["restore_stalls"],
        "restored_pages": stats["restored_pages"],
        "restored_bytes": stats["restored_pages"] * page_bytes,
    }
