"""Serving fleet: a multi-replica router with live session migration
(counterpart of ``deepspeed_tpu/serving/fleet.py``; the same routing,
shedding, migration protocol, metric families and ``stats()``).

* N :class:`~deepspeed_tpu_torch.serving.scheduler.ServingEngine`
  replicas over ONE :class:`InferenceEngine` (one set of weights; each
  replica its own page pools and captured programs), all driven by one
  injectable clock so fleet runs replay deterministically. A replica at
  tp 1 runs on the engine's device. With a placement that is on (``tp >
  1`` or ``disaggregate``) and ``spread_devices``, replica i serves from
  its own window of ``per`` ranks of the default process group, from
  ``device_base = i * per`` (JAX's device windows; ``per`` = decode_tp +
  prefill_tp when disaggregated), and shares rank 0's window when the
  ranks run out, as JAX shares device 0's. The router runs on every rank
  and keeps every replica's host state there (the replicas' schedulers
  are SPMD over the world: a rank runs the programs of the replica whose
  window holds it, and each program's outputs reach every rank), so
  every rank routes, sheds and migrates alike from the same submissions
  and clock: call every method on every rank in the same order.
* Routing by per-tenant SLO-class **affinity** (a tenant's sessions keep
  landing where its prefix working set is warm), **prefix locality** (the
  prefix index's ``probe`` plus the host tier's chain links) and load as
  the tie-break; or ``round_robin`` / ``least_loaded``.
* Admission backpressure from the SLO signals: the fleet sheds new
  requests only when EVERY replica's measured attainment sits under
  ``admit_attainment_floor``, or, with ``slo_alerts.backpressure``, while a
  burn-rate alert is firing; queue depth alone never sheds.
* Elastic leave: a preempted replica (a SIGTERM on the router's
  :class:`PreemptionGuard`, or :meth:`FleetRouter.preempt`) hands its
  backlog to peers and **migrates its live decode sessions**: each
  session's state and KV page row cross through the engine's
  ``serving_kv_gather`` → crc-checked manifest (``resilience/manifest``)
  → ``serving_kv_scatter`` transport, so a corrupt payload is a counted
  failure that restarts the session on a peer, never a wedged request.
  Between windows the export gathers every KV head of the session's
  pages from the source window to every rank and the adoption re-shards
  them over the destination's; each rank writes and validates its own
  copy of the manifest, and the outcome is agreed over the ranks.
  Migrated streams are the un-migrated ones: the pair copies pool bytes
  verbatim, the sampling keys ride the payload and the speculative
  drafter's index rebuilds from prompt + tokens.

A migration's blackout is the wall time the session emits nothing (export
→ manifest write → validate → load → adopt), observed into
``fleet_migration_blackout_seconds`` and stamped on the request trace's
``migration`` event.
"""

from __future__ import annotations

import copy
import os
import shutil
import tempfile
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..elasticity.preemption import PreemptionGuard
from ..resilience.manifest import load_arrays, read_manifest, validate_tag, write_tag
from ..telemetry.request_trace import LATENCY_BUCKETS
from ..telemetry.slo_budget import SLOBudgetEngine
from ..utils.logging import log_dist
from .replay import ReplayClock, ReplayItem
from .request import Request, RequestStatus


class FleetError(RuntimeError):
    """Fleet-level routing/migration failure (no alive replica, bad rid)."""


@dataclass
class FleetReplica:
    """One serving replica under the router: the engine, its programmatic
    preemption guard, and liveness. ``guard`` installs NO signal handler:
    a real SIGTERM lands on the ROUTER's guard, which picks one victim."""

    rid: str
    srv: Any
    guard: PreemptionGuard
    alive: bool = True
    routed: int = 0


class FleetRouter:
    """Front N ServingEngine replicas: route, balance, shed, migrate.

    ``engine`` is the shared InferenceEngine; ``serving_config`` (a dict
    or a ``ServingConfig``) carries the ``serving.fleet`` section that
    sizes the fleet. All replicas share ``clock``, the request tracer and
    the journal, so the fleet's metrics and traces aggregate in one
    plane; the ``fleet_*`` families live in replica r0's registry."""

    def __init__(self, engine, serving_config=None, clock=None, tracer=None,
                 fault_injector=None, journal=None):
        from ..runtime.config import ServingConfig

        if serving_config is None:
            serving_config = ServingConfig()
        elif isinstance(serving_config, dict):
            serving_config = ServingConfig.from_dict(serving_config)
        self.config = serving_config
        self.fcfg = serving_config.fleet
        self.engine = engine
        self.clock = clock if clock is not None else time.monotonic
        self.fault_injector = fault_injector
        self._mig_dir = self.fcfg.migration_dir or tempfile.mkdtemp(prefix="dstt-fleet-mig-")
        if self.fcfg.migration_dir and dist.is_initialized() and dist.get_world_size() > 1:
            # every rank writes its own copy of each payload
            self._mig_dir = os.path.join(self._mig_dir, f"rank{dist.get_rank()}")
        # test hook: runs with (tag_dir, request) after the migration
        # payload is written and before it validates
        self.on_migration_payload: Optional[Callable[[str, Request], None]] = None

        # -- replicas ---------------------------------------------------
        self.replicas: List[FleetReplica] = []
        n_avail = self._visible_devices()
        for i in range(int(self.fcfg.replicas)):
            rcfg = copy.deepcopy(serving_config)
            rcfg.fleet.enabled = False  # replicas never nest fleets
            plc = rcfg.placement
            if plc.on and self.fcfg.spread_devices:
                per = int(plc.decode_tp or plc.tp) + (
                    int(plc.prefill_tp or plc.tp) if plc.disaggregate else 0)
                base = i * per
                # too few ranks for a window of its own: share rank 0's
                plc.device_base = base if base + per <= n_avail else 0
            srv = engine.serve(serving_config=rcfg, clock=self.clock, tracer=tracer,
                               journal=journal)
            if fault_injector is not None:
                srv.fault_injector = fault_injector
            guard = PreemptionGuard(install=False, grace_window_s=0.0)
            self.replicas.append(FleetReplica(f"r{i}", srv, guard))
        log_dist(f"fleet: {len(self.replicas)} replicas on {n_avail} visible device(s), "
                 f"windows {[r.srv.decode_placement.ranks for r in self.replicas]}, "
                 f"policy {self.fcfg.policy}")
        self.tracer = self.replicas[0].srv.tracer
        self.metrics = self.replicas[0].srv.metrics

        # the router's own guard is the ONLY one that may own real signal
        # handlers: one SIGTERM = one victim replica, not a fleet stop
        self.guard = PreemptionGuard(install=bool(self.fcfg.install_sigterm),
                                     grace_window_s=0.0)
        self._fleet_stop_consumed = False

        # routing state
        self._rr = 0
        self._affinity: Dict[tuple, str] = {}
        # requests that went terminal at the FLEET level (shed at the door,
        # or unplaceable after a failed migration): replicas never saw them
        self.completed_here: List[Request] = []

        # -- telemetry: JAX's families, labels and buckets ------------------
        m = self.metrics
        self._g_replicas = m.gauge("fleet_replicas", "alive serving replicas")
        self._g_rep_goodput = m.gauge(
            "fleet_replica_goodput_tokens_per_sec",
            "per-replica SLO-good tokens per second (goodput)",
            labelnames=("replica",),
        )
        self._g_rep_occ = m.gauge(
            "fleet_replica_occupancy", "per-replica active slots / max_slots",
            labelnames=("replica",),
        )
        self._c_routed = m.counter(
            "fleet_routed_total", "requests routed, by replica", labelnames=("replica",))
        self._c_migrations = m.counter(
            "fleet_migrations_total",
            "live session migrations by outcome (ok | crc_failed | no_capacity)",
            labelnames=("status",),
        )
        self._c_mig_bytes = m.counter(
            "fleet_migration_bytes_total",
            "KV + sampling-state bytes moved by session migrations",
        )
        self._h_blackout = m.histogram(
            "fleet_migration_blackout_seconds",
            "per-migration emission blackout: export -> manifest -> "
            "validate -> adopt (wall time)",
            buckets=LATENCY_BUCKETS,
        )
        self._c_requeues = m.counter(
            "fleet_requeues_total",
            "sessions restarted from scratch on a peer (mid-prefill "
            "preemption, failed migration)",
        )
        self._c_rejections = m.counter(
            "fleet_rejections_total",
            "requests shed at the fleet door by the attainment floor",
        )
        self._g_rep_queue = m.gauge(
            "fleet_replica_queue_depth", "per-replica admission queue depth",
            labelnames=("replica",),
        )
        self._g_replicas.set(len(self.replicas))
        for rep in self.replicas:
            self._g_rep_occ.set(0.0, replica=rep.rid)
            self._g_rep_goodput.set(0.0, replica=rep.rid)
            self._g_rep_queue.set(0.0, replica=rep.rid)

        # -- the time-series journal and burn-rate alerting -----------------
        # ONE journal serves the whole fleet, bound to the fleet registry
        # (replica r0's): without a shared telemetry plane each replica has
        # its own registry and the last replica's attach would win
        self.journal = (journal if journal is not None
                        else getattr(getattr(engine, "telemetry", None), "metrics_journal", None))
        if self.journal is not None:
            self.journal.bind(m, clock=self.clock)
        self.slo_budget = None
        acfg = self.fcfg.slo_alerts
        if acfg.enabled:
            if self.journal is None:
                raise FleetError(
                    "serving.fleet.slo_alerts.enabled requires a metrics "
                    "journal (telemetry.timeseries.enabled or an explicit "
                    "journal=)"
                )
            self.slo_budget = SLOBudgetEngine(self.journal, acfg, registry=m, clock=self.clock)

    # -- small accessors ------------------------------------------------

    def _visible_devices(self) -> int:
        """Devices the replicas could spread over: with a process group up,
        its ranks (one device each); otherwise the card's count on the
        card, 1 on the CPU (every replica runs on the engine's device)."""
        if dist.is_initialized():
            return dist.get_world_size()
        return torch.cuda.device_count() if self.engine.device.type == "cuda" else 1

    def alive(self) -> List[FleetReplica]:
        return [r for r in self.replicas if r.alive]

    def replica(self, rid: str) -> FleetReplica:
        for r in self.replicas:
            if r.rid == rid:
                return r
        raise FleetError(f"unknown replica {rid!r}")

    @property
    def completed(self) -> List[Request]:
        """Every terminal request across the fleet, replica order then
        fleet-level terminals (shed / unplaceable)."""
        out: List[Request] = []
        for rep in self.replicas:
            out.extend(rep.srv.completed)
        out.extend(self.completed_here)
        return out

    @staticmethod
    def _load(rep: FleetReplica) -> int:
        srv = rep.srv
        return len(srv.queue) + sum(1 for s in srv.slots if s.request is not None)

    # -- routing --------------------------------------------------------

    def _warmth(self, srv, prompt: np.ndarray) -> int:
        """Prefix-locality score: the device-index pages ``probe`` would
        map (counted twice), plus the host tier's chain links on this
        replica (a restore is cheaper than a recompute)."""
        pc = srv.prefix_cache
        if pc is None:
            return 0
        score = 2 * int(pc.probe(prompt))
        ti = srv.tiering
        if ti is not None:
            score += sum(1 for k in pc.chain_keys(prompt) if k in ti.store)
        return score

    def _route(self, prompt: np.ndarray, tenant: str, slo_class) -> FleetReplica:
        alive = self.alive()
        if not alive:
            raise FleetError("no alive replicas")
        policy = self.fcfg.policy
        if policy == "round_robin":
            rep = alive[self._rr % len(alive)]
            self._rr += 1
            return rep
        if policy == "least_loaded":
            return min(alive, key=self._load)
        # affinity: sticky (tenant, slo_class) placement while the mapped
        # replica is alive and its queue has room; new keys land by prefix
        # warmth, then least-loaded
        akey = (str(tenant), str(slo_class or ""))
        rid = self._affinity.get(akey)
        if rid is not None:
            rep = next((r for r in alive if r.rid == rid), None)
            if rep is not None and len(rep.srv.queue) < int(rep.srv.config.max_queue_depth):
                return rep
        scored = [(self._warmth(r.srv, prompt), -self._load(r), i, r)
                  for i, r in enumerate(alive)]
        scored.sort(key=lambda t: (t[0], t[1], -t[2]), reverse=True)
        return scored[0][3]

    def _should_shed(self) -> bool:
        """Shed ONLY when every alive replica has enough SLO verdicts to
        judge AND all of them attain below the floor; queue depth never
        sheds at the fleet door (each replica's ``max_queue_depth`` still
        applies after routing). With ``slo_alerts.backpressure`` on, the
        burn-rate engine replaces the floor: shed only while an alert is
        FIRING, never while one is pending."""
        if self.slo_budget is not None and self.fcfg.slo_alerts.backpressure:
            return self.slo_budget.firing() and bool(self.alive())
        floor = float(self.fcfg.admit_attainment_floor)
        if floor <= 0.0:
            return False
        for rep in self.alive():
            snap = rep.srv.slo_snapshot()
            if snap["evaluated"] < int(self.fcfg.min_slo_samples):
                return False
            if snap["attainment"] is not None and snap["attainment"] >= floor:
                return False
        return bool(self.alive())

    def submit(self, prompt, max_new_tokens: Optional[int] = None, seed: int = 0,
               eos_token_id: Optional[int] = None, deadline_s: Optional[float] = None,
               tenant: str = "default", slo_class: Optional[str] = None) -> Request:
        """Route one request to a replica (policy, prefix warmth, load) or
        shed it at the fleet door while the whole fleet misses its SLOs.
        The request carries ``replica`` for trace grouping."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if self._should_shed():
            now = self.clock()
            req = Request(
                prompt=prompt,
                max_new_tokens=int(max_new_tokens if max_new_tokens is not None
                                   else self.config.max_new_tokens),
                seed=int(seed), eos_token_id=eos_token_id, deadline_s=deadline_s,
                tenant=str(tenant), slo_class=slo_class or "",
            )
            req.t_submit = now
            req.status = RequestStatus.REJECTED
            if self.slo_budget is not None and self.slo_budget.firing():
                req.detail = ("fleet shedding: sustained error-budget burn "
                              f"(firing: {', '.join(self.slo_budget.firing_classes())})")
            else:
                req.detail = (f"fleet shedding: attainment < "
                              f"{self.fcfg.admit_attainment_floor} on every replica")
            req.t_finish = now
            self._c_rejections.inc()
            if self.tracer is not None:
                self.tracer.submit(req, now)
                self.tracer.event(req, "reject", now, cause="attainment")
                self.tracer.finish(req, now)
            self.completed_here.append(req)
            return req
        rep = self._route(prompt, tenant, slo_class)
        req = rep.srv.submit(prompt, max_new_tokens=max_new_tokens, seed=seed,
                             eos_token_id=eos_token_id, deadline_s=deadline_s,
                             tenant=tenant, slo_class=slo_class)
        if not req.done:
            req.replica = rep.rid
            rep.routed += 1
            self._c_routed.inc(replica=rep.rid)
            if self.fcfg.policy == "affinity":
                self._affinity[(str(tenant), str(req.slo_class or ""))] = rep.rid
        return req

    # -- stepping -------------------------------------------------------

    def step(self) -> int:
        """One fleet round: consume any pending preemption, then step every
        alive replica. → the active slots after the round, summed over the
        replicas (what each replica's ``step`` returns)."""
        self._poll_preemptions()
        emitted = 0
        for rep in self.replicas:
            if rep.alive:
                emitted += rep.srv.step()
        self._refresh_gauges()
        # the journal and the burn-rate evaluation on the shared cadence
        # (a replica's own step may have taken this interval's snapshot;
        # maybe_evaluate keys off journal.last_t, so alerts advance once a
        # snapshot)
        if self.journal is not None:
            self.journal.maybe_snapshot(self.clock())
            if self.slo_budget is not None:
                self.slo_budget.maybe_evaluate()
        return emitted

    def _refresh_gauges(self) -> None:
        for rep in self.replicas:
            if not rep.alive:
                continue
            srv = rep.srv
            active = sum(1 for s in srv.slots if s.request is not None)
            self._g_rep_occ.set(active / srv.max_slots if srv.max_slots else 0.0,
                                replica=rep.rid)
            self._g_rep_goodput.set(srv.slo_snapshot()["goodput_tokens_per_sec"],
                                    replica=rep.rid)
            self._g_rep_queue.set(float(len(srv.queue)), replica=rep.rid)

    def _idle(self) -> bool:
        return all(not rep.srv.queue and all(s.request is None for s in rep.srv.slots)
                   for rep in self.alive())

    def run(self, max_steps: Optional[int] = None) -> List[Request]:
        """Drive :meth:`step` until every alive replica is idle and no
        preemption is pending → the requests that went terminal."""
        if max_steps is None:
            budget = 16
            for rep in self.alive():
                srv = rep.srv
                budget += 2 * (
                    sum(r.max_new_tokens for r in srv.queue)
                    + sum(s.request.max_new_tokens for s in srv.slots if s.request is not None)
                ) + 8 * len(srv.queue) + 64
        else:
            budget = max_steps
        start = len(self.completed)
        for _ in range(budget):
            if self._idle() and not self._pending_preemption():
                break
            self.step()
        else:
            raise RuntimeError(f"FleetRouter.run: no drain within {budget} steps")
        return self.completed[start:]

    def _pending_preemption(self) -> bool:
        if self.guard.should_stop() and not self._fleet_stop_consumed:
            return True
        return any(r.alive and r.guard.should_stop() for r in self.replicas)

    # -- elastic leave / migration -------------------------------------

    def preempt(self, rid: str) -> None:
        """Programmatic SIGTERM-equivalent: mark ``rid`` for preemption;
        the next :meth:`step` migrates its sessions and retires it."""
        self.replica(rid).guard.request_stop()

    def _poll_preemptions(self) -> None:
        if self.guard.should_stop() and not self._fleet_stop_consumed:
            # a real SIGTERM on the router: pick ONE victim
            self._fleet_stop_consumed = True
            alive = self.alive()
            if alive:
                victim = (max(alive, key=self._load)
                          if self.fcfg.preempt_policy == "most_loaded" else alive[0])
                victim.guard.request_stop()
        for rep in self.replicas:
            if rep.alive and rep.guard.should_stop():
                self._preempt_replica(rep)

    def _preempt_replica(self, rep: FleetReplica) -> None:
        """Elastic leave: reroute the backlog, migrate live decode
        sessions, restart not-yet-emitting ones on peers, then drain and
        leak-audit the empty replica. After this the replica is dead: its
        pools free of sessions, its prefix index intact but unreachable."""
        now = self.clock()
        srv = rep.srv
        log_dist(f"fleet: preempting {rep.rid} (queue={len(srv.queue)}, "
                 f"active={sum(1 for s in srv.slots if s.request)})")
        # dead to the router FIRST: rerouted backlog and migration targets
        # must never land back on the replica being retired
        rep.alive = False
        for req in srv.takeover_queue():
            self._requeue(req, now, f"replica {rep.rid} preempted", fresh=False)
        for i, slot in enumerate(srv.slots):
            if slot.request is None:
                continue
            if slot.prefilling or not slot.request.tokens:
                # nothing emitted yet: a fresh start on a peer replays the
                # same stream, so restart instead of moving prefill state
                req = srv.release_slot(i, now)
                self._c_requeues.inc()
                self._requeue(req, now, f"replica {rep.rid} preempted mid-prefill")
            elif self.fcfg.migrate_sessions:
                self._migrate_session(rep, i, now)
            else:
                req = srv.release_slot(i, now)
                self._c_requeues.inc()
                self._requeue(req, now, "migration disabled; restarted")
        srv.drain(deadline_s=0.0)
        srv.check_no_leaks()
        self._affinity = {k: v for k, v in self._affinity.items() if v != rep.rid}
        self._g_replicas.set(len(self.alive()))
        self._g_rep_occ.set(0.0, replica=rep.rid)
        self._g_rep_goodput.set(0.0, replica=rep.rid)

    def _pick_dest(self, src: FleetReplica, req: Request) -> Optional[FleetReplica]:
        cands = [r for r in self.alive() if r is not src]
        if not cands:
            return None
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        return max(cands, key=lambda r: (self._warmth(r.srv, prompt), -self._load(r)))

    def _migrate_session(self, src: FleetReplica, slot_i: int, now: float) -> bool:
        """Move one LIVE decode session ``src`` → a peer through the
        manifest protocol. The source slot is released BEFORE the
        destination adopts: in between the session exists only as the
        crc-checked payload, so no token is ever emitted by two replicas.
        A payload that fails validation or reading is a counted
        ``crc_failed`` migration and the session restarts from scratch on
        a peer; a peer without a free slot or pages, ``no_capacity``. An
        error of the transport itself (the gather or scatter program)
        raises."""
        srv = src.srv
        req = srv.slots[slot_i].request
        t0 = time.perf_counter()
        state, arrays = srv.export_session(slot_i)
        dst = self._pick_dest(src, req)
        srv.release_slot(slot_i, now)
        tag_dir = write_tag(self._mig_dir, f"mig-{req.id}", arrays, client_state=state,
                            fingerprint=f"migration:{req.id}", save_latest=False)
        if self.on_migration_payload is not None:
            self.on_migration_payload(tag_dir, req)
        ok, reason = validate_tag(tag_dir)
        adopted = None
        if ok and dst is not None:
            try:
                man = read_manifest(tag_dir)
                payload = load_arrays(tag_dir, man)
            except Exception as e:  # a torn payload surfaces as a failure
                ok, reason = False, f"{type(e).__name__}: {e}"
        # each rank read its own copy: a failure on one is a failure on all
        if not srv.agree(ok):
            ok, reason = False, reason or "the payload failed on another rank"
        if ok and dst is not None:
            # outside the try: a transport that fails to build or run
            # raises, it is never counted as a bad payload and requeued
            adopted = dst.srv.adopt_session(man.get("client_state") or state, payload,
                                            request=req)
        shutil.rmtree(tag_dir, ignore_errors=True)
        nbytes = sum(int(a.numel() * a.element_size()) if isinstance(a, torch.Tensor)
                     else int(np.asarray(a).nbytes) for a in arrays.values())
        blackout = time.perf_counter() - t0
        if adopted is not None:
            req.replica = dst.rid
            if self.fcfg.policy == "affinity":
                self._affinity[(str(req.tenant), str(req.slo_class or ""))] = dst.rid
            self._c_migrations.inc(status="ok")
            self._c_mig_bytes.inc(nbytes)
            self._h_blackout.observe(blackout)
            if self.tracer is not None:
                self.tracer.event(req, "migration", self.clock(), src=src.rid, dst=dst.rid,
                                  pages=int(state["n_pages"]), bytes=nbytes,
                                  blackout_s=round(blackout, 6))
            return True
        status = "no_capacity" if ok else "crc_failed"
        self._c_migrations.inc(status=status)
        self._c_requeues.inc()
        if self.tracer is not None:
            self.tracer.event(req, "migration", self.clock(), src=src.rid,
                              dst=dst.rid if dst is not None else "", status=status,
                              reason="" if ok else reason)
        self._requeue(req, now, f"migration failed ({status}); restarted")
        return False

    def _requeue(self, req: Request, now: float, why: str, fresh: bool = True) -> None:
        """Restart a session from scratch on a peer: rewind its emitted
        state (``fresh``; a still-QUEUED backlog request keeps its clean
        state) and enqueue it on the least-loaded alive replica. Only when
        NO replica can take it does the request go terminal PREEMPTED."""
        if fresh:
            req.status = RequestStatus.QUEUED
            req.tokens = []
            req.t_emissions = []
            req.margins = []
            req.t_first_token = None
            req.t_admit = None
            req.t_requeue = now
            req.detail = why
            req.prefix_shared_tokens = 0
            req.cow_forked = False
            req.draft_state = None
        for rep in sorted(self.alive(), key=self._load):
            if rep.srv.adopt_request(req):
                req.replica = rep.rid
                if self.tracer is not None:
                    self.tracer.event(req, "requeue", now, cause=why, replica=rep.rid)
                return
        req.status = RequestStatus.PREEMPTED
        req.detail = f"{why}; no replica could adopt"
        req.t_finish = now
        if self.tracer is not None:
            self.tracer.event(req, "requeue", now, cause=req.detail)
            self.tracer.finish(req, now)
        self.completed_here.append(req)

    # -- shutdown / audit ----------------------------------------------

    def drain(self, deadline_s: Optional[float] = None) -> Dict[str, Any]:
        """Graceful fleet shutdown: drain every alive replica."""
        out: Dict[str, Any] = {"replicas": {}}
        for rep in self.replicas:
            if rep.alive:
                out["replicas"][rep.rid] = rep.srv.drain(deadline_s=deadline_s)
        if self.tracer is not None:
            self.tracer.flush()
        return out

    def check_no_leaks(self) -> None:
        """Fleet drain invariant: EVERY replica, dead ones included, holds
        zero session pages; a page left on a dead replica means a
        migration leaked across replica death."""
        for rep in self.replicas:
            rep.srv.check_no_leaks()

    def close(self) -> None:
        """Release the router's SIGTERM handler and its migration
        directory (a configured ``migration_dir`` stays)."""
        self.guard.uninstall()
        if not self.fcfg.migration_dir:
            shutil.rmtree(self._mig_dir, ignore_errors=True)

    def stats(self) -> Dict[str, Any]:
        """The JAX router's ``stats()``: the fleet's counters and
        per-replica load, attainment and goodput (and the burn-rate
        alerts when configured)."""
        reps = {}
        for rep in self.replicas:
            snap = rep.srv.slo_snapshot()
            reps[rep.rid] = {
                "alive": rep.alive,
                "routed": rep.routed,
                "queue": len(rep.srv.queue),
                "active": sum(1 for s in rep.srv.slots if s.request is not None),
                "goodput_tokens_per_sec": snap["goodput_tokens_per_sec"],
                "attainment": snap["attainment"],
            }
        out = {
            "fleet": {
                "replicas": len(self.replicas),
                "alive": len(self.alive()),
                "policy": self.fcfg.policy,
                "migrations_ok": self._c_migrations.value(status="ok"),
                "migrations_crc_failed": self._c_migrations.value(status="crc_failed"),
                "migrations_no_capacity": self._c_migrations.value(status="no_capacity"),
                "migration_bytes": self._c_mig_bytes.value(),
                "migration_blackout_p99_s": self._h_blackout.quantile(0.99),
                "requeues": self._c_requeues.value(),
                "rejections": self._c_rejections.value(),
            },
            "replicas": reps,
        }
        if self.slo_budget is not None:
            out["slo_alerts"] = {
                "firing": self.slo_budget.firing(),
                "fired_total": self.slo_budget.alerts_fired,
                "resolved_total": self.slo_budget.alerts_resolved,
                "classes": self.slo_budget.states(),
            }
        return out


def replay_fleet(
    fleet: FleetRouter,
    items: Sequence[ReplayItem],
    step_dt: float = 0.0,
    max_steps: Optional[int] = None,
    preempt_at: Optional[float] = None,
    preempt_rid: Optional[str] = None,
) -> Dict[str, Any]:
    """Drive a fleet through a workload the way ``replay`` drives one
    engine, plus one scripted elastic leave: at offset ``preempt_at`` the
    ``preempt_rid`` replica (default: the most loaded) is preempted and the
    next step migrates it away. → ``{"requests", "steps", "duration_s"}``."""
    virtual = isinstance(fleet.clock, ReplayClock)
    items = sorted(items, key=lambda it: it.t_arrival)
    t_start = fleet.clock()
    submitted: List[Request] = []
    i = 0
    steps = 0
    preempted = preempt_at is None
    if max_steps is None:
        per_req = max(it.max_new_tokens for it in items) if items else 1
        max_steps = 8 * len(items) * (per_req + 4) + 2048
    while True:
        now = fleet.clock() - t_start
        if not preempted and now >= preempt_at and fleet.alive():
            rid = preempt_rid
            if rid is None:
                rid = max(fleet.alive(), key=FleetRouter._load).rid
            fleet.preempt(rid)
            preempted = True
        while i < len(items) and items[i].t_arrival <= now:
            it = items[i]
            submitted.append(fleet.submit(
                it.prompt, max_new_tokens=it.max_new_tokens, seed=it.seed,
                tenant=it.tenant, slo_class=it.slo_class,
            ))
            i += 1
        idle = fleet._idle() and not fleet._pending_preemption()
        if idle and i >= len(items) and (preempted or not virtual):
            break
        if idle and i < len(items):
            if virtual:
                fleet.clock.t = t_start + items[i].t_arrival
            else:
                time.sleep(max(0.0, items[i].t_arrival - now))
            steps += 1
            if steps > max_steps:
                raise RuntimeError("replay_fleet: step budget exhausted")
            continue
        if idle and not preempted:
            # nothing left but the scripted preemption: jump to it
            if virtual:
                fleet.clock.t = max(fleet.clock.t, t_start + preempt_at)
            continue
        queued = [r for rep in fleet.alive() for r in rep.srv.queue]
        active = any(s.request is not None for rep in fleet.alive() for s in rep.srv.slots)
        if not active and queued and all(r.not_before > fleet.clock() for r in queued):
            target = min(r.not_before for r in queued)
            if i < len(items):
                target = min(target, t_start + items[i].t_arrival)
            if virtual:
                fleet.clock.t = max(fleet.clock.t, target)
            else:
                time.sleep(max(0.0, target - fleet.clock()))
        fleet.step()
        steps += 1
        if steps > max_steps:
            raise RuntimeError(f"replay_fleet: no drain within {max_steps} steps")
        if virtual and step_dt > 0.0:
            fleet.clock.advance(step_dt)
    return {
        "requests": submitted,
        "steps": steps,
        "duration_s": fleet.clock() - t_start,
    }
