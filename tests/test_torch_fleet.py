"""The port's serving fleet on the CPU, held against the JAX package's
(``tests/unit/test_serving_fleet.py`` and the fleet cases of
``tests/unit/test_timeseries.py`` are the oracle):

- ``serving.fleet``: defaults, coercion and every rejection with JAX's
  message; a ``placement`` beside the fleet still refused, naming its
  ROADMAP item (11c: the fleet over placements);
- the 16-request mixed suite with every feature (speculation, prefix
  sharing, chunked prefill, int8 pages, the host tier) on 2 replicas with
  a forced mid-stream preemption, through both packages under one stepped
  clock: streams equal the port's un-migrated engine and JAX's fleet, the
  routing (``req.replica``), the ``fleet_*`` counters, ``stats()`` and the
  terminal trace records equal JAX's (wall-clock blackout aside), at
  least one ``ok`` migration, no leak on either replica;
- the SIGTERM delivered by the fault injector and the crc-corrupted
  payload (counted, requeued, finished with the un-migrated stream);
- a session exported by either package, written with its ``write_tag``,
  validated, loaded and adopted by the other, finishing with the
  adopter's un-migrated stream (int8 pages with speculation; f32 pages
  sampled, with the keys);
- backpressure: shed only while the burn-rate engine fires, never while
  pending; the fleet's step drives the journal and the alerts;
- ``tools/request_trace.py --by replica`` equal to JAX's CLI.

gpt2-tiny, fp32 compute, from the same numpy weights.

Waiting for other items: Engine G's fleet protocol model and its
``drop-migration-free`` mutation (ROADMAP queue 1 item 15)."""

import glob
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.inference.engine import InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.resilience import manifest as jmanifest
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu.serving import FleetRouter as JaxFleetRouter
from deepspeed_tpu.telemetry.request_trace import RequestTracer as JaxRequestTracer
from deepspeed_tpu.telemetry.request_trace import load_request_records as jax_load
from deepspeed_tpu.tools import request_trace as jax_cli
from deepspeed_tpu_torch.resilience import FaultInjector
from deepspeed_tpu_torch.resilience import manifest as tmanifest
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.serving import FleetError, FleetRouter, RequestStatus
from deepspeed_tpu_torch.telemetry.request_trace import RequestTracer, load_request_records
from deepspeed_tpu_torch.telemetry.timeseries import MetricsJournal
from deepspeed_tpu_torch.tools import request_trace as cli
from deepspeed_tpu_torch.utils.weights import params_from_numpy
from tests.torch_threads import one_torch_thread  # noqa: F401

BASE = {"max_slots": 4, "page_size": 4, "num_pages": 64, "max_prompt_len": 12,
        "max_new_tokens": 8}
ALL_FEATURES = {"speculative": {"enabled": True, "k": 3}, "prefix_cache": {"enabled": True},
                "prefill_chunk_tokens": 8, "kv_cache_dtype": "int8",
                "tiering": {"enabled": True, "host_budget_pages": 64}}
FLEET2 = {"fleet": {"enabled": True, "replicas": 2}}
VOCAB = 512
STEP_S = 0.01


@pytest.fixture(scope="module")
def tree():
    cfg = jgpt2.get_config("gpt2-tiny")
    return jax.tree.map(np.asarray, jgpt2.init_params(cfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def engine(tree):
    return dtt.init_inference(dtt.get_config("gpt2-tiny"), params=params_from_numpy(tree, "cpu"),
                              dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def jax_engine(tree):
    cfg = jgpt2.get_config("gpt2-tiny", attn_impl="jnp")
    return JaxInferenceEngine(jgpt2.make_module(cfg), params=jax.tree.map(jnp.asarray, tree),
                              dtype=jnp.float32)


def _mixed_requests(n=16, seed=7):
    rs = np.random.RandomState(seed)
    plens = [2, 5, 8, 12, 7, 3, 11, 4] * 2
    return [(rs.randint(0, VOCAB, (plens[i],)).astype(np.int32), 6 if i % 7 else (1, 3, 8)[i // 7])
            for i in range(n)]


def _unmigrated(engine, reqs, cfg=None):
    srv = engine.serve(dict(BASE, **ALL_FEATURES) if cfg is None else cfg)
    subs = [srv.submit(p, max_new_tokens=n, seed=i) for i, (p, n) in enumerate(reqs)]
    srv.run()
    srv.drain()
    srv.release_prefix_cache()
    srv.check_no_leaks()
    srv.tiering.close()
    return [list(r.tokens) for r in subs]


def _idle(fleet):
    """Every alive replica's queue and slots empty (either package's fleet)."""
    return all(not rep.srv.queue and all(s.request is None for s in rep.srv.slots)
               for rep in fleet.alive())


class SteppedClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _preempted_run(router_cls, engine, tracer, reqs, cfg=None, on_payload=None):
    """The suite through a 2-replica fleet under a stepped clock: 3 steps,
    then the most loaded replica preempted with live sessions mid-stream,
    then steps to the end."""
    clk = SteppedClock()
    fleet = router_cls(engine, dict(BASE, **ALL_FEATURES, **FLEET2) if cfg is None else cfg,
                       clock=clk, tracer=tracer)
    fleet.on_migration_payload = on_payload
    subs = [fleet.submit(p, max_new_tokens=n, seed=i) for i, (p, n) in enumerate(reqs)]
    for _ in range(3):
        fleet.step()
        clk.t += STEP_S
    victim = max(fleet.alive(), key=type(fleet)._load)
    live = [s for s in victim.srv.slots
            if s.request is not None and not s.prefilling and s.request.tokens]
    assert live, "the preemption landed before any session went mid-stream"
    fleet.preempt(victim.rid)
    for _ in range(400):
        if _idle(fleet) and not fleet._pending_preemption():
            break
        fleet.step()
        clk.t += STEP_S
    assert not fleet.replica(victim.rid).alive
    return fleet, subs


def _fleet_families(reg):
    """The fleet families of a registry's Prometheus text, the wall-clock
    blackout histogram's sum and buckets aside (its count stays)."""
    out = []
    for ln in reg.to_prometheus().splitlines():
        if not ln.startswith("fleet_"):
            continue
        if ln.startswith(("fleet_migration_blackout_seconds_bucket",
                          "fleet_migration_blackout_seconds_sum")):
            continue
        out.append(ln)
    return out


def _normalized(records):
    """Terminal records without ``ts``/``host``, ids as offsets from the
    run's first, and the migration event's wall-clock blackout dropped."""
    base = min(r["id"] for r in records)
    out = []
    for r in records:
        r = {k: v for k, v in r.items() if k not in ("ts", "host")}
        r["id"] -= base
        r["events"] = [{k: v for k, v in e.items() if k != "blackout_s"} for e in r["events"]]
        out.append(r)
    return sorted(out, key=lambda r: r["id"])


@pytest.fixture(scope="module")
def suite(engine, jax_engine, tmp_path_factory):
    """The mixed suite: the port's un-migrated engine, the port's fleet and
    JAX's fleet, each fleet traced."""
    root = tmp_path_factory.mktemp("fleet")
    reqs = _mixed_requests()
    ref = _unmigrated(engine, reqs)
    out = {"ref": ref, "root": root}
    for side, router_cls, tracer_cls, eng in (
            ("port", FleetRouter, RequestTracer, engine),
            ("jax", JaxFleetRouter, JaxRequestTracer, jax_engine)):
        tracer = tracer_cls(str(root / f"{side}.jsonl"), flush_interval=1)
        fleet, subs = _preempted_run(router_cls, eng, tracer, reqs)
        st = fleet.stats()
        fams = _fleet_families(fleet.metrics)
        fleet.drain()
        fleet.check_no_leaks()  # every replica, the dead one included
        fleet.close()
        tracer.close()
        out[side] = {"streams": [list(r.tokens) for r in subs], "replicas": [r.replica for r in subs],
                     "stats": st, "families": fams, "trace": tracer.file_path,
                     "status": [r.status for r in subs]}
    return out


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def test_fleet_config_defaults_and_coercion():
    cfg = tconfig.ServingConfig()
    assert cfg.fleet.enabled is False
    cfg = tconfig.ServingConfig(fleet={"enabled": True, "replicas": 3})
    assert cfg.fleet.replicas == 3 and cfg.fleet.policy == "affinity"
    # every field and default equal to JAX's, and the dict form coerced
    assert tconfig.FleetConfig().__dict__.keys() == jconfig.FleetConfig().__dict__.keys()
    for key, value in tconfig.FleetConfig().__dict__.items():
        if key != "slo_alerts":
            assert value == getattr(jconfig.FleetConfig(), key), key
    cfg = tconfig.ServingConfig.from_dict(dict(BASE, fleet={
        "enabled": 1, "replicas": "3", "admit_attainment_floor": "0.5",
        "slo_alerts": {"enabled": True, "for_s": 2}}))
    assert cfg.fleet.enabled is True and cfg.fleet.replicas == 3
    assert cfg.fleet.admit_attainment_floor == 0.5
    assert isinstance(cfg.fleet.slo_alerts, tconfig.SLOAlertsConfig)
    assert cfg.fleet.slo_alerts.enabled and cfg.fleet.slo_alerts.for_s == 2.0


@pytest.mark.parametrize("bad", [
    {"replicas": 0},
    {"policy": "hash_ring"},
    {"preempt_policy": "newest"},
    {"admit_attainment_floor": 1.5},
    {"min_slo_samples": 0},
])
def test_fleet_config_rejects_with_jax_message(bad):
    with pytest.raises(jconfig.DeepSpeedConfigError) as jerr:
        jconfig.FleetConfig(**bad)
    with pytest.raises(tconfig.DeepSpeedConfigError) as terr:
        tconfig.FleetConfig(**bad)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(tconfig.DeepSpeedConfigError):
        tconfig.ServingConfig.from_dict(dict(BASE, fleet=dict(bad, enabled=True)))


def test_fleet_builds_and_placement_still_refused(engine):
    fleet = FleetRouter(engine, dict(BASE, **FLEET2))
    try:
        assert [r.rid for r in fleet.replicas] == ["r0", "r1"]
        assert fleet.replicas[0].srv is not fleet.replicas[1].srv
        assert all(r.srv.config.fleet.enabled is False for r in fleet.replicas)
        assert fleet._visible_devices() == 1
    finally:
        fleet.close()
    with pytest.raises(tconfig.NotPortedError, match="item 11c"):
        FleetRouter(engine, dict(BASE, **FLEET2, placement={"tp": 2}))


# ---------------------------------------------------------------------------
# the mixed suite through a preempted fleet, both packages
# ---------------------------------------------------------------------------

def test_streams_equal_unmigrated_engine_and_jax_fleet(suite):
    assert suite["port"]["streams"] == suite["ref"], [
        i for i, (a, b) in enumerate(zip(suite["ref"], suite["port"]["streams"])) if a != b]
    assert suite["port"]["streams"] == suite["jax"]["streams"]
    assert set(suite["port"]["status"]) == {RequestStatus.FINISHED}


def test_routing_equals_jax(suite):
    assert all(suite["port"]["replicas"])
    assert suite["port"]["replicas"] == suite["jax"]["replicas"]


def test_counters_and_stats_equal_jax(suite):
    pst, jst = suite["port"]["stats"], suite["jax"]["stats"]
    assert pst["fleet"]["migrations_ok"] >= 1, pst
    assert pst["fleet"]["migration_blackout_p99_s"] is not None
    for st in (pst, jst):
        st["fleet"].pop("migration_blackout_p99_s")
    assert pst == jst
    assert suite["port"]["families"] == suite["jax"]["families"]
    assert any(ln.startswith('fleet_migrations_total{status="ok"}')
               for ln in suite["port"]["families"])


def test_trace_records_equal_jax(suite):
    pr = load_request_records(suite["port"]["trace"])
    jr = jax_load(suite["jax"]["trace"])
    assert len(pr) == 16
    assert _normalized(pr) == _normalized(jr)
    migrated = [e for r in pr for e in r["events"] if e["e"] == "migration"]
    assert migrated and all(e["src"] != e["dst"] and e["bytes"] > 0 and e["blackout_s"] >= 0
                            for e in migrated)
    assert any(e["e"] == "requeue" for r in pr for e in r["events"])


def test_cli_by_replica_equals_jax(suite, capsys):
    for path in (suite["port"]["trace"], suite["jax"]["trace"]):
        assert cli.main([path, "--by", "replica", "--json"]) == 0
        port_doc = json.loads(capsys.readouterr().out)
        assert jax_cli.main([path, "--by", "replica", "--json"]) == 0
        assert port_doc == json.loads(capsys.readouterr().out)
        assert port_doc["by"] == "replica" and port_doc["records"] == 16
        groups = set(port_doc["score"]["groups"])
        assert groups and groups <= {"r0", "r1"}, groups
        assert cli.main([path, "--by", "replica"]) == 0
        out = capsys.readouterr().out
        assert "(replica)" in out and ("r0" in out or "r1" in out)


# ---------------------------------------------------------------------------
# SIGTERM through the fault injector; a corrupted payload
# ---------------------------------------------------------------------------

def test_injected_sigterm_mid_decode_migrates_and_finishes(engine):
    inj = FaultInjector(tconfig.FaultInjectionConfig(enabled=True, sigterm_steps=[2]))
    fleet = FleetRouter(engine, dict(BASE, **ALL_FEATURES,
                                     fleet={"enabled": True, "replicas": 2,
                                            "install_sigterm": True}))
    reqs = _mixed_requests(n=8)
    try:
        subs = [fleet.submit(p, max_new_tokens=n, seed=i) for i, (p, n) in enumerate(reqs)]
        steps = 0
        while not _idle(fleet) or fleet._pending_preemption():
            if inj.fire("sigterm", steps):
                assert inj.deliver_sigterm(), "no SIGTERM handler"
            fleet.step()
            steps += 1
            assert steps < 2000
        assert inj.counts().get("sigterm") == 1
        assert len(fleet.alive()) == 1  # one replica retired
        assert all(r.done for r in subs)
        assert {r.status for r in subs} == {RequestStatus.FINISHED}
        st = fleet.stats()["fleet"]
        assert st["migrations_ok"] + st["requeues"] >= 1
        assert [list(r.tokens) for r in subs] == _unmigrated(engine, reqs)
        fleet.drain()
        fleet.check_no_leaks()
    finally:
        prev = signal.getsignal(signal.SIGTERM)
        fleet.close()
        # close() releases the process-wide SIGTERM handler
        assert signal.getsignal(signal.SIGTERM) is not prev


def test_crc_failure_is_counted_requeued_and_finishes(engine):
    def corrupt(tag_dir, req):
        # one byte of the first array file flipped AFTER the manifest
        # recorded its crc: validate_tag must refuse the payload
        fname = sorted(glob.glob(os.path.join(tag_dir, "*.bin")))[0]
        with open(fname, "r+b") as fh:
            b = fh.read(1)
            fh.seek(0)
            fh.write(bytes([b[0] ^ 0xFF]))

    reqs = _mixed_requests(n=8)
    fleet, subs = _preempted_run(FleetRouter, engine, None, reqs, on_payload=corrupt)
    try:
        st = fleet.stats()["fleet"]
        assert st["migrations_crc_failed"] >= 1, st
        assert st["migrations_ok"] == 0
        assert st["requeues"] >= st["migrations_crc_failed"]
        assert fleet._c_migrations.value(status="crc_failed") == st["migrations_crc_failed"]
        assert all(r.status == RequestStatus.FINISHED for r in subs)
        assert [list(r.tokens) for r in subs] == _unmigrated(engine, reqs)
        fleet.drain()
        fleet.check_no_leaks()
    finally:
        fleet.close()


# ---------------------------------------------------------------------------
# a session across the packages, both directions
# ---------------------------------------------------------------------------

CROSS = {
    # int8 codes + scales, speculation (no keys)
    "int8_spec": dict(BASE, speculative={"enabled": True, "k": 3},
                      prefix_cache={"enabled": True}, kv_cache_dtype="int8"),
    # f32 pages, sampled: the keys ride the payload
    "f32_sampled": dict(BASE, kv_cache_dtype="float32", temperature=0.8, top_k=50),
}


@pytest.fixture(scope="module")
def jax_servers(jax_engine):
    return {name: jax_engine.serve(cfg) for name, cfg in CROSS.items()}


def _mid_stream(srv, prompt, budget, seed):
    """Submit one request and step until it has emitted tokens and is still
    decoding → (request, its slot)."""
    req = srv.submit(prompt, max_new_tokens=budget, seed=seed)
    for _ in range(50):
        srv.step()
        slot = next((i for i, s in enumerate(srv.slots) if s.request is req), None)
        if slot is not None and len(req.tokens) >= 2 and not srv.slots[slot].prefilling:
            return req, slot
    raise AssertionError("the request never went mid-stream")


def _finish_alone(srv, prompt, budget, seed):
    req = srv.submit(prompt, max_new_tokens=budget, seed=seed)
    srv.run()
    return list(req.tokens)


@pytest.mark.parametrize("name", sorted(CROSS))
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_session_migrates_across_packages(engine, jax_servers, tmp_path, name, direction):
    prompt = np.random.RandomState(5).randint(0, VOCAB, (11,)).astype(np.int32)
    budget, seed = 8, 3
    jsrv = jax_servers[name]
    tsrv = engine.serve(CROSS[name])
    src, dst = (jsrv, tsrv) if direction == "jax_to_port" else (tsrv, jsrv)
    src_write = jmanifest.write_tag if direction == "jax_to_port" else tmanifest.write_tag
    dst_mf = tmanifest if direction == "jax_to_port" else jmanifest
    want = _finish_alone(dst, prompt, budget, seed)
    req, slot = _mid_stream(src, prompt, budget, seed)
    state, arrays = src.export_session(slot)
    src.release_slot(slot)
    assert set(arrays) == ({"k_pages", "v_pages", "kv_scales"} if name == "int8_spec"
                           else {"k_pages", "v_pages", "keys"})
    tag = src_write(str(tmp_path), f"mig-{req.id}", arrays, client_state=state,
                    fingerprint=f"migration:{req.id}", save_latest=False)
    ok, reason = dst_mf.validate_tag(tag)
    assert ok, reason
    man = dst_mf.read_manifest(tag)
    entries = man["arrays"]
    if name == "int8_spec":
        assert entries["k_pages"]["dtype"] == "int8" and entries["kv_scales"]["dtype"] == "float32"
    else:
        assert entries["keys"]["dtype"] == "uint32" and entries["keys"]["shape"] == [budget - 1, 2]
    mc = engine.model_config
    assert entries["k_pages"]["shape"] == [mc.n_layer, src.pages_per_slot, mc.n_head, 4,
                                           mc.head_dim]
    adopted = dst.adopt_session(man["client_state"], dst_mf.load_arrays(tag, man))
    assert adopted is not None and adopted.id == req.id and adopted.tokens == req.tokens
    dst.run()
    assert adopted.status == RequestStatus.FINISHED
    assert list(adopted.tokens) == want
    for srv in (src, dst):
        srv.check_no_leaks()


# ---------------------------------------------------------------------------
# backpressure and the journal (test_timeseries.py's TestFleetBackpressure)
# ---------------------------------------------------------------------------

SERVING_F32 = dict(BASE, kv_cache_dtype="float32")


def _alert_fleet(engine, tmp_path, for_s):
    clk = SteppedClock()
    j = MetricsJournal(str(tmp_path / "fleet.jsonl"), clock=clk, interval_s=1.0, flush_interval=1)
    fleet = FleetRouter(engine, dict(
        SERVING_F32,
        slo={"classes": {"interactive": {"ttft_target_s": 1.0}}, "default_class": "interactive"},
        fleet={"enabled": True, "replicas": 2, "slo_alerts": {
            "enabled": True, "backpressure": True, "objective": 0.99,
            "fast_short_s": 5.0, "fast_long_s": 30.0, "fast_burn_threshold": 10.0,
            "slow_short_s": 30.0, "slow_long_s": 120.0, "slow_burn_threshold": 1.0,
            "for_s": for_s}},
    ), clock=clk, journal=j)
    return clk, j, fleet


def _drive(journal, budget, c_ev, c_met, clk, start, end, miss_every=0):
    for sec in range(start, end):
        clk.t = float(sec)
        for i in range(10):
            c_ev.inc(slo_class="interactive")
            if not miss_every or i % miss_every != 0:
                c_met.inc(slo_class="interactive")
        journal.maybe_snapshot(clk.t)
        budget.maybe_evaluate()


def test_sheds_only_on_firing_never_pending(engine, tmp_path):
    clk, j, fleet = _alert_fleet(engine, tmp_path, for_s=20.0)
    m = fleet.metrics
    c_ev = m.counter("serving_slo_evaluated_total", "", labelnames=("slo_class",))
    c_met = m.counter("serving_slo_met_total", "", labelnames=("slo_class",))
    budget = fleet.slo_budget
    assert budget is not None and not fleet._should_shed()
    _drive(j, budget, c_ev, c_met, clk, 0, 40)
    assert not fleet._should_shed()
    # the violation starts: the rules go pending (a 20 s dwell), no shedding
    _drive(j, budget, c_ev, c_met, clk, 40, 50, miss_every=2)
    assert any(st["state"] == "pending" for st in budget._states.values())
    assert not fleet._should_shed()
    req = fleet.submit(np.arange(4, dtype=np.int32), max_new_tokens=2)
    assert req.status != RequestStatus.REJECTED and req.replica
    # the dwell elapses under sustained violation: firing, shedding
    _drive(j, budget, c_ev, c_met, clk, 50, 75, miss_every=2)
    assert budget.firing() and fleet._should_shed()
    req = fleet.submit(np.arange(4, dtype=np.int32), max_new_tokens=2)
    assert req.status == RequestStatus.REJECTED
    assert "sustained error-budget burn" in req.detail
    assert fleet.stats()["fleet"]["rejections"] == 1.0
    assert req in fleet.completed
    # recovery: resolved, admissions reopen
    _drive(j, budget, c_ev, c_met, clk, 75, 200)
    assert not budget.firing() and not fleet._should_shed()
    fleet.drain()
    fleet.close()
    j.close()


def test_fleet_step_drives_journal_and_alerts(engine, tmp_path):
    clk, j, fleet = _alert_fleet(engine, tmp_path, for_s=0.0)
    for i, (p, n) in enumerate(_mixed_requests(n=4)):
        fleet.submit(p, max_new_tokens=n, seed=i)
    evaluations = []
    real = fleet.slo_budget.maybe_evaluate
    fleet.slo_budget.maybe_evaluate = lambda: evaluations.append(clk.t) or real()
    for _ in range(200):
        if _idle(fleet):
            break
        fleet.step()
        clk.t += 0.5
    assert j.snapshots > 0 and len(evaluations) > 0
    # per-replica gauges journaled under {replica="..."} labels
    assert sorted(j.sids("fleet_replica_occupancy")) == [
        'fleet_replica_occupancy{replica="r0"}', 'fleet_replica_occupancy{replica="r1"}']
    assert j.sids("fleet_replica_queue_depth")
    st = fleet.stats()
    assert st["slo_alerts"]["firing"] is False
    fleet.drain()
    fleet.check_no_leaks()
    fleet.close()
    j.close()


def test_slo_alerts_need_a_journal(engine):
    with pytest.raises(FleetError, match="requires a metrics journal"):
        FleetRouter(engine, dict(SERVING_F32, fleet={"enabled": True,
                                                     "slo_alerts": {"enabled": True}}))
