"""The port's trace-replay harness and its CLIs on the CPU, held against the
JAX package's (``tests/unit/test_request_trace.py``'s replay cases,
``tests/unit/test_timeseries.py``'s journal and ``fleet_dash`` cases and
``tests/unit/test_serving_fleet.py`` are the oracle):

- ``generate_workload``: items equal to JAX's field for field (arrival
  floats exact, prompts equal) over bursts on and off, diurnal, 1 and 4
  tenants and two seeds;
- ``replay`` under a ``ReplayClock``: greedy streams, step counts, the
  terminal trace records (ids as offsets from each run's first) and
  ``score_requests`` equal JAX's, in the steady case and under overload
  (queue waits emitted); the metrics journal byte-identical across two
  port runs;
- ``replay_fleet`` with a scripted preemption: streams, routing and the
  fleet's counters equal JAX's;
- ``request_phases`` / ``time_binned`` and ``tools/request_trace.py``'s
  JSON equal JAX's on the same records;
- ``tools/fleet_dash.py``: the exit matrix, ``--watch --iterations``, the
  report and forecast, ``--diff``, with ``--json`` equal to JAX's CLI on
  the same journal.

gpt2-tiny, fp32, from the same numpy weights."""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.inference.engine import InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.serving import FleetRouter as JaxFleetRouter
from deepspeed_tpu.serving import replay_fleet as jax_replay_fleet
from deepspeed_tpu.telemetry import request_trace as jrt
from deepspeed_tpu.tools import fleet_dash as jax_dash
from deepspeed_tpu.tools import request_trace as jax_cli
from deepspeed_tpu_torch.serving import (
    FleetRouter,
    ReplayClock,
    WorkloadSpec,
    generate_workload,
    replay,
    replay_fleet,
)
from deepspeed_tpu_torch.telemetry import request_trace as trt
from deepspeed_tpu_torch.telemetry.registry import MetricsRegistry
from deepspeed_tpu_torch.telemetry.slo_budget import SLOBudgetEngine
from deepspeed_tpu_torch.telemetry.timeseries import MetricsJournal, load_journal
from deepspeed_tpu_torch.runtime.config import SLOAlertsConfig
from deepspeed_tpu_torch.tools import fleet_dash
from deepspeed_tpu_torch.tools import request_trace as cli
from deepspeed_tpu_torch.utils.weights import params_from_numpy
from tests.torch_threads import one_torch_thread  # noqa: F401

# the module (the package's ``replay`` attribute is the function)
jreplay = importlib.import_module("deepspeed_tpu.serving.replay")

SERVING_CFG = {"max_slots": 4, "page_size": 4, "num_pages": 64, "max_prompt_len": 12,
               "max_new_tokens": 8, "kv_cache_dtype": "float32"}
SLO_CFG = {"classes": {"interactive": {"ttft_target_s": 0.5, "tpot_target_s": 0.2},
                       "batch": {"ttft_target_s": 5.0}},
           "default_class": "batch"}
# TestReplayHarness's spec
SPEC = dict(n_requests=10, vocab_size=256, max_prompt_len=12, max_new_tokens=4,
            base_interarrival_s=0.02, diurnal_amplitude=0.6, burst_factor=2.0,
            n_tenants=3, prefix_fraction=0.5, slo_classes=["interactive", "batch"])


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


# ---------------------------------------------------------------------------
# the seeded workload
# ---------------------------------------------------------------------------

WORKLOADS = {
    "steady_seed11": dict(SPEC, seed=11),
    "steady_seed12": dict(SPEC, seed=12),
    "no_bursts": dict(SPEC, seed=11, burst_factor=1.0, burst_duty=0.0),
    "diurnal_flat": dict(SPEC, seed=5, diurnal_amplitude=0.0),
    "diurnal_deep": dict(SPEC, seed=5, diurnal_amplitude=0.95, diurnal_period_s=0.3),
    "one_tenant": dict(SPEC, seed=3, n_tenants=1, slo_classes=[]),
    "four_tenants_long": dict(SPEC, seed=3, n_tenants=4, tenant_zipf_s=1.1, n_requests=64,
                              max_prompt_len=512, prompt_len_median=128.0, vocab_size=50257),
    "defaults": {},
}


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_generate_workload_equals_jax(name):
    kw = WORKLOADS[name]
    ours = generate_workload(WorkloadSpec(**kw))
    theirs = jreplay.generate_workload(jreplay.WorkloadSpec(**kw))
    assert len(ours) == len(theirs) == kw.get("n_requests", 64)
    for a, b in zip(ours, theirs):
        assert a.t_arrival == b.t_arrival  # exact floats
        assert a.prompt.dtype == b.prompt.dtype == np.int32
        assert np.array_equal(a.prompt, b.prompt)
        assert (a.max_new_tokens, a.seed, a.tenant, a.slo_class) == \
            (b.max_new_tokens, b.seed, b.tenant, b.slo_class)
        assert a.key() == b.key()
    ts = [it.t_arrival for it in ours]
    assert ts == sorted(ts) and ts[0] > 0
    assert all(1 <= len(it.prompt) <= kw.get("max_prompt_len", 12) for it in ours)
    # the same seed again gives the same items; the spec's knobs matter
    assert [it.key() for it in generate_workload(WorkloadSpec(**kw))] == [it.key() for it in ours]


def test_rate_multiplier_and_clock_equal_jax():
    from deepspeed_tpu_torch.serving.replay import _rate_multiplier

    for kw in WORKLOADS.values():
        ts, js = WorkloadSpec(**kw), jreplay.WorkloadSpec(**kw)
        for t in np.linspace(0.0, 5.0, 101):
            assert _rate_multiplier(ts, float(t)) == jreplay._rate_multiplier(js, float(t))
    clk = ReplayClock(2.5)
    clk.advance(0.25)
    assert clk() == 2.75


# ---------------------------------------------------------------------------
# replay under the virtual clock, against JAX's
# ---------------------------------------------------------------------------

def _normalized(records):
    base = min(r["id"] for r in records)
    out = []
    for r in records:
        r = {k: v for k, v in r.items() if k not in ("ts", "host")}
        r["id"] -= base
        out.append(r)
    return sorted(out, key=lambda r: r["id"])


def _replay_side(side, eng, root, section, items, step_dt):
    tracer_cls = trt.RequestTracer if side == "port" else jrt.RequestTracer
    clock_cls = ReplayClock if side == "port" else jreplay.ReplayClock
    run = replay if side == "port" else jreplay.replay
    tr = tracer_cls(str(root / f"{side}.jsonl"), flush_interval=1)
    srv = eng.serve(section, clock=clock_cls(), tracer=tr)
    res = run(srv, items, step_dt=step_dt)
    srv.check_no_leaks()
    tr.flush()
    load = trt.load_request_records if side == "port" else jrt.load_request_records
    return res, load(tr.file_path), tr.file_path


CASES = {
    # TestReplayHarness.test_replay_trace_deterministic
    "steady": (dict(SPEC, seed=21), dict(SERVING_CFG, slo=SLO_CFG), 0.01),
    # TestReplayHarness.test_replay_emits_waits_under_overload
    "overload": (dict(SPEC, seed=3, n_requests=16, base_interarrival_s=0.001),
                 dict(SERVING_CFG, max_slots=2, slo=SLO_CFG), 0.05),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def replays(request, engine, jax_engine, tmp_path_factory):
    spec, section, step_dt = CASES[request.param]
    items = generate_workload(WorkloadSpec(**spec))
    root = tmp_path_factory.mktemp(request.param)
    out = {"case": request.param, "n": len(items)}
    for side, eng in (("port", engine), ("jax", jax_engine)):
        out[side] = _replay_side(side, eng, root, section, items, step_dt)
    return out


def test_replay_streams_and_steps_equal_jax(replays):
    (pres, _, _), (jres, _, _) = replays["port"], replays["jax"]
    assert [list(r.tokens) for r in pres["requests"]] == [list(r.tokens) for r in jres["requests"]]
    assert all(r.tokens for r in pres["requests"])
    assert pres["steps"] == jres["steps"] and pres["duration_s"] == jres["duration_s"]


def test_replay_trace_records_equal_jax(replays):
    prec, jrec = replays["port"][1], replays["jax"][1]
    assert len(prec) == replays["n"]
    assert _normalized(prec) == _normalized(jrec)
    if replays["case"] == "overload":
        # near-simultaneous arrivals over 2 slots: someone waited on slots
        assert any(r["waits"].get("no_free_slot") for r in prec)
        assert any(r["queue_wait_s"] > 0 for r in prec)


def test_replay_scores_equal_jax(replays):
    prec, jrec = replays["port"][1], replays["jax"][1]
    for key in (lambda r: r.get("slo_class") or "", lambda r: r["tenant"]):
        assert trt.score_requests(prec, key=key) == jrt.score_requests(jrec, key=key)
    assert trt.score_requests(prec)["overall"]["slo_evaluated"] == replays["n"]


def test_request_phases_and_time_binned_equal_jax(replays):
    prec = replays["port"][1]
    for r in prec:
        assert trt.request_phases(r) == jrt.request_phases(r)
    for bins in (1, 3, 10):
        got = trt.time_binned(prec, bins=bins)
        assert got == jrt.time_binned(prec, bins=bins)
        assert sum(b["arrivals"] for b in got) == len(prec)
    assert trt.time_binned([], bins=4) == []


@pytest.mark.parametrize("args", [
    ["--json"], ["--json", "--by", "tenant", "--bins", "4"], ["--json", "--waterfall", "3"],
    ["--min-attainment", "100"], ["--bins", "3"],
])
def test_request_trace_cli_equals_jax(replays, capsys, args):
    path = replays["port"][2]
    rc = cli.main([path] + args)
    out = capsys.readouterr()
    assert rc == jax_cli.main([path] + args)
    jout = capsys.readouterr()
    assert (out.out, out.err) == (jout.out, jout.err)
    if "--json" in args:
        doc = json.loads(out.out)
        assert doc["records"] == replays["n"]


def test_request_trace_cli_diff_and_errors(replays, tmp_path, capsys):
    a, b = replays["port"][2], replays["jax"][2]
    assert cli.main([a, "--diff", b, "--json"]) == 0  # equal runs: no regression
    assert json.loads(capsys.readouterr().out)["regressions"] == []
    assert cli.main([a, "--request", "-1"]) == 2
    assert cli.main([str(tmp_path / "missing.jsonl")]) == 2
    capsys.readouterr()


def test_seeded_replay_journal_byte_identical(engine, tmp_path):
    """Two identical seeded virtual-clock replays write byte-identical
    journals (no wall-clock field anywhere)."""
    items = generate_workload(WorkloadSpec(
        n_requests=12, seed=11, vocab_size=engine.model_config.vocab_size,
        max_prompt_len=SERVING_CFG["max_prompt_len"], max_new_tokens=6,
        base_interarrival_s=0.01, slo_classes=["interactive"]))
    blobs = []
    for run in range(2):
        j = MetricsJournal(str(tmp_path / f"replay{run}.jsonl"), interval_s=0.02,
                           flush_interval=1)
        srv = engine.serve(dict(SERVING_CFG, slo={
            "classes": {"interactive": {"ttft_target_s": 1.0}}, "default_class": "interactive",
        }), clock=ReplayClock(), journal=j)
        replay(srv, items, step_dt=0.005)
        srv.drain()
        srv.check_no_leaks()
        j.close()
        with open(j.file_path, "rb") as fh:
            blobs.append(fh.read())
    assert blobs[0] == blobs[1] and len(blobs[0]) > 0
    assert load_journal(j.file_path).sids("serving_queue_depth")


# ---------------------------------------------------------------------------
# replay_fleet with a scripted preemption, against JAX's
# ---------------------------------------------------------------------------

FLEET_CFG = dict(SERVING_CFG, speculative={"enabled": True, "k": 3},
                 prefix_cache={"enabled": True}, prefill_chunk_tokens=8,
                 fleet={"enabled": True, "replicas": 2})


def test_replay_fleet_equals_jax(engine, jax_engine, tmp_path):
    items = generate_workload(WorkloadSpec(**dict(SPEC, seed=7, n_requests=12,
                                                  max_new_tokens=8, base_interarrival_s=0.005,
                                                  vocab_size=512)))
    sides = {}
    for side, router_cls, run, clock_cls, eng in (
            ("port", FleetRouter, replay_fleet, ReplayClock, engine),
            ("jax", JaxFleetRouter, jax_replay_fleet, jreplay.ReplayClock, jax_engine)):
        clk = clock_cls()
        fleet = router_cls(eng, FLEET_CFG, clock=clk)
        res = run(fleet, items, step_dt=0.01, preempt_at=0.03)
        st = fleet.stats()
        st["fleet"].pop("migration_blackout_p99_s")
        fleet.drain()
        fleet.check_no_leaks()
        fleet.close()
        sides[side] = ([list(r.tokens) for r in res["requests"]],
                       [r.replica for r in res["requests"]], [r.status for r in res["requests"]],
                       res["steps"], res["duration_s"], st)
    assert sides["port"] == sides["jax"]
    streams, _, statuses, _, _, st = sides["port"]
    assert all(streams) and set(statuses) == {"finished"}
    assert st["fleet"]["alive"] == 1 and st["fleet"]["migrations_ok"] >= 1, st


# ---------------------------------------------------------------------------
# fleet_dash over a burn-rate journal (TestFleetDashCLI)
# ---------------------------------------------------------------------------

class SteppedClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _dash_journal(tmp_path):
    """A journal with the budget gauges, the alert events and per-replica
    fleet series: 260 s of completions, 60 s of them at half misses."""
    clk = SteppedClock()
    reg = MetricsRegistry()
    c_ev = reg.counter("serving_slo_evaluated_total", "t", labelnames=("slo_class",))
    c_met = reg.counter("serving_slo_met_total", "t", labelnames=("slo_class",))
    occ = reg.gauge("fleet_replica_occupancy", "t", labelnames=("replica",))
    mig = reg.counter("fleet_migrations_total", "t", labelnames=("status",))
    j = MetricsJournal(str(tmp_path / "alerts.jsonl"), registry=reg, clock=clk,
                       flush_interval=1)
    budget = SLOBudgetEngine(j, SLOAlertsConfig(
        enabled=True, objective=0.99, fast_short_s=5.0, fast_long_s=30.0,
        fast_burn_threshold=10.0, slow_short_s=30.0, slow_long_s=120.0,
        slow_burn_threshold=1.0, for_s=2.0), registry=reg, clock=clk)
    for sec in range(260):
        clk.t = float(sec)
        miss = 60 <= sec < 120
        for i in range(10):
            c_ev.inc(slo_class="interactive")
            if not miss or i % 2 != 0:
                c_met.inc(slo_class="interactive")
        occ.set(min(1.0, sec / 300.0), replica="r0")
        occ.set(0.25, replica="r1")
        if sec == 100:
            mig.inc(status="ok")
        j.maybe_snapshot(clk.t)
        budget.maybe_evaluate()
    j.close()
    return j.file_path


def test_fleet_dash_exit_matrix(tmp_path, capsys):
    path = _dash_journal(tmp_path)
    for args, rc in (([], 0), (["--json"], 0), (["--min-budget", "-100"], 0),
                     (["--min-budget", "0.99"], 1), (["--max-burn", "1e9"], 0),
                     (["--min-goodput", "1"], 1), (["--diff", path], 0), (["--bins", "0"], 2),
                     (["--watch", "0"], 2)):
        assert fleet_dash.main([path] + args) == rc, args
        assert jax_dash.main([path] + args) == rc, args
    assert fleet_dash.main([str(tmp_path / "nope.jsonl")]) == 2
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"kind": "tsdb_meta", "schema": "other"}\n')
    assert fleet_dash.main([str(bad)]) == 2
    capsys.readouterr()


def test_fleet_dash_watch_iterations_bounded(tmp_path, capsys):
    path = _dash_journal(tmp_path)
    assert fleet_dash.main([path, "--watch", "0.01", "--iterations", "2"]) == 0
    assert capsys.readouterr().out.count("fleet_dash  span=") == 2


def test_fleet_dash_report_and_forecast(tmp_path, capsys):
    path = _dash_journal(tmp_path)
    rep = fleet_dash.dash_report(load_journal(path))
    assert rep["slo"]["interactive"]["budget_remaining"] is not None
    assert rep["fleet"]["alerts_fired"] >= 1
    assert rep["fleet"]["migrations"] == {"ok": 1.0}
    assert sorted(rep["replicas"]) == ["r0", "r1"]
    assert "budget_exhaustion_s" in rep["forecast"]
    # r0's occupancy climbs toward 1.0: a finite saturation horizon; r1 flat
    sat = rep["forecast"]["occupancy_saturation_s"]
    assert sat["r0"] is not None and sat["r0"] > 0 and sat["r1"] is None
    out = fleet_dash.render(rep)
    assert "slo_class" in out and "alerts" in out and "migrations: ok=1" in out
    assert out == jax_dash.render(jax_dash.dash_report(jax_dash.load_journal(path)))
    capsys.readouterr()


def test_fleet_dash_json_equals_jax(tmp_path, capsys):
    path = _dash_journal(tmp_path)
    for args in (["--json"], ["--json", "--bins", "8", "--min-budget", "0.99"],
                 ["--json", "--diff", path]):
        rc = fleet_dash.main([path] + args)
        ours = capsys.readouterr().out
        assert rc == jax_dash.main([path] + args)
        assert json.loads(ours) == json.loads(capsys.readouterr().out)


def test_fleet_dash_diff_flags_regression():
    a = {"goodput_tokens_per_sec": 100.0, "alerts_fired": 0.0}
    b = {"goodput_tokens_per_sec": 50.0, "alerts_fired": 0.0}
    dr = fleet_dash.diff_reports(a, b, threshold_pct=10.0)
    assert dr["regressions"] == ["goodput_tokens_per_sec"]
    assert dr == jax_dash.diff_reports(a, b, threshold_pct=10.0)
    assert fleet_dash.diff_reports(a, dict(a), threshold_pct=10.0)["regressions"] == []
