"""The KV heat plane, the metrics journal and the SLO burn-rate engine of
the port against the JAX package's, on the CPU (gpt2-tiny, fp32):

- the same traffic (the all-features suite: speculation, prefix cache,
  chunked prefill, under a stepped clock) gives the same ``kv_heat.jsonl``
  line for line (request ids as offsets from each run's first), each package's replay reads the other's file to the same
  occupancy, and the ledger reconciles with the allocator and the prefix
  index at drain;
- the same registry script gives the same ``dstpu-tsdb-v1`` journal, and
  the journal's queries agree;
- ``SLOBudgetEngine`` fires and resolves on the same steps as JAX's for the
  scenarios of ``tests/unit/test_timeseries.py::TestBurnRateAlerts``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.inference.engine import InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.runtime.config import SLOAlertsConfig as JaxAlerts
from deepspeed_tpu.telemetry import kv_heat as jheat
from deepspeed_tpu.telemetry import registry as jregistry
from deepspeed_tpu.telemetry import timeseries as jts
from deepspeed_tpu.telemetry.slo_budget import SLOBudgetEngine as JaxBudget
from deepspeed_tpu_torch.runtime.config import SLOAlertsConfig
from deepspeed_tpu_torch.telemetry import kv_heat as theat
from deepspeed_tpu_torch.telemetry import registry as tregistry
from deepspeed_tpu_torch.telemetry import timeseries as tts
from deepspeed_tpu_torch.telemetry.slo_budget import SLOBudgetEngine
from deepspeed_tpu_torch.utils.weights import params_from_numpy

SPEC_CFG = {
    "max_slots": 4,
    "page_size": 4,
    "num_pages": 64,
    "max_prompt_len": 12,
    "max_new_tokens": 8,
    "kv_cache_dtype": "float32",
    "speculative": {"enabled": True, "k": 3},
    "prefix_cache": {"enabled": True},
    "prefill_chunk_tokens": 4,
}
THRESHOLDS = (0.02, 0.1, 1.0)


class SteppedClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _traffic():
    """8 prompts sharing a two-page head (prefix hits, a full-prefix
    copy-on-write fork) and 8 cold ones, 16 requests."""
    rs = np.random.RandomState(11)
    head = rs.randint(0, 512, (8,)).astype(np.int32)
    prompts = [head.copy()] + [
        np.concatenate([head, rs.randint(0, 512, (1 + i % 4,)).astype(np.int32)])
        for i in range(7)]
    prompts += [rs.randint(0, 512, (n,)).astype(np.int32) for n in (2, 5, 8, 12, 7, 3, 11, 4)]
    return [(p, 6 if i % 5 else 8) for i, p in enumerate(prompts)]


def _drive(srv, clk):
    reqs = [srv.submit(p, max_new_tokens=n, seed=i) for i, (p, n) in enumerate(_traffic())]
    while srv.queue or any(s.request is not None for s in srv.slots):
        srv.step()
        clk.t += 0.01
    return reqs


@pytest.fixture(scope="module")
def heat_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("heat")
    cfg = jgpt2.get_config("gpt2-tiny")
    tree = jax.tree.map(np.asarray, jgpt2.init_params(cfg, jax.random.PRNGKey(0)))
    out = {}
    jeng = JaxInferenceEngine(jgpt2.make_module(cfg), params=jax.tree.map(jnp.asarray, tree),
                              dtype=jnp.float32)
    peng = dtt.init_inference(dtt.get_config("gpt2-tiny"), params=params_from_numpy(tree, "cpu"),
                              dtype=torch.float32, device="cpu")
    for side, eng, mod in (("jax", jeng, jheat), ("port", peng, theat)):
        clk = SteppedClock()
        tracer = mod.KVHeatTracer(str(root / side / "kv_heat.jsonl"), flush_interval=3,
                                  segment_events=32, idle_thresholds_s=THRESHOLDS)
        srv = eng.serve(SPEC_CFG, clock=clk, heat_tracer=tracer)
        reqs = _drive(srv, clk)
        srv.check_no_leaks()
        led = srv._heat_decode
        err = led.reconcile(srv.allocator, srv.prefix_cache)
        occ = led.occupancy(clk.t, THRESHOLDS)
        stats = srv.stats()["kv_heat"]
        released = srv.release_prefix_cache()
        tracer.flush()
        tracer.close()
        out[side] = dict(srv=srv, reqs=reqs, err=err, occ=occ, stats=stats, released=released,
                         path=tracer.file_path, led=led)
    return out


def _heat_lines(run):
    """The heat file's records, line by line, with each session start's
    request id taken as its offset from the run's first request (ids come
    from a process-wide counter in each package)."""
    base = run["reqs"][0].id
    out = []
    with open(run["path"]) as fh:
        for line in fh:
            rec = json.loads(line)
            for ev in rec.get("events", []):
                if ev[0] == "S":
                    ev[3] -= base
            out.append(rec)
    return out


def test_heat_streams_equal_line_by_line(heat_runs):
    port, jax_lines = _heat_lines(heat_runs["port"]), _heat_lines(heat_runs["jax"])
    assert port == jax_lines and len(port) > 2
    recs = theat.load_heat_records(heat_runs["port"]["path"])
    ops = {ev[0] for r in recs if r.get("kind") == "kv_heat" for ev in r.get("events", [])}
    assert {"A", "R", "F", "G", "H", "E", "S", "X"} <= ops
    assert any(r.get("touches") for r in recs if r.get("kind") == "kv_heat")
    assert [list(r.tokens) for r in heat_runs["port"]["reqs"]] \
        == [list(r.tokens) for r in heat_runs["jax"]["reqs"]]


def test_ledger_reconciles_with_allocator_and_prefix_index_at_drain(heat_runs):
    for side in ("port", "jax"):
        assert heat_runs[side]["err"] is None
    led = heat_runs["port"]["led"]
    assert led.prefix_registered > 0 and led.prefix_hits > 0
    assert heat_runs["port"]["released"] > 0
    assert heat_runs["port"]["occ"] == heat_runs["jax"]["occ"]
    pst, jst = dict(heat_runs["port"]["stats"]), dict(heat_runs["jax"]["stats"])
    for st in (pst, jst):
        st.pop("path")
    assert pst == jst


@pytest.mark.parametrize("reader,writer", [("port", "jax"), ("jax", "port")])
def test_replay_reads_the_other_packages_file(heat_runs, reader, writer):
    """Replaying the other package's file rebuilds the writer's live ledger
    (the prefix index released at the end): the same occupancy, and the
    same report from either package's reader."""
    mod, other = (theat, jheat) if reader == "port" else (jheat, theat)
    recs = mod.load_heat_records(heat_runs[writer]["path"])
    assert mod.pools_in(recs) == ["shared"]
    t_end = max(float(ev[1]) for ev in mod.iter_pool_events(recs, "shared"))
    replayed = mod.replay_heat(recs, "shared")
    live = heat_runs[writer]["led"]
    assert replayed.occupancy(t_end, THRESHOLDS) == live.occupancy(t_end, THRESHOLDS)
    assert replayed.pages_in_use == live.pages_in_use == 0
    assert mod.heat_report(recs) == other.heat_report(recs)


# ---------------------------------------------------------------------------
# metrics journal
# ---------------------------------------------------------------------------

def _registry_script(reg, journal, clk):
    c = reg.counter("serving_requests_total", "t", labelnames=("status",))
    g = reg.gauge("serving_queue_depth", "q")
    h = reg.histogram("serving_ttft_seconds", "ttft", buckets=(0.01, 0.05, 0.1, 0.5))
    rs = np.random.RandomState(5)
    for sec in range(40):
        clk.t = sec * 0.5
        for _ in range(rs.randint(0, 4)):
            c.inc(status="finished" if rs.rand() > 0.2 else "rejected")
            h.observe(float(rs.exponential(0.05)))
        if sec % 3 == 0:
            g.set(int(rs.randint(0, 9)))
        journal.maybe_snapshot(clk.t)
    journal.emit_event({"kind": "slo_alert", "t": clk.t, "state": "firing"})
    journal.snapshot(clk.t + 0.25)
    journal.close()


@pytest.mark.parametrize("max_mb", [0, 1])
def test_journal_records_equal_for_the_same_registry_script(tmp_path, max_mb):
    paths = {}
    stores = {}
    for side, reg_mod, ts_mod in (("port", tregistry, tts), ("jax", jregistry, jts)):
        clk = SteppedClock()
        reg = reg_mod.MetricsRegistry()
        j = ts_mod.MetricsJournal(str(tmp_path / side / "tsdb.jsonl"), registry=reg,
                                  clock=clk, interval_s=1.0, flush_interval=3,
                                  max_bytes=max_mb * 2 ** 20)
        _registry_script(reg, j, clk)
        paths[side] = j.file_path
        stores[side] = (j, ts_mod.load_journal(j.file_path))
    with open(paths["port"]) as fh:
        port = fh.read().splitlines()
    with open(paths["jax"]) as fh:
        jax_lines = fh.read().splitlines()
    assert port == jax_lines and len(port) > 10
    (pj, ps), (jj, js) = stores["port"], stores["jax"]
    sid = 'serving_requests_total{status="finished"}'
    for t0, t1 in ((0.0, 5.0), (3.0, 17.5), (None, None)):
        assert ps.increase(sid, t0 or 0.0, t1 or 20.0) == js.increase(sid, t0 or 0.0, t1 or 20.0)
        assert pj.quantile_over_time("serving_ttft_seconds", 0.9, t0, t1) \
            == jj.quantile_over_time("serving_ttft_seconds", 0.9, t0, t1)
    assert ps.events == js.events


# ---------------------------------------------------------------------------
# burn-rate alerts: TestBurnRateAlerts' scenarios
# ---------------------------------------------------------------------------

def _alert_rig(tmp_path, side, **cfg_kw):
    reg_mod, ts_mod, cfg_cls, eng_cls = (
        (tregistry, tts, SLOAlertsConfig, SLOBudgetEngine) if side == "port"
        else (jregistry, jts, JaxAlerts, JaxBudget))
    clk = SteppedClock()
    reg = reg_mod.MetricsRegistry()
    c_ev = reg.counter("serving_slo_evaluated_total", "t", labelnames=("slo_class",))
    c_met = reg.counter("serving_slo_met_total", "t", labelnames=("slo_class",))
    j = ts_mod.MetricsJournal(str(tmp_path / side / "alerts.jsonl"), registry=reg, clock=clk,
                              flush_interval=1)
    kw = dict(enabled=True, objective=0.99, fast_short_s=5.0, fast_long_s=30.0,
              fast_burn_threshold=10.0, slow_short_s=30.0, slow_long_s=120.0,
              slow_burn_threshold=1.0)
    kw.update(cfg_kw)
    budget = eng_cls(j, cfg_cls(**kw), registry=reg, clock=clk)
    return clk, reg, c_ev, c_met, j, budget


def _drive_alerts(journal, budget, c_ev, c_met, clk, start, end, miss_every=0):
    out = []
    for sec in range(start, end):
        clk.t = float(sec)
        for i in range(10):
            c_ev.inc(slo_class="interactive")
            if not miss_every or i % miss_every != 0:
                c_met.inc(slo_class="interactive")
        journal.maybe_snapshot(clk.t)
        out.extend(budget.maybe_evaluate())
    return out


SCENARIOS = {
    "fires_and_resolves": ({"for_s": 2.0}, [(0, 60, 0), (60, 120, 2), (120, 300, 0)]),
    "single_bad_window": ({"for_s": 0.0, "slow_burn_threshold": 1e9},
                          [(0, 100, 0), (100, 103, 2), (103, 140, 0)]),
    "dwell_gates_pending": ({"for_s": 1e9}, [(0, 30, 0), (30, 120, 2)]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_burn_rate_transitions_equal(tmp_path, name):
    cfg_kw, phases = SCENARIOS[name]
    results = {}
    for side in ("port", "jax"):
        clk, reg, c_ev, c_met, j, budget = _alert_rig(tmp_path, side, **cfg_kw)
        trs = []
        for start, end, miss in phases:
            trs.append(_drive_alerts(j, budget, c_ev, c_met, clk, start, end, miss_every=miss))
        states = {k: v["state"] for k, v in budget._states.items()}
        remaining = budget.budget_remaining("interactive")
        gauges = [ln for ln in reg.to_prometheus().splitlines() if ln.startswith("slo_")]
        j.close()
        results[side] = (trs, states, remaining, gauges, budget.firing_classes())
    assert results["port"] == results["jax"]
    trs = results["port"][0]
    if name == "fires_and_resolves":
        assert any(t["state"] == "firing" for t in trs[1])
        assert any(t["state"] == "resolved" for t in trs[2])
    elif name == "single_bad_window":
        assert not any(t["state"] == "firing" for phase in trs for t in phase)
    else:
        assert "pending" in results["port"][1].values() and not results["port"][4]


def test_budget_remaining_math_equal(tmp_path):
    out = {}
    for side in ("port", "jax"):
        clk, reg, c_ev, c_met, j, budget = _alert_rig(tmp_path, side)
        first = budget.budget_remaining("interactive")
        for i in range(1000):
            c_ev.inc(slo_class="interactive")
            if i >= 10:
                c_met.inc(slo_class="interactive")
        clk.t = 1.0
        j.snapshot(1.0)
        out[side] = (first, budget.budget_remaining("interactive"))
        j.close()
    assert out["port"] == out["jax"]
    assert out["port"][0] == 1.0 and out["port"][1] == pytest.approx(0.0)
