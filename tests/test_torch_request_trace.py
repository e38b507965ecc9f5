"""The serving engine's telemetry plane against the JAX package's, on the
CPU (gpt2-tiny, fp32): the 16-request mixed suite and the all-features
suite (speculation, prefix cache, chunked prefill) run through both
ServingEngines with the whole plane on (request trace, KV heat, metrics
journal, watchdog with the straggler detector, Prometheus textfile), two
SLO classes and two tenants, under a stepped clock: the test advances it
between steps, and by a fixed amount inside each decode/verify program
call, so every time the engines read is the same in both. Then:

- the terminal request records are equal field by field, apart from
  ``ts`` and ``host`` (request ids as offsets from each run's first);
- ``score_requests``, ``stats()`` and the serving families of the
  registries' Prometheus text are equal;
- the streams with the plane on are the streams with it off, and JAX's;
- stragglers trip on the same (step, request) in both;
- ``generate`` under TestGenerateCacheLRU's sequence gives equal
  ``generate_cache_*`` families and ``compiled_cache_hit`` flags.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.inference.engine import InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.telemetry.request_trace import load_request_records as jax_load
from deepspeed_tpu.telemetry.request_trace import score_requests as jax_score
from deepspeed_tpu_torch.serving.scheduler import exact_percentiles
from deepspeed_tpu_torch.telemetry.request_trace import (
    histogram_quantile,
    load_request_records,
    score_requests,
)
from deepspeed_tpu_torch.utils.weights import params_from_numpy

SERVING_CFG = {
    "max_slots": 4,
    "page_size": 4,
    "num_pages": 64,
    "max_prompt_len": 12,
    "max_new_tokens": 8,
    "kv_cache_dtype": "float32",
}
SPEC_CFG = dict(
    SERVING_CFG,
    speculative={"enabled": True, "k": 3},
    prefix_cache={"enabled": True},
    prefill_chunk_tokens=4,
)
SLO = {
    "classes": {"chat": {"ttft_target_s": 0.08, "tpot_target_s": 0.03},
                "batch": {"ttft_target_s": 0.5}},
    "default_class": "batch",
}
TENANTS = ("acme", "globex")
STEP_S = 0.01      # the clock between scheduler steps
PROGRAM_S = 0.004  # the clock inside each decode / verify program call
PREFILL_S = 0.002  # the clock inside each prefill / chunk program call
STALL_S = 10.0     # one prefill-side call stalls this long (see _Clocked)
STALL_CALL = {"mixed": 10, "features": 12}


def plane(root):
    return {
        "enabled": True,
        "trace_path": str(root),
        "prometheus_path": str(root / "serving.prom"),
        "introspection": {"enabled": False},
        "watchdog": {"enabled": True, "straggler_factor": 3.0,
                     "capture_dir": str(root / "anomalies")},
        "request_trace": {"enabled": True, "flush_interval": 4},
        "kv_heat": {"enabled": True, "flush_interval": 4, "segment_events": 64,
                    "idle_thresholds_s": [0.05, 0.2, 1.0]},
        "timeseries": {"enabled": True, "interval_s": 0.05, "flush_interval": 4},
    }


class SteppedClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


class _Clocked:
    """A program whose call advances the clock first: the device time of a
    step, seen the same way by both engines. The prefill and chunk programs
    share one call counter (``calls``), and their ``stall``-th call takes
    STALL_S: requests that got their first token before it in the step, or
    earlier, are then resident far beyond their budget at the straggler
    check, while the decode-step EMA stays unmoved."""

    def __init__(self, prog, clock, dt, calls=None, stall=0):
        self._prog, self._clock, self._dt = prog, clock, dt
        self._calls, self._stall = calls, stall

    def __call__(self, *args):
        self._clock.t += self._dt
        if self._calls is not None:
            self._calls[0] += 1
            if self._calls[0] == self._stall:
                self._clock.t += STALL_S
        return self._prog(*args)

    def __getattr__(self, name):
        return getattr(self._prog, name)


def _clocked(srv, clk, names, stall):
    """Wrap the engine's programs (attribute names: decode-shaped, prefill,
    chunk)."""
    step, prefill, chunk = names
    setattr(srv, step, _Clocked(getattr(srv, step), clk, PROGRAM_S))
    calls = [0]
    for name in (prefill, chunk):
        if getattr(srv, name, None) is not None:
            setattr(srv, name, _Clocked(getattr(srv, name), clk, PREFILL_S, calls, stall))


def _traffic(spec):
    """(prompt, max_new_tokens, seed, tenant, slo_class, deadline_s) of the
    run: the 16-request mixed suite (or 8 shared-prefix + 8 cold prompts
    for the features), two tenants, two classes and a class unset (the
    default), two requests under a deadline the stall breaks, and one
    over-long prompt rejected at the door."""
    rs = np.random.RandomState(7)
    if spec:
        head = rs.randint(0, 512, (8,)).astype(np.int32)
        prompts = [np.concatenate([head, rs.randint(0, 512, (1 + i % 4,)).astype(np.int32)])
                   for i in range(8)]
        prompts += [rs.randint(0, 512, (n,)).astype(np.int32)
                    for n in (2, 5, 8, 12, 7, 3, 11, 4)]
    else:
        plens = [2, 5, 8, 12, 7, 3, 11, 4] * 2
        prompts = [rs.randint(0, 512, (plens[i],)).astype(np.int32) for i in range(16)]
    out = []
    for i, p in enumerate(prompts):
        n = 6 if i % 7 else (1, 3, 8)[i // 7]
        if spec and i >= 8:
            n = 8  # cold prompts ask for the whole budget: two verify steps at least
        cls = ("chat", "batch", None)[i % 3]
        deadline = 5.0 if i in (9, 14) else None
        out.append((p, n, i, TENANTS[i % 2], cls, deadline))
    out.append((rs.randint(0, 512, (13,)).astype(np.int32), 4, 99, "acme", "chat", None))
    return out


def _drive(srv, clk, traffic):
    reqs = [srv.submit(p, max_new_tokens=n, seed=s, tenant=t, slo_class=c, deadline_s=d)
            for p, n, s, t, c, d in traffic]
    for _ in range(400):
        if not srv.queue and all(s.request is None for s in srv.slots):
            break
        srv.step()
        clk.t += STEP_S
    srv.drain()
    return reqs


@pytest.fixture(scope="module")
def tree():
    cfg = jgpt2.get_config("gpt2-tiny")
    return jax.tree.map(np.asarray, jgpt2.init_params(cfg, jax.random.PRNGKey(0)))


def _jax_run(tree, root, section, traffic, stall):
    cfg = jgpt2.get_config("gpt2-tiny")
    eng = JaxInferenceEngine(jgpt2.make_module(cfg), params=jax.tree.map(jnp.asarray, tree),
                             dtype=jnp.float32, config={"telemetry": plane(root)})
    clk = SteppedClock()
    srv = eng.serve(section, clock=clk)
    srv._ensure_compiled()
    step = "_verify_exec" if srv.spec_enabled else "_decode_exec"
    _clocked(srv, clk, (step, "_prefill_exec", "_chunk_exec"), stall)
    reqs = _drive(srv, clk, traffic)
    eng.telemetry.flush()
    return eng, srv, reqs


def _port_run(tree, root, section, traffic, stall, on=True):
    eng = dtt.init_inference(
        dtt.get_config("gpt2-tiny"), params=params_from_numpy(tree, "cpu"),
        dtype=torch.float32, device="cpu",
        config={"telemetry": plane(root)} if on else None,
    )
    clk = SteppedClock()
    srv = eng.serve(section, clock=clk)
    _clocked(srv, clk, ("_step_prog", "_prefill_prog", "_chunk_prog"), stall)
    reqs = _drive(srv, clk, traffic)
    if on:
        eng.telemetry.flush()
    return eng, srv, reqs


@pytest.fixture(scope="module", params=["mixed", "features"])
def runs(request, tree, tmp_path_factory):
    """The suite through the JAX engine and the port, plane on, and the
    port with the plane off."""
    spec = request.param == "features"
    section = dict(SPEC_CFG if spec else SERVING_CFG, slo=SLO)
    traffic = _traffic(spec)
    root = tmp_path_factory.mktemp(request.param)
    (root / "jax").mkdir()
    (root / "port").mkdir()
    (root / "off").mkdir()
    stall = STALL_CALL[request.param]
    jax_side = _jax_run(tree, root / "jax", section, traffic, stall)
    port_side = _port_run(tree, root / "port", section, traffic, stall)
    off_side = _port_run(tree, root / "off", section, traffic, stall, on=False)
    return {"jax": jax_side, "port": port_side, "off": off_side, "spec": spec,
            "root": root}


def _normalized(records):
    base = min(r["id"] for r in records)
    out = []
    for r in records:
        r = {k: v for k, v in r.items() if k not in ("ts", "host")}
        r["id"] -= base
        out.append(r)
    return out


def test_terminal_records_equal_field_by_field(runs):
    jr = jax_load(runs["jax"][1].tracer.file_path)
    pr = load_request_records(runs["port"][1].tracer.file_path)
    assert len(pr) == len(runs["port"][2]) == 17
    assert [r["status"] for r in pr].count("rejected") == 1
    assert _normalized(pr) == _normalized(jr)
    # one terminal record a request, with its tenant and resolved class
    assert sorted(r["id"] for r in pr) == sorted(r.id for r in runs["port"][2])
    assert {r["tenant"] for r in pr} == set(TENANTS)
    assert {r["slo_class"] for r in pr} == {"chat", "batch"}
    kinds = {e["e"] for r in pr for e in r["events"]}
    assert {"submit", "admit", "first_token", "reject"} <= kinds
    assert ("verify" in kinds) == runs["spec"]
    assert any(r["decode"] for r in pr) != runs["spec"]


def test_score_requests_equal(runs):
    jr = jax_load(runs["jax"][1].tracer.file_path)
    pr = load_request_records(runs["port"][1].tracer.file_path)
    for key in (lambda r: r.get("slo_class") or "", lambda r: r["tenant"]):
        assert score_requests(pr, key=key) == jax_score(jr, key=key)
    score = score_requests(pr)
    assert score["overall"]["slo_evaluated"] == 17
    assert 0 < score["overall"]["slo_met"] < 17


def _comparable_stats(st, jax_keys):
    st = json.loads(json.dumps({k: v for k, v in st.items() if k in jax_keys}))
    for plc in st.get("placement", {}).get("placements", {}).values():
        plc.pop("devices")
    for sec in ("request_trace", "kv_heat", "timeseries"):
        if sec in st:
            st[sec]["path"] = st[sec]["path"].rsplit("/", 1)[-1]
    return st


def test_stats_equal(runs):
    jst, pst = runs["jax"][1].stats(), runs["port"][1].stats()
    assert set(pst) - set(jst) == {"prefills", "timeout_evictions", "decode_tokens_per_s",
                                   "tokens_per_s"}
    assert set(jst) <= set(pst)
    assert _comparable_stats(pst, jst) == _comparable_stats(jst, jst)
    assert pst["stragglers"] > 0
    assert pst["by_status"].get("truncated", 0) + pst["by_status"].get("timed_out", 0) >= 1
    assert set(pst["tenants"]) == set(TENANTS) and set(pst["slo"]["classes"]) == {"chat", "batch"}


def _serving_families(text):
    """The Prometheus text without the jit_* and hbm_* families (the
    compiles and the device memory differ by construction), a HELP line
    without its trailing parenthesised remark."""
    out = []
    for line in text.splitlines():
        name = re.split(r"[ {]", line.split(" ", 2)[2] if line.startswith("#") else line)[0]
        if name.startswith(("jit_", "hbm_")):
            continue
        if line.startswith("# HELP"):
            line = re.sub(r" \([^()]*\)$", "", line)
        out.append(line)
    return out


def test_prometheus_serving_families_equal(runs):
    jtext = runs["jax"][0].telemetry.registry.to_prometheus()
    ptext = runs["port"][0].telemetry.registry.to_prometheus()
    assert _serving_families(ptext) == _serving_families(jtext)
    # the textfile the plane wrote parses: every sample line is name value
    prom = (runs["root"] / "port" / "serving.prom").read_text()
    samples = [ln for ln in prom.splitlines() if ln and not ln.startswith("#")]
    assert samples and all(float(ln.rsplit(" ", 1)[1]) == float(ln.rsplit(" ", 1)[1])
                           or "NaN" in ln for ln in samples)
    assert "serving_tenant_requests_total" in prom and "jit_compiles_total" in prom


def test_streams_plane_on_equal_off_and_jax(runs):
    j = [list(r.tokens) for r in runs["jax"][2]]
    on = [list(r.tokens) for r in runs["port"][2]]
    off = [list(r.tokens) for r in runs["off"][2]]
    assert on == off == j
    for side in ("port", "off"):
        srv = runs[side][1]
        srv.check_no_leaks()
        assert len(srv.executables) == srv.expected_executables


def test_stragglers_trip_on_the_same_step_and_request(runs):
    def trips(eng, reqs):
        first = min(r.id for r in reqs)
        return [(a["step"], int(a["signal"].split("_")[1]) - first, a["value"], a["detail"])
                for a in eng.telemetry.watchdog.anomalies if a["anomaly_kind"] == "straggler"]

    jt = trips(runs["jax"][0], runs["jax"][2])
    pt = trips(runs["port"][0], runs["port"][2])
    assert pt and pt == jt
    # the trips reached the step trace and the counters
    srv = runs["port"][1]
    assert srv.metrics.counter("serving_stragglers_total").value() == len(pt)


def test_trace_and_journal_reproduce_stats(runs):
    """The trace's quantiles (histogram_quantile over the same buckets) and
    the journal's quantile_over_time reproduce stats()."""
    srv = runs["port"][1]
    st = srv.stats()
    recs = load_request_records(srv.tracer.file_path)
    score = score_requests(recs)["overall"]
    assert score["ttft_p50_s"] == st["ttft"]["p50_s"]
    assert score["tpot_p99_s"] == st["tpot"]["p99_s"]
    assert score["queue_wait_p50_s"] == st["queue_wait"]["p50_s"]
    j = srv._journal
    j.snapshot(srv.clock())
    for name, hist in (("ttft", "serving_ttft_seconds"), ("tpot", "serving_tpot_seconds")):
        for q, label in ((0.5, "p50_s"), (0.99, "p99_s")):
            assert j.quantile_over_time(hist, q) == st[name][label]
    # exact percentiles are a different estimator: only the counts agree
    exact = exact_percentiles([r for r in runs["port"][2] if r.t_first_token is not None])
    assert exact["ttft"]["count"] == st["ttft"]["count"]
    vals = [r.ttft_s for r in runs["port"][2] if r.ttft_s is not None]
    assert histogram_quantile(vals, 0.5) == st["ttft"]["p50_s"]


@pytest.fixture(scope="module")
def lru_pair(tree, tmp_path_factory):
    root = tmp_path_factory.mktemp("lru")
    tel = {"enabled": True, "trace_path": str(root / "jax")}
    cfg = jgpt2.get_config("gpt2-tiny")
    jeng = JaxInferenceEngine(jgpt2.make_module(cfg), params=jax.tree.map(jnp.asarray, tree),
                              dtype=jnp.float32,
                              config={"generate_cache_size": 2, "telemetry": tel})
    peng = dtt.init_inference(
        dtt.get_config("gpt2-tiny"), params=params_from_numpy(tree, "cpu"),
        dtype=torch.float32, device="cpu",
        config={"generate_cache_size": 2,
                "telemetry": dict(tel, trace_path=str(root / "port"))})
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (1, 4)).astype(np.int32)
    outs = {}
    for side, eng in (("jax", jeng), ("port", peng)):
        outs[side] = [eng.generate(ids, max_new_tokens=m) for m in (1, 2, 1, 3, 2)]
        eng.telemetry.flush()
    return jeng, peng, outs


def test_generate_lru_families_and_cache_hit_flags(lru_pair):
    jeng, peng, outs = lru_pair
    for a, b in zip(outs["jax"], outs["port"]):
        np.testing.assert_array_equal(a, b)

    def families(eng):
        reg = eng.telemetry.registry
        return {name: reg.get(name).value() for name in
                ("generate_cache_evictions_total", "generate_cache_size")}

    assert families(peng) == families(jeng) == {
        "generate_cache_evictions_total": 2.0, "generate_cache_size": 2.0}

    def records(eng):
        with open(eng.telemetry.tracer.file_path) as fh:
            return [json.loads(ln) for ln in fh if ln.strip()]

    pr, jr = records(peng), records(jeng)
    assert [r["compiled_cache_hit"] for r in pr] == [r["compiled_cache_hit"] for r in jr] \
        == [False, False, True, False, False]
    keep = ("kind", "step", "batch", "prompt_tokens", "new_tokens")
    assert [{k: r[k] for k in keep} for r in pr] == [{k: r[k] for k in keep} for r in jr]
    assert all(r["hbm"] == {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0}
               for r in pr)
