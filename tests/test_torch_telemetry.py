"""The port's telemetry core against the JAX package's, on the CPU: the
metrics registry (the same operations give the same Prometheus text and
scalar samples), the step tracer (the same records give the same JSONL
apart from ``ts``), the exporters, the Telemetry facade's step records,
the watchdog's detectors, the compile families, and the ``telemetry`` /
``serving.slo`` config sections (the same defaults and errors; the
refusals of what is not ported name their ROADMAP item)."""

import dataclasses
import json
import math
import os

import numpy as np
import pytest

from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu.telemetry import Telemetry as JaxTelemetry
from deepspeed_tpu.telemetry import exporters as jexporters
from deepspeed_tpu.telemetry import registry as jregistry
from deepspeed_tpu.telemetry import tracer as jtracer
from deepspeed_tpu.telemetry import watchdog as jwatchdog
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.runtime.config import NotPortedError
from deepspeed_tpu_torch.telemetry import Telemetry, compile_stats, device_hbm_stats
from deepspeed_tpu_torch.telemetry import exporters as texporters
from deepspeed_tpu_torch.telemetry import from_config
from deepspeed_tpu_torch.telemetry import registry as tregistry
from deepspeed_tpu_torch.telemetry import tracer as ttracer
from deepspeed_tpu_torch.telemetry import watchdog as twatchdog


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def _script_counters(reg):
    c = reg.counter("requests_total", "requests by status", labelnames=("status",))
    c.inc(status="ok")
    c.inc(2.5, status="ok")
    c.inc(status="err")
    reg.counter("plain_total", "no labels").inc(7)
    with pytest.raises(ValueError):
        c.inc(-1, status="ok")
    with pytest.raises(ValueError):
        c.inc(bogus="x")


def _script_gauges(reg):
    g = reg.gauge("queue_depth", "waiting")
    g.set(3)
    g.inc(2)
    g.inc(-1.5)
    reg.gauge("train_loss").set(float("nan"))
    reg.gauge("g_inf").set(float("inf"))
    reg.gauge("g_big").set(2.0 ** 60)
    reg.gauge("path_g", labelnames=("path",)).set(1, path='a"b\\c\nd')


def _script_histograms(reg):
    h = reg.histogram("lat_seconds", "latency", buckets=(0.001, 0.01, 0.1, 1.0))
    for v in (0.0005, 0.002, 0.002, 0.05, 0.5, 3.0, 0.01):
        h.observe(v)
    hl = reg.histogram("lab_seconds", "labelled", labelnames=("kind",))
    for i in range(40):
        hl.observe(i * 0.013, kind="a" if i % 3 else "b")
    reg.histogram("empty_seconds", "no observations")


SCRIPTS = {"counters": _script_counters, "gauges": _script_gauges,
           "histograms": _script_histograms}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_registry_text_and_samples_equal(name):
    treg, jreg = tregistry.MetricsRegistry(), jregistry.MetricsRegistry()
    SCRIPTS[name](treg)
    SCRIPTS[name](jreg)
    assert treg.to_prometheus() == jreg.to_prometheus()
    ts, js = treg.scalar_samples(), jreg.scalar_samples()
    assert len(ts) == len(js)
    for (tn, tv), (jn, jv) in zip(ts, js):
        assert tn == jn and (tv == jv or (math.isnan(tv) and math.isnan(jv)))


@pytest.mark.parametrize("q", [0.01, 0.25, 0.5, 0.9, 0.95, 0.99])
def test_histogram_quantiles_equal(q):
    treg, jreg = tregistry.MetricsRegistry(), jregistry.MetricsRegistry()
    _script_histograms(treg)
    _script_histograms(jreg)
    for nm, labels in (("lat_seconds", {}), ("lab_seconds", {"kind": "a"}),
                       ("lab_seconds", {"kind": "b"})):
        assert treg.get(nm).quantile(q, **labels) == jreg.get(nm).quantile(q, **labels)
        assert treg.get(nm).stats(**labels) == jreg.get(nm).stats(**labels)
    assert treg.get("empty_seconds").quantile(q) is None
    buckets, counts = (0.1, 0.2, float("inf")), [1, 5, 9]
    assert tregistry.quantile_from_buckets(buckets, counts, 9, q) \
        == jregistry.quantile_from_buckets(buckets, counts, 9, q)


def test_registry_kind_clash_and_textfile(tmp_path):
    treg = tregistry.MetricsRegistry()
    treg.counter("x_total")
    with pytest.raises(ValueError, match="already declared"):
        treg.gauge("x_total")
    with pytest.raises(TypeError):
        treg.histogram("h").value()
    _script_gauges(treg)
    jreg = jregistry.MetricsRegistry()
    jreg.counter("x_total")
    jreg.histogram("h")
    _script_gauges(jreg)
    out_t = tmp_path / "t" / "m.prom"
    out_j = tmp_path / "j" / "m.prom"
    treg.write_textfile(str(out_t))
    jreg.write_textfile(str(out_j))
    assert out_t.read_text() == out_j.read_text()
    assert os.listdir(out_t.parent) == ["m.prom"]  # no temp litter


# ---------------------------------------------------------------------------
# step tracer
# ---------------------------------------------------------------------------

RECORDS = [
    {"kind": "train_step", "step": 1, "loss": 1.0},
    {"kind": "train_step", "step": 2, "loss": np.float32(0.5), "n": np.int64(3)},
    {"kind": "checkpoint", "dur_ms": 12.5, "tag": "a"},
    {"kind": "inference_step", "step": 3, "arr": np.float64(2.25), "lst": [1, 2]},
]


def _lines(path):
    with open(path) as fh:
        return [json.loads(ln) for ln in fh if ln.strip()]


@pytest.mark.parametrize("max_bytes", [0, 200])
def test_step_tracer_jsonl_equal(tmp_path, max_bytes):
    tr = ttracer.StepTracer(str(tmp_path / "t"), flush_interval=2, max_bytes=max_bytes,
                            process_index=0)
    jr = jtracer.StepTracer(str(tmp_path / "j"), flush_interval=2, max_bytes=max_bytes,
                            process_index=0)
    for rec in RECORDS * 3:
        tr.emit(dict(rec))
        jr.emit(dict(rec))
    tr.emit_serialized(json.dumps({"kind": "request", "id": 1}))
    jr.emit_serialized(json.dumps({"kind": "request", "id": 1}))
    tr.close()
    jr.close()
    assert tr.rotations == jr.rotations and (tr.rotations > 0) == (max_bytes > 0)
    for suffix in ("", ".1") if max_bytes else ("",):
        t = [{k: v for k, v in r.items() if k != "ts"} for r in _lines(tr.file_path + suffix)]
        j = [{k: v for k, v in r.items() if k != "ts"} for r in _lines(jr.file_path + suffix)]
        assert t == j and t
    assert os.path.basename(tr.file_path) == os.path.basename(jr.file_path)


def test_step_tracer_sampling_spans_and_aggregate(tmp_path):
    tr = ttracer.StepTracer(str(tmp_path), flush_interval=1, sample_every=10)
    assert tr.process_index == 0
    assert tr.should_sample(10) and not tr.should_sample(11)
    tr.force_next()
    assert tr.should_sample(11)
    tr.emit({"kind": "train_step", "step": 11})
    assert not tr.should_sample(11)
    tr.emit_aggregate({"kind": "train_step_aggregate", "loss": np.float32(1.5)})
    assert _lines(os.path.join(tmp_path, "trace-aggregate.jsonl")) == [
        {"kind": "train_step_aggregate", "loss": 1.5}]
    spans = [("prepare", 1.0), ("dispatch", 2.0)]
    assert ttracer.spans_to_tree(spans, 5.0) == jtracer.spans_to_tree(spans, 5.0)
    assert ttracer.aggregate_scalars({"a": 1.0}) == jtracer.aggregate_scalars({"a": 1.0})
    # a named file: host 0 keeps the name, others are suffixed
    named = ttracer.StepTracer(str(tmp_path / "x.jsonl"), process_index=3)
    assert named.file_path.endswith("x-00003.jsonl")


# ---------------------------------------------------------------------------
# facade and exporters
# ---------------------------------------------------------------------------

class FakeMonitor:
    enabled = True

    def __init__(self):
        self.events = []

    def write_events(self, ev):
        self.events.extend(ev)


def _record_steps(tel):
    tel.record_step("inference", step=1, duration_s=0.25,
                    scalars={"batch": 8, "tokens_per_sec": 1234.5},
                    spans=[("generate", 250.0)],
                    hbm={"bytes_in_use": 100, "peak_bytes_in_use": 200, "bytes_limit": 300},
                    extra={"compiled_cache_hit": False})
    tel.record_step("inference", step=2, duration_s=0.125, scalars={"batch": 8},
                    spans=[("generate", 100.0)], extra={"compiled_cache_hit": True})
    tel.record_event("checkpoint_save", 0.5, {"tag": "t"})


def test_record_step_monitor_bridge_and_prometheus_equal(tmp_path):
    def make(cls, cfg_mod, root):
        cfg = cfg_mod.TelemetryConfig(
            enabled=True, trace_path=str(root), prometheus_path=str(root / "m.prom"),
            flush_interval=1)
        cfg.introspection.enabled = False
        return cls(cfg, process_index=0)

    tel = make(Telemetry, tconfig, tmp_path / "t")
    jtel = make(JaxTelemetry, jconfig, tmp_path / "j")
    _record_steps(tel)
    _record_steps(jtel)
    tel.flush()
    jtel.flush()
    drop = ("ts",)
    assert [{k: v for k, v in r.items() if k not in drop} for r in _lines(tel.tracer.file_path)] \
        == [{k: v for k, v in r.items() if k not in drop} for r in _lines(jtel.tracer.file_path)]

    def serving_text(path):
        return [ln for ln in open(path).read().splitlines() if "jit_" not in ln]

    assert serving_text(tmp_path / "t" / "m.prom") == serving_text(tmp_path / "j" / "m.prom")
    mon, jmon = FakeMonitor(), FakeMonitor()
    tel.attach_monitor(mon)
    jtel.attach_monitor(jmon)
    assert tel.export_monitor(step=3) == len(mon.events) > 0
    jtel.export_monitor(step=3)
    keep = lambda evs: [e for e in evs if "jit_" not in e[0]]  # noqa: E731
    assert keep(mon.events) == keep(jmon.events)
    assert all("{" not in t and '"' not in t for t, _, _ in mon.events)
    tel.close()
    jtel.close()


def test_exporters_equal(tmp_path):
    treg, jreg = tregistry.MetricsRegistry(), jregistry.MetricsRegistry()
    for reg in (treg, jreg):
        _script_counters(reg)
        _script_histograms(reg)
    texporters.PrometheusTextfileExporter(treg, str(tmp_path / "t.prom")).export()
    jexporters.PrometheusTextfileExporter(jreg, str(tmp_path / "j.prom")).export()
    assert (tmp_path / "t.prom").read_text() == (tmp_path / "j.prom").read_text()
    assert texporters.MonitorBridge(treg, None).events(5) \
        == jexporters.MonitorBridge(jreg, None).events(5)
    assert texporters._tag('a{b="1",c="2"}') == jexporters._tag('a{b="1",c="2"}') == "a/b=1,c=2"


def test_disabled_plane_constructs_nothing(tmp_path):
    cfg = tconfig.TelemetryConfig(enabled=False, trace_path=str(tmp_path / "t"))
    assert from_config(cfg) is None and from_config(None) is None
    assert not (tmp_path / "t").exists()


def test_device_hbm_stats_on_the_cpu_are_zeros():
    assert device_hbm_stats("cpu") == {"bytes_in_use": 0, "peak_bytes_in_use": 0,
                                       "bytes_limit": 0}


def test_compile_families_count_the_ports_compiles():
    """The five jit_* families are declared at 0 when a registry installs
    and count what the notes report (CUDA graph captures and warm-ups,
    kernel libraries found or built); an uninstalled registry stops."""
    reg = tregistry.MetricsRegistry()
    compile_stats.install(reg)
    try:
        names = [n for n, _ in compile_stats.FAMILIES]
        assert {n for n, v in reg.scalar_samples()} == set()  # declared, no children
        assert all(reg.get(n) is not None for n in names)
        compile_stats.note_warmup(0.25)
        compile_stats.note_capture(0.5)
        compile_stats.note_capture(0.25)
        compile_stats.note_build(hit=True)
        compile_stats.note_build(hit=False)
        compile_stats.note_build(hit=True)
        vals = {n: reg.get(n).value() for n in names}
        assert vals == {"jit_compiles_total": 2.0, "jit_compile_seconds_total": 0.75,
                        "jit_trace_seconds_total": 0.25, "jit_cache_hits_total": 2.0,
                        "jit_cache_misses_total": 1.0}
    finally:
        compile_stats.uninstall()
    compile_stats.note_capture(1.0)
    assert reg.get("jit_compiles_total").value() == 2.0


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------

def _series():
    rs = np.random.RandomState(3)
    out = []
    for step in range(60):
        loss = 3.0 - 0.01 * step + 0.01 * rs.randn()
        st = 0.1 + 0.001 * rs.randn()
        if step in (30, 45):
            loss += 2.0
        if step == 50:
            st = 0.5
        out.append({"loss": loss, "step_time_s": st,
                    "grad_norm": float("nan") if step == 55 else 1.0})
    return out


def _watch(mod, cfg_mod, tmp_path, **kw):
    cfg = cfg_mod.WatchdogConfig(enabled=True, warmup_steps=10,
                                 capture_dir=str(tmp_path / "cap"), **kw)
    return mod.AnomalyWatchdog(cfg)


def test_watchdog_trips_equal():
    import tempfile
    from pathlib import Path

    tmp = Path(tempfile.mkdtemp())
    w, jw = _watch(twatchdog, tconfig, tmp), _watch(jwatchdog, jconfig, tmp)
    for step, sc in enumerate(_series()):
        a = w.observe_step(step, sc)
        b = jw.observe_step(step, sc)
        assert [{k: v for k, v in x.items() if k != "ts"} for x in a] \
            == [{k: v for k, v in x.items() if k != "ts"} for x in b]
    assert [x["step"] for x in w.anomalies] == [30, 45, 50, 55]
    assert w.observe_straggler(7, 3, "d") and not w.observe_straggler(8, 3, "d")
    assert jw.observe_straggler(7, 3, "d") and not jw.observe_straggler(8, 3, "d")
    assert w.anomalies[-1]["signal"] == jw.anomalies[-1]["signal"] == "request_3"


def test_watchdog_kill_policy_raises_in_both(tmp_path):
    w, jw = (_watch(twatchdog, tconfig, tmp_path, policy="kill"),
             _watch(jwatchdog, jconfig, tmp_path, policy="kill"))
    with pytest.raises(twatchdog.AnomalyError):
        w.observe_step(0, {"loss": float("inf")})
    with pytest.raises(jwatchdog.AnomalyError):
        jw.observe_step(0, {"loss": float("inf")})


def test_watchdog_captures_with_torch_profiler_and_prune(tmp_path):
    w = _watch(twatchdog, tconfig, tmp_path, max_captures=2)
    dirs = []
    for step in range(3):
        w.observe_step(step, {"loss": float("nan")})
        assert w.capture_pending or step >= 2
        target = w.start_capture(100 + step)
        if target is None:
            break
        sum(range(1000))
        assert w.stop_capture() == target
        dirs.append(os.path.basename(target))
        assert os.path.isfile(os.path.join(target, "trace.json"))
    assert dirs == ["anomaly-step-00000100", "anomaly-step-00000101"]
    assert sorted(os.listdir(tmp_path / "cap")) == dirs  # bounded at max_captures


# ---------------------------------------------------------------------------
# config sections
# ---------------------------------------------------------------------------

SECTIONS = ["IntrospectionConfig", "WatchdogConfig", "RequestTraceConfig", "KVHeatConfig",
            "TimeseriesConfig", "TelemetryConfig", "SLOConfig", "SLOAlertsConfig"]


@pytest.mark.parametrize("name", SECTIONS)
def test_config_defaults_equal(name):
    t = dataclasses.asdict(getattr(tconfig, name)())
    j = dataclasses.asdict(getattr(jconfig, name)())
    assert t == j


BAD = [
    ("WatchdogConfig", {"policy": "explode"}),
    ("WatchdogConfig", {"zscore": 0}),
    ("WatchdogConfig", {"ema_alpha": 1.5}),
    ("RequestTraceConfig", {"max_events_per_request": 0}),
    ("RequestTraceConfig", {"flush_interval": 0}),
    ("KVHeatConfig", {"flush_interval": 0}),
    ("KVHeatConfig", {"segment_events": 0}),
    ("KVHeatConfig", {"idle_thresholds_s": []}),
    ("KVHeatConfig", {"idle_thresholds_s": [5.0, 1.0]}),
    ("TimeseriesConfig", {"interval_s": 0}),
    ("TimeseriesConfig", {"flush_interval": 0}),
    ("TimeseriesConfig", {"retention_s": -1}),
    ("SLOConfig", {"goodput_window_s": -1}),
    ("SLOConfig", {"classes": {"a": 3}}),
    ("SLOConfig", {"classes": {"a": {"ttft": 1}}}),
    ("SLOConfig", {"classes": {"a": {"ttft_target_s": -1}}}),
    ("SLOConfig", {"classes": {"a": {}}, "default_class": "b"}),
    ("SLOAlertsConfig", {"objective": 1.0}),
    ("SLOAlertsConfig", {"fast_short_s": 0}),
    ("SLOAlertsConfig", {"fast_short_s": 7200}),
    ("SLOAlertsConfig", {"slow_burn_threshold": 0}),
    ("SLOAlertsConfig", {"for_s": -1}),
]


@pytest.mark.parametrize("name,d", BAD, ids=[f"{n}-{sorted(d)[0]}" for n, d in BAD])
def test_config_errors_equal(name, d):
    with pytest.raises(jconfig.DeepSpeedConfigError) as jerr:
        getattr(jconfig, name).from_dict(d)
    with pytest.raises(tconfig.DeepSpeedConfigError) as terr:
        getattr(tconfig, name).from_dict(d)
    assert str(terr.value) == str(jerr.value)


def test_config_parses_nested_sections_as_jax():
    d = {"enabled": True, "trace_path": "/x", "flush_interval": "5", "sample_every": 2.0,
         "introspection": {"enabled": False},
         "watchdog": {"enabled": True, "straggler_factor": 2, "warmup_steps": "7"},
         "request_trace": {"enabled": True, "max_mb": 1},
         "kv_heat": {"enabled": True, "idle_thresholds_s": [0.5, 2]},
         "timeseries": {"enabled": True, "interval_s": 0.25}}
    t = dataclasses.asdict(tconfig.TelemetryConfig.from_dict(d))
    j = dataclasses.asdict(jconfig.TelemetryConfig.from_dict(d))
    assert t == j
    slo = {"classes": {"chat": {"ttft_target_s": 0.5, "tpot_target_s": 0.05},
                       "batch": {"ttft_target_s": 30}}, "goodput_window_s": 60}
    ts, js = tconfig.SLOConfig.from_dict(slo), jconfig.SLOConfig.from_dict(slo)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    for name in (None, "chat", "batch", "nope"):
        assert ts.resolve_class(name) == js.resolve_class(name)
        assert ts.targets(ts.resolve_class(name)) == js.targets(js.resolve_class(name))
    serving = tconfig.ServingConfig.from_dict({"slo": slo})
    assert serving.slo.classes == slo["classes"] and serving.slo.goodput_window_s == 60.0


def test_refusals_name_their_roadmap_item():
    with pytest.raises(NotPortedError, match="item 15"):
        tconfig.TelemetryConfig.from_dict({"enabled": True,
                                           "introspection": {"enabled": True}})
    # the rollback policy landed with the resilience plane (item 8)
    assert tconfig.TelemetryConfig.from_dict(
        {"enabled": True, "watchdog": {"enabled": True, "policy": "rollback"}}
    ).watchdog.policy == "rollback"
    assert twatchdog.AnomalyWatchdog(
        jconfig.WatchdogConfig(enabled=True, policy="rollback")).policy == "rollback"
    # the training config takes the section (item 6b landed) and refuses
    # what stays unported in it, and the monitor backends (item 14)
    cfg = tconfig.DeepSpeedConfig.from_dict({"train_batch_size": 8,
                                             "telemetry": {"enabled": True, "sample_every": 3},
                                             "wall_clock_breakdown": True,
                                             "memory_breakdown": True})
    assert cfg.telemetry.enabled and cfg.telemetry.sample_every == 3
    assert cfg.wall_clock_breakdown and cfg.memory_breakdown
    cfg = tconfig.DeepSpeedConfig.from_dict({"train_batch_size": 8, "telemetry": {
        "enabled": True, "watchdog": {"enabled": True, "policy": "rollback"}},
        "resilience": {"enabled": True}})
    assert cfg.telemetry.watchdog.policy == "rollback" and cfg.resilience.enabled
    with pytest.raises(NotPortedError, match="item 15"):
        tconfig.DeepSpeedConfig.from_dict({"train_batch_size": 8, "telemetry": {
            "enabled": True, "introspection": {"enabled": True}}})
    with pytest.raises(NotPortedError, match="item 14"):
        tconfig.DeepSpeedConfig.from_dict({"train_batch_size": 8,
                                           "tensorboard": {"enabled": True}})
    # an off section is accepted by the training config; the fleet (item 9),
    # the placements (item 11) and the fleet over placements (device_base,
    # item 11c) are ported
    tconfig.DeepSpeedConfig.from_dict({"train_batch_size": 8, "telemetry": {"enabled": False}})
    assert tconfig.ServingConfig.from_dict({"fleet": {"enabled": True}}).fleet.enabled
    both = tconfig.ServingConfig.from_dict({"fleet": {"enabled": True}, "placement": {"tp": 2}})
    assert both.fleet.enabled and both.placement.tp == 2
    assert tconfig.ServingConfig.from_dict({"placement": {"tp": 2}}).placement.tp == 2
    assert tconfig.ServingConfig.from_dict(
        {"placement": {"device_base": 1}}).placement.device_base == 1
