"""Config: the ``serving`` section and the training subset of the document.

Counterpart of ``deepspeed_tpu/runtime/config.py``. ``ServingConfig``: the
same fields, defaults and validation for the continuous-batching path
(paged KV pool, admission control, deadlines, drain), its int8 KV pages
(``kv_cache_dtype="int8"``), its three hot-path features: speculative
decode (``speculative``), shared-prefix KV reuse (``prefix_cache``) and
chunked prefill (``prefill_chunk_tokens``), and its SLO classes
(``slo``), the host KV tier (``tiering``), retries with backoff
(``retry_max``), the multi-replica fleet (``fleet``, read by
``serving/fleet.py``'s ``FleetRouter``) and the placements (``placement``:
tensor-parallel and disaggregated serving over the ranks of the default
process group, ``serving/placement.py``; a fleet over placements gives
each replica its own window of ranks, ``placement.device_base``).

``TelemetryConfig``: the ``telemetry`` section of ``init_inference``'s and
``initialize``'s configs (the same fields, defaults and errors as the JAX
package's), with
its watchdog, request-trace, kv-heat and time-series sections.
``telemetry.introspection.enabled`` raises :class:`NotPortedError`;
``watchdog.policy="rollback"`` restores the resilience plane's snapshots.
``SLOAlertsConfig`` is the fleet's
burn-rate section (``serving.fleet.slo_alerts``), which
``telemetry.slo_budget`` also takes standalone.

``DeepSpeedConfig``: the training subset (the batch triple over ``dp``
ranks, ``fp16``/``bf16``, ``gradient_clipping``, ``optimizer``, ``scheduler``,
``prescale_gradients``/``gradient_predivide_factor``,
``data_types.grad_accum_dtype``, ``zero_optimization`` at stages 0-3, the
``mesh`` section's ``dp``, ``sp`` and ``tp`` axes, ``comms_logger``,
``activation_checkpointing``,
``steps_per_print``, ``wall_clock_breakdown``, ``memory_breakdown``, the
``telemetry``, ``resilience`` and ``checkpoint`` sections, and the typed
``sparse_attention`` section that a
model config reads through ``ops.sparse_attention.from_ds_config``) with
the JAX package's key names and defaults. Any other section at a value that
turns something on raises :class:`NotPortedError`.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional


class DeepSpeedConfigError(ValueError):
    pass


class NotPortedError(DeepSpeedConfigError, NotImplementedError):
    """A config value asks for a feature this package does not have yet."""


def _not_ported(what: str, item) -> NotPortedError:
    return NotPortedError(
        f"serving.{what} is not ported to deepspeed_tpu_torch yet (ROADMAP "
        f"queue 1 item {item}; the default continuous-batching path is); use "
        "deepspeed_tpu for it"
    )


def _section_from_dict(cls, name: str, d: Dict[str, Any]):
    """A feature section's dataclass from its dict; unknown keys raise."""
    known = {f.name for f in fields(cls)}
    unknown = sorted(set(d) - known)
    if unknown:
        raise DeepSpeedConfigError(f"serving.{name}: unknown config keys {unknown}")
    return cls(**{k: type(getattr(cls, k))(v) for k, v in d.items()})


@dataclass
class SpeculativeConfig:
    """``serving.speculative``: self-speculative decode. The scheduler
    drafts ``k`` tokens per slot host-side (prompt lookup: the continuation
    of the last ``ngram`` tokens' most recent earlier occurrence) and one
    verify step scores all ``k + 1`` positions, accepting the longest
    matching prefix. Greedy only (``temperature == 0``)."""

    enabled: bool = False
    k: int = 4
    ngram: int = 2

    def __post_init__(self):
        if not 1 <= int(self.k) <= 16:
            raise DeepSpeedConfigError(
                f"serving.speculative.k must be in [1, 16], got {self.k}"
            )
        if int(self.ngram) < 1:
            raise DeepSpeedConfigError(
                f"serving.speculative.ngram must be >= 1, got {self.ngram}"
            )


@dataclass
class PrefixCacheConfig:
    """``serving.prefix_cache``: shared-prefix KV reuse. Full prompt pages
    are indexed after prefill; a later prompt maps its matching page-aligned
    prefix (refcounted pages) and prefills only the tail. ``max_pages``
    caps the index (0 = no cap; pool pressure evicts regardless)."""

    enabled: bool = False
    max_pages: int = 0

    def __post_init__(self):
        if int(self.max_pages) < 0:
            raise DeepSpeedConfigError(
                "serving.prefix_cache.max_pages must be >= 0, got "
                f"{self.max_pages}"
            )


@dataclass
class TieringConfig:
    """``serving.tiering``: the host-DRAM second tier for cold KV pages
    (``serving/tiering.py``). With it on (it needs ``prefix_cache``), a
    prefix-index leaf evicted as the index's last reference is demoted to
    pinned host buffers instead of dropped, and a later prompt re-hitting
    the chain restores the page through the width-1 ``serving_kv_restore``
    program at admission (a ``kv_restore`` queue wait in the request trace)
    instead of recomputing it. ``host_budget_pages``: host slots (0 = the
    device pool's capacity); ``policy``: the spill-victim order (one of
    ``telemetry.kv_heat.SPILL_POLICIES``); ``prefetch_depth``: pages
    restored per admission attempt; ``crc``: crc32 every spilled buffer and
    treat a mismatch at restore as a cold miss."""

    enabled: bool = False
    host_budget_pages: int = 0
    policy: str = "idle_lru"
    prefetch_depth: int = 4
    crc: bool = True

    def __post_init__(self):
        if self.policy not in ("idle_lru", "prefix_aware", "slot_priority"):
            raise DeepSpeedConfigError(
                "serving.tiering.policy must be one of 'idle_lru', "
                f"'prefix_aware', 'slot_priority'; got {self.policy!r}"
            )
        if int(self.host_budget_pages) < 0:
            raise DeepSpeedConfigError(
                "serving.tiering.host_budget_pages must be >= 0, got "
                f"{self.host_budget_pages}"
            )
        if int(self.prefetch_depth) < 1:
            raise DeepSpeedConfigError(
                "serving.tiering.prefetch_depth must be >= 1, got "
                f"{self.prefetch_depth}"
            )


# ---------------------------------------------------------------------------
# telemetry and SLO sections: dict → dataclass as the JAX package's
# DSConfigModel does (nested sections from dicts, scalars coerced, unknown
# keys warned about and ignored)
# ---------------------------------------------------------------------------

def _unwrap_optional(typ):
    args = typing.get_args(typ)
    if args and type(None) in args:
        rest = [a for a in args if a is not type(None)]
        if len(rest) == 1:
            return rest[0]
    return typ


def _coerce(value: Any, typ: Any) -> Any:
    if value is None:
        return None
    typ = _unwrap_optional(typ)
    if typing.get_origin(typ) is not None:
        return value
    try:
        if typ is int and not isinstance(value, bool):
            return int(float(value))
        if typ is float:
            return float(value)
        if typ is bool:
            return bool(value)
    except (TypeError, ValueError):
        return value
    return value


@dataclass
class _ConfigModel:
    """A section built from a (possibly partial) dict, as the JAX package's
    ``runtime/config_utils.DSConfigModel`` builds it."""

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]], warn_unknown: bool = True):
        from ..utils.logging import logger

        hints = typing.get_type_hints(cls)
        known = {f.name for f in fields(cls)}
        kwargs = {}
        for key, value in dict(d or {}).items():
            if key in known:
                typ = _unwrap_optional(hints.get(key, Any))
                if dataclasses.is_dataclass(typ) and isinstance(value, dict):
                    kwargs[key] = typ.from_dict(value, warn_unknown=warn_unknown)
                else:
                    kwargs[key] = _coerce(value, typ)
            elif warn_unknown:
                logger.warning(f"{cls.__name__}: ignoring unknown config key '{key}'")
        return cls(**kwargs)


@dataclass
class IntrospectionConfig(_ConfigModel):
    """``telemetry.introspection``: the JAX package's HLO cost / MFU
    analyzer, driven by its training engine. Not ported (ROADMAP queue 1
    item 15); ``TelemetryConfig.from_dict`` refuses a section that turns it
    on."""

    enabled: bool = True
    peak_tflops: float = 0.0


@dataclass
class WatchdogConfig(_ConfigModel):
    """``telemetry.watchdog``: in-run anomaly detection
    (``telemetry/watchdog.py``): EMA z-score spikes on watched scalars
    after ``warmup_steps`` observations, bounded ``torch.profiler``
    captures under ``capture_dir``, and the serving straggler detector
    (``straggler_factor`` × max_new_tokens × EMA decode step time).
    ``policy``: ``continue``, ``kill`` or ``rollback`` (the training
    engine restores its last clean-step snapshot; it needs the
    ``resilience`` section with ``snapshot_every > 0``). ``nan_check``: the
    training step computes its ``anomaly_flags`` (the loss's and the
    gradient norm's non-finite bits) for the watchdog."""

    enabled: bool = False
    nan_check: bool = True
    zscore: float = 6.0
    ema_alpha: float = 0.05
    min_rel_std: float = 0.02  # std floor as a fraction of |mean|
    warmup_steps: int = 20
    check_every: int = 1
    policy: str = "continue"  # continue | kill | rollback
    capture_dir: str = "./telemetry/anomalies"
    max_captures: int = 3
    straggler_factor: float = 3.0

    def __post_init__(self):
        if self.policy not in ("continue", "kill", "rollback"):
            raise DeepSpeedConfigError(
                f"telemetry.watchdog.policy must be 'continue', 'kill' or "
                f"'rollback', got {self.policy!r}"
            )
        if self.zscore <= 0:
            raise DeepSpeedConfigError("telemetry.watchdog.zscore must be positive")
        if not 0.0 < self.ema_alpha <= 1.0:
            raise DeepSpeedConfigError(
                "telemetry.watchdog.ema_alpha must be in (0, 1]"
            )


@dataclass
class RequestTraceConfig(_ConfigModel):
    """``telemetry.request_trace``: one ``dstpu-reqtrace-v1`` JSONL record
    per terminal serving request (``telemetry/request_trace.py``). ``path``
    "" puts ``requests.jsonl`` under ``telemetry.trace_path``;
    ``max_events_per_request`` bounds one request's event list."""

    enabled: bool = False
    path: str = ""  # "" = <telemetry.trace_path>/requests.jsonl
    flush_interval: int = 20
    max_mb: int = 64  # 0 = unbounded
    max_events_per_request: int = 4096

    def __post_init__(self):
        if int(self.max_events_per_request) < 1:
            raise DeepSpeedConfigError(
                "telemetry.request_trace.max_events_per_request must be "
                f">= 1, got {self.max_events_per_request}"
            )
        if int(self.flush_interval) < 1:
            raise DeepSpeedConfigError(
                "telemetry.request_trace.flush_interval must be >= 1, got "
                f"{self.flush_interval}"
            )


@dataclass
class KVHeatConfig(_ConfigModel):
    """``telemetry.kv_heat``: page-lifetime / session-heat tracing
    (``telemetry/kv_heat.py``), ``dstpu-kvheat-v1`` segment records off the
    engine's clock. ``path`` "" puts ``kv_heat.jsonl`` under
    ``telemetry.trace_path``; ``segment_events`` is the seal threshold;
    ``idle_thresholds_s`` the cold-page gauges' thresholds (ascending)."""

    enabled: bool = False
    path: str = ""  # "" = <telemetry.trace_path>/kv_heat.jsonl
    flush_interval: int = 20
    max_mb: int = 64  # 0 = unbounded
    segment_events: int = 256
    idle_thresholds_s: tuple = (1.0, 5.0, 30.0)

    def __post_init__(self):
        if int(self.flush_interval) < 1:
            raise DeepSpeedConfigError(
                "telemetry.kv_heat.flush_interval must be >= 1, got "
                f"{self.flush_interval}"
            )
        if int(self.segment_events) < 1:
            raise DeepSpeedConfigError(
                "telemetry.kv_heat.segment_events must be >= 1, got "
                f"{self.segment_events}"
            )
        ths = tuple(float(t) for t in self.idle_thresholds_s)
        if not ths:
            raise DeepSpeedConfigError(
                "telemetry.kv_heat.idle_thresholds_s must be non-empty"
            )
        if any(t <= 0.0 for t in ths) or list(ths) != sorted(ths):
            raise DeepSpeedConfigError(
                "telemetry.kv_heat.idle_thresholds_s must be positive and "
                f"ascending, got {self.idle_thresholds_s}"
            )
        self.idle_thresholds_s = ths


@dataclass
class TimeseriesConfig(_ConfigModel):
    """``telemetry.timeseries``: the metrics journal
    (``telemetry/timeseries.py``): the registry snapshotted every
    ``interval_s`` seconds of the engine's clock into ``dstpu-tsdb-v1``
    delta records. ``path`` "" puts ``metrics_tsdb.jsonl`` under
    ``telemetry.trace_path``; ``retention_s`` bounds the in-memory query
    window (0 = auto, min 1 h)."""

    enabled: bool = False
    path: str = ""  # "" = <telemetry.trace_path>/metrics_tsdb.jsonl
    interval_s: float = 1.0
    flush_interval: int = 20
    max_mb: int = 64  # 0 = unbounded
    retention_s: float = 0.0  # 0 = auto (largest alert window, min 3600)

    def __post_init__(self):
        if float(self.interval_s) <= 0.0:
            raise DeepSpeedConfigError(
                "telemetry.timeseries.interval_s must be > 0, got "
                f"{self.interval_s}"
            )
        if int(self.flush_interval) < 1:
            raise DeepSpeedConfigError(
                "telemetry.timeseries.flush_interval must be >= 1, got "
                f"{self.flush_interval}"
            )
        if float(self.retention_s) < 0.0:
            raise DeepSpeedConfigError(
                "telemetry.timeseries.retention_s must be >= 0, got "
                f"{self.retention_s}"
            )


@dataclass
class TelemetryConfig(_ConfigModel):
    """``telemetry``: the plane of ``deepspeed_tpu_torch/telemetry``.
    ``trace_path`` receives the step records (``generate`` calls here);
    ``prometheus_path`` (optional) an atomically replaced ``.prom``
    snapshot; ``sample_every`` thins records; ``flush_interval`` is records
    per file append / Prometheus rewrite; ``trace_max_mb`` caps each trace
    file (one rolled generation, 0 disables). Disabled ⇒ nothing is
    constructed. The introspection analyzer is not ported (ROADMAP queue 1
    item 15): an enabled plane whose section asks for it
    (``"introspection": {"enabled": true}``) raises
    :class:`NotPortedError`; left at its default it runs nothing, as in
    the JAX package's inference engine, which never drives it."""

    enabled: bool = False
    trace_path: str = "./telemetry"
    prometheus_path: str = ""  # "" = no Prometheus snapshot
    flush_interval: int = 20
    sample_every: int = 1
    trace_max_mb: int = 64  # 0 = unbounded
    introspection: IntrospectionConfig = field(default_factory=IntrospectionConfig)
    watchdog: WatchdogConfig = field(default_factory=WatchdogConfig)
    request_trace: RequestTraceConfig = field(default_factory=RequestTraceConfig)
    kv_heat: KVHeatConfig = field(default_factory=KVHeatConfig)
    timeseries: TimeseriesConfig = field(default_factory=TimeseriesConfig)

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]], warn_unknown: bool = True):
        intro = (d or {}).get("introspection")
        if (d or {}).get("enabled") and isinstance(intro, dict) and intro.get("enabled"):
            raise NotPortedError(
                "telemetry.introspection.enabled is not ported to "
                "deepspeed_tpu_torch yet (the HLO cost / MFU analyzer, ROADMAP "
                "queue 1 item 15)"
            )
        return super().from_dict(d, warn_unknown=warn_unknown)


@dataclass
class SLOConfig(_ConfigModel):
    """``serving.slo``: per-class latency targets for goodput and SLO
    attainment. ``classes`` maps a class name to ``{"ttft_target_s": x,
    "tpot_target_s": y}`` (0 or omitted = no target on that axis); a
    request submitted with ``slo_class=None`` or an unknown class lands in
    ``default_class`` ("" = the first declared class). A FINISHED request
    meets its SLO when TTFT ≤ ``ttft_target_s`` and mean TPOT ≤
    ``tpot_target_s``; every other terminal status misses.
    ``goodput_window_s`` > 0 computes the goodput gauge over that trailing
    window (0 = the whole span since the first submit)."""

    classes: Dict[str, Dict[str, float]] = field(default_factory=dict)
    default_class: str = ""  # "" = first declared class
    goodput_window_s: float = 0.0

    def __post_init__(self):
        if float(self.goodput_window_s) < 0.0:
            raise DeepSpeedConfigError(
                "serving.slo.goodput_window_s must be >= 0, got "
                f"{self.goodput_window_s}"
            )
        for name, targets in (self.classes or {}).items():
            if not isinstance(targets, dict):
                raise DeepSpeedConfigError(
                    f"serving.slo.classes[{name!r}] must be a dict of "
                    f"targets, got {type(targets).__name__}"
                )
            for k, v in targets.items():
                if k not in ("ttft_target_s", "tpot_target_s"):
                    raise DeepSpeedConfigError(
                        f"serving.slo.classes[{name!r}]: unknown target "
                        f"{k!r} (ttft_target_s | tpot_target_s)"
                    )
                if float(v) < 0:
                    raise DeepSpeedConfigError(
                        f"serving.slo.classes[{name!r}].{k} must be >= 0, "
                        f"got {v}"
                    )
        if self.default_class and self.default_class not in (self.classes or {}):
            raise DeepSpeedConfigError(
                f"serving.slo.default_class {self.default_class!r} is not a "
                f"declared class ({sorted(self.classes or {})})"
            )

    def resolve_class(self, name: Optional[str]) -> str:
        """The class a request lands in: its own when declared, else the
        default (explicit ``default_class`` or the first declared class),
        else ""."""
        if name and name in (self.classes or {}):
            return name
        if self.default_class:
            return self.default_class
        return next(iter(self.classes), "") if self.classes else ""

    def targets(self, name: str) -> Dict[str, float]:
        """{"ttft_target_s": x, "tpot_target_s": y} for a class (0 = no
        target on that axis; unknown class = no targets)."""
        t = (self.classes or {}).get(name, {})
        return {
            "ttft_target_s": float(t.get("ttft_target_s", 0.0) or 0.0),
            "tpot_target_s": float(t.get("tpot_target_s", 0.0) or 0.0),
        }


@dataclass
class SLOAlertsConfig(_ConfigModel):
    """``serving.fleet.slo_alerts`` in the JAX package: per-SLO-class error
    budget and multi-window burn-rate alerting over the metrics journal
    (``telemetry/slo_budget.py``). With an attainment ``objective`` the
    error budget is the ``1 - objective`` miss fraction; the burn rate over
    a window is the observed miss fraction over the budget fraction. Two
    rules per class, each needing its short AND long window over threshold:
    ``fast`` (5m/1h at 14.4x) and ``slow`` (6h/3d at 1.0x) by default, in
    seconds of the journal's clock. ``for_s`` is the dwell before pending
    promotes to firing. With ``backpressure`` on, a firing alert sheds
    the fleet's admissions (``FleetRouter._should_shed``); the section
    also builds a standalone ``SLOBudgetEngine``."""

    enabled: bool = False
    objective: float = 0.99
    fast_short_s: float = 300.0
    fast_long_s: float = 3600.0
    fast_burn_threshold: float = 14.4
    slow_short_s: float = 21600.0
    slow_long_s: float = 259200.0
    slow_burn_threshold: float = 1.0
    for_s: float = 0.0  # dwell before a pending alert promotes to firing
    backpressure: bool = False  # firing alerts drive fleet admission shedding

    def __post_init__(self):
        if not 0.0 < float(self.objective) < 1.0:
            raise DeepSpeedConfigError(
                "serving.fleet.slo_alerts.objective must be in (0, 1), got "
                f"{self.objective}"
            )
        for key in ("fast_short_s", "fast_long_s", "slow_short_s",
                    "slow_long_s"):
            if float(getattr(self, key)) <= 0.0:
                raise DeepSpeedConfigError(
                    f"serving.fleet.slo_alerts.{key} must be > 0"
                )
        for short, long in (("fast_short_s", "fast_long_s"),
                            ("slow_short_s", "slow_long_s")):
            if float(getattr(self, short)) >= float(getattr(self, long)):
                raise DeepSpeedConfigError(
                    f"serving.fleet.slo_alerts.{short} must be < {long} "
                    f"({getattr(self, short)} >= {getattr(self, long)})"
                )
        for key in ("fast_burn_threshold", "slow_burn_threshold"):
            if float(getattr(self, key)) <= 0.0:
                raise DeepSpeedConfigError(
                    f"serving.fleet.slo_alerts.{key} must be > 0"
                )
        if float(self.for_s) < 0.0:
            raise DeepSpeedConfigError(
                f"serving.fleet.slo_alerts.for_s must be >= 0, got "
                f"{self.for_s}"
            )

    def max_window_s(self) -> float:
        """The widest window any rule evaluates — the journal's minimum
        useful in-memory retention."""
        return max(float(self.fast_long_s), float(self.slow_long_s))


@dataclass
class FleetConfig(_ConfigModel):
    """``serving.fleet``: the multi-replica router with live session
    migration (JAX ``runtime/config.py`` ``FleetConfig``; the same fields,
    defaults and errors). ``serving/fleet.py``'s ``FleetRouter`` fronts
    ``replicas`` serving engines over one set of weights and routes by
    per-tenant SLO-class affinity, prefix locality (the prefix index and
    the host tier) and load. With ``admit_attainment_floor`` > 0 it sheds
    new requests (REJECTED) only while every replica's SLO attainment sits
    below the floor; with ``slo_alerts.backpressure`` only while a
    burn-rate alert fires. A preempted replica migrates its live decode
    sessions to a peer through the crc-checked manifest; a corrupt payload
    is a counted failure that re-queues the session. ``spread_devices``
    gives each replica of a placement that is on its own window of ranks
    (``placement.device_base = i * per``, JAX's device windows), sharing
    rank 0's window when the ranks run out."""

    enabled: bool = False
    replicas: int = 2
    # "affinity" (SLO-class affinity -> prefix locality -> load; the
    # default), "round_robin", "least_loaded"
    policy: str = "affinity"
    spread_devices: bool = True
    # migrate live sessions on preemption; off = restart them on a peer
    migrate_sessions: bool = True
    # where migration manifests land; "" = a temporary directory a router
    migration_dir: str = ""
    # shed new sessions while EVERY replica's attainment (over >=
    # min_slo_samples verdicts) sits below this floor; 0 = never
    admit_attainment_floor: float = 0.0
    min_slo_samples: int = 8
    # a real SIGTERM handler on the router: a delivery preempts ONE
    # replica, chosen by preempt_policy
    install_sigterm: bool = False
    preempt_policy: str = "most_loaded"   # most_loaded | first
    slo_alerts: SLOAlertsConfig = field(default_factory=SLOAlertsConfig)

    def __post_init__(self):
        if isinstance(self.slo_alerts, dict):
            self.slo_alerts = SLOAlertsConfig.from_dict(self.slo_alerts)
        if int(self.replicas) < 1:
            raise DeepSpeedConfigError(
                f"serving.fleet.replicas must be >= 1, got {self.replicas}"
            )
        if self.policy not in ("affinity", "round_robin", "least_loaded"):
            raise DeepSpeedConfigError(
                "serving.fleet.policy must be one of 'affinity', "
                f"'round_robin', 'least_loaded'; got {self.policy!r}"
            )
        if self.preempt_policy not in ("most_loaded", "first"):
            raise DeepSpeedConfigError(
                "serving.fleet.preempt_policy must be 'most_loaded' or "
                f"'first'; got {self.preempt_policy!r}"
            )
        if not 0.0 <= float(self.admit_attainment_floor) <= 1.0:
            raise DeepSpeedConfigError(
                "serving.fleet.admit_attainment_floor must be in [0, 1], "
                f"got {self.admit_attainment_floor}"
            )
        if int(self.min_slo_samples) < 1:
            raise DeepSpeedConfigError(
                "serving.fleet.min_slo_samples must be >= 1, got "
                f"{self.min_slo_samples}"
            )


@dataclass
class PlacementConfig:
    """``serving.placement``: tensor-parallel and disaggregated program
    placement (JAX ``runtime/config.py`` ``PlacementConfig``; the same
    fields, defaults and errors), over the ranks of the default process
    group (``serving/placement.py``: one rank is one device).

    ``tp`` > 1 shards the paged KV pools (and the int8 scales), the
    attention heads and the MLP over ``tp`` ranks through the committed
    spec table (``serving/placement.py`` ``GPT2_SERVING_RULES``): per-rank
    KV bytes drop ``1/tp``, and greedy streams stay token-identical to the
    single-device engine. ``disaggregate`` splits prefill from decode:
    decode and verify own the main pool on ranks ``[0, decode_tp)``; the
    prefill and chunk programs run on the next ``prefill_tp`` ranks with
    their own ``prefill_num_pages``-page pool, and a finished prompt's KV
    moves to the decode ranks by the gather → send/recv → scatter handoff.
    ``decode_tp`` / ``prefill_tp`` default to ``tp`` (and are read only
    with ``disaggregate``); ``prefill_num_pages`` defaults to ``max_slots``
    prompts twice over plus scratch. ``device_base`` is the first rank of
    the placements' window (a fleet replica's, JAX's first device); one
    rank serving alone ignores it."""

    tp: int = 1
    disaggregate: bool = False
    decode_tp: int = 0       # 0 = tp
    prefill_tp: int = 0      # 0 = tp
    prefill_num_pages: int = 0  # 0 = auto-size from max_slots * prompt pages
    device_base: int = 0

    def __post_init__(self):
        for key in ("tp", "decode_tp", "prefill_tp", "prefill_num_pages", "device_base"):
            if int(getattr(self, key)) < 0:
                raise DeepSpeedConfigError(f"serving.placement.{key} must be >= 0")
        if int(self.tp) < 1:
            raise DeepSpeedConfigError(f"serving.placement.tp must be >= 1, got {self.tp}")

    @property
    def on(self) -> bool:
        """More than one device: tp > 1, or disaggregation."""
        return int(self.tp) > 1 or bool(self.disaggregate)


@dataclass
class ServingConfig:
    """See ``deepspeed_tpu.runtime.config.ServingConfig`` for what each
    field means; the sizing rules are the same: ``num_pages`` pages of
    ``page_size`` tokens (page 0 is scratch), one request reserves
    ``ceil((prompt_len + max_new_tokens) / page_size)`` pages at admission,
    ``max_prompt_len`` fixes the prefill width (rounded up to whole pages)."""

    enabled: bool = False
    max_slots: int = 8
    page_size: int = 16
    num_pages: int = 512
    max_prompt_len: int = 128
    max_new_tokens: int = 64
    max_queue_depth: int = 64
    default_deadline_s: float = 0.0  # 0 = no deadline
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    # "" = the inference engine's dtype
    kv_cache_dtype: str = ""
    drain_deadline_s: float = 5.0
    retry_max: int = 0
    retry_backoff_s: float = 0.05
    # > 0: prompts longer than this prefill in page-rounded chunks of this
    # many tokens, one chunk per scheduler step; prefix-cache tails always
    # take the chunk program (one page wide when this is 0)
    prefill_chunk_tokens: int = 0
    speculative: SpeculativeConfig = field(default_factory=SpeculativeConfig)
    prefix_cache: PrefixCacheConfig = field(default_factory=PrefixCacheConfig)
    slo: SLOConfig = field(default_factory=SLOConfig)
    tiering: TieringConfig = field(default_factory=TieringConfig)
    fleet: FleetConfig = field(default_factory=FleetConfig)
    placement: PlacementConfig = field(default_factory=PlacementConfig)

    def __post_init__(self):
        for key in ("max_slots", "page_size", "num_pages", "max_prompt_len",
                    "max_new_tokens", "max_queue_depth"):
            if int(getattr(self, key)) <= 0:
                raise DeepSpeedConfigError(f"serving.{key} must be positive")
        if self.num_pages < 2:
            raise DeepSpeedConfigError(
                "serving.num_pages must be >= 2 (page 0 is reserved scratch)"
            )
        if int(self.prefill_chunk_tokens) < 0:
            raise DeepSpeedConfigError(
                "serving.prefill_chunk_tokens must be >= 0, got "
                f"{self.prefill_chunk_tokens}"
            )
        if self.kv_cache_dtype not in (
            "", "bfloat16", "float16", "float32", "int8"
        ):
            raise DeepSpeedConfigError(
                "serving.kv_cache_dtype must be one of '', 'bfloat16', "
                f"'float16', 'float32', 'int8'; got {self.kv_cache_dtype!r}"
            )
        if isinstance(self.speculative, dict):
            self.speculative = _section_from_dict(SpeculativeConfig, "speculative",
                                                  self.speculative)
        if isinstance(self.prefix_cache, dict):
            self.prefix_cache = _section_from_dict(PrefixCacheConfig, "prefix_cache",
                                                   self.prefix_cache)
        if isinstance(self.slo, dict):
            self.slo = SLOConfig.from_dict(self.slo)
        if isinstance(self.tiering, dict):
            self.tiering = _section_from_dict(TieringConfig, "tiering", self.tiering)
        if isinstance(self.fleet, dict):
            self.fleet = FleetConfig.from_dict(self.fleet)
        if isinstance(self.placement, dict):
            self.placement = _section_from_dict(PlacementConfig, "placement", self.placement)
        if self.tiering.enabled and not self.prefix_cache.enabled:
            raise DeepSpeedConfigError(
                "serving.tiering requires serving.prefix_cache (demotion "
                "spills prefix-index pages; there is nothing to tier "
                "without the index)"
            )
        if self.speculative.enabled and float(self.temperature) > 0.0:
            raise DeepSpeedConfigError(
                "serving.speculative requires temperature == 0 (greedy): the "
                "verify step accepts drafts by argmax comparison"
            )
        if int(self.retry_max) < 0:
            raise DeepSpeedConfigError(
                f"serving.retry_max must be >= 0, got {self.retry_max}")

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "ServingConfig":
        d = dict(d or {})
        known = {f.name: f for f in fields(cls)}
        unknown = sorted(set(d) - set(known))
        if unknown:
            raise DeepSpeedConfigError(f"serving: unknown config keys {unknown}")
        kwargs = {}
        for key, value in d.items():
            if key in ("speculative", "prefix_cache", "slo", "tiering", "fleet", "placement"):
                kwargs[key] = value  # a section: __post_init__ builds it
            else:
                typ = type(getattr(cls, key))  # every other field is a scalar
                kwargs[key] = typ(value)
        return cls(**kwargs)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _typed_section(cls, name: str, d) -> Any:
    """A section's dataclass from its dict, values coerced to the field
    types; unknown keys raise."""
    if isinstance(d, cls):
        return d
    if not isinstance(d, dict):
        raise DeepSpeedConfigError(f"{name} must be a dict, got {type(d).__name__}")
    known = {f.name: f for f in fields(cls)}
    unknown = sorted(set(d) - set(known))
    if unknown:
        raise DeepSpeedConfigError(f"{name}: unknown config keys {unknown}")
    kwargs = {}
    for key, value in d.items():
        default = known[key].default
        if isinstance(default, bool):
            kwargs[key] = bool(value)
        elif isinstance(default, int) and value is not None:
            kwargs[key] = int(float(value))
        elif isinstance(default, float) and value is not None:
            kwargs[key] = float(value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


@dataclass
class FP16Config:
    """``fp16`` (reference loss-scaler keys); ``loss_scale`` 0 = dynamic."""

    enabled: bool = False
    loss_scale: float = 0.0
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    min_loss_scale: float = 1.0

    @property
    def dynamic_loss_scale(self) -> bool:
        return self.loss_scale == 0.0


@dataclass
class BF16Config:
    enabled: bool = False


@dataclass
class OptimizerConfig:
    type: str = "Adam"
    params: Dict[str, Any] = field(default_factory=dict)


@dataclass
class SchedulerConfig:
    type: Optional[str] = None
    params: Dict[str, Any] = field(default_factory=dict)


@dataclass
class DataTypesConfig:
    grad_accum_dtype: Optional[str] = None  # None | fp32 | fp16 | bf16

    def __post_init__(self):
        if self.grad_accum_dtype not in (None, "fp32", "fp16", "bf16"):
            raise DeepSpeedConfigError(
                "data_types.grad_accum_dtype must be fp32, fp16 or bf16; got "
                f"{self.grad_accum_dtype!r}"
            )


@dataclass
class CheckpointConfig:
    """``checkpoint`` (the reference's checkpoint keys). ``tag_validation``
    (Ignore | Warn | Fail) checks that every process saves under the same
    tag: with one process there is nothing to compare. ``load_universal``,
    ``use_node_local_storage``, ``parallel_write`` and ``async_save`` are
    accepted as the JAX package accepts them; the non-resilient path writes
    synchronously (the resilient path's ``resilience.async_checkpoint`` is
    the asynchronous one)."""

    tag_validation: str = "Warn"
    load_universal: bool = False
    use_node_local_storage: bool = False
    parallel_write: Dict[str, Any] = field(default_factory=dict)
    async_save: bool = False

    def __post_init__(self):
        if str(self.tag_validation).lower() not in ("ignore", "warn", "fail"):
            raise DeepSpeedConfigError(
                "checkpoint.tag_validation must be Ignore, Warn or Fail; got "
                f"{self.tag_validation!r}"
            )


@dataclass
class FaultInjectionConfig:
    """``resilience.fault_injection`` (``resilience/faults.py``): seeded
    deterministic faults. ``nan_loss_steps`` / ``sigterm_steps`` index the
    engine's ``train_batch`` calls (1-based, monotonic: NOT
    ``global_steps``, which a rollback rewinds), ``crash_saves`` a
    writer's saves (1-based), ``stall_requests`` the serving admissions
    (1-based). ``probability`` adds a chaos mode: each (site, index) fires
    with probability p, from a stable hash of (seed, site, index)."""

    enabled: bool = False
    seed: int = 0
    nan_loss_steps: List[int] = field(default_factory=list)
    sigterm_steps: List[int] = field(default_factory=list)
    crash_saves: List[int] = field(default_factory=list)
    stall_requests: List[int] = field(default_factory=list)
    probability: float = 0.0

    def __post_init__(self):
        if not 0.0 <= self.probability <= 1.0:
            raise DeepSpeedConfigError(
                "resilience.fault_injection.probability must be in [0, 1], "
                f"got {self.probability}"
            )


@dataclass
class ResilienceConfig:
    """``resilience``: the fault-tolerance plane (``resilience/``). On,
    the engine's checkpoints use the integrity-checked manifest format
    (per-array crc32 and a config fingerprint, ``<tag>.tmp`` → fsync →
    rename → atomic ``latest``; the JAX package's format, byte for byte)
    and ``load_checkpoint`` walks back across corrupt and torn tags.
    ``async_checkpoint`` moves the disk write to a background thread (the
    step path pays the device-to-host snapshot). ``snapshot_every``: the
    cadence of the last-clean-state host snapshot (0 = off) that the
    watchdog's ``rollback`` policy restores, bounded by ``max_rollbacks``
    (snapshots are taken only under that policy). ``grace_window_s``: the
    PreemptionGuard's budget for flushing an in-flight async save.
    ``fault_injection``: see :class:`FaultInjectionConfig`."""

    enabled: bool = False
    async_checkpoint: bool = True
    snapshot_every: int = 1
    max_rollbacks: int = 8
    grace_window_s: float = 30.0
    fault_injection: FaultInjectionConfig = field(default_factory=FaultInjectionConfig)

    def __post_init__(self):
        if isinstance(self.fault_injection, dict):
            self.fault_injection = _typed_section(
                FaultInjectionConfig, "resilience.fault_injection", self.fault_injection)
        if self.snapshot_every < 0:
            raise DeepSpeedConfigError(
                f"resilience.snapshot_every must be >= 0, got {self.snapshot_every}")
        if self.max_rollbacks < 0:
            raise DeepSpeedConfigError(
                f"resilience.max_rollbacks must be >= 0, got {self.max_rollbacks}")
        if self.grace_window_s < 0:
            raise DeepSpeedConfigError(
                f"resilience.grace_window_s must be >= 0, got {self.grace_window_s}")


@dataclass
class ZeroConfig:
    """``zero_optimization`` (JAX ``ZeroConfig``, the reference's
    zero/config.py): the same fields and defaults. ``stage`` 0-3 over the
    ``dp`` axis; ``stage3_param_persistence_threshold`` sets stage 3's
    parameter threshold (``max(2, value)`` elements, as the JAX engine
    builds its policy); ``stage3_gather_16bit_weights_on_model_save``
    makes ``save_checkpoint`` export ``pytorch_model.npz``. The bucket,
    overlap and prefetch keys tune the reference's hand-rolled NCCL
    pipeline and are accepted as the JAX package accepts them.
    ``offload_param`` / ``offload_optimizer`` with a device raise
    :class:`NotPortedError` (ROADMAP queue 1 item 13)."""

    stage: int = 0
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = 500_000_000
    allgather_partitions: bool = True
    allgather_bucket_size: int = 500_000_000
    overlap_comm: bool = True
    offload_param: Optional[Dict[str, Any]] = None
    offload_optimizer: Optional[Dict[str, Any]] = None
    sub_group_size: int = 1_000_000_000
    stage3_max_live_parameters: int = 1_000_000_000
    stage3_max_reuse_distance: int = 1_000_000_000
    stage3_prefetch_bucket_size: int = 50_000_000
    stage3_param_persistence_threshold: int = 100_000
    stage3_gather_16bit_weights_on_model_save: bool = False
    zero_hpz_partition_size: int = 1
    round_robin_gradients: bool = False
    ignore_unused_parameters: bool = True
    legacy_stage1: bool = False
    cpu_offload: Optional[bool] = None  # deprecated alias of offload_optimizer cpu

    def __post_init__(self):
        if not 0 <= int(self.stage) <= 3:
            raise DeepSpeedConfigError(f"zero_optimization.stage must be 0-3, got {self.stage}")
        offload = {"offload_param": self.offload_param,
                   "offload_optimizer": self.offload_optimizer}
        if self.cpu_offload:
            offload["cpu_offload"] = {"device": "cpu"}
        for key, v in offload.items():
            if v and str(v.get("device", "none")) not in ("none", "None"):
                raise NotPortedError(
                    f"zero_optimization.{key}={v!r}: ZeRO-Offload / Infinity is not ported to "
                    "deepspeed_tpu_torch yet (ROADMAP queue 1 item 13)")
        if int(self.zero_hpz_partition_size) > 1:
            raise NotPortedError(
                "zero_optimization.zero_hpz_partition_size > 1 (a secondary partition) is not "
                "ported to deepspeed_tpu_torch yet (ROADMAP queue 1 item 12)")


@dataclass
class MeshConfig:
    """``mesh``: named-axis sizes, -1 = the ranks left (JAX ``MeshConfig``).
    dp, sp and tp may exceed 1 in the port; pp and ep > 1 raise
    :class:`NotPortedError` (ROADMAP queue 1 items 12b and 12d)."""

    dp: int = -1
    tp: int = 1
    pp: int = 1
    ep: int = 1
    sp: int = 1

    def __post_init__(self):
        for axis, item in (("pp", "12b"), ("ep", "12d")):
            if int(getattr(self, axis)) > 1:
                raise NotPortedError(
                    f"mesh.{axis}={getattr(self, axis)}: only the dp, sp and tp axes are "
                    f"ported to deepspeed_tpu_torch (ROADMAP queue 1 item {item})")


@dataclass
class ActivationCheckpointingConfig:
    """``activation_checkpointing`` (JAX ``ActivationCheckpointingConfig``,
    the reference's ``activation_checkpointing/config.py``), read and
    typed. The engine hands ``partition_activations`` and
    ``cpu_checkpointing`` to the model (``ModuleSpec.checkpointing``):
    GPT-2 turns on its config's fields of the same names, and a model
    without the hook refuses either option on. (The JAX engine hands them
    to a process-global policy that only its ``checkpoint_wrapper`` reads;
    its GPT-2 reads only its own fields.) The other four fields are read
    and kept, as JAX keeps them."""

    partition_activations: bool = False
    contiguous_memory_optimization: bool = False
    cpu_checkpointing: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False


@dataclass
class CommsLoggerConfig:
    enabled: bool = False
    verbose: bool = False
    prof_all: bool = True
    debug: bool = False
    prof_ops: List[str] = field(default_factory=list)


# top-level sections of the JAX document that the training path reads
_TRAINING_KEYS = (
    "train_batch_size", "train_micro_batch_size_per_gpu", "gradient_accumulation_steps",
    "steps_per_print", "optimizer", "scheduler", "fp16", "bf16", "zero_optimization",
    "data_types", "gradient_clipping", "prescale_gradients", "gradient_predivide_factor",
    "sparse_attention", "telemetry", "wall_clock_breakdown", "memory_breakdown",
    "resilience", "checkpoint", "mesh", "comms_logger", "activation_checkpointing",
)
# sections still refused, each with the ROADMAP queue 1 item that ports it
_REFUSED_ITEMS = {
    "comm_compression": "12/13", "aio": "13",
    "flops_profiler": "14", "elasticity": "14", "curriculum_learning": "14",
    "progressive_layer_drop": "14", "eigenvalue": "14", "debug": "14", "analysis": "15",
}
# the monitor backends (JAX monitor/): ROADMAP queue 1 item 14
_MONITOR_KEYS = ("tensorboard", "wandb", "csv_monitor")


@dataclass
class SparseAttentionConfig:
    """``sparse_attention``: the block-sparsity pattern a model config
    builds its ``SparsityConfig`` from (``mode`` selects the pattern; the
    other keys are its constructor's)."""

    mode: str = "fixed"
    block: int = 16
    different_layout_per_head: bool = False
    num_local_blocks: int = 4
    num_global_blocks: int = 1
    attention: str = "bidirectional"
    horizontal_global_attention: bool = False
    num_different_global_patterns: int = 1
    # None = the mode's own default (bigbird 1, variable 0), resolved by
    # ops.sparse_attention.from_ds_config
    num_random_blocks: Optional[int] = None
    num_sliding_window_blocks: int = 3
    local_window_blocks: List[int] = field(default_factory=lambda: [4])
    global_block_indices: List[int] = field(default_factory=lambda: [0])
    global_block_end_indices: Optional[List[int]] = None


def _is_off(value) -> bool:
    """A section left at a value that turns nothing on: empty, false, zero,
    ``{"enabled": false, ...}``, or a dict of such values."""
    if value is None or value is False or value == 0 or value == "" or value == []:
        return True
    if isinstance(value, dict):
        if "enabled" in value:
            return not value["enabled"]
        return all(_is_off(v) for v in value.values())
    return False


@dataclass
class DeepSpeedConfig:
    """The training subset of the JAX package's ``DeepSpeedConfig``
    (``deepspeed_tpu/runtime/config.py:1441``) for one device."""

    train_batch_size: Optional[int] = None
    train_micro_batch_size_per_gpu: Optional[int] = None
    gradient_accumulation_steps: Optional[int] = None
    steps_per_print: int = 10
    optimizer: Optional[OptimizerConfig] = None
    scheduler: Optional[SchedulerConfig] = None
    fp16: FP16Config = field(default_factory=FP16Config)
    bf16: BF16Config = field(default_factory=BF16Config)
    data_types: DataTypesConfig = field(default_factory=DataTypesConfig)
    gradient_clipping: float = 0.0
    prescale_gradients: bool = False
    gradient_predivide_factor: float = 1.0
    sparse_attention: Optional[SparseAttentionConfig] = None
    telemetry: Optional["TelemetryConfig"] = None
    wall_clock_breakdown: bool = False
    memory_breakdown: bool = False
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    zero_optimization: ZeroConfig = field(default_factory=ZeroConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    comms_logger: CommsLoggerConfig = field(default_factory=CommsLoggerConfig)
    activation_checkpointing: ActivationCheckpointingConfig = field(
        default_factory=ActivationCheckpointingConfig)
    _user_batch: Optional[tuple] = None
    _dp_world_size: int = 1

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DeepSpeedConfig":
        d = dict(d or {})
        for key in sorted(set(d) - set(_TRAINING_KEYS)):
            if key in _MONITOR_KEYS and not _is_off(d[key]):
                raise NotPortedError(
                    f"config section {key!r}={d[key]!r}: the monitor backends are not "
                    "ported to deepspeed_tpu_torch yet (ROADMAP queue 1 item 14)"
                )
            if not _is_off(d[key]):
                item = _REFUSED_ITEMS.get(key)
                raise NotPortedError(
                    f"config section {key!r}={d[key]!r} is not ported to deepspeed_tpu_torch "
                    "yet (" + (f"ROADMAP queue 1 item {item}" if item else
                               "ROADMAP queue 1 names the item that ports each section") + ")"
                )
        cfg = cls(
            train_batch_size=d.get("train_batch_size"),
            train_micro_batch_size_per_gpu=d.get("train_micro_batch_size_per_gpu"),
            gradient_accumulation_steps=d.get("gradient_accumulation_steps"),
            steps_per_print=int(d.get("steps_per_print", 10)),
            optimizer=(None if d.get("optimizer") is None
                       else _typed_section(OptimizerConfig, "optimizer", d["optimizer"])),
            scheduler=(None if d.get("scheduler") is None
                       else _typed_section(SchedulerConfig, "scheduler", d["scheduler"])),
            fp16=_typed_section(FP16Config, "fp16", d.get("fp16") or {}),
            bf16=_typed_section(BF16Config, "bf16", d.get("bf16") or {}),
            data_types=_typed_section(DataTypesConfig, "data_types", d.get("data_types") or {}),
            gradient_clipping=float(d.get("gradient_clipping", 0.0) or 0.0),
            prescale_gradients=bool(d.get("prescale_gradients", False)),
            gradient_predivide_factor=float(d.get("gradient_predivide_factor", 1.0)),
            sparse_attention=(None if d.get("sparse_attention") is None
                              else _typed_section(SparseAttentionConfig, "sparse_attention",
                                                  d["sparse_attention"])),
            telemetry=(None if d.get("telemetry") is None
                       else TelemetryConfig.from_dict(d["telemetry"])),
            wall_clock_breakdown=bool(d.get("wall_clock_breakdown", False)),
            memory_breakdown=bool(d.get("memory_breakdown", False)),
            resilience=_typed_section(ResilienceConfig, "resilience",
                                      d.get("resilience") or {}),
            checkpoint=_typed_section(CheckpointConfig, "checkpoint",
                                      d.get("checkpoint") or {}),
            zero_optimization=_typed_section(ZeroConfig, "zero_optimization",
                                             d.get("zero_optimization") or {}),
            mesh=_typed_section(MeshConfig, "mesh", d.get("mesh") or {}),
            comms_logger=_typed_section(CommsLoggerConfig, "comms_logger",
                                        d.get("comms_logger") or {}),
            activation_checkpointing=_typed_section(
                ActivationCheckpointingConfig, "activation_checkpointing",
                d.get("activation_checkpointing") or {}),
        )
        if cfg.fp16.enabled and cfg.bf16.enabled:
            raise DeepSpeedConfigError("fp16 and bf16 cannot both be enabled")
        return cfg

    @staticmethod
    def load(config: Any, dp_world_size: Optional[int] = 1) -> "DeepSpeedConfig":
        """A dict, a JSON string, a path to a JSON file or a config →
        the config, with the batch triple finalized for ``dp_world_size``
        ranks (None: not yet; the engine finalizes against its mesh)."""
        if isinstance(config, DeepSpeedConfig):
            cfg = config
        elif isinstance(config, dict):
            cfg = DeepSpeedConfig.from_dict(config)
        elif isinstance(config, str):
            if config.strip().startswith("{"):
                cfg = DeepSpeedConfig.from_dict(json.loads(config))
            else:
                with open(config) as fh:
                    cfg = DeepSpeedConfig.from_dict(json.load(fh))
        else:
            raise DeepSpeedConfigError(f"unsupported config type {type(config)}")
        if dp_world_size is not None:
            cfg.finalize(dp_world_size)
        return cfg

    def finalize(self, dp_world_size: int = 1) -> None:
        """Derive and validate the batch triple train_batch_size = micro *
        gas * dp (reference ``_configure_train_batch_size``); idempotent
        across dp sizes: the triple the user wrote is kept once and
        re-derived from."""
        dp = self._dp_world_size = max(1, int(dp_world_size))
        if self._user_batch is None:
            self._user_batch = (self.train_batch_size, self.train_micro_batch_size_per_gpu,
                                self.gradient_accumulation_steps)
        tb, mb, gas = (None if x is None else int(x) for x in self._user_batch)
        if tb is not None and mb is not None and gas is not None:
            if tb != mb * gas * dp:
                raise DeepSpeedConfigError(
                    f"train_batch_size {tb} != micro_batch {mb} * gas {gas} * dp {dp}"
                )
        elif tb is not None and mb is not None:
            if tb % (mb * dp):
                raise DeepSpeedConfigError(
                    f"train_batch_size {tb} not divisible by micro_batch {mb} * dp {dp}"
                )
            gas = tb // (mb * dp)
        elif tb is not None and gas is not None:
            if tb % (gas * dp):
                raise DeepSpeedConfigError(
                    f"train_batch_size {tb} not divisible by gas {gas} * dp {dp}")
            mb = tb // (gas * dp)
        elif mb is not None:
            gas = gas or 1
            tb = mb * gas * dp
        elif tb is not None:
            gas = 1
            if tb % dp:
                raise DeepSpeedConfigError(f"train_batch_size {tb} not divisible by dp {dp}")
            mb = tb // dp
        else:
            raise DeepSpeedConfigError(
                "one of train_batch_size / train_micro_batch_size_per_gpu must be set"
            )
        self.train_batch_size, self.train_micro_batch_size_per_gpu = tb, mb
        self.gradient_accumulation_steps = gas

    @property
    def compute_dtype(self):
        import torch

        if self.fp16.enabled:
            return torch.float16
        if self.bf16.enabled:
            return torch.bfloat16
        return torch.float32
