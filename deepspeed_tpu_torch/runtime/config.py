"""Config: the ``serving`` section and the training subset of the document.

Counterpart of ``deepspeed_tpu/runtime/config.py``. ``ServingConfig``: the
same fields, defaults and validation for the continuous-batching path
(paged KV pool, admission control, deadlines, drain), its int8 KV pages
(``kv_cache_dtype="int8"``), its three hot-path features: speculative
decode (``speculative``), shared-prefix KV reuse (``prefix_cache``) and
chunked prefill (``prefill_chunk_tokens``), and its SLO classes
(``slo``). The sections of the features that have not been ported yet
(tensor parallelism, the host tier, the fleet, retries) are accepted only
at their off values: turning one on raises :class:`NotPortedError`
instead of being silently ignored.

``TelemetryConfig``: the ``telemetry`` section of ``init_inference``'s and
``initialize``'s configs (the same fields, defaults and errors as the JAX
package's), with
its watchdog, request-trace, kv-heat and time-series sections.
``telemetry.introspection.enabled`` and ``watchdog.policy="rollback"``
raise :class:`NotPortedError`. ``SLOAlertsConfig`` is the fleet's
burn-rate section, used standalone by ``telemetry.slo_budget`` while the
fleet is not ported.

``DeepSpeedConfig``: the single-device training subset (the batch triple,
``fp16``/``bf16``, ``gradient_clipping``, ``optimizer``, ``scheduler``,
``prescale_gradients``/``gradient_predivide_factor``,
``data_types.grad_accum_dtype``, ``zero_optimization.stage == 0``,
``steps_per_print``, ``wall_clock_breakdown``, ``memory_breakdown``, the
``telemetry`` section, and the typed ``sparse_attention`` section that a
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


# section -> the keys that switch its feature on, each with its off test.
# Every other key of such a section sizes the feature and is harmless while
# the feature is off.
_UNPORTED_SECTIONS: Dict[str, Dict[str, Any]] = {
    "placement": {
        "tp": lambda v: int(v) <= 1,
        "decode_tp": lambda v: int(v) <= 1,
        "prefill_tp": lambda v: int(v) <= 1,
        "disaggregate": lambda v: not v,
        "device_base": lambda v: int(v) == 0,
    },
    "tiering": {"enabled": lambda v: not v},
    "fleet": {"enabled": lambda v: not v},
}


def _not_ported(what: str) -> NotPortedError:
    return NotPortedError(
        f"serving.{what} is not ported to deepspeed_tpu_torch yet (the "
        "default continuous-batching path is); use deepspeed_tpu for it"
    )


def _check_unported_section(name: str, value) -> None:
    if value is None:
        return
    if not isinstance(value, dict):
        raise DeepSpeedConfigError(
            f"serving.{name} must be a dict, got {type(value).__name__}"
        )
    for key, is_off in _UNPORTED_SECTIONS[name].items():
        if key in value and not is_off(value[key]):
            raise _not_ported(f"{name}.{key}={value[key]!r}")


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
    ``policy``: ``continue`` or ``kill``; ``rollback`` raises
    :class:`NotPortedError` (ROADMAP queue 1 item 8). ``nan_check``: the
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
        if self.enabled and self.policy == "rollback":
            raise NotPortedError(
                "telemetry.watchdog.policy='rollback' is not ported to "
                "deepspeed_tpu_torch yet: it restores the resilience snapshots "
                "(ROADMAP queue 1 item 8)"
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
    promotes to firing. The fleet (``serving.fleet``) is not ported, so
    ``backpressure`` has nothing to drive here; the section builds a
    standalone ``SLOBudgetEngine``."""

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
        if self.speculative.enabled and float(self.temperature) > 0.0:
            raise DeepSpeedConfigError(
                "serving.speculative requires temperature == 0 (greedy): the "
                "verify step accepts drafts by argmax comparison"
            )
        if int(self.retry_max) > 0:
            raise _not_ported(f"retry_max={self.retry_max}")

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "ServingConfig":
        d = dict(d or {})
        for name in _UNPORTED_SECTIONS:
            _check_unported_section(name, d.pop(name, None))
        known = {f.name: f for f in fields(cls)}
        unknown = sorted(set(d) - set(known))
        if unknown:
            raise DeepSpeedConfigError(f"serving: unknown config keys {unknown}")
        kwargs = {}
        for key, value in d.items():
            if key in ("speculative", "prefix_cache", "slo"):
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


# zero_optimization keys that turn on something not ported; the others tune
# ZeRO's collectives, which stage 0 does not run
_ZERO_OFF = {
    "stage": lambda v: int(v) == 0,
    "offload_param": lambda v: not v or str(v.get("device", "none")) in ("none", "None"),
    "offload_optimizer": lambda v: not v or str(v.get("device", "none")) in ("none", "None"),
}
# top-level sections of the JAX document that the training path reads
_TRAINING_KEYS = (
    "train_batch_size", "train_micro_batch_size_per_gpu", "gradient_accumulation_steps",
    "steps_per_print", "optimizer", "scheduler", "fp16", "bf16", "zero_optimization",
    "data_types", "gradient_clipping", "prescale_gradients", "gradient_predivide_factor",
    "sparse_attention", "telemetry", "wall_clock_breakdown", "memory_breakdown",
)
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
    _user_batch: Optional[tuple] = None

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DeepSpeedConfig":
        d = dict(d or {})
        for key in sorted(set(d) - set(_TRAINING_KEYS)):
            if key in _MONITOR_KEYS and not _is_off(d[key]):
                raise NotPortedError(
                    f"config section {key!r}={d[key]!r}: the monitor backends are not "
                    "ported to deepspeed_tpu_torch yet (ROADMAP queue 1 item 14)"
                )
            if key == "mesh" and all(int(d[key].get(a, 1)) <= 1 for a in ("tp", "pp", "ep", "sp")) \
                    and int(d[key].get("dp", -1)) in (-1, 1):
                continue  # one device is the mesh the port runs
            if not _is_off(d[key]):
                raise NotPortedError(
                    f"config section {key!r}={d[key]!r} is not ported to deepspeed_tpu_torch "
                    "yet (its training path is the single-device subset; ROADMAP queue 1 "
                    "names the item that ports each section)"
                )
        zero = d.get("zero_optimization") or {}
        for key, is_off in _ZERO_OFF.items():
            if key in zero and not is_off(zero[key]):
                raise NotPortedError(
                    f"zero_optimization.{key}={zero[key]!r} is not ported to "
                    "deepspeed_tpu_torch yet: ZeRO stages 1-3 and offload need comm/ on "
                    "NCCL (ROADMAP queue 1 item 10)"
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
        )
        if cfg.fp16.enabled and cfg.bf16.enabled:
            raise DeepSpeedConfigError("fp16 and bf16 cannot both be enabled")
        return cfg

    @staticmethod
    def load(config: Any) -> "DeepSpeedConfig":
        """A dict, a JSON string, a path to a JSON file or a config →
        the config, with the batch triple finalized for one device."""
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
        cfg.finalize(1)
        return cfg

    def finalize(self, dp_world_size: int = 1) -> None:
        """Derive and validate the batch triple train_batch_size = micro *
        gas * dp (reference ``_configure_train_batch_size``); idempotent."""
        if int(dp_world_size) != 1:
            raise NotPortedError(
                f"data-parallel world size {dp_world_size}: deepspeed_tpu_torch trains on "
                "one device (ROADMAP queue 1 item 10)"
            )
        if self._user_batch is None:
            self._user_batch = (self.train_batch_size, self.train_micro_batch_size_per_gpu,
                                self.gradient_accumulation_steps)
        tb, mb, gas = (None if x is None else int(x) for x in self._user_batch)
        if tb is not None and mb is not None and gas is not None:
            if tb != mb * gas:
                raise DeepSpeedConfigError(
                    f"train_batch_size {tb} != micro_batch {mb} * gas {gas} * dp 1"
                )
        elif tb is not None and mb is not None:
            if tb % mb:
                raise DeepSpeedConfigError(
                    f"train_batch_size {tb} not divisible by micro_batch {mb} * dp 1"
                )
            gas = tb // mb
        elif tb is not None and gas is not None:
            if tb % gas:
                raise DeepSpeedConfigError(f"train_batch_size {tb} not divisible by gas {gas} * dp 1")
            mb = tb // gas
        elif mb is not None:
            gas = gas or 1
            tb = mb * gas
        elif tb is not None:
            gas, mb = 1, tb
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
