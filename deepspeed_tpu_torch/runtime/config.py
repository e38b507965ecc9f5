"""The ``serving`` config section, for the features this package serves.

Counterpart of ``deepspeed_tpu/runtime/config.py`` ``ServingConfig``: the
same fields, defaults and validation for the continuous-batching path
(paged KV pool, admission control, deadlines, drain) and its three
hot-path features: speculative decode (``speculative``), shared-prefix KV
reuse (``prefix_cache``) and chunked prefill (``prefill_chunk_tokens``).
The sections of the features that have not been ported yet (int8 pages,
tensor parallelism, the host tier, the fleet, SLO classes, retries) are
accepted only at their off values: turning one on raises
:class:`NotPortedError` instead of being silently ignored.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Any, Dict, Optional


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
    "slo": {"classes": lambda v: not v},
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
        if self.speculative.enabled and float(self.temperature) > 0.0:
            raise DeepSpeedConfigError(
                "serving.speculative requires temperature == 0 (greedy): the "
                "verify step accepts drafts by argmax comparison"
            )
        if self.kv_cache_dtype == "int8":
            raise _not_ported("kv_cache_dtype='int8'")
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
            if key in ("speculative", "prefix_cache"):
                kwargs[key] = value  # a section: __post_init__ builds it
            else:
                typ = type(getattr(cls, key))  # every other field is a scalar
                kwargs[key] = typ(value)
        return cls(**kwargs)
