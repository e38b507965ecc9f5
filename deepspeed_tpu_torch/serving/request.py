"""Serving request lifecycle: QUEUED → RUNNING → FINISHED/TRUNCATED, or
REJECTED at the door / TIMED_OUT while still queued / PREEMPTED by a drain /
FAILED when admission could not reserve its pages or a transient slot
failure spent its retries (counterpart of
``deepspeed_tpu/serving/request.py``, with its SLO, tenancy, retry and
fleet fields).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np


class RequestStatus:
    QUEUED = "queued"
    RUNNING = "running"
    FINISHED = "finished"       # emitted max_new_tokens or hit EOS
    TRUNCATED = "truncated"     # deadline passed mid-decode, or the ask was clamped
    TIMED_OUT = "timed_out"     # deadline passed before ever reaching a slot
    REJECTED = "rejected"       # backpressure: queue full / can never fit
    PREEMPTED = "preempted"     # graceful drain evicted it
    FAILED = "failed"           # no pages at admission, or retries spent

    TERMINAL = (FINISHED, TRUNCATED, TIMED_OUT, REJECTED, PREEMPTED, FAILED)


_ids = itertools.count()


@dataclass
class Request:
    """One generation request. ``prompt`` is a 1-D int array of token ids."""

    prompt: np.ndarray
    max_new_tokens: int
    seed: int = 0
    eos_token_id: Optional[int] = None
    # relative deadline (seconds from submit); None → serving config default
    deadline_s: Optional[float] = None
    # original ask when admission clamped max_new_tokens; None = not clamped
    requested_new_tokens: Optional[int] = None

    # -- SLO / tenancy --------------------------------------------------
    # tenant is a free-form accounting dimension (per-tenant counters and
    # trace records); slo_class names a ``serving.slo.classes`` entry (the
    # scheduler resolves unknown/empty to the configured default)
    tenant: str = "default"
    slo_class: str = ""
    # -- fleet ----------------------------------------------------------
    # the replica serving this request: stamped by the FleetRouter when it
    # routes and again when a session migrates or restarts on a peer ("" =
    # no fleet); the terminal trace record carries it (--by replica)
    replica: str = ""

    # -- resilience -----------------------------------------------------
    # transient-failure retries consumed (the scheduler's retry with backoff)
    retries: int = 0
    # earliest re-admission time after a backoff (the scheduler's clock)
    not_before: float = 0.0
    # fault injection: fail this slot transiently once it has emitted this
    # many tokens (None = healthy); set by the scheduler at admission
    stall_after: Optional[int] = None

    # -- prefix cache ---------------------------------------------------
    # prompt tokens served from shared prefix-index pages at admission
    # (0 = cold); the tail past this point was prefilled
    prefix_shared_tokens: int = 0
    # a full-prefix hit forked the last prompt page copy-on-write
    cow_forked: bool = False

    # -- filled by the scheduler ---------------------------------------
    id: int = field(default_factory=lambda: next(_ids))
    status: str = RequestStatus.QUEUED
    tokens: List[int] = field(default_factory=list)
    detail: str = ""            # why rejected/truncated
    t_submit: float = 0.0
    t_admit: Optional[float] = None   # queue wait ends: slot assigned
    t_requeue: Optional[float] = None  # a retry's re-queue
    t_first_token: Optional[float] = None
    t_finish: Optional[float] = None
    # one timestamp per emitted token (parallel to ``tokens``): a verify
    # step emits its accepted run at one instant, so entries repeat, as a
    # streaming client sees them; the TPOT histogram observes their gaps
    t_emissions: List[float] = field(default_factory=list)
    # top-1 minus top-2 logit of each emitted token's step, when the engine
    # records them (ServingEngine(track_margins=True)): how close each
    # greedy choice was to a tie
    margins: List[float] = field(default_factory=list)
    # the speculative drafter's incremental n-gram index over prompt +
    # tokens (owned by ServingEngine._draft; None = not built yet)
    draft_state: Optional[Any] = field(default=None, repr=False, compare=False)
    _prompt_list: Optional[List[int]] = field(default=None, repr=False, compare=False)

    @property
    def prompt_list(self) -> List[int]:
        """The prompt as a plain list, converted once: the drafter reads
        prompt + tokens every step."""
        if self._prompt_list is None:
            self._prompt_list = np.asarray(self.prompt, np.int64).tolist()
        return self._prompt_list

    @property
    def prompt_len(self) -> int:
        return int(np.asarray(self.prompt).shape[-1])

    @property
    def done(self) -> bool:
        return self.status in RequestStatus.TERMINAL

    @property
    def output(self) -> np.ndarray:
        """prompt + generated tokens."""
        return np.concatenate(
            [np.asarray(self.prompt, np.int32).reshape(-1),
             np.asarray(self.tokens, np.int32)]
        )

    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit

    @property
    def queue_wait_s(self) -> Optional[float]:
        """Enqueue → slot assignment; None while queued or rejected at the
        door."""
        if self.t_admit is None:
            return None
        return self.t_admit - (self.t_requeue if self.t_requeue is not None else self.t_submit)

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean time per output token after the first (decode cadence)."""
        if self.t_finish is None or self.t_first_token is None or len(self.tokens) < 2:
            return None
        return (self.t_finish - self.t_first_token) / (len(self.tokens) - 1)

    @property
    def inter_token_gaps_s(self) -> List[float]:
        """Per-token arrival deltas from the emission timestamps (tokens a
        verify step emitted together have gap 0): what
        ``serving_tpot_seconds`` observes."""
        from ..telemetry.request_trace import inter_token_gaps

        return inter_token_gaps(self.t_emissions)
