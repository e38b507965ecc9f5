"""Serving request lifecycle: QUEUED → RUNNING → FINISHED/TRUNCATED, or
REJECTED at the door / TIMED_OUT while still queued / PREEMPTED by a drain
(counterpart of ``deepspeed_tpu/serving/request.py``, without the SLO,
tenancy, retry, prefix-cache and fleet fields of the features not ported).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


class RequestStatus:
    QUEUED = "queued"
    RUNNING = "running"
    FINISHED = "finished"       # emitted max_new_tokens or hit EOS
    TRUNCATED = "truncated"     # deadline passed mid-decode, or the ask was clamped
    TIMED_OUT = "timed_out"     # deadline passed before ever reaching a slot
    REJECTED = "rejected"       # backpressure: queue full / can never fit
    PREEMPTED = "preempted"     # graceful drain evicted it

    TERMINAL = (FINISHED, TRUNCATED, TIMED_OUT, REJECTED, PREEMPTED)


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

    # -- filled by the scheduler ---------------------------------------
    id: int = field(default_factory=lambda: next(_ids))
    status: str = RequestStatus.QUEUED
    tokens: List[int] = field(default_factory=list)
    detail: str = ""            # why rejected/truncated
    t_submit: float = 0.0
    t_first_token: Optional[float] = None
    t_finish: Optional[float] = None
    # top-1 minus top-2 logit of each emitted token's step, when the engine
    # records them (ServingEngine(track_margins=True)): how close each
    # greedy choice was to a tie
    margins: List[float] = field(default_factory=list)

    @property
    def prompt_len(self) -> int:
        return int(np.asarray(self.prompt).shape[-1])

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
    def tpot_s(self) -> Optional[float]:
        """Mean time per output token after the first (decode cadence)."""
        if self.t_finish is None or self.t_first_token is None or len(self.tokens) < 2:
            return None
        return (self.t_finish - self.t_first_token) / (len(self.tokens) - 1)
