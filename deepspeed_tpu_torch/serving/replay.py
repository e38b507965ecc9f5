"""Trace-replay workload harness: seeded serving load (counterpart of
``deepspeed_tpu/serving/replay.py``; the same items for the same spec, byte
for byte).

A synthetic trace with three production-shaped properties that a steady
Poisson sweep cannot express:

- **bursty / diurnal arrivals**: a base Poisson process whose rate is
  modulated by a sinusoid (the "diurnal" cycle, compressed to seconds) plus
  optional square-wave bursts, so queue-wait tails and SLO misses happen at
  the offered load where the mean says they should not;
- **heavy-tailed prompt lengths**: lognormal, clipped to the engine's
  prompt budget — most prompts short, the p99 near ``max_prompt_len``;
- **hot-tenant prefix skew**: tenants drawn Zipf-style, each sharing a
  per-tenant system-prompt prefix across its requests, so the prefix
  cache's hit rate under replay follows the traffic.

Everything derives from ONE ``numpy.random.RandomState(seed)``: the same
seed yields the identical arrival schedule, prompts, tenants and SLO
classes, so two engine configurations can be compared on the same offered
trace. The items stay numpy on the host; a prompt becomes a tensor only
inside ``submit``.

Replay drives a live :class:`~deepspeed_tpu_torch.serving.scheduler.ServingEngine`
through its injectable clock. Two modes:

- **virtual** (:class:`ReplayClock`): time advances ``step_dt`` per
  scheduler step — deterministic, wall-clock-free; the same seed gives
  identical per-request trace records;
- **realtime** (the engine's own ``time.monotonic``): arrivals are offset
  from the replay start.

Scoring reads the emitted request trace
(:func:`deepspeed_tpu_torch.telemetry.request_trace.score_requests`), so
the harness measures what the observability plane recorded.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from .request import Request


@dataclass
class ReplayItem:
    """One request of a generated workload: what to submit, and when."""

    t_arrival: float
    prompt: np.ndarray
    max_new_tokens: int
    seed: int
    tenant: str
    slo_class: str

    def key(self) -> tuple:
        """Hashable identity for determinism comparisons."""
        return (
            round(self.t_arrival, 9), self.prompt.tobytes(),
            self.max_new_tokens, self.seed, self.tenant, self.slo_class,
        )


@dataclass
class WorkloadSpec:
    """Knobs of :func:`generate_workload` (JAX's defaults)."""

    n_requests: int = 64
    seed: int = 0
    vocab_size: int = 256
    max_prompt_len: int = 12
    max_new_tokens: int = 8
    # arrivals: Poisson base rate modulated by a sinusoidal "diurnal" cycle
    # and an optional square-wave burst window
    base_interarrival_s: float = 0.05
    diurnal_amplitude: float = 0.5   # 0 = flat Poisson; rate *= 1 + a*sin
    diurnal_period_s: float = 2.0
    burst_factor: float = 3.0        # rate multiplier inside a burst window
    burst_duty: float = 0.2          # fraction of each period spent bursting
    # prompt lengths: lognormal (heavy tail), clipped to [1, max_prompt_len]
    prompt_len_median: float = 4.0
    prompt_len_sigma: float = 0.6
    # tenants: Zipf-ranked popularity; each tenant owns a shared prefix of
    # prefix_fraction * its prompt (0 disables the skew)
    n_tenants: int = 4
    tenant_zipf_s: float = 1.2
    prefix_fraction: float = 0.5
    # SLO classes, assigned per tenant round-robin (tenant rank i →
    # classes[i % len]); [] = no classes on the submitted requests
    slo_classes: List[str] = field(default_factory=list)


def _rate_multiplier(spec: WorkloadSpec, t: float) -> float:
    m = 1.0 + spec.diurnal_amplitude * math.sin(
        2.0 * math.pi * t / max(spec.diurnal_period_s, 1e-9)
    )
    phase = (t % max(spec.diurnal_period_s, 1e-9)) / max(spec.diurnal_period_s, 1e-9)
    if phase < spec.burst_duty:
        m *= spec.burst_factor
    return max(m, 1e-3)


def generate_workload(spec: WorkloadSpec) -> List[ReplayItem]:
    """The seeded trace: ``spec.n_requests`` items in arrival order. The
    same spec (seed included) gives byte-identical items, in this package
    and in the JAX one: the draws are the same calls on one RandomState."""
    rs = np.random.RandomState(spec.seed)
    # per-tenant shared prefix pools (the "system prompt" each tenant's
    # requests open with)
    prefix_pool = [
        rs.randint(0, spec.vocab_size, (spec.max_prompt_len,)).astype(np.int32)
        for _ in range(max(1, spec.n_tenants))
    ]
    # Zipf popularity over tenant ranks (explicit normalization: numpy's
    # rs.zipf is unbounded and its tail would alias tenants)
    ranks = np.arange(1, max(1, spec.n_tenants) + 1, dtype=np.float64)
    pop = ranks ** (-float(spec.tenant_zipf_s))
    pop /= pop.sum()
    items: List[ReplayItem] = []
    t = 0.0
    for i in range(int(spec.n_requests)):
        # thinned Poisson: exponential gap at the base rate, shrunk by the
        # current diurnal/burst multiplier
        gap = rs.exponential(spec.base_interarrival_s)
        t += gap / _rate_multiplier(spec, t)
        tenant_i = int(rs.choice(len(pop), p=pop))
        plen = int(np.clip(
            round(rs.lognormal(math.log(max(spec.prompt_len_median, 1.0)),
                               spec.prompt_len_sigma)),
            1, spec.max_prompt_len,
        ))
        n_prefix = int(min(plen - 1, math.floor(plen * spec.prefix_fraction)))
        prompt = np.empty((plen,), np.int32)
        if n_prefix > 0:
            prompt[:n_prefix] = prefix_pool[tenant_i][:n_prefix]
        prompt[n_prefix:] = rs.randint(0, spec.vocab_size, (plen - n_prefix,))
        slo_class = (
            spec.slo_classes[tenant_i % len(spec.slo_classes)]
            if spec.slo_classes else ""
        )
        items.append(ReplayItem(
            t_arrival=t,
            prompt=prompt,
            max_new_tokens=int(spec.max_new_tokens),
            seed=i,
            tenant=f"tenant-{tenant_i}",
            slo_class=slo_class,
        ))
    return items


class ReplayClock:
    """Injectable virtual clock: reads return the current virtual time;
    :func:`replay` advances it explicitly, so no wall clock leaks into a
    replay's timestamps."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


def replay(
    srv,
    items: Sequence[ReplayItem],
    step_dt: float = 0.0,
    max_steps: Optional[int] = None,
    on_step: Optional[Callable[[int], None]] = None,
) -> Dict[str, Any]:
    """Drive ``srv`` through the workload: submit every item whose arrival
    time has passed, step the scheduler, repeat until drained.

    With a :class:`ReplayClock` installed on the engine, ``step_dt`` > 0
    advances virtual time per scheduler step (deterministic mode); idle
    gaps fast-forward to the next arrival instead of spinning. With a real
    clock, pacing is wall-clock. Returns ``{"requests", "steps",
    "duration_s"}``; scoring belongs to
    :func:`~deepspeed_tpu_torch.telemetry.request_trace.score_requests`
    over the emitted trace."""
    virtual = isinstance(srv.clock, ReplayClock)
    items = sorted(items, key=lambda it: it.t_arrival)
    t_start = srv.clock()
    submitted: List[Request] = []
    i = 0
    steps = 0
    # generous default budget: every request's full decode plus prefill
    # chunks plus the arrival span — overrunning it is a harness bug
    if max_steps is None:
        per_req = max(it.max_new_tokens for it in items) if items else 1
        chunks = (
            -(-srv.prefill_width // srv.chunk_width) if srv.chunk_width else 1
        )
        max_steps = 4 * len(items) * (per_req + chunks) + 1024
    while True:
        now = srv.clock() - t_start
        while i < len(items) and items[i].t_arrival <= now:
            it = items[i]
            submitted.append(srv.submit(
                it.prompt, max_new_tokens=it.max_new_tokens, seed=it.seed,
                tenant=it.tenant, slo_class=it.slo_class,
            ))
            i += 1
        active = any(s.request is not None for s in srv.slots)
        idle = not srv.queue and not active
        if idle and i >= len(items):
            break
        if idle:
            # nothing in flight: jump (virtual) or sleep (realtime) to the
            # next arrival instead of burning no-op scheduler steps against
            # the max_steps budget
            if virtual:
                srv.clock.t = t_start + items[i].t_arrival
            else:
                time.sleep(max(0.0, items[i].t_arrival - now))
            continue
        if (
            not active and srv.queue
            and all(r.not_before > srv.clock() for r in srv.queue)
        ):
            # every queued request is sitting out its retry backoff and no
            # slot can drain meanwhile: with step_dt=0 a frozen virtual
            # clock would livelock here, and a realtime replay would burn
            # no-op steps; jump (virtual) or sleep (realtime) to the
            # earliest wake-up (or the next arrival, whichever comes first)
            target = min(r.not_before for r in srv.queue)
            if i < len(items):
                target = min(target, t_start + items[i].t_arrival)
            if virtual:
                srv.clock.t = max(srv.clock.t, target)
            else:
                time.sleep(max(0.0, target - srv.clock()))
        srv.step()
        steps += 1
        if on_step is not None:
            on_step(steps)
        if virtual and step_dt > 0.0:
            srv.clock.advance(step_dt)
        if steps > max_steps:
            raise RuntimeError(
                f"replay: no drain within {max_steps} steps "
                f"(submitted {i}/{len(items)}, queue={len(srv.queue)})"
            )
    # serving is done here (every slot drained): duration_s is the serving
    # span; making the trace durable below is bookkeeping
    duration = srv.clock() - t_start
    if srv.tracer is not None:
        srv.tracer.flush()
    return {
        "requests": submitted,
        "steps": steps,
        "duration_s": duration,
    }
