"""Continuous-batching scheduler: slot-based decode over the paged KV pool
(counterpart of ``deepspeed_tpu/serving/scheduler.py``).

A fixed array of ``max_slots`` decode slots advances one token per step
through ONE batched decode step, while finished sequences vacate their slot
mid-flight and queued requests are admitted into free slots by a prefill
insertion. Inactive slots ride along in the decode batch pointed at the
scratch page; every op is row-independent, so active slots are unaffected.

int8 KV pages (``serving.kv_cache_dtype = "int8"``) halve the pool's
bytes: the pools hold codes and ``ProgramSet.scales`` their per-(page, kv
head) scales, which every program reads and writes beside the pages and
which follow their pages through prefix sharing and copy-on-write (a scale
row is indexed by page id like the page itself).

Three hot-path features, each off by default and each keeping the greedy
token streams:

- **Speculative decode** (``serving.speculative``): the scheduler drafts
  ``k`` tokens per slot host-side (prompt lookup over prompt + output) and
  one verify step replaces the decode step, scoring all ``k + 1`` positions
  and accepting the longest matching prefix. Rejected drafts' K/V is
  overwritten before anything attends it. Greedy only.
- **Shared-prefix KV reuse** (``serving.prefix_cache``): full prompt pages
  are indexed after prefill; a later prompt maps its matching page-aligned
  prefix (refcounted pages) and prefills only the tail through the chunk
  program. A full-prefix hit recomputes the last page into a private page
  (copy-on-write); the shared original is never written.
- **Chunked prefill** (``serving.prefill_chunk_tokens``): long prompts
  prefill in page-aligned chunks, one chunk per scheduler step, so a long
  prompt does not stall the co-resident decode slots for its whole width.

The programs are the JAX engine's fixed, config-derived set
(``deepspeed_tpu/serving/scheduler.py:1-12``, ``:651-664``): one prefill,
ONE decode-shaped program (the verify step REPLACES the decode step when
speculation is on) and the chunk program when chunking or the prefix cache
needs it, built once in :meth:`ServingEngine._build_programs` and listed in
``executables`` (``expected_executables`` is JAX's formula over the ported
features). Each is a ``utils.graphs.CapturedProgram``: a captured CUDA
graph on the card over static device buffers (tokens, sequence lengths,
block tables ``[max_slots, pages_per_slot]``, verify tokens ``[max_slots,
spec_k + 1]``, keys ``[max_slots, 2]``; the prefill's and the chunk's own
inputs), refilled each step by one copy from pinned host memory and
replayed; on the CPU the same programs run their step functions. The
decode (or verify) program's staging arrays are the :class:`SlotTable`'s.
``track_margins`` and the sampling settings are fixed per engine; the
chunk program always samples (the final chunk's token is the request's
first, an earlier chunk's is discarded), as the JAX program does.

Sampling (``serving.temperature > 0``) draws what the JAX scheduler draws
for the same request seed: the prefill (or the final prefill chunk) samples
with ``PRNGKey(seed)``, and decode step t with ``split(fold_in(PRNGKey(seed),
1), max_new_tokens - 1)[t - 1]``, the key sequence of ``generate`` for the
request, computed on the host at admission (``ops/prng.py``). A slot's
key sits in ``SlotTable.keys`` beside its last token.

Robustness: admission control (queue depth, KV-page budget) rejects at the
door; per-request deadlines evict mid-flight to a TRUNCATED response; an
over-long ask is clamped at submit; :meth:`drain` stops admission, finishes
in-flight work up to a deadline and preempts the rest. A transient slot
failure (the fault injector's ``serving_stall``) or a failed reservation
frees the slot and its pages and re-queues the request with exponential
backoff (``serving.retry_max`` times, from ``serving.retry_backoff_s``;
generation restarts from scratch) before it fails terminally. A stuck
request can never wedge the batch.

The host KV tier (``serving.tiering``, ``serving/tiering.py``): a
prefix-index leaf evicted as the last reference to its page is demoted to
pinned host memory; at admission the prompt's chain is walked and every
host-held link restored into a fresh page by the ``serving_kv_restore``
program (a width-1 scatter into the pools, k/v and the int8 scales) and
re-adopted by the index, so the lookup right after maps it as a plain hit;
a crc mismatch or a broken chain stops the walk and the rest recomputes.
When the pool's free list drops under an eighth of its pages, cold leaves
are demoted ahead of the admissions that would need them.

Live session migration, for the fleet (``serving/fleet.py``; JAX
scheduler.py:2236-2490): :meth:`export_session` packs a decoding slot's
whole ``pages_per_slot``-wide page row, k and v (and the int8 scales), with
the request and slot state; :meth:`release_slot` frees the slot without
terminal accounting; :meth:`adopt_session` rebuilds the session in a free
slot of another engine and decoding resumes where it stopped;
:meth:`takeover_queue` / :meth:`adopt_request` move queued requests. The
transport is two captured programs built on first use over one pair of
static row buffers (``serving_kv_gather`` fills them from the pools,
``serving_kv_scatter`` writes them into the pools; pad entries address
the scratch page), kept out of ``executables`` as the JAX engine keeps its
migration programs out of its set.

Telemetry, as the JAX engine's: ``self.metrics`` is the owning engine's
registry (``init_inference(config={"telemetry": ...})``) or a private one,
carrying every serving instrument under JAX's family names; the request
tracer, the KV heat tracer and the metrics journal come from the plane or
from the constructor's arguments, and the plane's watchdog flags
stragglers. ``submit`` takes a ``tenant`` and an ``slo_class``
(``serving.slo``): every terminal request is judged against its class's
targets for attainment and goodput. Every hook is host-side: it records
values the scheduler already holds on the host (the token read is still
the step's one device read), the decode-step events stay columnar, and
wall times come from ``self.clock`` after that read. :meth:`stats`
reports the JAX engine's numbers: TTFT/TPOT/decode-step/queue-wait
quantiles interpolated over the histograms' ``LATENCY_BUCKETS``
(:func:`exact_percentiles` gives exact ones over a set of requests).

Placements (``serving.placement``, ``serving/placement.py``, whose
docstring sets out the process model): with ``tp > 1`` every program runs
head-parallel over ``tp`` ranks of the default process group (the
``_tp{n}`` program names, ``serving_tp_collective_bytes`` per program as
JAX computes it); with ``disaggregate`` the prefill and chunk programs run
on a prefill placement with its own pool and allocator, and a finished
prompt's KV moves to the decode placement by the ``serving_kv_gather`` /
``serving_kv_scatter`` handoff pair (``_complete_handoff``; the
``serving_kv_handoff*`` families, the ``kv_handoff`` span). Every rank
runs this scheduler; a program runs on its placement's ranks, and what the
host reads from it reaches the other ranks by one broadcast. At tp 1
without disaggregation none of this exists: no process group, no
collective, the same programs and launches.

Single-threaded by design: ``submit``/``step``/``drain``/``stats`` mutate
the queue, slots and counters without a lock and must run on one thread
(and, across placements, be called on every rank in the same order).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..comm import torch as comm
from ..models.gpt2 import GPT2Config
from ..ops import prng
from ..runtime.config import NotPortedError, ServingConfig
from ..telemetry import device_hbm_stats
from ..telemetry.registry import MetricsRegistry
from ..telemetry.request_trace import LATENCY_BUCKETS
from ..utils.graphs import CapturedProgram, StaticInputs
from ..utils.logging import log_dist
from . import model as smodel
from .kv_cache import (
    PageAllocatorError,
    PrefixCache,
    SlotTable,
    pages_for,
    pool_bytes,
    scales_bytes,
)
from .placement import Placement, ProgramSet
from .request import Request, RequestStatus
from .tiering import HostPageStore, KVTieringEngine

_CACHE_DTYPES = {
    "bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32,
    "int8": torch.int8,
}


def exact_percentiles(requests, qs=(50, 95, 99)) -> dict:
    """Exact TTFT and TPOT percentiles (``np.percentile``, linear) over
    ``requests`` (each request's TTFT and its mean TPOT, requests without
    one left out): {"ttft": {"count", "p50_s", ...}, "tpot": {...}}. The
    engine's :meth:`ServingEngine.stats` interpolates over histogram
    buckets instead, as the JAX engine does, so a printout that wants the
    precise number takes this one."""
    out = {}
    for name, vals in (("ttft", [r.ttft_s for r in requests]),
                       ("tpot", [r.tpot_s for r in requests])):
        vals = [v for v in vals if v is not None]
        entry = {"count": len(vals)}
        for q in qs:
            entry[f"p{q}_s"] = float(np.percentile(vals, q)) if vals else None
        out[name] = entry
    return out


@dataclass
class _Slot:
    request: Optional[Request] = None
    pages: List[int] = field(default_factory=list)  # full row: shared + private
    pos: int = 0    # tokens currently in this slot's cache
    step: int = 0   # decode (or verify) steps completed
    # the decode steps' keys (temperature > 0): [max_new_tokens - 1, 2]
    keys: Optional[np.ndarray] = None
    # True while the prompt prefills chunk by chunk; the main table row then
    # stays scratch (the batched decode must not touch this slot's real,
    # possibly shared, pages) and ``row`` carries the real block table
    prefilling: bool = False
    prefill_pos: int = 0               # prompt tokens prefilled so far
    row: Optional[np.ndarray] = None   # [1, pages_per_slot] real block table
    # disaggregated placements: the prompt's pages in the PREFILL pool
    # (shared + private), freed by the handoff into ``pages``; and the
    # first token, read at the prefill, that the handoff is waiting to emit
    prefill_pages: List[int] = field(default_factory=list)
    pending_tok: Optional[int] = None


def _top2_margin(logits: torch.Tensor) -> np.ndarray:
    top2 = torch.topk(logits.float(), 2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).cpu().numpy()


class _AgreedClock:
    """The serving ranks' one clock: rank 0's reading, broadcast over the
    host group (gloo on host memory, so the card is not synchronised for
    it) at every call. Only the scheduler's decisions read it, at points
    that every rank reaches in the same order (the scheduler is SPMD, and
    what steers it is checked equal on every rank at construction), so
    every decision that reads the time is the same on every rank.

    :meth:`local` is this rank's own reading moved onto rank 0's by the
    offset of the last agreed reading, with no collective: what only the
    telemetry records (the request tracer, the journal, the watchdog's
    straggler scan) reads it, so a plane attached on some ranks only
    changes no rank's sequence of collectives. :meth:`last` is the last
    agreed reading itself, the same on every rank with no collective: the
    heat ledger stamps its page events with it (they happen between
    decisions, and their times order the tier's victims)."""

    def __init__(self, clock, group):
        self.clock = clock
        self.group = group
        self.root = dist.get_rank() == 0
        self.offset = 0.0
        self.agreed = None

    def __call__(self) -> float:
        mine = self.clock()
        t = torch.tensor([mine if self.root else 0.0], dtype=torch.float64)
        comm.broadcast(t, self.group, 0)
        self.agreed = float(t.item())
        self.offset = self.agreed - mine
        return self.agreed

    def last(self) -> float:
        return self() if self.agreed is None else self.agreed

    def local(self) -> float:
        return self.clock() + self.offset


class ServingEngine:
    """Continuous-batching front end over an
    :class:`~deepspeed_tpu_torch.inference.engine.InferenceEngine`.

    Construct via ``InferenceEngine.serve()`` (or directly); drive with
    :meth:`submit` + :meth:`step`, or :meth:`run` to drain. ``clock`` is
    injectable for deterministic timeout tests. ``track_margins`` records,
    for every emitted token, the top-1 minus top-2 logit of its step in
    ``Request.margins`` (one extra top-2 reduction and device read per
    step).

    ``tracer``, ``heat_tracer`` and ``journal`` (a
    :class:`~deepspeed_tpu_torch.telemetry.request_trace.RequestTracer`, a
    :class:`~deepspeed_tpu_torch.telemetry.kv_heat.KVHeatTracer`, a
    :class:`~deepspeed_tpu_torch.telemetry.timeseries.MetricsJournal`)
    win over the owning engine's telemetry plane; with neither, that plane
    is off and each hook costs one None check."""

    def __init__(self, engine, config=None, clock=time.monotonic,
                 track_margins: bool = False, tracer=None, heat_tracer=None,
                 journal=None, fault_injector=None):
        if config is None:
            config = ServingConfig()
        elif isinstance(config, dict):
            config = ServingConfig.from_dict(config)
        self.config = config
        self.clock = clock
        self.track_margins = bool(track_margins)
        telemetry = getattr(engine, "telemetry", None)
        self.tracer = (tracer if tracer is not None
                       else getattr(telemetry, "request_tracer", None))
        mcfg = engine.model_config
        if not isinstance(mcfg, GPT2Config):
            raise ValueError(
                "ServingEngine serves the gpt2 family (GPT2Config models); "
                f"got {type(mcfg).__name__}"
            )
        self.model_config = mcfg

        page = int(config.page_size)
        self.page_size = page
        # static prefill width: max_prompt_len rounded up to whole pages
        self.prefill_pages = pages_for(config.max_prompt_len, page)
        self.prefill_width = self.prefill_pages * page
        self.max_total_len = min(
            int(config.max_prompt_len) + int(config.max_new_tokens),
            int(mcfg.n_positions),
        )
        if self.prefill_width > mcfg.n_positions:
            raise ValueError(
                f"serving.max_prompt_len (page-rounded to {self.prefill_width}) "
                f"exceeds the model's n_positions={mcfg.n_positions}"
            )
        self.pages_per_slot = pages_for(self.max_total_len, page)
        self.cache_dtype = (
            _CACHE_DTYPES[config.kv_cache_dtype] if config.kv_cache_dtype
            else engine.dtype
        )
        self.max_slots = int(config.max_slots)
        self.device = engine.device
        self.engine_dtype = engine.dtype
        self._init_placements(engine, config)
        if self.pages_per_slot > self.allocator.capacity:
            raise ValueError(
                f"serving.num_pages={config.num_pages} cannot hold even one "
                f"max-size request ({self.pages_per_slot} pages of {page} "
                "tokens; page 0 is scratch)"
            )
        if self.disaggregated and self.prefill_pages > self.prefill_set.allocator.capacity:
            raise ValueError(
                f"serving.placement.prefill_num_pages={self.prefill_set.num_pages} "
                f"cannot hold one max-size prompt ({self.prefill_pages} pages)"
            )
        self.slots: List[_Slot] = [_Slot() for _ in range(self.max_slots)]
        self.queue: Deque[Request] = deque()
        self.completed: List[Request] = []
        self._sampling = float(config.temperature) > 0.0
        self._draining = False
        # the resilience plane: an injector from the caller or the engine
        # (serving_stall), the admission ordinal it indexes, and whether a
        # retried request may be waiting out its backoff
        self.fault_injector = (fault_injector if fault_injector is not None
                               else getattr(engine, "fault_injector", None))
        self._admissions = 0
        self._backoff_pending = False

        spec = config.speculative
        self.spec_enabled = bool(spec.enabled)
        self.spec_k = int(spec.k) if self.spec_enabled else 0
        self.spec_ngram = int(spec.ngram) if self.spec_enabled else 2
        if self.spec_enabled and self._sampling:
            raise ValueError("serving.speculative requires temperature == 0 (greedy)")
        # the prefix index lives beside the pool the prefill WRITES: under
        # disaggregation the prefill placement's (decode-side pages are
        # always private copies)
        pcfg = config.prefix_cache
        self.prefix_cache: Optional[PrefixCache] = (
            PrefixCache(self.prefill_set.allocator, page, max_pages=int(pcfg.max_pages))
            if pcfg.enabled else None
        )
        # the host tier for cold prefix pages (JAX scheduler.py:346-385):
        # evicted leaves spill to pinned host buffers, and a later prompt
        # re-hitting the chain restores them through serving_kv_restore
        tcfg = config.tiering
        self.tiering_enabled = bool(tcfg.enabled and self.prefix_cache is not None)
        self.tiering: Optional[KVTieringEngine] = None
        if self.tiering_enabled:
            # on the prefill placement's pool (the index's); each rank's
            # store holds its own KV heads of a page (none on a rank
            # outside the placement, whose store keeps the bookkeeping)
            pset = self.prefill_set
            budget = int(tcfg.host_budget_pages) or pset.allocator.capacity
            store = HostPageStore(
                budget, n_layer=mcfg.n_layer, n_kv_head=int(pset.k_pool.shape[2]),
                page_size=page, head_dim=mcfg.head_dim, dtype=self.cache_dtype,
                quantized=pset.scales is not None, crc=bool(tcfg.crc),
                pin=self.device.type == "cuda")
            self.tiering = KVTieringEngine(store, pset, policy=str(tcfg.policy),
                                           prefetch_depth=int(tcfg.prefetch_depth),
                                           clock=self.clock)
            self.prefix_cache.demote_sink = self.tiering
            self.prefix_cache.victim_order = self.tiering.select_leaf
            self.tiering.device_resident = self.prefix_cache._entries.__contains__
        cw = int(config.prefill_chunk_tokens)
        self._chunk_cold = cw > 0  # chunk long cold prompts too
        if cw > 0:
            self.chunk_width = pages_for(cw, page) * page
        elif self.prefix_cache is not None:
            self.chunk_width = page  # prefix-hit tails run through the chunk program
        else:
            self.chunk_width = 0
        self.chunk_width = min(self.chunk_width, self.prefill_width)
        self._build_programs()

        # SLO classes and per-tenant accounting: class -> [met, evaluated];
        # tenant -> its counts. The terminal-status counts are this
        # engine's own (a plane shared by two engines mixes its counters)
        self._slo = config.slo
        self._slo_enabled = bool(self._slo.classes)
        self._slo_counts: dict = {}
        self.tenants: dict = {}
        self._slo_good_tokens = 0
        self._status_counts: dict = {}
        self._step_count = 0
        self._decode_tokens = 0  # tokens the decode / verify steps emitted
        self._t_first_submit: Optional[float] = None
        self._t_last_finish: Optional[float] = None
        quantized = self.pset.scales is not None
        self.kv_pool_bytes = pool_bytes(
            mcfg.n_layer, int(config.num_pages), mcfg.n_head, page, mcfg.head_dim,
            self._itemsize,
        )
        self.kv_scales_bytes = (
            scales_bytes(mcfg.n_layer, int(config.num_pages), mcfg.n_head)
            if quantized else 0
        )
        self._check_steering(heat_tracer if heat_tracer is not None
                             else getattr(telemetry, "kv_heat_tracer", None))
        self._init_metrics(telemetry, heat_tracer, journal)
        log_dist(
            f"ServingEngine: slots={self.max_slots} page={page} "
            f"pages={config.num_pages} (pool {self.kv_pool_bytes / 1e6:.1f} MB"
            + (f" + {self.kv_scales_bytes / 1e6:.2f} MB scales" if quantized else "")
            + ") "
            f"prefill_width={self.prefill_width} chunk_width={self.chunk_width} "
            f"spec_k={self.spec_k} prefix_cache={self.prefix_cache is not None} "
            f"dtype={str(self.cache_dtype).replace('torch.', '')} device={self.device}"
            + (f" placement={self.decode_placement!r}" if self._spmd else "")
            + (f" disaggregated(prefill={self.prefill_placement!r}, "
               f"prefill_pages={self.prefill_set.num_pages})" if self.disaggregated else "")
        )

    def _init_placements(self, engine, config) -> None:
        """The placements and their program sets (JAX scheduler.py:224-303):
        one shared placement by default; with ``disaggregate`` a decode
        placement on ranks ``[0, decode_tp)`` and a prefill placement on the
        next ``prefill_tp``, with its own auto-sized pool and allocator. A
        placement of more than one rank needs the default process group
        (``comm.init_distributed``); then the engine's clock becomes rank
        0's, and every call on it is collective. Otherwise this process
        serves alone, as rank 0 of its placement, whatever its rank in a
        process group of its own job: no collective at all."""
        mcfg, page = self.model_config, self.page_size
        plc = config.placement
        tp = int(plc.tp)
        self.tp = tp
        self.disaggregated = bool(plc.disaggregate)
        decode_tp = prefill_tp = tp
        if self.disaggregated:
            decode_tp = int(plc.decode_tp) or tp
            prefill_tp = int(plc.prefill_tp) or tp
        if max(decode_tp, prefill_tp) > 1 and getattr(engine, "quantized", False):
            raise ValueError(
                "serving.placement.tp > 1 requires unquantized weights (the "
                "rank-major QKV permute operates on the plain tree); int8 KV "
                "pages (serving.kv_cache_dtype) shard fine"
            )
        n = decode_tp + (prefill_tp if self.disaggregated else 0)
        want = (f"serving.placement needs {n} devices, one rank each (decode_tp={decode_tp}"
                + (f" + prefill_tp={prefill_tp}" if self.disaggregated else "") + ")")
        # more than one rank: every rank of the default group runs this
        # scheduler (SPMD); a rank past the placements mirrors the host side
        self._spmd = n > 1
        # the host reads outputs that some rank did not compute: broadcast
        self._bcast = False
        # the serving ranks' host-side agreement (the clock, the outputs the
        # host reads, the checks): the default group when it is gloo, else a
        # gloo group of the same ranks, so that none of it syncs the card
        self._host_group = None
        self._trace_clock = self.clock  # what only the telemetry records reads
        self._ledger_clock = self.clock  # the heat ledger's page-event stamps
        rank = 0
        if self._spmd:
            if not dist.is_initialized():
                raise ValueError(f"{want}, and no process group is initialised "
                                 "(comm.init_distributed)")
            world = dist.get_world_size()
            if n > world:
                raise ValueError(f"{want}, only {world} visible (the ranks of the default "
                                 "process group)")
            rank = dist.get_rank()
            self._bcast = self.disaggregated or n < world
            d_group = comm.subgroup(range(decode_tp), "tp") if decode_tp > 1 else None
            p_group = None
            if self.disaggregated and prefill_tp > 1:
                p_group = comm.subgroup(range(decode_tp, n), "tp")
            if dist.get_backend() != "gloo":
                self._host_group = comm.subgroup(range(world), "host", backend="gloo")
            self.clock = _AgreedClock(self.clock, self._host_group)
            self._trace_clock = self.clock.local
            self._ledger_clock = self.clock.last
            names = [None] * world
            dist.all_gather_object(names, str(self.device), group=self._host_group)
            self._rank_devices = names
        else:
            d_group = p_group = None
            self._rank_devices = [str(self.device)]
        self.decode_placement = Placement(
            "decode" if self.disaggregated else "shared", range(decode_tp), decode_tp,
            d_group, self.device, rank=rank)
        self.decode_placement.local_model_config(mcfg)  # fail fast on divisibility
        self.decode_set = ProgramSet(self.decode_placement, mcfg, int(config.num_pages), page,
                                     self.cache_dtype, engine.params)
        self.pset = self.decode_set
        if self.disaggregated:
            # the prefill pool only ever holds PROMPT pages: auto-size it to
            # max_slots prompts twice over plus scratch
            pnp = int(plc.prefill_num_pages)
            if pnp <= 0:
                pnp = min(int(config.num_pages), 2 * self.max_slots * self.prefill_pages + 1)
            self.prefill_placement = Placement("prefill", range(decode_tp, n), prefill_tp,
                                               p_group, self.device, rank=rank)
            self.prefill_placement.local_model_config(mcfg)
            self.prefill_set = ProgramSet(self.prefill_placement, mcfg, pnp, page,
                                          self.cache_dtype, engine.params)
        else:
            self.prefill_placement = self.decode_placement
            self.prefill_set = self.decode_set
        self._itemsize = torch.empty((), dtype=self.cache_dtype).element_size()

    # ------------------------------------------------------------------
    # telemetry: the JAX engine's instruments, tracers and journal
    # ------------------------------------------------------------------
    def _init_metrics(self, telemetry, heat_tracer, journal) -> None:
        """Declare the serving instruments in the plane's registry (or a
        private one), under the JAX engine's family names and help strings,
        and attach the plane's watchdog, heat tracer and journal."""
        self.metrics: MetricsRegistry = (
            telemetry.registry if telemetry is not None else MetricsRegistry())
        m = self.metrics
        self._h_ttft = m.histogram(
            "serving_ttft_seconds", "submit → first token", buckets=LATENCY_BUCKETS)
        self._h_tpot = m.histogram(
            "serving_tpot_seconds",
            "inter-token emission latency, streaming-client view (one "
            "observation per gap; a speculative accepted run lands at one "
            "instant, so its intra-run gaps are 0)",
            buckets=LATENCY_BUCKETS,
        )
        self._h_qwait = m.histogram(
            "serving_queue_wait_seconds", "submit → slot admission",
            buckets=LATENCY_BUCKETS)
        self._h_step = m.histogram(
            "serving_decode_step_seconds", "one batched decode step",
            buckets=LATENCY_BUCKETS)
        self._c_requests = m.counter(
            "serving_requests_total", "requests by terminal status", labelnames=("status",))
        self._c_tokens = m.counter("serving_tokens_total", "generated tokens")
        self._c_prefills = m.counter("serving_prefills_total", "prefill insertions")
        self._c_steps = m.counter("serving_decode_steps_total", "batched decode steps")
        self._c_timeouts = m.counter(
            "serving_timeout_evictions_total", "requests evicted mid-flight by deadline")
        self._g_queue = m.gauge("serving_queue_depth", "waiting requests")
        self._g_util = m.gauge("serving_slot_utilization", "active slots / max_slots")
        self._g_pages = m.gauge("serving_kv_pages_in_use", "allocated KV pages")
        self._g_occ = m.gauge("serving_kv_page_occupancy", "allocated / allocatable KV pages")
        self._g_quant = m.gauge(
            "serving_latency_quantile_seconds",
            "TTFT/TPOT/decode-step quantiles estimated from the histograms",
            labelnames=("metric", "q"),
        )
        self._c_stragglers = m.counter(
            "serving_stragglers_total",
            "requests flagged resident in a slot far beyond their decode budget",
        )
        self._c_drained = m.counter(
            "serving_drained_requests_total",
            "requests preempted by a graceful drain (queued + in-flight)",
        )
        self._c_retries = m.counter(
            "serving_retried_requests_total",
            "transient slot failures re-enqueued with backoff",
        )
        self._h_accept = m.histogram(
            "serving_spec_accept_length",
            "tokens emitted per slot per speculative verify step "
            "(1 = no draft accepted, k+1 = full accept)",
            buckets=tuple(float(i) for i in range(1, max(2, self.spec_k) + 2)),
        )
        self._c_spec_steps = m.counter(
            "serving_spec_steps_total", "batched speculative verify steps")
        self._c_spec_drafted = m.counter(
            "serving_spec_drafted_total", "draft tokens proposed (host-side)")
        self._c_spec_accepted = m.counter(
            "serving_spec_accepted_total", "draft tokens accepted by verify")
        self._c_prefix_hits = m.counter(
            "serving_prefix_hits_total", "prefix-cache admission lookups by outcome",
            labelnames=("kind",),  # full | partial | miss
        )
        self._g_prefix_rate = m.gauge(
            "serving_prefix_hit_rate", "lookups that mapped >= 1 shared page")
        self._c_pages_reused = m.counter(
            "serving_prefix_pages_reused_total",
            "KV pages mapped from the prefix index instead of prefilled",
        )
        self._g_pages_shared = m.gauge(
            "serving_kv_pages_shared", "in-use pages with refcount > 1")
        self._c_cow = m.counter(
            "serving_kv_cow_forks_total",
            "shared pages forked copy-on-write at a full-prefix hit",
        )
        self._c_chunks = m.counter(
            "serving_chunk_prefills_total", "chunk-prefill program invocations")
        self._g_index_pages = m.gauge(
            "serving_prefix_index_pages", "pages held live by the prefix index")
        self._g_slo = m.gauge(
            "serving_slo_attainment", "SLO-met / SLO-evaluated terminal requests per class",
            labelnames=("slo_class",),
        )
        self._g_goodput = m.gauge(
            "serving_goodput_tokens_per_sec",
            "tokens from SLO-met requests per second — over the trailing "
            "serving.slo.goodput_window_s window when set, else over the "
            "whole span since first submit",
        )
        # the monotone per-class counters a burn-rate engine windows over
        self._c_slo_eval = m.counter(
            "serving_slo_evaluated_total", "SLO-evaluated terminal requests per class",
            labelnames=("slo_class",),
        )
        self._c_slo_met = m.counter(
            "serving_slo_met_total", "SLO-met terminal requests per class",
            labelnames=("slo_class",),
        )
        self._c_good_tokens = m.counter(
            "serving_slo_good_tokens_total",
            "tokens generated by SLO-met requests (windowed goodput source)",
        )
        self._goodput_window_s = float(self._slo.goodput_window_s or 0.0)
        # without a journal: (t, tokens) of each SLO-met completion,
        # trimmed to the window on read
        self._good_events: Deque[tuple] = deque()
        self._c_tenant_requests = m.counter(
            "serving_tenant_requests_total",
            "terminal requests by tenant and status (tenant cardinality is "
            "the caller's responsibility)",
            labelnames=("tenant", "status"),
        )
        self._c_tenant_tokens = m.counter(
            "serving_tenant_tokens_total", "generated tokens by tenant",
            labelnames=("tenant",),
        )
        self._g_tp_coll = m.gauge(
            "serving_tp_collective_bytes",
            "per-invocation all-reduce payload of a TP-sharded serving "
            "program (2 psums/layer over the [batch, width, n_embd] partial "
            "products; 0 = program not TP-sharded)",
            labelnames=("program",),
        )
        self._set_collective_gauges()
        self._c_handoffs = m.counter(
            "serving_kv_handoffs_total",
            "prefill→decode KV page handoffs (disaggregated placements)")
        self._c_handoff_bytes = m.counter(
            "serving_kv_handoff_bytes_total",
            "logical KV bytes moved prefill→decode by page handoffs")
        self._h_handoff = m.histogram(
            "serving_kv_handoff_seconds",
            "one gather → device_put → scatter KV handoff, dispatch to installed",
            buckets=LATENCY_BUCKETS)
        # the plane's watchdog flags stragglers on the decode-step EMA
        self.watchdog = telemetry.watchdog if telemetry is not None else None
        self._ema_step_s = 0.0
        self._heat = None            # the KVHeatTracer
        self._heat_decode = None     # the decode (or shared) pool's ledger
        self._heat_prefill = None    # the prefill pool's (the decode one when shared)
        ht = (heat_tracer if heat_tracer is not None
              else getattr(telemetry, "kv_heat_tracer", None))
        if ht is not None:
            self.attach_heat(ht)
        self._journal = None
        mj = (journal if journal is not None
              else getattr(telemetry, "metrics_journal", None))
        if mj is not None:
            self.attach_journal(mj)

    def _check_steering(self, heat_tracer) -> None:
        """Under placements, raise before anything is attached unless what
        steers the host scheduler is the same on every rank: the heat
        tracer (the host tier's victim keys read its ledger) and the fault
        injector's schedule. Ranks that decide differently would part ways
        in their collectives. The rest of the telemetry plane only records,
        and may differ (a request tracer on rank 0 alone, say)."""
        if not self._spmd:
            return
        fi = self.fault_injector
        mine = {"heat tracer": heat_tracer is not None,
                "fault injector": None if fi is None else (
                    fi.seed, fi.probability, sorted(fi._sched["serving_stall"]))}
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, mine, group=self._host_group)
        for key in mine:
            if any(g[key] != got[0][key] for g in got):
                raise ValueError(
                    f"serving.placement: the {key} differs across the serving ranks "
                    f"({[g[key] for g in got]}); it steers the scheduler that every "
                    "rank runs, so give every rank the same one")

    def attach_heat(self, tracer) -> None:
        """Attach a :class:`~deepspeed_tpu_torch.telemetry.kv_heat.KVHeatTracer`:
        one ledger per placement pool, keyed by the placement's name (JAX's),
        seeded from the allocator's current refcounts and the prefix index's
        pages (attaching mid-run reconciles from the first event), hooks
        installed on the allocators and the prefix index, the derived gauges
        bound to this engine's registry. Idempotent for the same tracer.
        Under placements it steers the host tier's victims: attach (and
        detach) it on every rank, as every call on the engine is made."""
        if tracer is self._heat:
            return
        tracer.bind_registry(self.metrics)
        mc = self.model_config
        page_b = pool_bytes(mc.n_layer, 1, mc.n_head, self.page_size, mc.head_dim,
                            self._itemsize)
        now = self._ledger_clock()
        held = ([int(p) for p in self.prefix_cache.held_pages]
                if self.prefix_cache is not None else [])

        def ledger(pset, prefix_held):
            alloc = pset.allocator
            led = tracer.pool(pset.placement.name, alloc.capacity, page_size=self.page_size,
                              page_bytes=page_b, clock=self._ledger_clock)
            led.seed(alloc.refcounts(), prefix_held, now)
            alloc.heat = led
            return led

        self._heat_decode = ledger(self.decode_set, [] if self.disaggregated else held)
        self._heat_prefill = (ledger(self.prefill_set, held) if self.disaggregated
                              else self._heat_decode)
        # the index and the host tier live on the prefill placement's pool
        if self.prefix_cache is not None:
            self.prefix_cache.heat = self._heat_prefill
        if self.tiering is not None:
            # the tier's D/U/V events and its victim keys read that ledger
            self.tiering.ledger = self._heat_prefill
        self._heat = tracer

    def detach_heat(self) -> None:
        """Uninstall every heat hook (the tracer and its records survive)."""
        self.decode_set.allocator.heat = None
        self.prefill_set.allocator.heat = None
        if self.prefix_cache is not None:
            self.prefix_cache.heat = None
        if self.tiering is not None:
            self.tiering.ledger = None
        self._heat = None
        self._heat_decode = None
        self._heat_prefill = None

    def attach_journal(self, journal) -> None:
        """Attach a :class:`~deepspeed_tpu_torch.telemetry.timeseries.MetricsJournal`:
        bound to this engine's registry and clock, snapshotted on the step
        cadence. Idempotent for the same journal."""
        if journal is self._journal:
            return
        journal.bind(self.metrics, clock=self._trace_clock)
        self._journal = journal

    def detach_journal(self) -> None:
        """Stop snapshotting (the journal and its file survive)."""
        self._journal = None

    def _goodput_now(self, now: float) -> tuple:
        """(windowed, cumulative) goodput in tokens/s: SLO-met tokens over
        the trailing ``goodput_window_s`` (the journal's ``increase()``
        when attached, the ring of completions when not) over the window
        capped at the span; with no window both are the whole-span
        number."""
        if self._t_first_submit is None:
            return 0.0, 0.0
        span = max(now - self._t_first_submit, 1e-12)
        cumulative = self._slo_good_tokens / span
        w = self._goodput_window_s
        if w <= 0.0:
            return cumulative, cumulative
        if self._journal is not None and self._journal.last_t is not None:
            good = self._journal.increase("serving_slo_good_tokens_total", now - w, now)
            # snapshots trail the live counter by up to interval_s: fold in
            # the not-yet-journaled tail
            live = self._c_good_tokens.value()
            latest = self._journal.latest("serving_slo_good_tokens_total")
            good += live - (latest if latest is not None else 0.0)
        else:
            ring = self._good_events
            while ring and ring[0][0] < now - w:
                ring.popleft()
            good = float(sum(tok for _t, tok in ring))
        eff = min(w, span)
        return good / max(eff, 1e-12), cumulative

    def draft_index_bytes(self) -> int:
        """Host bytes held by live slots' n-gram drafter state (the JAX
        engine's estimate)."""
        import sys

        total = 0
        for slot in self.slots:
            st = slot.request.draft_state if slot.request is not None else None
            if not st:
                continue
            ctx, index, _watermark = st
            total += sys.getsizeof(ctx) + 28 * len(ctx)
            total += sys.getsizeof(index)
            total += len(index) * (28 * (self.spec_ngram + 1) + 56)
        return total

    def host_metadata_breakdown(self) -> dict:
        """Host-side (RSS) metadata: the prefix index, the drafter indexes,
        the heat ledgers and the host tier's page buffers."""
        prefix_b = (self.prefix_cache.host_metadata_bytes()
                    if self.prefix_cache is not None else 0)
        draft_b = self.draft_index_bytes()
        heat_b = self._heat.ledger_bytes() if self._heat is not None else 0
        tier_b = self.tiering.store.host_bytes() if self.tiering is not None else 0
        return {
            "prefix_index_bytes": prefix_b,
            "draft_index_bytes": draft_b,
            "heat_ledger_bytes": heat_b,
            "kv_host_tier_bytes": tier_b,
            "total_bytes": prefix_b + draft_b + heat_b + tier_b,
        }

    def slo_snapshot(self) -> dict:
        """The goodput / attainment numbers behind the gauges, without the
        quantile sweep of :meth:`stats`."""
        met = sum(c[0] for c in self._slo_counts.values())
        evaluated = sum(c[1] for c in self._slo_counts.values())
        now = self.clock()
        span = now - self._t_first_submit if self._t_first_submit is not None else 0.0
        windowed, cumulative = self._goodput_now(now)
        return {
            "good_tokens": int(self._slo_good_tokens),
            "met": int(met),
            "evaluated": int(evaluated),
            "attainment": (met / evaluated) if evaluated else None,
            "goodput_tokens_per_sec": windowed,
            "goodput_cumulative_tokens_per_sec": cumulative,
            "span_s": span,
        }

    # ------------------------------------------------------------------
    # the programs: a fixed, config-derived set, captured on the card
    # ------------------------------------------------------------------
    def _build_programs(self) -> None:
        """The prefill, the decode or verify step and (with chunks) the
        chunk program, each over its static inputs and for its placement
        (the placement's per-rank config, its tp group, its ``_tp{n}``
        name suffix; eager on a gloo group) → ``executables``; the slot
        table lives in the decode-shaped program's staging arrays. Every
        rank builds every program; only a placement's ranks run its
        programs."""
        S, pps = self.max_slots, self.pages_per_slot
        dev = self.device
        sample = dict(temperature=float(self.config.temperature),
                      top_k=int(self.config.top_k), top_p=float(self.config.top_p))
        sampling = self._sampling
        sfx = "_int8" if self.pset.scales is not None else ""
        self._program_info = {}
        dset, pset = self.decode_set, self.prefill_set
        dcfg = self.decode_placement.local_model_config(self.model_config)
        pcfg = self.prefill_placement.local_model_config(self.model_config)

        def common(ps):
            return dict(return_logits=self.track_margins, scales=ps.scales,
                        tp_group=ps.placement.group)

        def program(name, ps, kind, shapes, fn):
            plc = ps.placement
            inputs = StaticInputs(shapes, dev)

            def step():
                with torch.no_grad():
                    return fn(inputs.dev)

            prog = CapturedProgram(name + sfx + plc.suffix(), step, dev, inputs,
                                   capture=plc.captures)
            self._program_info[prog.name] = (kind, plc)
            return prog

        self._prefill_prog = program(
            "serving_prefill", pset, "prefill",
            {"ids": (1, self.prefill_width), "plen": (1,), "page_ids": (self.prefill_pages,),
             "key": (2,)},
            lambda x: smodel.paged_prefill(
                pcfg, pset.params, x["ids"], x["plen"], pset.k_pool, pset.v_pool,
                x["page_ids"], x["key"] if sampling else None, **sample, **common(pset)))
        self.executables: List[CapturedProgram] = [self._prefill_prog]
        if self.spec_enabled:
            self._step_prog = program(
                "serving_verify", dset, "verify",
                {"tokens": (S, self.spec_k + 1), "seq_lens": (S,), "block_tables": (S, pps)},
                lambda x: smodel.paged_verify_step(
                    dcfg, dset.params, x["tokens"], x["seq_lens"], dset.k_pool, dset.v_pool,
                    x["block_tables"], **common(dset)))
        else:
            self._step_prog = program(
                "serving_decode", dset, "decode",
                {"tokens": (S,), "seq_lens": (S,), "block_tables": (S, pps), "keys": (S, 2)},
                lambda x: smodel.paged_decode_step(
                    dcfg, dset.params, x["tokens"], x["seq_lens"], dset.k_pool, dset.v_pool,
                    x["block_tables"], x["keys"] if sampling else None, **sample,
                    **common(dset)))
        self.executables.append(self._step_prog)
        staged = self._step_prog.inputs.staging()
        self.table = SlotTable(S, pps, staging={
            k: v for k, v in staged.items() if not (self.spec_enabled and k == "tokens")})
        self._chunk_prog = None
        if self.chunk_width > 0:
            C = self.chunk_width
            self._chunk_prog = program(
                "serving_chunk_prefill", pset, "chunk",
                {"ids": (1, C), "start": (1,), "plen": (1,), "page_ids": (C // self.page_size,),
                 "row": (1, pps), "key": (2,)},
                lambda x: smodel.paged_chunk_prefill(
                    pcfg, pset.params, x["ids"], x["start"], x["plen"], pset.k_pool,
                    pset.v_pool, x["page_ids"], x["row"], x["key"] if sampling else None,
                    **sample, **common(pset)))
            self.executables.append(self._chunk_prog)
        if self.disaggregated:
            # the handoff pair (JAX scheduler.py:970-1040): the gather on
            # the prefill placement, the scatter on the decode placement,
            # each over the static prefill_pages width
            self._gather_prog, self._scatter_prog, self._hg_rows, self._hs_rows = (
                self._row_programs(pset, dset, self.prefill_pages,
                                   "serving_kv_gather" + sfx + pset.placement.suffix(),
                                   "serving_kv_scatter" + sfx + dset.placement.suffix()))
            for prog, kind, ps in ((self._gather_prog, "gather", pset),
                                   (self._scatter_prog, "scatter", dset)):
                self._program_info[prog.name] = (kind, ps.placement)
                self.executables.append(prog)
        self._restore_prog = None
        if self.tiering is not None:
            self._build_restore_program(program)
        # the migration transport, built by the first export or adoption
        self._migrate_gather = self._migrate_scatter = None
        self._migrate_rows: List[torch.Tensor] = []

    def _set_collective_gauges(self) -> None:
        """``serving_tp_collective_bytes`` per program (JAX
        scheduler.py:1095-1108): the head-parallel programs all-reduce the
        ``[B, width, n_embd]`` partial product twice a layer, in the
        engine's dtype; 0 for a program of a tp-1 placement and for the
        handoff and restore programs."""
        mc = self.model_config
        it = torch.empty((), dtype=self.engine_dtype).element_size()
        widths = {"prefill": (1, self.prefill_width), "decode": (self.max_slots, 1),
                  "verify": (self.max_slots, self.spec_k + 1), "chunk": (1, self.chunk_width)}
        for name, (kind, plc) in self._program_info.items():
            bs = widths.get(kind)
            nbytes = (2 * mc.n_layer * bs[0] * bs[1] * mc.n_embd * it
                      if bs is not None and plc.tp > 1 else 0)
            self._g_tp_coll.set(nbytes, program=name)

    def _build_restore_program(self, program) -> None:
        """The host tier's restore program (JAX scheduler.py:1044-1085): a
        width-1 scatter of one page of every layer, k and v (and the int8
        scales), from the program's device source buffers into page ``dst``
        of the prefill placement's pools (this rank's heads), in place. Its
        only host input is ``dst``; the page goes up by one asynchronous
        copy a buffer, straight from the host store's pinned slot into the
        source buffers, ahead of the replay on the same stream."""
        pset = self.prefill_set
        src = {"k": torch.empty_like(pset.k_pool[:, 0]),
               "v": torch.empty_like(pset.v_pool[:, 0])}
        if pset.scales is not None:
            src["s"] = torch.empty_like(pset.scales[:, 0])
        self._restore_src = src

        def restore(x):
            dst = x["dst"].long()
            pset.k_pool.index_copy_(1, dst, src["k"].unsqueeze(1))
            pset.v_pool.index_copy_(1, dst, src["v"].unsqueeze(1))
            if pset.scales is not None:
                pset.scales.index_copy_(1, dst, src["s"].unsqueeze(1))

        self._restore_prog = program("serving_kv_restore", pset, "restore", {"dst": (1,)},
                                     restore)
        self.executables.append(self._restore_prog)
        self.tiering.bind_restore_exec(self._restore_page)

    def _restore_page(self, k, v, s, pid: int) -> None:
        """One restore: the host page (views of the store's slot) up into
        the source buffers, then the program (its one upload, the
        scatter). Only the prefill placement's ranks hold the pool."""
        if not self.prefill_placement.member:
            return
        x = self._restore_prog.inputs.staging()
        x["dst"][0] = pid
        cuda = self.device.type == "cuda"
        for name, host in (("k", k), ("v", v), ("s", s)):
            if host is not None:
                self._restore_src[name].copy_(host, non_blocking=cuda)
        self._restore_prog()

    def _row_programs(self, src, dst, width: int, gather_name: str, scatter_name: str):
        """A gather/scatter pair over static row buffers of ``width`` pages
        (``[L, width, KV, page, D]`` for k and v of this rank's heads, and
        ``[L, width, KV, 2]`` for the int8 scales): the gather fills its
        rows from ``src``'s pools at the staged page ids, the scatter
        writes its rows into ``dst``'s pools at the staged ones. Page-id
        lists are padded with the scratch page, which no live slot reads,
        so each program is one captured graph an engine. With ``src is
        dst`` the two share their rows. → (gather, scatter, gather rows,
        scatter rows)."""
        dev = self.device

        def rows_for(ps):
            return [torch.empty((p.shape[0], width) + tuple(p.shape[2:]), dtype=p.dtype,
                                device=dev) for p in ps.pools()]

        g_rows = rows_for(src)
        s_rows = g_rows if dst is src else rows_for(dst)
        src_ids = StaticInputs({"ids": (width,)}, dev)
        dst_ids = StaticInputs({"dst": (width,)}, dev)

        def gather():
            # the source's pools are read, not written
            ids = src_ids.dev["ids"].long()
            with torch.no_grad():
                for pool, row in zip(src.pools(), g_rows):
                    torch.index_select(pool, 1, ids, out=row)

        def scatter():
            ids = dst_ids.dev["dst"].long()
            with torch.no_grad():
                for pool, row in zip(dst.pools(), s_rows):
                    pool.index_copy_(1, ids, row)

        return (CapturedProgram(gather_name, gather, dev, src_ids),
                CapturedProgram(scatter_name, scatter, dev, dst_ids), g_rows, s_rows)

    def _ensure_migration_programs(self) -> None:
        """The migration transport (JAX scheduler.py:2236-2300), built on
        first use: :meth:`_row_programs` over the pool at ``pages_per_slot``
        pages; ``serving_kv_gather`` fills the rows from a slot's page ids,
        ``serving_kv_scatter`` writes them into freshly allocated ones.
        Neither is in ``executables``."""
        if self._migrate_gather is not None:
            return
        sfx = "_int8" if self.pset.scales is not None else ""
        self._migrate_gather, self._migrate_scatter, self._migrate_rows, _ = self._row_programs(
            self.pset, self.pset, self.pages_per_slot, "serving_kv_gather" + sfx,
            "serving_kv_scatter" + sfx)

    @property
    def expected_executables(self) -> int:
        """The static-shapes contract of the JAX engine (JAX
        scheduler.py:651-662): one prefill program, ONE decode-shaped
        program (verify replaces decode), the chunk program when chunking
        or the prefix cache needs it, the handoff pair under disaggregated
        placements, and the host tier's ``serving_kv_restore``."""
        return (2 + (1 if self.chunk_width > 0 else 0) + (2 if self.disaggregated else 0)
                + (1 if self.tiering_enabled else 0))

    @property
    def allocator(self):
        """The decode (or shared) placement's page allocator."""
        return self.decode_set.allocator

    @property
    def k_pool(self):
        return self.decode_set.k_pool

    @property
    def v_pool(self):
        return self.decode_set.v_pool

    @property
    def kv_scales(self):
        """The int8 pool's ``[L, P, KV, 2]`` scales (None otherwise)."""
        return self.decode_set.scales

    # ------------------------------------------------------------------
    # admission control
    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None, seed: int = 0,
               eos_token_id: Optional[int] = None,
               deadline_s: Optional[float] = None, tenant: str = "default",
               slo_class: Optional[str] = None) -> Request:
        """Enqueue one request. Backpressure REJECTS at the door (queue
        depth, or a prompt that can never fit); an over-long
        ``max_new_tokens`` is clamped and the response marked TRUNCATED at
        finish. ``tenant`` is a free-form accounting dimension;
        ``slo_class`` names a ``serving.slo.classes`` entry (unknown or
        None → the configured default: SLO accounting observes, it never
        admits or rejects)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        mnt = int(self.config.max_new_tokens if max_new_tokens is None else max_new_tokens)
        req = Request(
            prompt=prompt, max_new_tokens=mnt, seed=int(seed), eos_token_id=eos_token_id,
            deadline_s=deadline_s, tenant=str(tenant),
            slo_class=(self._slo.resolve_class(slo_class) if self._slo_enabled
                       else (slo_class or "")),
        )
        req.t_submit = self.clock()
        if self._t_first_submit is None:
            self._t_first_submit = req.t_submit
        if self.tracer is not None:
            self.tracer.submit(req, req.t_submit)
        plen = req.prompt_len
        if plen < 1 or plen > int(self.config.max_prompt_len):
            return self._reject(
                req, f"prompt length {plen} outside [1, {self.config.max_prompt_len}]"
            )
        if mnt < 1:
            return self._reject(req, f"max_new_tokens {mnt} < 1")
        cap = min(int(self.config.max_new_tokens), self.max_total_len - plen)
        if cap < 1:
            return self._reject(req, f"prompt length {plen} leaves no decode budget")
        if mnt > cap:
            # degrade, don't wedge: the response will be truncated at cap
            req.requested_new_tokens = mnt
            req.max_new_tokens = cap
            req.detail = f"max_new_tokens clamped {mnt} -> {cap}"
        if self._draining:
            return self._reject(req, "engine draining (admission stopped)", cause="draining")
        if len(self.queue) >= int(self.config.max_queue_depth):
            return self._reject(req, f"queue full ({self.config.max_queue_depth})",
                                cause="queue_depth")
        self.queue.append(req)
        self._g_queue.set(len(self.queue))
        return req

    def _reject(self, req: Request, why: str, cause: str = "invalid") -> Request:
        req.status = RequestStatus.REJECTED
        req.detail = why
        req.t_finish = self.clock()
        self._c_requests.inc(status=RequestStatus.REJECTED)
        if self.tracer is not None:
            self.tracer.event(req, "reject", req.t_finish, cause=cause)
        self._req_terminal(req, req.t_finish)
        return req

    def _deadline(self, req: Request) -> Optional[float]:
        d = req.deadline_s
        if d is None:
            d = float(self.config.default_deadline_s) or None
        return None if d is None else req.t_submit + d

    # ------------------------------------------------------------------
    # the scheduler loop
    # ------------------------------------------------------------------
    def step(self) -> int:
        """One scheduler iteration: evict deadline-passed work, admit queued
        requests into free slots (prefill insertion), advance every
        prefilling slot one chunk and every decoding slot one decode (or
        verify) step. Returns the number of active slots after the step."""
        now = self.clock()

        # 1. timeout eviction: a request past its deadline degrades to a
        # truncated response; its slot and pages are reclaimed immediately
        for i, slot in enumerate(self.slots):
            if slot.request is None:
                continue
            dl = self._deadline(slot.request)
            if dl is not None and now > dl:
                self._c_timeouts.inc()
                self._finish_slot(i, RequestStatus.TRUNCATED, "deadline exceeded", now)
        if self.queue:
            keep: Deque[Request] = deque()
            for req in self.queue:
                dl = self._deadline(req)
                if dl is not None and now > dl:
                    req.status = RequestStatus.TIMED_OUT
                    req.detail = "deadline exceeded while queued"
                    req.t_finish = now
                    self._c_requests.inc(status=RequestStatus.TIMED_OUT)
                    self._req_terminal(req, now)
                else:
                    keep.append(req)
            self.queue = keep

        # a request waiting out its retry backoff waits on itself, not on
        # capacity: note it once a step (the loop below attributes the
        # capacity causes); the flag spares the scan when no retry is out
        if self.tracer is not None and self._backoff_pending:
            waiting = False
            for r in self.queue:
                if r.not_before > now:
                    self.tracer.note_wait(r, "backoff")
                    waiting = True
            if not waiting:
                self._backoff_pending = False

        # 2. prefill insertions: FIFO admission into free slots, gated by the
        # KV-page budget net of the prefix-index pages the prompt can map
        # (the head of line blocks until finishing slots free pages). Under
        # pool pressure the index yields cold entries first, and the need is
        # re-probed: the eviction may have dropped pages the probe counted.
        # A drain stops admission; a retried request inside its backoff
        # window is passed over, not a head-of-line blocker. The tracer
        # attributes each step the head of line waits to its cause.
        while self.queue and not self._draining:
            free = next((i for i, s in enumerate(self.slots) if s.request is None), None)
            if free is None:
                if self.tracer is not None:
                    idx = next((j for j, r in enumerate(self.queue) if r.not_before <= now),
                               None)
                    if idx is not None:
                        self.tracer.note_wait(self.queue[idx], "no_free_slot")
                break
            idx = next((j for j, r in enumerate(self.queue) if r.not_before <= now), None)
            if idx is None:
                break
            req = self.queue[idx]
            # restore the prompt's demoted prefix pages from the host tier
            # before costing the reservation (each restore turns a page to
            # recompute into a mapped hit); depth-bounded a step, so a long
            # host-held chain keeps the request queued under a kv_restore wait
            if self.tiering is not None and self._tier_prefetch(req, now):
                if self.tracer is not None:
                    self.tracer.note_wait(req, "kv_restore")
                break
            # under disaggregation BOTH placements gate admission: the
            # decode pool must hold the full private reservation, the
            # prefill pool the prompt's pages net of prefix hits (the index
            # holds prefill-side pages, so eviction relieves that side)
            need = self._pages_needed(req)
            p_alloc = self.prefill_set.allocator
            p_need = self._prefill_pages_needed(req) if self.disaggregated else need
            if need > self.allocator.free_pages or (
                    self.disaggregated and p_need > p_alloc.free_pages):
                if self.prefix_cache is not None and len(self.prefix_cache):
                    self.prefix_cache.evict(need_free=p_need)
                    self._g_index_pages.set(len(self.prefix_cache))
                    need = self._pages_needed(req)
                    if self.disaggregated:
                        p_need = self._prefill_pages_needed(req)
                if need > self.allocator.free_pages or (
                        self.disaggregated and p_need > p_alloc.free_pages):
                    if self.tracer is not None:
                        self.tracer.note_wait(req, "page_budget")
                    break
            del self.queue[idx]
            self._admit(free, req)

        # 2b. chunked prefill: every prefilling slot advances one chunk, and
        # the decode batch below still runs. A slot whose first token is
        # read (pending_tok, disaggregated) waits on the handoff instead
        for i, slot in enumerate(self.slots):
            if slot.request is not None and slot.prefilling and slot.pending_tok is None:
                self._advance_chunk(i)

        # 2c. disaggregated handoff completion (JAX scheduler.py:1322-1342):
        # a slot whose prefill placement has sampled the first token moves
        # its prompt KV into the decode pool and joins the decode batch.
        # The token was read at the prefill, so the handoff runs in the
        # same step on every rank
        if self.disaggregated:
            for i, slot in enumerate(self.slots):
                if slot.request is not None and slot.pending_tok is not None:
                    self._complete_handoff(i)

        # 3. one batched decode (or speculative verify) step for every slot
        # past its prefill
        active = [i for i, s in enumerate(self.slots)
                  if s.request is not None and not s.prefilling]
        if active:
            t0 = self.clock()
            emitted, margins = (self._verify(active) if self.spec_enabled
                                else self._decode(active))
            now = self.clock()
            self._step_count += 1
            dt = now - t0
            self._h_step.observe(dt)
            self._c_steps.inc()
            self._ema_step_s = dt if self._ema_step_s == 0.0 else 0.8 * self._ema_step_s + 0.2 * dt
            # pass 1: tokens and this step's trace and heat events for every
            # slot, each plane fed once, before any retirement below folds a
            # request's events into its terminal record
            ev_batch: list = []
            heat_batch: list = []
            heat = self._heat_decode
            page = self.page_size
            for i, toks in emitted:
                slot = self.slots[i]
                req = slot.request
                req.tokens.extend(toks)
                if margins is not None:
                    req.margins.extend(float(m) for m in margins[i][: len(toks)])
                if heat is not None:
                    # the step's KV write landed in the page of the last
                    # emitted position; the slot attends its block-table prefix
                    pos_after = slot.pos + len(toks)
                    heat_batch.append((i, int(self.table.block_tables[i, (pos_after - 1) // page]),
                                       pages_for(pos_after, page)))
                # one emission time a token: a verify step's accepted run
                # lands at one instant
                req.t_emissions.extend([now] * len(toks))
                if self.tracer is not None:
                    ev_batch.append((req.id, {
                        "e": "verify", "t": now, "step": self._step_count, "slot": i,
                        "emitted": len(toks), "drafted": self.spec_k,
                        "accepted": len(toks) - 1, "total": len(req.tokens),
                    } if self.spec_enabled else (now, self._step_count, i)))
            if ev_batch:
                if self.spec_enabled:
                    self.tracer.step_events(ev_batch)
                else:
                    self.tracer.decode_events(ev_batch)
            if heat_batch:
                heat.touch_step(now, self._step_count, heat_batch)
            # pass 2: advance or retire the slots
            for i, toks in emitted:
                slot = self.slots[i]
                req = slot.request
                self._decode_tokens += len(toks)
                slot.pos += len(toks)
                slot.step += 1
                self.table.seq_lens[i] = slot.pos
                self.table.tokens[i] = toks[-1]
                if len(req.tokens) >= req.max_new_tokens or (
                    req.eos_token_id is not None and toks[-1] == req.eos_token_id
                ):
                    self._finish_slot(i, RequestStatus.FINISHED, "", now)
                elif req.stall_after is not None and len(req.tokens) >= req.stall_after:
                    # an injected transient slot failure: evict, then the
                    # retry-with-backoff path
                    self._fail_slot(i, "injected slot stall", now)
                elif slot.keys is not None:
                    # token t (0-based) was drawn with keys[t - 1]
                    self.table.keys[i] = slot.keys[len(req.tokens) - 1]

        # straggler detection: a request resident in its slot far beyond its
        # decode budget (straggler_factor x max_new_tokens x the EMA step
        # time) is flagged once
        if self.watchdog is not None and self._ema_step_s > 0.0:
            factor = float(getattr(self.watchdog.config, "straggler_factor", 3.0))
            now = self._trace_clock()
            for slot in self.slots:
                req = slot.request
                if req is None or req.t_first_token is None:
                    continue
                budget = factor * max(1, req.max_new_tokens) * self._ema_step_s
                elapsed = now - req.t_first_token
                if elapsed > budget and self.watchdog.observe_straggler(
                    self._step_count, req.id,
                    f"slot residence {elapsed:.3f}s > {budget:.3f}s "
                    f"({len(req.tokens)}/{req.max_new_tokens} tokens)",
                ):
                    self._c_stragglers.inc()

        n_active = sum(1 for s in self.slots if s.request is not None)
        self._g_queue.set(len(self.queue))
        self._g_util.set(n_active / self.max_slots)
        self._g_pages.set(self.allocator.pages_in_use)
        self._g_occ.set(self.allocator.pages_in_use / self.allocator.capacity)
        self._g_pages_shared.set(self.allocator.pages_shared)
        if self.prefix_cache is not None:
            self._g_index_pages.set(len(self.prefix_cache))
        if self.tiering is not None:
            self._tier_pump()
        if self._step_count and self._step_count % 32 == 0:
            self.stats()  # refresh the quantile gauges for textfile scrapes
        if self._journal is not None:
            self._journal.maybe_snapshot(self._trace_clock())
        return n_active

    def _decode(self, active):
        """One batched decode step → ([(slot, [token])], margins [B, 1] or
        None). The slot table is the program's staging: one upload."""
        out = self._run(self._step_prog, self.decode_placement)
        # the one deliberate sync of the slot loop: the scheduler must read
        # the sampled tokens to retire or advance slots (and it leaves the
        # staged table free to write)
        out_np, margins = self._host_outputs(self.decode_placement, out, (self.max_slots,))
        margins = margins[:, None] if margins is not None else None
        return [(i, [int(out_np[i])]) for i in active], margins

    def _verify(self, active):
        """One speculative verify step: ``[max_slots, k+1]`` tokens (last
        emitted + the drafts) → ([(slot, accepted tokens)], margins
        [B, k+1] or None)."""
        vt = self._step_prog.inputs.staging()["tokens"]
        vt[:] = 0
        vt[:, 0] = self.table.tokens
        drafts = {}
        for i in active:
            drafts[i] = self._draft(self.slots[i].request)
            vt[i, 1:] = drafts[i]
        out = self._run(self._step_prog, self.decode_placement)
        # the step's one deliberate sync
        out_np, margins = self._host_outputs(self.decode_placement, out,
                                             (self.max_slots, self.spec_k + 1))
        self._c_spec_steps.inc()
        self._c_spec_drafted.inc(self.spec_k * len(active))
        return [(i, self._accept_tokens(self.slots[i].request, drafts[i], out_np[i]))
                for i in active], margins

    def _draft(self, req: Request) -> np.ndarray:
        """Host-side prompt-lookup draft: the continuation of the most
        recent PRIOR occurrence of the context's last ``ngram`` tokens,
        padded with the last token. The ngram → position map is kept on the
        request and grown by the positions appended since the last step, so
        a draft costs O(tokens appended), not a rescan of the context; a
        context that shrank rebuilds it. A bad draft costs nothing extra
        (the verify step's shape is fixed), so the fallback is plain."""
        k, n = self.spec_k, self.spec_ngram
        prompt = req.prompt_list
        L = len(prompt) + len(req.tokens)
        st = req.draft_state
        if st is None or len(st[0]) > L:
            st = ([], {}, [0])  # (context copy, ngram -> latest start, watermark)
            req.draft_state = st
        ctx, index, cur = st
        if len(ctx) < L:
            grown = len(ctx)
            ctx.extend(prompt[grown:] if grown < len(prompt) else [])
            ctx.extend(req.tokens[len(ctx) - len(prompt):])
        # index every ngram start strictly before the target position L-n;
        # the latest write wins, so a lookup is the backward scan's "most
        # recent prior occurrence"
        for s in range(cur[0], L - n):
            index[tuple(ctx[s:s + n])] = s
        cur[0] = max(cur[0], L - n)
        last = ctx[-1]
        if L >= n + 1:
            s = index.get(tuple(ctx[L - n:]))
            if s is not None:
                cont = ctx[s + n:s + n + k]
                return np.asarray((cont + [last] * k)[:k], np.int32)
        return np.full((k,), last, np.int32)

    def _accept_tokens(self, req: Request, draft: np.ndarray,
                       greedy: np.ndarray) -> List[int]:
        """The speculative accept rule: ``greedy[t]`` is the argmax token
        after the prefix + draft[:t], so drafts are accepted while
        ``draft[t] == greedy[t]`` and the step emits the accepted drafts plus
        one bonus token: exactly the sequential greedy stream, cut to the
        remaining budget and at EOS."""
        n_acc = 0
        while n_acc < self.spec_k and int(draft[n_acc]) == int(greedy[n_acc]):
            n_acc += 1
        emit = min(n_acc + 1, req.max_new_tokens - len(req.tokens))
        toks = [int(t) for t in greedy[:emit]]
        if req.eos_token_id is not None and req.eos_token_id in toks:
            toks = toks[: toks.index(req.eos_token_id) + 1]
        self._c_spec_accepted.inc(len(toks) - 1)
        self._h_accept.observe(len(toks))
        return toks

    def _run(self, prog: CapturedProgram, plc: Placement):
        """``prog()`` on its placement's ranks → its outputs (None on a rank
        outside the placement)."""
        return prog() if plc.member else None

    def _host_outputs(self, plc: Placement, out, shape: tuple):
        """What the host reads of a program's outputs → (tokens as int64
        numpy of ``shape``, margins of the same shape or None): read on a
        rank of the placement; when some rank is outside it
        (disaggregation, or ranks past the placements) broadcast from the
        placement's first rank to every rank, tokens and margins in one
        float64 buffer (exact for token ids)."""
        tok = margins = None
        if plc.member:
            tok, logits = out if self.track_margins else (out, None)
            if not self._bcast:
                return (tok.cpu().numpy().reshape(shape),
                        _top2_margin(logits).reshape(shape) if logits is not None else None)
        n = int(np.prod(shape))
        buf = torch.zeros((2 if self.track_margins else 1) * n, dtype=torch.float64)
        if plc.member:
            buf[:n] = tok.reshape(-1).to("cpu", torch.float64)
            if self.track_margins:
                top2 = torch.topk(logits.float(), 2, dim=-1).values
                buf[n:] = (top2[..., 0] - top2[..., 1]).reshape(-1).to("cpu", torch.float64)
        comm.broadcast(buf, self._host_group, plc.root)
        host = buf.numpy()
        tok = host[:n].astype(np.int64).reshape(shape)
        if self.track_margins:
            margins = host[n:].astype(np.float32).reshape(shape)
        return tok, margins

    def _pages_needed(self, req: Request) -> int:
        """Net new DECODE-pool pages an admission allocates: the request's
        full reservation minus the pages the prefix index can map (a probe
        that counts nothing and refreshes nothing: the gate runs it every
        step while a request heads the queue). Under disaggregation the
        decode reservation is all private (the handoff scatters the shared
        prompt KV into it), so nothing nets out."""
        total = pages_for(req.prompt_len + req.max_new_tokens, self.page_size)
        if self.prefix_cache is None or self.disaggregated:
            return total
        return total - self.prefix_cache.probe(req.prompt)

    def _prefill_pages_needed(self, req: Request) -> int:
        """Prefill-pool pages a disaggregated admission allocates: the
        prompt's pages net of prefix-index hits."""
        pp = pages_for(req.prompt_len, self.page_size)
        if self.prefix_cache is None:
            return pp
        return pp - self.prefix_cache.probe(req.prompt)

    # ------------------------------------------------------------------
    # the host tier: restore prefetch and spill pump (JAX scheduler.py:1523-1577)
    # ------------------------------------------------------------------
    def _tier_prefetch(self, req: Request, now: float) -> bool:
        """Walk ``req``'s prefix chain root to leaf and restore every link
        the host tier holds into a freshly allocated page (the
        ``serving_kv_restore`` program), re-adopting each into the index so
        the admission probe right after maps it as a plain hit. → True when
        the restore budget (``tiering.prefetch_depth``) ran out with
        host-held links left: the caller keeps the request queued under a
        ``kv_restore`` wait and goes on next step. A broken chain, a crc
        failure or an exhausted pool stops the walk: the rest re-prefills
        through the normal (chunked) path."""
        pc = self.prefix_cache
        tier = self.tiering
        alloc = self.prefill_set.allocator
        restored = 0
        for key in pc.chain_keys(req.prompt):
            if key in pc._entries:
                continue  # device-resident
            if key not in tier.store:
                break  # the chain is cold from this link on
            if restored >= tier.prefetch_depth:
                return True  # budget spent, the host still holds links
            try:
                pids = alloc.alloc(1)
            except PageAllocatorError:
                break  # pool pressure: the relief valve takes over
            t0 = self._trace_clock()
            ok = tier.restore(key, pids[0])
            if self._spmd:
                # each rank restores its own heads: a miss on one (a crc
                # mismatch) is a miss on every rank, so all decide alike
                flag = torch.tensor([int(ok)], dtype=torch.int32)
                agreed = bool(comm.all_reduce(flag, self._host_group, "min").item())
                if ok and not agreed:
                    tier.drop_orphans()  # the key left this store too: sweep as the miss did
                ok = agreed
            if not ok:
                alloc.free(pids)  # a cold miss: recompute
                break
            pc.adopt(key, pids[0])
            restored += 1
            if self.tracer is not None:
                t1 = self._trace_clock()
                self.tracer.event(req, "kv_restore", t1, page=int(pids[0]),
                                  bytes=tier.store.page_bytes, dur_s=t1 - t0)
        return False

    def _tier_pump(self) -> None:
        """Keep free-page headroom by demoting cold index leaves to the host
        BEFORE admissions hit the relief valve: when the free list drops
        under an eighth of the pool, evict (= demote: the sink is wired)
        enough leaves to climb back. The copies are queued here; the
        worker waits for them off the step path."""
        pc = self.prefix_cache
        if pc is None or not len(pc):
            return
        alloc = self.prefill_set.allocator
        low = max(1, alloc.capacity // 8)
        if alloc.free_pages >= low:
            return
        pc.evict(need_free=low)
        self._g_index_pages.set(len(pc))

    def _admit(self, slot_i: int, req: Request) -> None:
        self._admissions += 1
        # queue wait ends here: the request owns a slot
        req.t_admit = self.clock()
        qw = req.queue_wait_s
        if qw is not None:
            self._h_qwait.observe(qw)
        if (req.stall_after is None and self.fault_injector is not None
                and self.fault_injector.fire("serving_stall", self._admissions)):
            # fail once the request is mid-decode: pages held, tokens
            # emitted, and the retry must rewind all of it
            req.stall_after = max(1, req.max_new_tokens // 2)
        total = pages_for(req.prompt_len + req.max_new_tokens, self.page_size)
        # prefix-cache lookup: map every indexed full page of the prompt. A
        # full-prefix hit also finds the LAST prompt page indexed; that page
        # is forked copy-on-write (a fresh private page, filled by
        # recomputing its tokens through the chunk program), because the
        # slot's own decode writes continue next to it
        shared: List[int] = []
        shared_tokens = 0
        cow_page = None
        kind = None
        if self.prefix_cache is not None:
            pc = self.prefix_cache
            shared, shared_tokens, cow_page = pc.lookup(req.prompt)
            kind = "full" if cow_page is not None else ("partial" if shared else "miss")
            self._c_prefix_hits.inc(kind=kind)
            lookups = pc.hits_full + pc.hits_partial + pc.misses
            if lookups:
                self._g_prefix_rate.set((pc.hits_full + pc.hits_partial) / lookups)
            # refcounts live with the pool that holds the pages: the
            # prefill allocator under disaggregation (the decode one else)
            if shared:
                self.prefill_set.allocator.retain(shared)
                self._c_pages_reused.inc(len(shared))
            if cow_page is not None:
                self.prefill_set.allocator.cow_forks_total += 1
                self._c_cow.inc()
        p_priv: List[int] = []
        try:
            if self.disaggregated:
                # two reservations: the prompt's pages on the prefill
                # placement (shared + private; the handoff reads, then frees
                # them), the FULL reservation as private pages on the decode
                # placement (the handoff scatters the prompt KV in)
                p_priv = self.prefill_set.allocator.alloc(
                    pages_for(req.prompt_len, self.page_size) - len(shared))
                prefill_pages = shared + p_priv
                pages = self.allocator.alloc(total)
            else:
                prefill_pages = []
                pages = shared + self.allocator.alloc(total - len(shared))
        except PageAllocatorError as e:
            # all or nothing: a failed reservation must not strand the
            # prefix retains or the other pool's reservation
            rollback = p_priv + shared
            if rollback:
                self.prefill_set.allocator.free(rollback)
            self._retry_or_fail(req, f"admission reservation failed: {e}", self.clock())
            return
        slot = self.slots[slot_i]
        slot.request = req
        slot.pages = pages
        slot.prefill_pages = prefill_pages
        slot.pos = 0
        req.prefix_shared_tokens = shared_tokens
        req.cow_forked = cow_page is not None
        if self._heat_decode is not None:
            # the full reservation is taken here, so the session's page
            # list is the slot's whole footprint
            self._heat_decode.session_start(req.t_admit, slot_i, req.id, req.tenant, pages)
        if self.tracer is not None:
            self.tracer.event(
                req, "admit", req.t_admit, step=self._step_count, slot=slot_i,
                queue_wait_s=qw, pages=total, shared_pages=len(shared),
                shared_tokens=shared_tokens, prefix_kind=kind, retries=req.retries,
            )

        if self.chunk_width > 0 and (
            shared_tokens > 0 or (self._chunk_cold and req.prompt_len > self.chunk_width)
        ):
            # chunked (tail) prefill: the real block table lives on the slot,
            # the main table row stays scratch until the prompt is in. Under
            # disaggregation the chunk program runs on the prefill
            # placement, so the row addresses the prefill pool's pages
            row = np.zeros((1, self.pages_per_slot), np.int32)
            src = prefill_pages if self.disaggregated else pages
            row[0, : len(src)] = src
            slot.row = row
            slot.prefilling = True
            slot.prefill_pos = shared_tokens
            req.status = RequestStatus.RUNNING
            return

        x = self._prefill_prog.inputs.staging()
        x["ids"][:] = 0
        x["ids"][0, : req.prompt_len] = req.prompt
        x["plen"][0] = req.prompt_len
        if self.disaggregated:
            # the whole prefill on the PREFILL placement: its page ids
            # address the prefill pool
            x["page_ids"][:] = 0
            x["page_ids"][: len(prefill_pages)] = prefill_pages
        else:
            self.table.assign(slot_i, pages)
            x["page_ids"][:] = self.table.block_tables[slot_i, : self.prefill_pages]
        x["key"][:] = self._prefill_key(req)
        out = self._run(self._prefill_prog, self.prefill_placement)
        self._c_prefills.inc()
        # deliberate sync: TTFT is defined by the first token reaching the
        # host, and an at-admission EOS must retire the slot before decode
        first, margins = self._host_outputs(self.prefill_placement, out, (1,))
        tok0 = int(first[0])
        if self.tracer is not None:
            self.tracer.event(req, "prefill", self._trace_clock(), step=self._step_count,
                              slot=slot_i, width=self.prefill_width,
                              prompt_len=req.prompt_len)
        if margins is not None:
            req.margins.append(float(margins[0]))
        if self.disaggregated:
            # the handoff (step phase 2c) emits the token and joins the slot
            # to the decode batch
            slot.pending_tok = tok0
            slot.prefilling = True
            slot.prefill_pos = req.prompt_len
            req.status = RequestStatus.RUNNING
            return
        self._start_decoding(slot_i, tok0)

    def _prefill_key(self, req: Request) -> np.ndarray:
        """The first token's key as int32 staging: ``PRNGKey(seed)`` (JAX
        ``_host_prng_key``; unread when greedy)."""
        return prng.PRNGKey(req.seed).view(np.int32)

    def _advance_chunk(self, slot_i: int) -> None:
        """One chunk of a prefilling slot's prompt through the chunk
        program; after the final chunk its sampled token is the request's
        first token and the slot joins the decode batch."""
        slot = self.slots[slot_i]
        req = slot.request
        C = self.chunk_width
        page = self.page_size
        start = slot.prefill_pos
        x = self._chunk_prog.inputs.staging()
        seg = req.prompt[start: start + C]
        x["ids"][:] = 0
        x["ids"][0, : len(seg)] = seg
        x["start"][0] = start
        x["plen"][0] = req.prompt_len
        p0 = start // page
        avail = slot.row[0, p0: p0 + C // page]
        x["page_ids"][:] = 0  # scratch-padded past the row
        x["page_ids"][: len(avail)] = avail
        x["row"][:] = slot.row
        # every chunk samples with the unchunked prefill's key (JAX's chunk
        # program); only the final chunk's token is kept
        x["key"][:] = self._prefill_key(req)
        final = start + C >= req.prompt_len
        out = self._run(self._chunk_prog, self.prefill_placement)
        self._c_chunks.inc()
        slot.prefill_pos = start + C
        if self.tracer is not None:
            self.tracer.event(req, "prefill_chunk", self._trace_clock(), step=self._step_count,
                              slot=slot_i, start=start, width=C, final=final)
        if not final:
            return  # more chunks; the decode batch advances meanwhile
        self._c_prefills.inc()
        # deliberate sync, as in _admit: the final chunk's sample is the
        # request's first token
        first, margins = self._host_outputs(self.prefill_placement, out, (1,))
        tok0 = int(first[0])
        if margins is not None:
            req.margins.append(float(margins[0]))
        if self.disaggregated:
            slot.pending_tok = tok0  # the handoff of step phase 2c follows
            return
        self._start_decoding(slot_i, tok0)

    def _complete_handoff(self, slot_i: int) -> None:
        """Finish a disaggregated prefill (JAX scheduler.py:1858-1920): move
        the prompt KV from the prefill placement's pool into the slot's
        private decode-pool reservation (:meth:`_handoff`), register the
        prompt in the prefix index (PREFILL-side pages: admissions compute
        there), free the prefill-side pages, and join the decode batch with
        the first token. A prefill-terminal request (``max_new_tokens ==
        1`` or EOS on the first token) skips the move: it finishes without
        decoding. ``kv_handoff_bytes`` counts JAX's logical bytes: the
        packed global payload over the static width, on every rank."""
        slot = self.slots[slot_i]
        req = slot.request
        tok0 = slot.pending_tok
        slot.pending_tok = None
        pset = self.prefill_set
        if req.max_new_tokens == 1 or (req.eos_token_id is not None
                                       and tok0 == req.eos_token_id):
            if self.prefix_cache is not None:
                self.prefix_cache.insert(req.prompt, slot.prefill_pages)
                self._g_index_pages.set(len(self.prefix_cache))
            pset.allocator.free(slot.prefill_pages)
            slot.prefill_pages = []
            self._start_decoding(slot_i, tok0)
            return
        t0 = self.clock()
        n = len(slot.prefill_pages)
        # scratch-padded to the static width; pad entries hit scratch page 0
        src = np.zeros((self.prefill_pages,), np.int32)
        src[:n] = slot.prefill_pages
        dst = np.zeros((self.prefill_pages,), np.int32)
        dst[:n] = slot.pages[:n]
        self._handoff(src, dst)
        now = self.clock()
        mc = self.model_config
        nbytes = pool_bytes(mc.n_layer, self.prefill_pages, mc.n_head, self.page_size,
                            mc.head_dim, self._itemsize)
        if pset.scales is not None:
            nbytes += scales_bytes(mc.n_layer, self.prefill_pages, mc.n_head)
        self._c_handoffs.inc()
        self._c_handoff_bytes.inc(nbytes)
        self._h_handoff.observe(now - t0)
        if self.tracer is not None:
            self.tracer.event(req, "kv_handoff", now, step=self._step_count, slot=slot_i,
                              pages=n, bytes=nbytes, latency_s=now - t0)
        # prefix insert BEFORE the free: insert retains the prompt's full
        # pages, so only the private non-full tail is released
        if self.prefix_cache is not None:
            self.prefix_cache.insert(req.prompt, slot.prefill_pages)
            self._g_index_pages.set(len(self.prefix_cache))
        pset.allocator.free(slot.prefill_pages)
        slot.prefill_pages = []
        self._start_decoding(slot_i, tok0)

    def _handoff(self, src: np.ndarray, dst: np.ndarray) -> None:
        """One KV handoff: the prefill ranks gather the pages ``src`` of
        their pools (their KV heads, with the int8 scales) into the static
        rows; each sends every decode rank the heads both hold
        (``comm.send_recv``: heads ``[h0, h1)`` re-sharded when
        ``decode_tp != prefill_tp``); the decode ranks scatter what they
        received into pages ``dst``, and the copy is synchronized (the
        latency covers the move, not its dispatch)."""
        pp, dp = self.prefill_placement, self.decode_placement
        if pp.member:
            self._gather_prog.inputs.staging()["ids"][:] = src
            self._gather_prog()
        if dp.member:
            self._scatter_prog.inputs.staging()["dst"][:] = dst
        kv = self.model_config.n_head
        me = dist.get_rank()
        sends, recvs = [], []
        for i, src_rank in enumerate(pp.ranks):
            a0, a1 = pp.kv_heads(kv, i)
            for j, dst_rank in enumerate(dp.ranks):
                b0, b1 = dp.kv_heads(kv, j)
                lo, hi = max(a0, b0), min(a1, b1)
                if lo >= hi:
                    continue
                if src_rank == me:
                    sends += [(row[:, :, lo - a0:hi - a0], dst_rank) for row in self._hg_rows]
                if dst_rank == me:
                    recvs += [(row[:, :, lo - b0:hi - b0], src_rank) for row in self._hs_rows]
        comm.send_recv(sends, recvs)
        if dp.member:
            self._scatter_prog()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _start_decoding(self, slot_i: int, tok0: int) -> None:
        """Post-prefill transition: install the real block table (after a
        chunked prefill), record TTFT, arm the slot's decode row, index the
        prompt's full pages, and finish at once on an immediate EOS or a
        single-token ask."""
        slot = self.slots[slot_i]
        req = slot.request
        now = self.clock()
        if self.disaggregated:
            # the slot decodes against its private decode-pool reservation;
            # whatever row the prefill used addressed the OTHER pool
            self.table.assign(slot_i, slot.pages)
            slot.prefilling = False
            slot.row = None
        elif slot.row is not None:
            self.table.block_tables[slot_i, :] = slot.row[0]
            slot.prefilling = False
            slot.row = None
        req.status = RequestStatus.RUNNING
        # TTFT: the first sampled token reaching the host (after a chunked
        # prefill, the last chunk's)
        req.t_first_token = now
        self._h_ttft.observe(now - req.t_submit)
        req.tokens.append(tok0)
        req.t_emissions.append(now)
        if self.tracer is not None:
            self.tracer.event(req, "first_token", now, step=self._step_count, slot=slot_i,
                              ttft_s=now - req.t_submit)
        slot.pos = req.prompt_len
        self.table.seq_lens[slot_i] = slot.pos
        self.table.tokens[slot_i] = tok0
        if self.prefix_cache is not None and not self.disaggregated:
            # disaggregated: _complete_handoff indexed the PREFILL-side pages
            self.prefix_cache.insert(req.prompt, slot.pages)
            self._g_index_pages.set(len(self.prefix_cache))
        if self._sampling and req.max_new_tokens > 1:
            # generate's key sequence for this request (JAX
            # scheduler.py:1963-1975): step t consumes keys[t - 1]
            slot.keys = prng.split(prng.fold_in(prng.PRNGKey(req.seed), 1),
                                   req.max_new_tokens - 1)
            self.table.keys[slot_i] = slot.keys[0]
        if req.max_new_tokens == 1 or (
            req.eos_token_id is not None and tok0 == req.eos_token_id
        ):
            self._finish_slot(slot_i, RequestStatus.FINISHED, "", now)

    def _finish_slot(self, slot_i: int, status: str, detail: str, now: float) -> None:
        slot = self.slots[slot_i]
        req = slot.request
        stopped_on_eos = (
            req.eos_token_id is not None and bool(req.tokens)
            and req.tokens[-1] == req.eos_token_id
        )
        if (
            req.requested_new_tokens is not None
            and status == RequestStatus.FINISHED
            and not stopped_on_eos
        ):
            # the clamp bit: the decode budget ran out short of the original
            # ask. An EOS stop is a complete response even when clamped.
            status = RequestStatus.TRUNCATED
        req.status = status
        if detail:
            req.detail = detail
        req.t_finish = now
        # the streaming client's inter-token gaps, not the per-request mean:
        # a verify step's accepted run arrives at once (0-gaps) after the
        # step's whole latency
        for gap in req.inter_token_gaps_s:
            self._h_tpot.observe(gap)
        self._c_requests.inc(status=status)
        self._c_tokens.inc(len(req.tokens))
        self._release(slot_i, now)
        self._req_terminal(req, now)

    def _fail_slot(self, slot_i: int, why: str, now: float) -> None:
        """A transient slot failure: reclaim the slot and its pages at
        once, then retry with backoff or fail terminally."""
        req = self.slots[slot_i].request
        self._release(slot_i, now)
        self._retry_or_fail(req, why, now)

    def _release(self, slot_i: int, now: float) -> None:
        """Free slot ``slot_i``: its pages (and, evicted before its handoff,
        its prefill-side pages), its table row, its heat session."""
        slot = self.slots[slot_i]
        if self._heat_decode is not None:
            self._heat_decode.session_end(now, slot_i)
        self.allocator.free(slot.pages)
        if slot.prefill_pages:
            self.prefill_set.allocator.free(slot.prefill_pages)
        self.table.clear(slot_i)
        self.slots[slot_i] = _Slot()

    def _retry_or_fail(self, req: Request, why: str, now: float) -> None:
        """Re-queue with exponential backoff (``serving.retry_max`` retries,
        the first after ``serving.retry_backoff_s``; generation restarts
        from scratch), or fail terminally, a request whose slot and pages
        are already reclaimed. Makes no allocator call."""
        retry_max = int(self.config.retry_max)
        if not self._draining and req.retries < retry_max:
            req.retries += 1
            req.stall_after = None  # the injected fault is one-shot
            req.tokens = []
            # the retry regenerates: drop the drafter index over the
            # discarded output, and the emission / admission timeline (queue
            # wait and TPOT are measured again from the re-admission)
            req.draft_state = None
            req.margins = []
            req.status = RequestStatus.QUEUED
            req.t_first_token = None
            req.t_admit = None
            req.t_requeue = now
            req.t_emissions = []
            req.not_before = now + float(self.config.retry_backoff_s) * (2 ** (req.retries - 1))
            req.detail = f"retry {req.retries}/{retry_max}: {why}"
            self._c_retries.inc()
            self._backoff_pending = True
            if self.tracer is not None:
                self.tracer.event(req, "retry", now, cause=why, retries=req.retries,
                                  not_before=req.not_before)
            self.queue.append(req)
            self._g_queue.set(len(self.queue))
        else:
            req.status = RequestStatus.FAILED
            req.detail = why if req.retries == 0 else f"{why} (retry budget {retry_max} spent)"
            req.t_finish = now
            self._c_requests.inc(status=RequestStatus.FAILED)
            self._req_terminal(req, now)

    def _slo_verdict(self, req: Request) -> Optional[dict]:
        """The request's SLO outcome against its class's targets, or None
        when no SLO accounting applies (no classes, or a class without
        targets). Only a FINISHED request can meet; a request without a
        TPOT (< 2 tokens) passes that axis."""
        if not self._slo_enabled:
            return None
        t = self._slo.targets(req.slo_class)
        if t["ttft_target_s"] <= 0 and t["tpot_target_s"] <= 0:
            return None
        met = req.status == RequestStatus.FINISHED
        if met and t["ttft_target_s"] > 0:
            met = req.ttft_s is not None and req.ttft_s <= t["ttft_target_s"]
        if met and t["tpot_target_s"] > 0:
            tp = req.tpot_s
            met = tp is None or tp <= t["tpot_target_s"]
        return {"class": req.slo_class, **t, "met": bool(met)}

    def _req_terminal(self, req: Request, now: float) -> None:
        """Every terminal transition funnels here: the engine's status
        counts, the SLO verdict and goodput ledger, the tenant accounting
        and the trace record (``req.t_finish`` is already set)."""
        self._status_counts[req.status] = self._status_counts.get(req.status, 0) + 1
        self._t_last_finish = now
        verdict = self._slo_verdict(req)
        if verdict is not None:
            cnt = self._slo_counts.setdefault(req.slo_class, [0, 0])
            cnt[1] += 1
            self._c_slo_eval.inc(slo_class=req.slo_class)
            if verdict["met"]:
                cnt[0] += 1
                self._slo_good_tokens += len(req.tokens)
                self._c_slo_met.inc(slo_class=req.slo_class)
                if req.tokens:
                    self._c_good_tokens.inc(len(req.tokens))
                    if self._goodput_window_s > 0.0:
                        self._good_events.append((now, len(req.tokens)))
            self._g_slo.set(cnt[0] / cnt[1], slo_class=req.slo_class)
        ten = self.tenants.setdefault(req.tenant, {
            "requests": 0, "tokens": 0, "slo_met": 0, "slo_evaluated": 0,
        })
        ten["requests"] += 1
        ten["tokens"] += len(req.tokens)
        if verdict is not None:
            ten["slo_evaluated"] += 1
            ten["slo_met"] += int(verdict["met"])
        self._c_tenant_requests.inc(tenant=req.tenant, status=req.status)
        if req.tokens:
            self._c_tenant_tokens.inc(len(req.tokens), tenant=req.tenant)
        if self.tracer is not None:
            self.tracer.finish(req, req.t_finish if req.t_finish is not None else now,
                               slo=verdict)
        self.completed.append(req)

    def drain(self, deadline_s: Optional[float] = None) -> dict:
        """Graceful shutdown: stop admission, let in-flight requests finish
        inside the deadline (``serving.drain_deadline_s`` by default), then
        evict what remains as PREEMPTED. Queued requests are preempted at
        once. Every slot is empty and every page free when this returns.
        Terminal for this engine: ``submit`` afterwards rejects."""
        self._draining = True
        start = self.clock()
        deadline = start + float(
            self.config.drain_deadline_s if deadline_s is None else deadline_s
        )
        preempted = 0
        while self.queue:
            req = self.queue.popleft()
            req.status = RequestStatus.PREEMPTED
            req.detail = "drained before admission"
            req.t_finish = start
            self._c_requests.inc(status=RequestStatus.PREEMPTED)
            self._c_drained.inc()
            self._req_terminal(req, start)
            preempted += 1
        finished = 0
        while any(s.request is not None for s in self.slots) and self.clock() < deadline:
            before = sum(1 for s in self.slots if s.request is not None)
            after = self.step()
            finished += before - after
        now = self.clock()
        deadline_hit = False
        for i, s in enumerate(self.slots):
            if s.request is not None:
                deadline_hit = True
                self._c_drained.inc()
                self._finish_slot(i, RequestStatus.PREEMPTED, "drained at deadline", now)
                preempted += 1
        self._g_queue.set(0)
        self._g_util.set(0.0)
        self._g_pages.set(self.allocator.pages_in_use)
        if self.tiering is not None:
            # land every in-flight spill before callers audit the tiers
            self.tiering.flush()
        if self.tracer is not None:
            # every request is terminal now: make the records durable
            self.tracer.flush()
        log_dist(
            f"serving drain complete in {now - start:.3f}s: "
            f"{finished} finished in-flight, {preempted} preempted"
        )
        return {
            "duration_s": now - start,
            "finished_in_flight": finished,
            "preempted": preempted,
            "deadline_hit": deadline_hit,
        }

    def run(self, max_steps: Optional[int] = None) -> List[Request]:
        """Drive :meth:`step` until queue and slots drain; returns every
        request completed during the run (in completion order). The default
        step budget covers the worst case, so running out of it is a
        scheduler bug: raise rather than wedge."""
        if max_steps is None:
            budget = sum(r.max_new_tokens for r in self.queue) + sum(
                s.request.max_new_tokens for s in self.slots if s.request is not None
            )
            n_reqs = len(self.queue) + sum(1 for s in self.slots if s.request is not None)
            # chunked prefill takes steps without emitting tokens
            chunks_per_req = (
                -(-self.prefill_width // self.chunk_width) if self.chunk_width else 0
            )
            max_steps = 2 * budget + n_reqs * chunks_per_req + len(self.queue) + 16
        start = len(self.completed)
        for _ in range(max_steps):
            if not self.queue and all(s.request is None for s in self.slots):
                break
            self.step()
        else:
            raise RuntimeError(
                f"ServingEngine.run: no drain within {max_steps} steps "
                f"(queue={len(self.queue)}, "
                f"active={sum(1 for s in self.slots if s.request)})"
            )
        return self.completed[start:]

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """The JAX engine's ``stats()``: p50/p95/p99, mean and count of
        TTFT, TPOT (inter-token gaps), decode-step latency and queue wait,
        estimated from the histograms (the ``histogram_quantile``
        interpolation over ``LATENCY_BUCKETS``, so a quantile is as fine as
        its bucket), current load, the SLO and tenant accounting, the
        tracers' and journal's health and the feature counters; refreshes
        the ``serving_latency_quantile_seconds{metric,q}`` gauges, the
        goodput gauge, the heat gauges and the ``hbm_*`` gauges (the card's
        allocator counters; no synchronisation). Keys of features not ported
        read as the JAX engine's with the feature off. Beside them, this
        engine's own: ``prefills``, ``timeout_evictions``,
        ``decode_tokens_per_s`` (tokens over the summed decode-step clock
        spans, each ending in the step's token read) and ``tokens_per_s``
        (over first submit → last finish). :func:`exact_percentiles` gives
        exact quantiles over a set of requests."""
        out: dict = {}
        for name, hist in (
            ("ttft", self._h_ttft), ("tpot", self._h_tpot),
            ("decode_step", self._h_step), ("queue_wait", self._h_qwait),
        ):
            total, n = hist.stats()
            entry = {"count": n, "mean_s": (total / n) if n else None}
            for q, label in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                v = hist.quantile(q)
                entry[f"{label}_s"] = v
                if v is not None:
                    self._g_quant.set(v, metric=name, q=label)
            out[name] = entry
        out["queue_depth"] = len(self.queue)
        out["active_slots"] = sum(1 for s in self.slots if s.request is not None)
        out["kv_pages_in_use"] = self.allocator.pages_in_use
        out["completed"] = len(self.completed)
        out["decode_steps"] = self._step_count
        out["stragglers"] = int(self._c_stragglers.value())
        out["drained"] = int(self._c_drained.value())
        out["retried"] = int(self._c_retries.value())
        out["draining"] = self._draining
        out["by_status"] = dict(self._status_counts)
        # a report, not a decision: no collective, so one rank may ask alone
        now = self._trace_clock()
        if self._slo_enabled and self._t_first_submit is not None:
            windowed, cumulative = self._goodput_now(now)
            self._g_goodput.set(windowed)
            out["slo"] = {
                "goodput_tokens_per_sec": windowed,
                "goodput_cumulative_tokens_per_sec": cumulative,
                "goodput_window_s": self._goodput_window_s,
                "classes": {
                    cls: {"met": met, "evaluated": ev,
                          "attainment": (met / ev) if ev else None}
                    for cls, (met, ev) in sorted(self._slo_counts.items())
                },
            }
        if self.tenants:
            out["tenants"] = {t: dict(v) for t, v in sorted(self.tenants.items())}
        if self.tracer is not None:
            out["request_trace"] = {
                "path": self.tracer.file_path,
                "records": self.tracer.records_emitted,
                "live": self.tracer.live_requests,
                "rotations": self.tracer.rotations,
                "events_dropped": self.tracer.events_dropped,
                "records_lost": self.tracer.records_lost,
            }
            if self.tracer.encode_error is not None:
                out["request_trace"]["encode_error"] = self.tracer.encode_error
        out["host_metadata"] = self.host_metadata_breakdown()
        if self._heat is not None:
            self._heat.refresh_gauges(now)
            out["kv_heat"] = {
                "path": self._heat.file_path,
                "records": self._heat.records_emitted,
                "rotations": self._heat.rotations,
                "records_lost": self._heat.records_lost,
                "ledger_bytes": self._heat.ledger_bytes(),
                "pools": {name: led.occupancy(now, self._heat.idle_thresholds_s)
                          for name, led in self._heat.ledgers.items()},
            }
            if self._heat.encode_error is not None:
                out["kv_heat"]["encode_error"] = self._heat.encode_error
        if self._journal is not None:
            out["timeseries"] = {
                "path": self._journal.file_path,
                "snapshots": self._journal.snapshots,
                "records": self._journal.records_emitted,
                "rotations": self._journal.rotations,
                "last_t": self._journal.last_t,
            }
            if self._journal.encode_error is not None:
                out["timeseries"]["encode_error"] = self._journal.encode_error
        out["kv_pages_shared"] = self.allocator.pages_shared
        out["kv_cow_forks"] = self.allocator.cow_forks_total
        out["kv_cache_dtype"] = str(self.cache_dtype).replace("torch.", "")
        out["kv_pool_bytes"] = self.kv_pool_bytes
        out["kv_scales_bytes"] = self.kv_scales_bytes
        # where the programs run and what each rank holds (JAX
        # scheduler.py:2873-2898): per-rank pool bytes drop 1/tp
        psets = {self.decode_placement.name: self.decode_set,
                 self.prefill_placement.name: self.prefill_set}
        out["placement"] = {
            "tp": self.tp,
            "disaggregated": self.disaggregated,
            "placements": {
                name: {
                    "tp": ps.placement.tp,
                    "devices": [self._rank_devices[r] for r in ps.placement.ranks],
                    "num_pages": ps.num_pages,
                    "pages_in_use": ps.allocator.pages_in_use,
                    "per_device_pool_bytes": ps.local_pool_bytes(),
                    "per_device_scales_bytes": ps.local_scales_bytes(),
                }
                for name, ps in psets.items()
            },
        }
        if self.disaggregated:
            out["kv_handoffs"] = int(self._c_handoffs.value())
            out["kv_handoff_bytes"] = int(self._c_handoff_bytes.value())
            total, n = self._h_handoff.stats()
            out["kv_handoff_latency_mean_s"] = (total / n) if n else None
        out["chunk_prefills"] = int(self._c_chunks.value())
        if self.prefix_cache is not None:
            pc = self.prefix_cache
            lookups = pc.hits_full + pc.hits_partial + pc.misses
            out["prefix_index_pages"] = len(pc)
            out["prefix_hits_full"] = pc.hits_full
            out["prefix_hits_partial"] = pc.hits_partial
            out["prefix_misses"] = pc.misses
            out["prefix_evictions"] = pc.evictions
            out["prefix_hit_rate"] = (
                (pc.hits_full + pc.hits_partial) / lookups if lookups else None)
            out["prefix_host_metadata_bytes"] = pc.host_metadata_bytes()
            out["prefix_demotions"] = pc.demotions
            out["prefix_adoptions"] = pc.adoptions
        if self.tiering is not None:
            out["kv_tiering"] = {"enabled": True, **self.tiering.stats()}
        if self.spec_enabled:
            total, n = self._h_accept.stats()
            out["spec_steps"] = int(self._c_spec_steps.value())
            out["spec_drafted"] = int(self._c_spec_drafted.value())
            out["spec_accepted"] = int(self._c_spec_accepted.value())
            out["spec_accept_len_mean"] = (total / n) if n else None
        # this engine's own rates and counts
        span = (self._t_last_finish - self._t_first_submit
                if self._t_first_submit is not None and self._t_last_finish is not None
                else 0.0)
        tokens = sum(len(r.tokens) for r in self.completed)
        decode_s, _ = self._h_step.stats()
        out["prefills"] = int(self._c_prefills.value())
        out["timeout_evictions"] = int(self._c_timeouts.value())
        out["decode_tokens_per_s"] = (self._decode_tokens / decode_s
                                      if decode_s > 0 else None)
        out["tokens_per_s"] = tokens / span if span > 0 else None
        for k, v in device_hbm_stats(self.device).items():
            self.metrics.gauge(f"hbm_{k}", "device 0 HBM (memory_stats)").set(v)
        return out

    # ------------------------------------------------------------------
    # live session migration (the fleet's hooks; JAX scheduler.py:2302-2490)
    # ------------------------------------------------------------------
    def export_session(self, slot_i: int):
        """Slot ``slot_i``'s live decode session for migration →
        ``(state, arrays)``: the JSON-able request and slot state, and the
        page row gathered by ``serving_kv_gather`` as CPU tensors
        (``k_pages``, ``v_pages``, ``kv_scales`` with int8 pages) plus the
        sampling keys (``keys``, uint32 ``[max_new_tokens - 1, 2]``), the
        JAX engine's names, shapes and dtypes. The slot is untouched: pair
        with :meth:`release_slot` once the payload is written."""
        slot = self.slots[slot_i]
        req = slot.request
        if req is None:
            raise ValueError(f"slot {slot_i} is empty")
        if slot.prefilling:
            raise ValueError(
                f"slot {slot_i} is still prefilling — nothing emitted yet; "
                "requeue it instead of migrating"
            )
        self._refuse_migration_across_ranks()
        self._ensure_migration_programs()
        n = len(slot.pages)
        ids = self._migrate_gather.inputs.staging()["ids"]
        ids[:] = 0
        ids[:n] = slot.pages
        self._migrate_gather()
        # the export's one device read: host copies of the row buffers,
        # which the next gather rewrites
        packed = [row.to("cpu", copy=True) for row in self._migrate_rows]
        arrays = {"k_pages": packed[0], "v_pages": packed[1]}
        if self.pset.scales is not None:
            arrays["kv_scales"] = packed[2]
        if slot.keys is not None:
            arrays["keys"] = np.asarray(slot.keys, np.uint32)
        state = {
            "kind": "migration",
            "id": int(req.id),
            "prompt": [int(t) for t in req.prompt_list],
            "tokens": [int(t) for t in req.tokens],
            "seed": int(req.seed),
            "max_new_tokens": int(req.max_new_tokens),
            "requested_new_tokens": req.requested_new_tokens,
            "eos_token_id": req.eos_token_id,
            "deadline_s": req.deadline_s,
            "retries": int(req.retries),
            "tenant": req.tenant,
            "slo_class": req.slo_class,
            "prefix_shared_tokens": int(req.prefix_shared_tokens),
            "cow_forked": bool(req.cow_forked),
            "t_submit": req.t_submit,
            "t_admit": req.t_admit,
            "t_requeue": req.t_requeue,
            "t_first_token": req.t_first_token,
            "t_emissions": [float(t) for t in req.t_emissions],
            "pos": int(slot.pos),
            "step": int(slot.step),
            "n_pages": n,
            "last_token": int(self.table.tokens[slot_i]),
        }
        return state, arrays

    def release_slot(self, slot_i: int, now: Optional[float] = None) -> Request:
        """Free a migrated-out session's slot WITHOUT terminal accounting:
        pages back to the allocator, table row cleared, the request handed
        back still RUNNING (it finishes on the peer). This engine can never
        emit for the session again."""
        slot = self.slots[slot_i]
        req = slot.request
        if req is None:
            raise ValueError(f"slot {slot_i} is empty")
        if now is None:
            now = self.clock()
        self._release(slot_i, now)
        return req

    def adopt_session(self, state: dict, arrays: dict, request: Optional[Request] = None):
        """Rebuild a migrated decode session from a validated payload: a
        private page row, the KV written by ``serving_kv_scatter``, and
        decoding resumes where the source stopped (the drafter's index
        rebuilds from prompt + tokens; the sampling keys ride the payload).
        → the live request, or None when this engine cannot host it (no
        free slot or pages; the router requeues elsewhere). ``request``
        re-binds the caller's handle; without it the request is rebuilt
        from ``state`` (a payload from another process or package).
        ``arrays`` may hold numpy arrays or CPU tensors."""
        if self._draining:
            return None
        slot_i = next((i for i, s in enumerate(self.slots) if s.request is None), None)
        if slot_i is None:
            return None
        n = int(state["n_pages"])
        if n > self.pages_per_slot:
            raise ValueError(
                f"migration payload needs {n} pages/slot, this engine "
                f"holds {self.pages_per_slot}"
            )
        self._refuse_migration_across_ranks()
        self._ensure_migration_programs()
        names = ("k_pages", "v_pages") + (("kv_scales",) if self.pset.scales is not None else ())
        payload = [torch.as_tensor(arrays[name]) for name in names]
        for name, src, row in zip(names, payload, self._migrate_rows):
            if tuple(src.shape) != tuple(row.shape) or src.dtype != row.dtype:
                raise ValueError(
                    f"migration payload {name} is {tuple(src.shape)} {src.dtype}, this "
                    f"engine's row is {tuple(row.shape)} {row.dtype}"
                )
        if n > self.allocator.free_pages and self.prefix_cache is not None:
            self.prefix_cache.evict(need_free=n)
            self._g_index_pages.set(len(self.prefix_cache))
        try:
            pages = self.allocator.alloc(n)
        except PageAllocatorError:
            return None
        if request is not None:
            req = request
            if int(req.id) != int(state["id"]):
                self.allocator.free(pages)
                raise ValueError(
                    f"migration payload id {state['id']} does not match "
                    f"request {req.id}"
                )
        else:
            req = Request(
                prompt=np.asarray(state["prompt"], np.int32),
                max_new_tokens=int(state["max_new_tokens"]),
                seed=int(state["seed"]),
                eos_token_id=state["eos_token_id"],
                deadline_s=state["deadline_s"],
                tenant=state["tenant"],
                slo_class=state["slo_class"],
            )
            req.id = int(state["id"])
            req.requested_new_tokens = state["requested_new_tokens"]
            req.retries = int(state["retries"])
            req.prefix_shared_tokens = int(state["prefix_shared_tokens"])
            req.cow_forked = bool(state["cow_forked"])
            req.t_submit = state["t_submit"]
            req.t_admit = state["t_admit"]
            req.t_requeue = state["t_requeue"]
            req.t_first_token = state["t_first_token"]
        req.tokens = [int(t) for t in state["tokens"]]
        req.t_emissions = [float(t) for t in state["t_emissions"]]
        req.status = RequestStatus.RUNNING
        req.draft_state = None
        dst = self._migrate_scatter.inputs.staging()["dst"]
        dst[:] = 0
        dst[:n] = pages
        for src, row in zip(payload, self._migrate_rows):
            row.copy_(src)
        self._migrate_scatter()
        slot = self.slots[slot_i]
        slot.request = req
        slot.pages = list(pages)
        slot.pos = int(state["pos"])
        slot.step = int(state["step"])
        slot.prefilling = False
        keys = arrays.get("keys")
        if keys is not None:
            slot.keys = np.asarray(keys, np.uint32)
        self.table.assign(slot_i, slot.pages)
        self.table.seq_lens[slot_i] = slot.pos
        self.table.tokens[slot_i] = int(state["last_token"])
        if slot.keys is not None and slot.step < len(slot.keys):
            self.table.keys[slot_i] = slot.keys[slot.step]
        return req

    def _refuse_migration_across_ranks(self) -> None:
        """A migration payload holds every KV head of a page row; an engine
        over several ranks holds its heads spread over them (ROADMAP queue
        1 item 11c: the fleet over placements)."""
        if self._spmd:
            raise NotPortedError(
                "live session migration of an engine over several ranks "
                "(serving.placement tp > 1 or disaggregate) is not ported to "
                "deepspeed_tpu_torch yet (ROADMAP queue 1 item 11c)")

    def takeover_queue(self) -> List[Request]:
        """Hand the whole waiting queue to the caller (the router reroutes
        a draining replica's backlog). The requests stay QUEUED; this
        engine forgets them."""
        out = list(self.queue)
        self.queue.clear()
        self._g_queue.set(0)
        return out

    def adopt_request(self, req: Request) -> bool:
        """Enqueue a request rerouted from a peer replica (validated at its
        original submit; only the live gates apply). False = this engine
        cannot take it (draining, or the queue is full)."""
        if self._draining:
            return False
        if len(self.queue) >= int(self.config.max_queue_depth):
            return False
        self.queue.append(req)
        self._g_queue.set(len(self.queue))
        return True

    def release_prefix_cache(self) -> int:
        """Drop every prefix-index reference (teardown, tests): afterwards a
        drained engine's allocator is fully free. → pages released."""
        if self.prefix_cache is None:
            return 0
        n = self.prefix_cache.clear()
        self._g_index_pages.set(len(self.prefix_cache))
        self._g_pages_shared.set(self.allocator.pages_shared)
        return n

    def check_no_leaks(self) -> None:
        """Drain invariant: every page either back on the free list or held
        by exactly the prefix index (refcount 1), every slot empty, every
        block-table entry pointing at scratch; with the host tier, the
        store, the heat ledger's handles and the index reconcile. Under
        disaggregation the index lives on the PREFILL allocator and the
        decode pool drains completely (a page left there is a leaked
        handoff reservation)."""
        held = self.prefix_cache.held_pages if self.prefix_cache is not None else None
        if self.disaggregated:
            self.prefill_set.allocator.check_no_leaks(allowed=held)
            self.decode_set.allocator.check_no_leaks(allowed=None)
        else:
            self.allocator.check_no_leaks(allowed=held)
        assert all(s.request is None for s in self.slots)
        assert all(not s.prefill_pages for s in self.slots)
        assert (self.table.block_tables == 0).all()
        assert (self.table.seq_lens == 0).all()
        if self.tiering is not None:
            # the host tier: internally consistent, agreeing with the heat
            # ledger's handles, and never holding a key the device index
            # also holds (exactly one tier)
            self.tiering.flush()
            err = self.tiering.check_consistent(self.prefix_cache)
            assert err is None, f"host tier inconsistent at drain: {err}"
