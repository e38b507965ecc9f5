"""Continuous-batching scheduler: slot-based decode over the paged KV pool
(counterpart of ``deepspeed_tpu/serving/scheduler.py`` on its default path).

A fixed array of ``max_slots`` decode slots advances one token per step
through ONE batched decode step, while finished sequences vacate their slot
mid-flight and queued requests are admitted into free slots by a prefill
insertion. Inactive slots ride along in the decode batch pointed at the
scratch page; every op is row-independent, so active slots are unaffected.

Robustness: admission control (queue depth, KV-page budget) rejects at the
door; per-request deadlines evict mid-flight to a TRUNCATED response; an
over-long ask is clamped at submit; :meth:`drain` stops admission, finishes
in-flight work up to a deadline and preempts the rest. A stuck request can
never wedge the batch.

Single-threaded by design: ``submit``/``step``/``drain``/``stats`` mutate
the queue, slots and counters without a lock and must run on one thread.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional

import numpy as np
import torch

from ..models.gpt2 import GPT2Config
from ..runtime.config import ServingConfig
from ..utils.logging import log_dist
from . import model as smodel
from .kv_cache import SlotTable, pages_for, pool_bytes
from .placement import ProgramSet
from .request import Request, RequestStatus

_CACHE_DTYPES = {
    "bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32,
}


@dataclass
class _Slot:
    request: Optional[Request] = None
    pages: List[int] = field(default_factory=list)
    pos: int = 0    # tokens currently in this slot's cache
    generator: Optional[torch.Generator] = None  # sampling draws (temperature > 0)


def _top2_margin(logits: torch.Tensor) -> np.ndarray:
    top2 = torch.topk(logits.float(), 2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).cpu().numpy()


class ServingEngine:
    """Continuous-batching front end over an
    :class:`~deepspeed_tpu_torch.inference.engine.InferenceEngine`.

    Construct via ``InferenceEngine.serve()`` (or directly); drive with
    :meth:`submit` + :meth:`step`, or :meth:`run` to drain. ``clock`` is
    injectable for deterministic timeout tests. ``track_margins`` records,
    for every emitted token, the top-1 minus top-2 logit of its step in
    ``Request.margins`` (one extra top-2 reduction and device read per
    step)."""

    def __init__(self, engine, config=None, clock=time.monotonic,
                 track_margins: bool = False):
        if config is None:
            config = ServingConfig()
        elif isinstance(config, dict):
            config = ServingConfig.from_dict(config)
        self.config = config
        self.clock = clock
        self.track_margins = bool(track_margins)
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
        self.pset = ProgramSet(
            mcfg, int(config.num_pages), page, self.cache_dtype, engine.params,
            self.device,
        )
        if self.pages_per_slot > self.allocator.capacity:
            raise ValueError(
                f"serving.num_pages={config.num_pages} cannot hold even one "
                f"max-size request ({self.pages_per_slot} pages of {page} "
                "tokens; page 0 is scratch)"
            )
        self.table = SlotTable(self.max_slots, self.pages_per_slot)
        self.slots: List[_Slot] = [_Slot() for _ in range(self.max_slots)]
        self.queue: Deque[Request] = deque()
        self.completed: List[Request] = []
        self._sampling = float(config.temperature) > 0.0
        self._draining = False

        self._status_counts: dict = {}
        self._step_count = 0
        self._prefills = 0
        self._timeouts = 0
        self._decode_tokens = 0
        self._decode_seconds = 0.0
        self._t_first_submit: Optional[float] = None
        self._t_last_finish: Optional[float] = None
        pool_mb = pool_bytes(
            mcfg.n_layer, int(config.num_pages), mcfg.n_head, page, mcfg.head_dim,
            self.pset.k_pool.element_size(),
        ) / 1e6
        log_dist(
            f"ServingEngine: slots={self.max_slots} page={page} "
            f"pages={config.num_pages} (pool {pool_mb:.1f} MB) "
            f"prefill_width={self.prefill_width} "
            f"dtype={str(self.cache_dtype).replace('torch.', '')} device={self.device}"
        )

    @property
    def allocator(self):
        return self.pset.allocator

    # ------------------------------------------------------------------
    # admission control
    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None, seed: int = 0,
               eos_token_id: Optional[int] = None,
               deadline_s: Optional[float] = None) -> Request:
        """Enqueue one request. Backpressure REJECTS at the door (queue
        depth, or a prompt that can never fit); an over-long
        ``max_new_tokens`` is clamped and the response marked TRUNCATED at
        finish."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        mnt = int(self.config.max_new_tokens if max_new_tokens is None else max_new_tokens)
        req = Request(prompt=prompt, max_new_tokens=mnt, seed=int(seed),
                      eos_token_id=eos_token_id, deadline_s=deadline_s)
        req.t_submit = self.clock()
        if self._t_first_submit is None:
            self._t_first_submit = req.t_submit
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
            return self._reject(req, "engine draining (admission stopped)")
        if len(self.queue) >= int(self.config.max_queue_depth):
            return self._reject(req, f"queue full ({self.config.max_queue_depth})")
        self.queue.append(req)
        return req

    def _reject(self, req: Request, why: str) -> Request:
        req.status = RequestStatus.REJECTED
        req.detail = why
        req.t_finish = self.clock()
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
        requests into free slots (prefill insertion), advance every active
        slot one token. Returns the number of active slots after the step."""
        now = self.clock()

        # 1. timeout eviction: a request past its deadline degrades to a
        # truncated response; its slot and pages are reclaimed immediately
        for i, slot in enumerate(self.slots):
            if slot.request is None:
                continue
            dl = self._deadline(slot.request)
            if dl is not None and now > dl:
                self._timeouts += 1
                self._finish_slot(i, RequestStatus.TRUNCATED, "deadline exceeded", now)
        if self.queue:
            keep: Deque[Request] = deque()
            for req in self.queue:
                dl = self._deadline(req)
                if dl is not None and now > dl:
                    req.status = RequestStatus.TIMED_OUT
                    req.detail = "deadline exceeded while queued"
                    req.t_finish = now
                    self._req_terminal(req, now)
                else:
                    keep.append(req)
            self.queue = keep

        # 2. prefill insertions: FIFO admission into free slots, gated by the
        # KV-page budget (the head of line blocks until finishing slots free
        # pages). A drain stops admission.
        while self.queue and not self._draining:
            free = next((i for i, s in enumerate(self.slots) if s.request is None), None)
            if free is None:
                break
            req = self.queue[0]
            if self._pages_needed(req) > self.allocator.free_pages:
                break
            self.queue.popleft()
            self._admit(free, req)

        # 3. one batched decode step for every active slot
        active = [i for i, s in enumerate(self.slots) if s.request is not None]
        if active:
            t0 = self.clock()
            pset = self.pset
            dev = self.device
            gens = [s.generator for s in self.slots] if self._sampling else None
            out = smodel.paged_decode_step(
                self.model_config, pset.params,
                torch.from_numpy(self.table.tokens).to(dev),
                torch.from_numpy(self.table.seq_lens).to(dev),
                pset.k_pool, pset.v_pool,
                torch.from_numpy(self.table.block_tables).to(dev),
                generators=gens,
                temperature=float(self.config.temperature),
                top_k=int(self.config.top_k), top_p=float(self.config.top_p),
                return_logits=self.track_margins,
            )
            nxt, logits = out if self.track_margins else (out, None)
            # the one deliberate sync of the slot loop: the scheduler must
            # read the sampled tokens to retire or advance slots
            out_np = nxt.cpu().numpy()
            margins = _top2_margin(logits) if logits is not None else None
            now = self.clock()
            self._step_count += 1
            self._decode_seconds += now - t0
            self._decode_tokens += len(active)
            for i in active:
                slot = self.slots[i]
                req = slot.request
                tok = int(out_np[i])
                req.tokens.append(tok)
                if margins is not None:
                    req.margins.append(float(margins[i]))
                slot.pos += 1
                self.table.seq_lens[i] = slot.pos
                self.table.tokens[i] = tok
                if len(req.tokens) >= req.max_new_tokens or (
                    req.eos_token_id is not None and tok == req.eos_token_id
                ):
                    self._finish_slot(i, RequestStatus.FINISHED, "", now)

        return sum(1 for s in self.slots if s.request is not None)

    def _pages_needed(self, req: Request) -> int:
        """Pages an admission allocates: the request's full reservation."""
        return pages_for(req.prompt_len + req.max_new_tokens, self.page_size)

    def _admit(self, slot_i: int, req: Request) -> None:
        pages = self.allocator.alloc(self._pages_needed(req))
        slot = self.slots[slot_i]
        slot.request = req
        slot.pages = pages
        slot.pos = 0
        slot.generator = (
            torch.Generator(device=self.device).manual_seed(req.seed)
            if self._sampling else None
        )
        self.table.assign(slot_i, pages)

        dev = self.device
        ids = np.zeros((1, self.prefill_width), np.int64)
        ids[0, : req.prompt_len] = req.prompt
        page_ids = self.table.block_tables[slot_i, : self.prefill_pages]
        pset = self.pset
        out = smodel.paged_prefill(
            self.model_config, pset.params, torch.from_numpy(ids).to(dev),
            req.prompt_len, pset.k_pool, pset.v_pool,
            torch.from_numpy(page_ids).to(dev), slot.generator,
            temperature=float(self.config.temperature),
            top_k=int(self.config.top_k), top_p=float(self.config.top_p),
            return_logits=self.track_margins,
        )
        first, logits = out if self.track_margins else (out, None)
        self._prefills += 1
        # deliberate sync: TTFT is defined by the first token reaching the
        # host, and an at-admission EOS must retire the slot before decode
        tok0 = int(first[0].item())
        if logits is not None:
            req.margins.append(float(_top2_margin(logits)[0]))
        self._start_decoding(slot_i, tok0)

    def _start_decoding(self, slot_i: int, tok0: int) -> None:
        """Post-prefill transition: record TTFT, arm the slot's decode row,
        and finish at once on an immediate EOS or a single-token ask."""
        slot = self.slots[slot_i]
        req = slot.request
        now = self.clock()
        req.status = RequestStatus.RUNNING
        req.t_first_token = now
        req.tokens.append(tok0)
        slot.pos = req.prompt_len
        self.table.seq_lens[slot_i] = slot.pos
        self.table.tokens[slot_i] = tok0
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
        self.allocator.free(slot.pages)
        self.table.clear(slot_i)
        self.slots[slot_i] = _Slot()
        self._req_terminal(req, now)

    def _req_terminal(self, req: Request, now: float) -> None:
        """Every terminal transition funnels here."""
        self._status_counts[req.status] = self._status_counts.get(req.status, 0) + 1
        self._t_last_finish = now
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
                self._finish_slot(i, RequestStatus.PREEMPTED, "drained at deadline", now)
                preempted += 1
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
            max_steps = 2 * budget + len(self.queue) + 16
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
        """Counts by terminal status, TTFT/TPOT quantiles over the completed
        requests, decode-step counts and rates, and current load. Times are
        on the engine's clock; rates divide host-clock spans that end in the
        step's token read (a device sync)."""
        def quantiles(vals):
            vals = [v for v in vals if v is not None]
            out = {"count": len(vals)}
            for q, label in ((50, "p50"), (95, "p95"), (99, "p99")):
                out[f"{label}_s"] = float(np.percentile(vals, q)) if vals else None
            return out

        done = self.completed
        tokens = sum(len(r.tokens) for r in done)
        span = (
            self._t_last_finish - self._t_first_submit
            if self._t_first_submit is not None and self._t_last_finish is not None
            else 0.0
        )
        return {
            "by_status": dict(self._status_counts),
            "ttft": quantiles(r.ttft_s for r in done),
            "tpot": quantiles(r.tpot_s for r in done),
            "queue_depth": len(self.queue),
            "active_slots": sum(1 for s in self.slots if s.request is not None),
            "kv_pages_in_use": self.allocator.pages_in_use,
            "completed": len(done),
            "prefills": self._prefills,
            "timeout_evictions": self._timeouts,
            "decode_steps": self._step_count,
            "decode_tokens_per_s": (
                self._decode_tokens / self._decode_seconds
                if self._decode_seconds > 0 else None
            ),
            "tokens_per_s": tokens / span if span > 0 else None,
        }

    def check_no_leaks(self) -> None:
        """Drain invariant: every page back on the free list, every slot
        empty, every block-table entry pointing at scratch."""
        self.allocator.check_no_leaks()
        assert all(s.request is None for s in self.slots)
        assert (self.table.block_tables == 0).all()
        assert (self.table.seq_lens == 0).all()
