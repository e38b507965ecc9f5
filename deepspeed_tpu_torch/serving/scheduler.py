"""Continuous-batching scheduler: slot-based decode over the paged KV pool
(counterpart of ``deepspeed_tpu/serving/scheduler.py`` without TP,
disaggregation, the host tier, retries and telemetry).

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
from ..ops import prng
from ..runtime.config import ServingConfig
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
from .placement import ProgramSet
from .request import Request, RequestStatus

_CACHE_DTYPES = {
    "bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32,
    "int8": torch.int8,
}


@dataclass
class _Slot:
    request: Optional[Request] = None
    pages: List[int] = field(default_factory=list)  # full row: shared + private
    pos: int = 0    # tokens currently in this slot's cache
    # the decode steps' keys (temperature > 0): [max_new_tokens - 1, 2]
    keys: Optional[np.ndarray] = None
    # True while the prompt prefills chunk by chunk; the main table row then
    # stays scratch (the batched decode must not touch this slot's real,
    # possibly shared, pages) and ``row`` carries the real block table
    prefilling: bool = False
    prefill_pos: int = 0               # prompt tokens prefilled so far
    row: Optional[np.ndarray] = None   # [1, pages_per_slot] real block table


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
        self.slots: List[_Slot] = [_Slot() for _ in range(self.max_slots)]
        self.queue: Deque[Request] = deque()
        self.completed: List[Request] = []
        self._sampling = float(config.temperature) > 0.0
        self._draining = False

        spec = config.speculative
        self.spec_enabled = bool(spec.enabled)
        self.spec_k = int(spec.k) if self.spec_enabled else 0
        self.spec_ngram = int(spec.ngram) if self.spec_enabled else 2
        if self.spec_enabled and self._sampling:
            raise ValueError("serving.speculative requires temperature == 0 (greedy)")
        pcfg = config.prefix_cache
        self.prefix_cache: Optional[PrefixCache] = (
            PrefixCache(self.allocator, page, max_pages=int(pcfg.max_pages))
            if pcfg.enabled else None
        )
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

        self._status_counts: dict = {}
        self._step_count = 0
        self._prefills = 0
        self._timeouts = 0
        self._decode_tokens = 0
        self._decode_seconds = 0.0
        self._chunks = 0
        self._spec_steps = 0
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._spec_emitted = 0  # tokens emitted by verify steps (accept lengths summed)
        self._spec_runs = 0     # slot-steps of verify (accept lengths counted)
        self._t_first_submit: Optional[float] = None
        self._t_last_finish: Optional[float] = None
        quantized = self.pset.scales is not None
        self.kv_pool_bytes = pool_bytes(
            mcfg.n_layer, int(config.num_pages), mcfg.n_head, page, mcfg.head_dim,
            self.pset.k_pool.element_size(),
        )
        self.kv_scales_bytes = (
            scales_bytes(mcfg.n_layer, int(config.num_pages), mcfg.n_head)
            if quantized else 0
        )
        log_dist(
            f"ServingEngine: slots={self.max_slots} page={page} "
            f"pages={config.num_pages} (pool {self.kv_pool_bytes / 1e6:.1f} MB"
            + (f" + {self.kv_scales_bytes / 1e6:.2f} MB scales" if quantized else "")
            + ") "
            f"prefill_width={self.prefill_width} chunk_width={self.chunk_width} "
            f"spec_k={self.spec_k} prefix_cache={self.prefix_cache is not None} "
            f"dtype={str(self.cache_dtype).replace('torch.', '')} device={self.device}"
        )

    # ------------------------------------------------------------------
    # the programs: a fixed, config-derived set, captured on the card
    # ------------------------------------------------------------------
    def _build_programs(self) -> None:
        """The prefill, the decode or verify step and (with chunks) the
        chunk program, each over its static inputs → ``executables``; the
        slot table lives in the decode-shaped program's staging arrays."""
        mcfg, pset, dev = self.model_config, self.pset, self.device
        S, pps = self.max_slots, self.pages_per_slot
        sample = dict(temperature=float(self.config.temperature),
                      top_k=int(self.config.top_k), top_p=float(self.config.top_p))
        common = dict(return_logits=self.track_margins, scales=pset.scales)
        sampling = self._sampling
        sfx = "_int8" if pset.scales is not None else ""

        def program(name, shapes, fn):
            inputs = StaticInputs(shapes, dev)

            def step():
                with torch.no_grad():
                    return fn(inputs.dev)

            return CapturedProgram(name + sfx, step, dev, inputs)

        self._prefill_prog = program(
            "serving_prefill",
            {"ids": (1, self.prefill_width), "plen": (1,), "page_ids": (self.prefill_pages,),
             "key": (2,)},
            lambda x: smodel.paged_prefill(
                mcfg, pset.params, x["ids"], x["plen"], pset.k_pool, pset.v_pool,
                x["page_ids"], x["key"] if sampling else None, **sample, **common))
        self.executables: List[CapturedProgram] = [self._prefill_prog]
        if self.spec_enabled:
            self._step_prog = program(
                "serving_verify",
                {"tokens": (S, self.spec_k + 1), "seq_lens": (S,), "block_tables": (S, pps)},
                lambda x: smodel.paged_verify_step(
                    mcfg, pset.params, x["tokens"], x["seq_lens"], pset.k_pool, pset.v_pool,
                    x["block_tables"], **common))
        else:
            self._step_prog = program(
                "serving_decode",
                {"tokens": (S,), "seq_lens": (S,), "block_tables": (S, pps), "keys": (S, 2)},
                lambda x: smodel.paged_decode_step(
                    mcfg, pset.params, x["tokens"], x["seq_lens"], pset.k_pool, pset.v_pool,
                    x["block_tables"], x["keys"] if sampling else None, **sample, **common))
        self.executables.append(self._step_prog)
        staged = self._step_prog.inputs.staging()
        self.table = SlotTable(S, pps, staging={
            k: v for k, v in staged.items() if not (self.spec_enabled and k == "tokens")})
        self._chunk_prog = None
        if self.chunk_width > 0:
            C = self.chunk_width
            self._chunk_prog = program(
                "serving_chunk_prefill",
                {"ids": (1, C), "start": (1,), "plen": (1,), "page_ids": (C // self.page_size,),
                 "row": (1, pps), "key": (2,)},
                lambda x: smodel.paged_chunk_prefill(
                    mcfg, pset.params, x["ids"], x["start"], x["plen"], pset.k_pool,
                    pset.v_pool, x["page_ids"], x["row"], x["key"] if sampling else None,
                    **sample, **common))
            self.executables.append(self._chunk_prog)

    @property
    def expected_executables(self) -> int:
        """The static-shapes contract of the JAX engine over the ported
        features: one prefill program, ONE decode-shaped program (verify
        replaces decode) and the chunk program when chunking or the prefix
        cache needs it (disaggregation and the host tier are not ported:
        the config refuses them)."""
        return 2 + (1 if self.chunk_width > 0 else 0)

    @property
    def allocator(self):
        return self.pset.allocator

    @property
    def k_pool(self):
        return self.pset.k_pool

    @property
    def v_pool(self):
        return self.pset.v_pool

    @property
    def kv_scales(self):
        """The int8 pool's ``[L, P, KV, 2]`` scales (None otherwise)."""
        return self.pset.scales

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
        # KV-page budget net of the prefix-index pages the prompt can map
        # (the head of line blocks until finishing slots free pages). Under
        # pool pressure the index yields cold entries first, and the need is
        # re-probed: the eviction may have dropped pages the probe counted.
        # A drain stops admission.
        while self.queue and not self._draining:
            free = next((i for i, s in enumerate(self.slots) if s.request is None), None)
            if free is None:
                break
            req = self.queue[0]
            need = self._pages_needed(req)
            if need > self.allocator.free_pages:
                if self.prefix_cache is not None and len(self.prefix_cache):
                    self.prefix_cache.evict(need_free=need)
                    need = self._pages_needed(req)
                if need > self.allocator.free_pages:
                    break
            self.queue.popleft()
            self._admit(free, req)

        # 2b. chunked prefill: every prefilling slot advances one chunk, and
        # the decode batch below still runs
        for i, slot in enumerate(self.slots):
            if slot.request is not None and slot.prefilling:
                self._advance_chunk(i)

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
            self._decode_seconds += now - t0
            for i, toks in emitted:
                slot = self.slots[i]
                req = slot.request
                req.tokens.extend(toks)
                if margins is not None:
                    req.margins.extend(float(m) for m in margins[i][: len(toks)])
                self._decode_tokens += len(toks)
                slot.pos += len(toks)
                self.table.seq_lens[i] = slot.pos
                self.table.tokens[i] = toks[-1]
                if len(req.tokens) >= req.max_new_tokens or (
                    req.eos_token_id is not None and toks[-1] == req.eos_token_id
                ):
                    self._finish_slot(i, RequestStatus.FINISHED, "", now)
                elif slot.keys is not None:
                    # token t (0-based) was drawn with keys[t - 1]
                    self.table.keys[i] = slot.keys[len(req.tokens) - 1]

        return sum(1 for s in self.slots if s.request is not None)

    def _decode(self, active):
        """One batched decode step → ([(slot, [token])], margins [B, 1] or
        None). The slot table is the program's staging: one upload."""
        out = self._step_prog()
        nxt, logits = out if self.track_margins else (out, None)
        # the one deliberate sync of the slot loop: the scheduler must read
        # the sampled tokens to retire or advance slots (and it leaves the
        # staged table free to write)
        out_np = nxt.cpu().numpy()
        margins = _top2_margin(logits)[:, None] if logits is not None else None
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
        out = self._step_prog()
        greedy, logits = out if self.track_margins else (out, None)
        out_np = greedy.cpu().numpy()  # the step's one deliberate sync
        margins = _top2_margin(logits) if logits is not None else None
        self._spec_steps += 1
        self._spec_drafted += self.spec_k * len(active)
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
        self._spec_accepted += len(toks) - 1
        self._spec_emitted += len(toks)
        self._spec_runs += 1
        return toks

    def _pages_needed(self, req: Request) -> int:
        """Net new pages an admission allocates: the request's full
        reservation minus the pages the prefix index can map (a probe that
        counts nothing and refreshes nothing: the gate runs it every step
        while a request heads the queue)."""
        total = pages_for(req.prompt_len + req.max_new_tokens, self.page_size)
        if self.prefix_cache is None:
            return total
        return total - self.prefix_cache.probe(req.prompt)

    def _admit(self, slot_i: int, req: Request) -> None:
        total = pages_for(req.prompt_len + req.max_new_tokens, self.page_size)
        # prefix-cache lookup: map every indexed full page of the prompt. A
        # full-prefix hit also finds the LAST prompt page indexed; that page
        # is forked copy-on-write (a fresh private page, filled by
        # recomputing its tokens through the chunk program), because the
        # slot's own decode writes continue next to it
        shared: List[int] = []
        shared_tokens = 0
        cow_page = None
        if self.prefix_cache is not None:
            shared, shared_tokens, cow_page = self.prefix_cache.lookup(req.prompt)
            if shared:
                self.allocator.retain(shared)
            if cow_page is not None:
                self.allocator.cow_forks_total += 1
        try:
            pages = shared + self.allocator.alloc(total - len(shared))
        except PageAllocatorError as e:
            # all or nothing: a failed reservation must not strand the
            # prefix retains
            if shared:
                self.allocator.free(shared)
            req.status = RequestStatus.FAILED
            req.detail = f"admission reservation failed: {e}"
            req.t_finish = self.clock()
            self._req_terminal(req, req.t_finish)
            return
        slot = self.slots[slot_i]
        slot.request = req
        slot.pages = pages
        slot.pos = 0
        req.prefix_shared_tokens = shared_tokens
        req.cow_forked = cow_page is not None

        if self.chunk_width > 0 and (
            shared_tokens > 0 or (self._chunk_cold and req.prompt_len > self.chunk_width)
        ):
            # chunked (tail) prefill: the real block table lives on the slot,
            # the main table row stays scratch until the prompt is in
            row = np.zeros((1, self.pages_per_slot), np.int32)
            row[0, : len(pages)] = pages
            slot.row = row
            slot.prefilling = True
            slot.prefill_pos = shared_tokens
            req.status = RequestStatus.RUNNING
            return

        self.table.assign(slot_i, pages)

        x = self._prefill_prog.inputs.staging()
        x["ids"][:] = 0
        x["ids"][0, : req.prompt_len] = req.prompt
        x["plen"][0] = req.prompt_len
        x["page_ids"][:] = self.table.block_tables[slot_i, : self.prefill_pages]
        x["key"][:] = self._prefill_key(req)
        out = self._prefill_prog()
        first, logits = out if self.track_margins else (out, None)
        self._prefills += 1
        # deliberate sync: TTFT is defined by the first token reaching the
        # host, and an at-admission EOS must retire the slot before decode
        tok0 = int(first[0].item())
        if logits is not None:
            req.margins.append(float(_top2_margin(logits)[0]))
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
        out = self._chunk_prog()
        self._chunks += 1
        slot.prefill_pos = start + C
        if not final:
            return  # more chunks; the decode batch advances meanwhile
        first, logits = out if self.track_margins else (out, None)
        self._prefills += 1
        # deliberate sync, as in _admit: the final chunk's sample is the
        # request's first token
        tok0 = int(first[0].item())
        if logits is not None:
            req.margins.append(float(_top2_margin(logits)[0]))
        self._start_decoding(slot_i, tok0)

    def _start_decoding(self, slot_i: int, tok0: int) -> None:
        """Post-prefill transition: install the real block table (after a
        chunked prefill), record TTFT, arm the slot's decode row, index the
        prompt's full pages, and finish at once on an immediate EOS or a
        single-token ask."""
        slot = self.slots[slot_i]
        req = slot.request
        now = self.clock()
        if slot.row is not None:
            self.table.block_tables[slot_i, :] = slot.row[0]
            slot.prefilling = False
            slot.row = None
        req.status = RequestStatus.RUNNING
        req.t_first_token = now
        req.tokens.append(tok0)
        slot.pos = req.prompt_len
        self.table.seq_lens[slot_i] = slot.pos
        self.table.tokens[slot_i] = tok0
        if self.prefix_cache is not None:
            self.prefix_cache.insert(req.prompt, slot.pages)
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
        out = {
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
            "kv_pages_shared": self.allocator.pages_shared,
            "kv_cow_forks": self.allocator.cow_forks_total,
            "chunk_prefills": self._chunks,
            "kv_cache_dtype": str(self.cache_dtype).replace("torch.", ""),
            "kv_pool_bytes": self.kv_pool_bytes,
            "kv_scales_bytes": self.kv_scales_bytes,
        }
        if self.prefix_cache is not None:
            pc = self.prefix_cache
            lookups = pc.hits_full + pc.hits_partial + pc.misses
            out.update({
                "prefix_index_pages": len(pc),
                "prefix_hits_full": pc.hits_full,
                "prefix_hits_partial": pc.hits_partial,
                "prefix_misses": pc.misses,
                "prefix_evictions": pc.evictions,
                "prefix_hit_rate": (
                    (pc.hits_full + pc.hits_partial) / lookups if lookups else None
                ),
            })
        if self.spec_enabled:
            out.update({
                "spec_steps": self._spec_steps,
                "spec_drafted": self._spec_drafted,
                "spec_accepted": self._spec_accepted,
                "spec_accept_len_mean": (
                    self._spec_emitted / self._spec_runs if self._spec_runs else None
                ),
            })
        return out

    def release_prefix_cache(self) -> int:
        """Drop every prefix-index reference (teardown, tests): afterwards a
        drained engine's allocator is fully free. → pages released."""
        return self.prefix_cache.clear() if self.prefix_cache is not None else 0

    def check_no_leaks(self) -> None:
        """Drain invariant: every page either back on the free list or held
        by exactly the prefix index (refcount 1), every slot empty, every
        block-table entry pointing at scratch."""
        self.allocator.check_no_leaks(
            allowed=self.prefix_cache.held_pages if self.prefix_cache is not None else None
        )
        assert all(s.request is None for s in self.slots)
        assert (self.table.block_tables == 0).all()
        assert (self.table.seq_lens == 0).all()
