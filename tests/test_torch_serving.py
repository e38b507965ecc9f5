"""The port's continuous-batching ServingEngine on the CPU, held against the
JAX package's ServingEngine: the allocator cases, the 16-request mixed
suite token for token, and admission, backpressure, truncation and
deadlines mirroring ``tests/unit/test_serving.py`` (gpt2-tiny, fp32); then
speculative decode, the prefix cache and chunked prefill, alone and
together, mirroring that file's feature cases with ``stats()`` in place of
the metrics registry."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.inference.engine import InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.runtime.config import (
    DeepSpeedConfigError,
    NotPortedError,
    ServingConfig,
)
from deepspeed_tpu_torch.serving import (
    PageAllocator,
    PageAllocatorError,
    PrefixCache,
    Request,
    RequestStatus,
    ServingEngine,
    SlotTable,
    pages_for,
)
from deepspeed_tpu_torch.utils.weights import params_from_numpy

SERVING_CFG = {
    "max_slots": 4,
    "page_size": 4,
    "num_pages": 64,
    "max_prompt_len": 12,
    "max_new_tokens": 8,
    "kv_cache_dtype": "float32",
}
# every feature of the slice on: speculation (k=3), prefix cache, chunking
SPEC_CFG = dict(
    SERVING_CFG,
    speculative={"enabled": True, "k": 3},
    prefix_cache={"enabled": True},
    prefill_chunk_tokens=4,
)
PREFIX_CFG = dict(SERVING_CFG, prefix_cache={"enabled": True})


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def tree():
    cfg = jgpt2.get_config("gpt2-tiny")
    return jax.tree.map(np.asarray, jgpt2.init_params(cfg, jax.random.PRNGKey(0)))


def _jax_engine(tree):
    cfg = jgpt2.get_config("gpt2-tiny")
    return JaxInferenceEngine(jgpt2.make_module(cfg), params=jax.tree.map(jnp.asarray, tree),
                              dtype=jnp.float32)


@pytest.fixture(scope="module")
def jax_srv(tree):
    cfg = jgpt2.get_config("gpt2-tiny")
    eng = JaxInferenceEngine(
        jgpt2.make_module(cfg), params=jax.tree.map(jnp.asarray, tree), dtype=jnp.float32
    )
    return eng.serve(SERVING_CFG)


@pytest.fixture(scope="module")
def jax_spec_srv(tree):
    cfg = jgpt2.get_config("gpt2-tiny")
    eng = JaxInferenceEngine(
        jgpt2.make_module(cfg), params=jax.tree.map(jnp.asarray, tree), dtype=jnp.float32
    )
    return eng.serve(SPEC_CFG)


@pytest.fixture(scope="module")
def engine(tree):
    return dtt.init_inference(
        dtt.get_config("gpt2-tiny"), params=params_from_numpy(tree, "cpu"),
        dtype=torch.float32, device="cpu",
    )


def oracle(jax_srv, specs):
    """Greedy streams of the JAX ServingEngine for (prompt, n) specs."""
    reqs = [jax_srv.submit(p, max_new_tokens=n, seed=i) for i, (p, n) in enumerate(specs)]
    jax_srv.run()
    jax_srv.check_no_leaks()
    return [list(r.tokens) for r in reqs]


def _prompts(seed, lens, vocab=512):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, (n,)).astype(np.int32) for n in lens]


class TestPageAllocator:
    def test_alloc_free_roundtrip(self):
        a = PageAllocator(8)
        assert a.capacity == 7  # page 0 is scratch
        pages = a.alloc(3)
        assert len(set(pages)) == 3 and 0 not in pages
        assert a.free_pages == 4 and a.pages_in_use == 3
        a.free(pages)
        a.check_no_leaks()
        assert a.free_pages == 7

    def test_exhaustion_is_all_or_nothing(self):
        a = PageAllocator(4)
        a.alloc(2)
        with pytest.raises(PageAllocatorError, match="exhausted"):
            a.alloc(2)
        assert a.free_pages == 1

    def test_double_free_and_foreign_page_raise(self):
        a = PageAllocator(8)
        pages = a.alloc(2)
        a.free(pages)
        with pytest.raises(PageAllocatorError, match="double free"):
            a.free([pages[0]])
        with pytest.raises(PageAllocatorError):
            a.free([0])  # scratch is never freeable

    def test_leak_detection(self):
        a = PageAllocator(8)
        a.alloc(1)
        with pytest.raises(PageAllocatorError, match="leaked"):
            a.check_no_leaks()

    def test_refcounts_and_consistency(self):
        a = PageAllocator(8)
        p = a.alloc(2)
        a.retain(p[:1])
        assert a.refcount(p[0]) == 2 and a.pages_shared == 1
        a.free([p[1]])
        with pytest.raises(PageAllocatorError, match="extra refcounts"):
            a.check_no_leaks(allowed=[p[0]])
        a.free([p[0]])
        assert a.pages_in_use == 1 and a.check_consistent() is None
        a.check_no_leaks(allowed=[p[0]])
        a._free.append(a._free[0])  # corrupt: a duplicate free-list entry
        assert "duplicate" in a.check_consistent()

    def test_pages_for(self):
        assert pages_for(1, 4) == 1
        assert pages_for(4, 4) == 1
        assert pages_for(5, 4) == 2

    def test_slot_table_assign_and_clear(self):
        t = SlotTable(2, 3)
        t.assign(1, [5, 6])
        assert t.block_tables[1].tolist() == [5, 6, 0]
        with pytest.raises(ValueError):
            t.assign(0, [1, 2, 3, 4])
        t.seq_lens[1] = 4
        t.clear(1)
        assert not t.block_tables.any() and not t.seq_lens.any()


class TestTokenIdentity:
    def test_mixed_suite_matches_the_jax_serving_engine(self, engine, jax_srv):
        """The 16-request mixed suite of tests/unit/test_serving.py through
        both ServingEngines: identical greedy streams, zero leaks."""
        rs = np.random.RandomState(7)
        plens = [2, 5, 8, 12, 7, 3, 11, 4] * 2
        specs = []
        for i in range(16):
            n = 6 if i % 7 else (1, 3, 8)[i // 7]
            specs.append((rs.randint(0, 512, (plens[i],)).astype(np.int32), n))
        ref = oracle(jax_srv, specs)
        srv = engine.serve(SERVING_CFG)
        reqs = [srv.submit(p, max_new_tokens=n, seed=i) for i, (p, n) in enumerate(specs)]
        done = srv.run()
        assert len(done) == 16
        for (p, n), req, want in zip(specs, reqs, ref):
            assert req.status == RequestStatus.FINISHED
            assert len(req.tokens) == n
            assert req.tokens == want
            np.testing.assert_array_equal(req.output[: len(p)], p)
        srv.check_no_leaks()
        st = srv.stats()
        assert st["by_status"] == {"finished": 16} and st["kv_pages_in_use"] == 0
        assert st["ttft"]["count"] == 16

    def test_eos_stops_early_and_frees_pages(self, engine, jax_srv):
        prompt = _prompts(11, [6])[0]
        ref = oracle(jax_srv, [(prompt, 8)])[0]
        eos = ref[2]
        stop_at = ref.index(eos) + 1
        srv = engine.serve(SERVING_CFG)
        req = srv.submit(prompt, max_new_tokens=8, eos_token_id=eos)
        srv.run()
        assert req.status == RequestStatus.FINISHED
        assert req.tokens == ref[:stop_at]
        srv.check_no_leaks()

    def test_sampled_streams_are_seeded_and_batch_independent(self, engine, tree):
        """A sampled stream depends on its request's seed only: alone or
        co-batched with others, the draws are the same, and they are the
        JAX ServingEngine's draws for the same seeds."""
        cfg = dict(SERVING_CFG, temperature=0.8, top_k=5)
        prompts = _prompts(3, [3, 8, 4, 7])
        alone = []
        for i, p in enumerate(prompts):
            srv = engine.serve(cfg)
            r = srv.submit(p, max_new_tokens=5, seed=100 + i)
            srv.run()
            alone.append(r.tokens)
        srv = engine.serve(cfg)
        reqs = [srv.submit(p, max_new_tokens=5, seed=100 + i) for i, p in enumerate(prompts)]
        srv.run()
        assert [r.tokens for r in reqs] == alone
        srv.check_no_leaks()
        jsrv = _jax_engine(tree).serve(cfg)
        jreqs = [jsrv.submit(p, max_new_tokens=5, seed=100 + i) for i, p in enumerate(prompts)]
        jsrv.run()
        assert [list(r.tokens) for r in jreqs] == alone


class TestMidFlightAdmission:
    def test_queued_requests_fill_vacated_slots(self, engine, jax_srv):
        rs = np.random.RandomState(5)
        specs = []
        for _ in range(6):
            plen = int(rs.randint(1, 13))
            specs.append((rs.randint(0, 512, (plen,)).astype(np.int32), 6))
        ref = oracle(jax_srv, specs)
        srv = engine.serve(SERVING_CFG)
        reqs = [srv.submit(p, max_new_tokens=n, seed=i) for i, (p, n) in enumerate(specs)]
        srv.step()
        assert sum(1 for s in srv.slots if s.request is not None) <= srv.max_slots
        assert len(srv.queue) == 6 - srv.max_slots
        srv.run()
        assert srv.stats()["prefills"] == 6
        assert [r.tokens for r in reqs] == ref
        srv.check_no_leaks()

    def test_page_budget_gates_admission(self, engine, jax_srv):
        """12+6=18 tokens need 5 pages; 11 usable pages admit two requests
        although four slots exist: pages, not slots, gate here."""
        specs = [(p, 6) for p in _prompts(9, [12, 12, 12])]
        ref = oracle(jax_srv, specs)
        srv = engine.serve(dict(SERVING_CFG, num_pages=12))
        reqs = [srv.submit(p, max_new_tokens=n, seed=i) for i, (p, n) in enumerate(specs)]
        srv.step()
        assert sum(1 for s in srv.slots if s.request is not None) == 2
        assert any(s.request is None for s in srv.slots)
        srv.run()
        for req, want in zip(reqs, ref):
            assert req.status == RequestStatus.FINISHED and req.tokens == want
        srv.check_no_leaks()


class TestAdmissionControl:
    def test_queue_depth_backpressure(self, engine):
        srv = engine.serve(dict(SERVING_CFG, max_queue_depth=2))
        p = np.arange(4, dtype=np.int32)
        r1, r2, r3 = srv.submit(p), srv.submit(p), srv.submit(p)
        assert r1.status == r2.status == RequestStatus.QUEUED
        assert r3.status == RequestStatus.REJECTED and "queue full" in r3.detail
        assert srv.stats()["by_status"] == {"rejected": 1}

    def test_oversize_prompt_rejected(self, engine):
        srv = engine.serve(SERVING_CFG)
        r = srv.submit(np.zeros(40, np.int32))  # max_prompt_len = 12
        assert r.status == RequestStatus.REJECTED
        assert srv.submit(np.zeros(0, np.int32)).status == RequestStatus.REJECTED

    def test_overlong_ask_degrades_to_truncated(self, engine):
        srv = engine.serve(SERVING_CFG)
        prompt = np.arange(5, dtype=np.int32)
        req = srv.submit(prompt, max_new_tokens=10**6)
        assert req.requested_new_tokens == 10**6
        assert req.max_new_tokens == SERVING_CFG["max_new_tokens"]
        srv.run()
        assert req.status == RequestStatus.TRUNCATED
        assert len(req.tokens) == SERVING_CFG["max_new_tokens"]
        srv.check_no_leaks()


class TestTimeoutEviction:
    def test_midflight_deadline_truncates_without_wedging(self, engine, jax_srv):
        p_slow, p_ok = _prompts(13, [6, 9])
        ref_slow, ref_ok = oracle(jax_srv, [(p_slow, 8), (p_ok, 8)])
        clock = FakeClock()
        srv = engine.serve(SERVING_CFG, clock=clock)
        r_slow = srv.submit(p_slow, max_new_tokens=8, deadline_s=5.0)
        r_ok = srv.submit(p_ok, max_new_tokens=8)
        srv.step()
        srv.step()
        clock.t = 10.0  # past r_slow's deadline
        srv.run()
        assert r_slow.status == RequestStatus.TRUNCATED
        assert 0 < len(r_slow.tokens) < 8
        assert r_slow.tokens == ref_slow[: len(r_slow.tokens)]
        assert r_ok.status == RequestStatus.FINISHED and r_ok.tokens == ref_ok
        assert srv.stats()["timeout_evictions"] == 1
        srv.check_no_leaks()

    def test_queued_deadline_times_out_before_admission(self, engine):
        clock = FakeClock()
        srv = engine.serve(SERVING_CFG, clock=clock)
        p = np.arange(4, dtype=np.int32)
        running = [srv.submit(p, max_new_tokens=8) for _ in range(srv.max_slots)]
        r_wait = srv.submit(p, max_new_tokens=8, deadline_s=1.0)
        srv.step()
        clock.t = 2.0
        srv.run()
        assert all(r.status == RequestStatus.FINISHED for r in running)
        assert r_wait.status == RequestStatus.TIMED_OUT and r_wait.tokens == []
        srv.check_no_leaks()

    def test_drain_preempts_and_reclaims_everything(self, engine):
        clock = FakeClock()
        srv = engine.serve(dict(SERVING_CFG, max_slots=2), clock=clock)
        reqs = [srv.submit(p, max_new_tokens=8) for p in _prompts(17, [3, 5, 7, 9])]
        srv.step()
        out = srv.drain(deadline_s=0.0)
        assert out["deadline_hit"] and out["preempted"] == 4
        assert all(r.status == RequestStatus.PREEMPTED for r in reqs)
        assert srv.submit(np.arange(3)).status == RequestStatus.REJECTED
        srv.check_no_leaks()


# what each placement section does now: "11c" raises NotPortedError naming
# ROADMAP queue 1 item 11c at parse; "group" parses and raises at serve,
# where no process group is initialised; "tp1" parses and serves at tp 1
# (decode_tp and prefill_tp are read only with disaggregate, as JAX reads
# them, so beside a fleet they leave the placement off too)
@pytest.mark.parametrize("section,outcome", [
    ({"placement": {"decode_tp": 2}}, "tp1"),
    ({"placement": {"device_base": 1}}, "11c"),
    ({"placement": {"prefill_tp": 2}}, "tp1"),
    ({"placement": {"tp": 2, "disaggregate": True}}, "group"),
    ({"placement": {"tp": 2}}, "group"),
    ({"placement": {"disaggregate": True}}, "group"),
    # a fleet beside a placement that is on: each replica on its own ranks
    ({"fleet": {"enabled": True, "replicas": 2}, "placement": {"tp": 2}}, "11c"),
    ({"fleet": {"enabled": True}, "placement": {"decode_tp": 2}}, "tp1"),
    ({"placement": {"device_base": 1}}, "11c"),
    # parses for gpt2-tiny (4 heads); serving it needs 4 ranks
    ({"placement": {"tp": 4}}, "group"),
], ids=[f"section{i}" for i in range(10)])
def test_unported_features_raise(section, outcome, engine):
    cfg = dict(SERVING_CFG, **section)
    if outcome == "11c":
        with pytest.raises(NotPortedError, match="item 11c"):
            ServingConfig.from_dict(cfg)
        with pytest.raises(NotPortedError, match="item 11c"):
            engine.serve(cfg)
        return
    parsed = ServingConfig.from_dict(cfg)
    for key, value in section["placement"].items():
        assert getattr(parsed.placement, key) == value
    if outcome == "group":
        with pytest.raises(ValueError, match="devices.*no process group"):
            engine.serve(cfg)
        return
    srv = engine.serve(cfg)
    assert srv.stats()["placement"]["tp"] == 1 and not srv.disaggregated
    assert [p.name for p in srv.executables] == ["serving_prefill", "serving_decode"]


def test_features_switched_off_are_accepted():
    cfg = ServingConfig.from_dict(dict(
        SERVING_CFG, speculative={"enabled": False, "k": 4},
        placement={"tp": 1}, fleet={"enabled": False, "replicas": 3},
    ))
    assert cfg.max_slots == 4
    with pytest.raises(ValueError, match="unknown"):
        ServingConfig.from_dict({"max_slotz": 3})


def test_feature_sections_parse_and_validate():
    cfg = ServingConfig.from_dict(SPEC_CFG)
    assert cfg.speculative.enabled and cfg.speculative.k == 3 and cfg.speculative.ngram == 2
    assert cfg.prefix_cache.enabled and cfg.prefix_cache.max_pages == 0
    assert cfg.prefill_chunk_tokens == 4
    with pytest.raises(DeepSpeedConfigError, match="k must be"):
        ServingConfig.from_dict(dict(SERVING_CFG, speculative={"enabled": True, "k": 17}))
    with pytest.raises(DeepSpeedConfigError, match="max_pages"):
        ServingConfig.from_dict(dict(SERVING_CFG, prefix_cache={"max_pages": -1}))
    with pytest.raises(DeepSpeedConfigError, match="unknown"):
        ServingConfig.from_dict(dict(SERVING_CFG, prefix_cache={"enabld": True}))
    # the host tier and retries are ported: the tier needs the prefix cache
    cfg = ServingConfig.from_dict(dict(PREFIX_CFG, tiering={"enabled": True}, retry_max=2))
    assert cfg.tiering.enabled and cfg.tiering.policy == "idle_lru" and cfg.retry_max == 2
    with pytest.raises(DeepSpeedConfigError, match="prefix_cache"):
        ServingConfig.from_dict(dict(SERVING_CFG, tiering={"enabled": True}))
    with pytest.raises(DeepSpeedConfigError, match="policy"):
        ServingConfig.from_dict(dict(PREFIX_CFG, tiering={"enabled": True, "policy": "oracle"}))


# ---------------------------------------------------------------------------
# speculative decode, shared-prefix KV reuse, chunked prefill
# ---------------------------------------------------------------------------

def _mixed_specs():
    """The 16-request mixed suite of tests/unit/test_serving.py."""
    rs = np.random.RandomState(7)
    plens = [2, 5, 8, 12, 7, 3, 11, 4] * 2
    specs = []
    for i in range(16):
        n = 6 if i % 7 else (1, 3, 8)[i // 7]
        specs.append((rs.randint(0, 512, (plens[i],)).astype(np.int32), n))
    return specs


class TestRefcountedAllocator:
    def test_retain_free_roundtrip(self):
        a = PageAllocator(16)
        pages = a.alloc(3)
        a.retain(pages)
        assert a.pages_shared == 3
        assert all(a.refcount(p) == 2 for p in pages)
        a.free(pages)  # drops to 1: still in use
        assert a.pages_in_use == 3 and a.free_pages == 12
        assert a.pages_shared == 0
        a.free(pages)  # last holder: back on the free list
        a.check_no_leaks()
        assert a.free_pages == 15

    def test_free_below_zero_and_retain_free_raise(self):
        a = PageAllocator(8)
        pages = a.alloc(1)
        a.free(pages)
        with pytest.raises(PageAllocatorError, match="double free"):
            a.free(pages)
        with pytest.raises(PageAllocatorError, match="retain of free"):
            a.retain(pages)
        with pytest.raises(PageAllocatorError):
            a.retain([0])  # scratch is never retainable

    def test_leak_check_with_allowed_refcounts(self):
        a = PageAllocator(16)
        pages = a.alloc(2)
        with pytest.raises(PageAllocatorError, match="leaked"):
            a.check_no_leaks()
        a.check_no_leaks(allowed=pages)  # refcount exactly 1 each: fine
        a.retain([pages[0]])
        with pytest.raises(PageAllocatorError, match="refcount"):
            a.check_no_leaks(allowed=pages)


class TestPrefixCacheIndex:
    def test_insert_lookup_probe_chain(self):
        a = PageAllocator(32)
        pc = PrefixCache(a, page_size=4)
        prompt = np.arange(12, dtype=np.int32)
        pages = a.alloc(3)
        assert pc.insert(prompt, pages) == 3
        assert all(a.refcount(p) == 2 for p in pages)
        # page-aligned full match: 2 mappable pages + the last page as COW
        shared, ntok, cow = pc.lookup(prompt)
        assert shared == pages[:2] and ntok == 8 and cow == pages[2]
        assert pc.hits_full == 1
        # diverging third page: partial, no COW
        p2 = np.concatenate([prompt[:8], np.array([99, 98, 97], np.int32)])
        shared, ntok, cow = pc.lookup(p2)
        assert shared == pages[:2] and ntok == 8 and cow is None
        assert pc.hits_partial == 1
        before = (pc.hits_full, pc.hits_partial, pc.misses)
        assert pc.probe(prompt) == 2
        assert (pc.hits_full, pc.hits_partial, pc.misses) == before

    def test_lookup_never_shares_the_last_token(self):
        a = PageAllocator(32)
        pc = PrefixCache(a, page_size=4)
        prompt = np.arange(8, dtype=np.int32)
        pc.insert(prompt, a.alloc(2))
        shared, ntok, cow = pc.lookup(prompt[:5])
        assert ntok == 4 and cow is None

    def test_leaf_first_eviction_keeps_chains_reachable(self):
        a = PageAllocator(32)
        pc = PrefixCache(a, page_size=4)
        prompt = np.arange(12, dtype=np.int32)
        pages = a.alloc(3)
        pc.insert(prompt, pages)
        a.free(pages)  # only the index holds them now
        assert pc.evict(keep=2) == 1
        shared, ntok, _ = pc.lookup(prompt)
        assert ntok == 8
        pc.clear()
        a.check_no_leaks()

    def test_pressure_eviction_is_bounded_not_total(self):
        """evict(need_free=n) frees only what pool pressure demands."""
        a = PageAllocator(8)  # 7 usable
        pc = PrefixCache(a, page_size=4)
        pages = a.alloc(3)
        pc.insert(np.arange(12, dtype=np.int32), pages)
        a.free(pages)  # only the index holds them; free_pages == 4
        assert pc.evict(need_free=5) == 1 and a.free_pages == 5
        assert len(pc) == 2
        pc.clear()
        a.check_no_leaks()


class TestDraftIndex:
    """The incremental ngram → position drafter reproduces the brute-force
    backward scan exactly."""

    K, N = 4, 2

    @staticmethod
    def _scan_draft(ctx, k, n):
        last = ctx[-1]
        if len(ctx) >= n + 1:
            tgt = ctx[len(ctx) - n:]
            for s in range(len(ctx) - n - 1, -1, -1):
                if ctx[s:s + n] == tgt:
                    return (ctx[s + n:s + n + k] + [last] * k)[:k]
        return [last] * k

    def _shim(self):
        shim = types.SimpleNamespace(spec_k=self.K, spec_ngram=self.N)
        return lambda req: ServingEngine._draft(shim, req)

    def test_incremental_matches_scan_as_stream_grows(self):
        draft = self._shim()
        rs = np.random.RandomState(0)
        req = Request(prompt=rs.randint(0, 7, (23,)).astype(np.int32), max_new_tokens=64)
        for _ in range(60):
            got = [int(t) for t in draft(req)]
            assert got == self._scan_draft(req.prompt_list + req.tokens, self.K, self.N)
            req.tokens.append(int(rs.randint(0, 7)))

    def test_reset_state_rebuilds_index(self):
        draft = self._shim()
        rs = np.random.RandomState(1)
        req = Request(prompt=rs.randint(0, 5, (9,)).astype(np.int32), max_new_tokens=64)
        for _ in range(12):
            draft(req)
            req.tokens.append(int(rs.randint(0, 5)))
        req.tokens = []
        req.draft_state = None
        for _ in range(12):
            got = [int(t) for t in draft(req)]
            assert got == self._scan_draft(req.prompt_list + req.tokens, self.K, self.N)
            req.tokens.append(int(rs.randint(0, 5)))

    def test_length_guard_alone_recovers_from_rewind(self):
        draft = self._shim()
        rs = np.random.RandomState(2)
        req = Request(prompt=rs.randint(0, 5, (9,)).astype(np.int32), max_new_tokens=64)
        for _ in range(10):
            draft(req)
            req.tokens.append(int(rs.randint(0, 5)))
        req.tokens = []
        got = [int(t) for t in draft(req)]
        assert got == self._scan_draft(req.prompt_list, self.K, self.N)


class TestSpeculativeDecode:
    def test_mixed_suite_all_features_match_jax_and_the_default_path(
        self, engine, jax_srv, jax_spec_srv
    ):
        """The 16-request mixed suite with speculation (k=3), the prefix
        cache and chunk 4 on: token-identical to the JAX ServingEngine with
        the same features AND to the port's own default path, zero leaks."""
        specs = _mixed_specs()
        ref_spec = oracle(jax_spec_srv, specs)
        ref_default = oracle(jax_srv, specs)
        srv = engine.serve(SPEC_CFG)
        reqs = [srv.submit(p, max_new_tokens=n, seed=i) for i, (p, n) in enumerate(specs)]
        done = srv.run()
        assert len(done) == 16
        plain = engine.serve(SERVING_CFG)
        preqs = [plain.submit(p, max_new_tokens=n, seed=i) for i, (p, n) in enumerate(specs)]
        plain.run()
        for (p, n), req, preq, want_spec, want in zip(
            specs, reqs, preqs, ref_spec, ref_default
        ):
            assert req.status == RequestStatus.FINISHED
            assert len(req.tokens) == n
            assert req.tokens == want_spec == want == preq.tokens
        srv.check_no_leaks()
        plain.check_no_leaks()
        st = srv.stats()
        assert st["spec_steps"] > 0 and st["spec_accept_len_mean"] is not None
        assert st["chunk_prefills"] > 0
        total_tokens = sum(len(r.tokens) for r in reqs)
        assert st["spec_accepted"] + st["spec_steps"] <= total_tokens + 16

    def test_accepted_drafts_advance_multiple_tokens(self, engine, jax_srv):
        """Greedy decode of the tiny model loops, so prompt-lookup drafts
        accept > 1 token a step on average."""
        prompt = np.random.RandomState(11).randint(0, 512, (6,)).astype(np.int32)
        want = oracle(jax_srv, [(prompt, 8)])[0]
        srv = engine.serve(dict(SERVING_CFG, speculative={"enabled": True, "k": 3}))
        req = srv.submit(prompt, max_new_tokens=8, seed=0)
        srv.run()
        assert req.tokens == want
        st = srv.stats()
        assert st["spec_steps"] < 8  # sequential decode takes 7 steps after prefill
        assert st["spec_accept_len_mean"] > 1.0
        srv.check_no_leaks()

    def test_eos_inside_accepted_run_stops_exactly_at_eos(self, engine, jax_srv):
        prompt = np.random.RandomState(13).randint(0, 512, (6,)).astype(np.int32)
        ref = oracle(jax_srv, [(prompt, 8)])[0]
        eos = ref[2]
        stop_at = ref.index(eos) + 1
        srv = engine.serve(SPEC_CFG)
        req = srv.submit(prompt, max_new_tokens=8, eos_token_id=eos)
        srv.run()
        assert req.status == RequestStatus.FINISHED
        assert req.tokens == ref[:stop_at]
        srv.check_no_leaks()

    def test_speculative_rejects_sampling(self, engine):
        with pytest.raises(DeepSpeedConfigError, match="greedy"):
            engine.serve(dict(SERVING_CFG, temperature=0.8, speculative={"enabled": True}))
        cfg = ServingConfig.from_dict(dict(SERVING_CFG, speculative={"enabled": True}))
        cfg.temperature = 0.8  # past the config's own check
        with pytest.raises(ValueError, match="greedy"):
            ServingEngine(engine, cfg)


class TestPrefixCacheServing:
    def test_prefix_hit_identical_tokens_fewer_prefilled_pages(self, engine, jax_srv):
        """A resubmitted prompt maps its indexed pages instead of
        re-prefilling them: identical tokens, fewer newly allocated pages."""
        srv = engine.serve(PREFIX_CFG)
        prompt = np.random.RandomState(21).randint(0, 512, (11,)).astype(np.int32)
        total = pages_for(11 + 6, srv.page_size)
        r1 = srv.submit(prompt, max_new_tokens=6, seed=0)
        srv.run()
        pages_after_first = srv.allocator.pages_in_use  # index-held prompt pages
        r2 = srv.submit(prompt, max_new_tokens=6, seed=0)
        srv.step()
        assert srv.allocator.pages_in_use - pages_after_first == total - 2
        assert r2.prefix_shared_tokens == 8
        srv.run()
        assert r1.tokens == r2.tokens == oracle(jax_srv, [(prompt, 6)])[0]
        st = srv.stats()
        assert st["prefix_hits_partial"] == 1 and st["prefix_misses"] == 1
        srv.check_no_leaks()
        srv.release_prefix_cache()
        srv.allocator.check_no_leaks()

    def test_concurrent_sharing_and_divergent_tails_are_isolated(self, engine, jax_srv):
        srv = engine.serve(PREFIX_CFG)
        base = np.random.RandomState(23).randint(0, 512, (12,)).astype(np.int32)
        divergent = base.copy()
        divergent[9:] = (divergent[9:] + 7) % 512
        want_base, want_div = oracle(jax_srv, [(base, 6), (divergent, 6)])
        r0 = srv.submit(base, max_new_tokens=6, seed=0)
        srv.run()
        ra = srv.submit(base, max_new_tokens=6, seed=0)
        rb = srv.submit(divergent, max_new_tokens=6, seed=0)
        srv.step()
        assert srv.allocator.pages_shared > 0  # shared while resident
        srv.run()
        assert r0.tokens == ra.tokens == want_base
        assert rb.tokens == want_div
        assert ra.prefix_shared_tokens > 0
        assert rb.prefix_shared_tokens == 8  # shares 2 pages, diverges in page 3
        srv.check_no_leaks()

    def test_cow_fork_on_full_prefix_hit(self, engine, jax_srv):
        """A page-aligned full-prefix hit forks the last prompt page: the
        resubmission decodes right, the indexed original stays pristine (a
        third submission still hits and matches), the fork is counted."""
        srv = engine.serve(PREFIX_CFG)
        prompt = np.random.RandomState(29).randint(0, 512, (12,)).astype(np.int32)
        want = oracle(jax_srv, [(prompt, 6)])[0]
        reqs = []
        for _ in range(3):
            reqs.append(srv.submit(prompt, max_new_tokens=6, seed=0))
            srv.run()
        r1, r2, r3 = reqs
        assert not r1.cow_forked and r2.cow_forked and r3.cow_forked
        assert srv.allocator.cow_forks_total == 2
        for r in reqs:
            assert r.tokens == want
        st = srv.stats()
        assert st["prefix_hits_full"] == 2 and st["kv_cow_forks"] == 2
        srv.check_no_leaks()

    def test_eviction_and_preemption_of_sharing_slots_leak_free(self, engine):
        clock = FakeClock()
        srv = engine.serve(PREFIX_CFG, clock=clock)
        prompt = np.random.RandomState(31).randint(0, 512, (12,)).astype(np.int32)
        warm = srv.submit(prompt, max_new_tokens=6, seed=0)
        srv.run()
        assert warm.status == RequestStatus.FINISHED
        r_doomed = srv.submit(prompt, max_new_tokens=8, deadline_s=5.0)
        r_ok = srv.submit(prompt, max_new_tokens=8)
        srv.step()
        assert srv.allocator.pages_shared > 0
        clock.t = 10.0  # r_doomed's deadline passes mid-flight
        srv.run()
        assert r_doomed.status == RequestStatus.TRUNCATED
        assert r_ok.status == RequestStatus.FINISHED
        srv.check_no_leaks()  # index references allowed, slots all clear
        assert not srv.drain()["deadline_hit"]
        assert srv.release_prefix_cache() > 0
        srv.allocator.check_no_leaks()

    def test_index_yields_pages_under_pool_pressure(self, engine):
        """A cold request that cannot fit beside the index evicts cold
        entries (LRU leaves) instead of blocking the head of the line."""
        srv = engine.serve(dict(PREFIX_CFG, num_pages=16))
        rs = np.random.RandomState(37)
        for _ in range(3):
            srv.submit(rs.randint(0, 512, (12,)).astype(np.int32), max_new_tokens=6)
            srv.run()
        assert len(srv.prefix_cache) > 0
        rs2 = np.random.RandomState(41)
        reqs = [srv.submit(rs2.randint(0, 512, (12,)).astype(np.int32),
                           max_new_tokens=6, seed=i) for i in range(3)]
        srv.run()
        assert all(r.status == RequestStatus.FINISHED for r in reqs)
        assert srv.stats()["prefix_evictions"] > 0
        srv.check_no_leaks()

    def test_eviction_of_probed_pages_never_crashes_admission(self, engine, jax_srv):
        """The probe/evict race: pool pressure evicts the very index pages
        the admission gate counted as mappable; the gate re-probes."""
        srv = engine.serve(dict(PREFIX_CFG, num_pages=10))
        rs = np.random.RandomState(61)
        prompt_a = rs.randint(0, 512, (12,)).astype(np.int32)
        prompt_b = rs.randint(0, 512, (12,)).astype(np.int32)
        want_a, want_b = oracle(jax_srv, [(prompt_a, 8), (prompt_b, 8)])
        warm = srv.submit(prompt_a, max_new_tokens=2, seed=0)
        srv.run()  # the index holds A's 3 prompt pages
        assert warm.status == RequestStatus.FINISHED
        rb = srv.submit(prompt_b, max_new_tokens=8, seed=0)
        srv.step()  # B resident: 5 pages; free = 9 - 3 - 5 = 1
        ra = srv.submit(prompt_a, max_new_tokens=8, seed=0)
        srv.run()
        assert ra.status == rb.status == RequestStatus.FINISHED
        assert srv.prefix_cache.evictions >= 1
        assert ra.tokens == want_a and rb.tokens == want_b
        srv.check_no_leaks()

    def test_single_page_prompt_reports_no_phantom_cow(self, engine):
        srv = engine.serve(PREFIX_CFG)
        prompt = np.arange(4, dtype=np.int32)
        r1 = srv.submit(prompt, max_new_tokens=3, seed=0)
        srv.run()
        r2 = srv.submit(prompt, max_new_tokens=3, seed=0)
        srv.run()
        assert not r2.cow_forked and srv.allocator.cow_forks_total == 0
        assert srv.stats()["prefix_hits_full"] == 0
        assert r1.tokens == r2.tokens
        srv.check_no_leaks()

    def test_max_pages_caps_the_index(self, engine):
        srv = engine.serve(dict(SERVING_CFG, prefix_cache={"enabled": True, "max_pages": 2}))
        rs = np.random.RandomState(43)
        for i in range(3):
            srv.submit(rs.randint(0, 512, (12,)).astype(np.int32), max_new_tokens=6, seed=i)
            srv.run()
        assert len(srv.prefix_cache) <= 2
        srv.check_no_leaks()


class TestChunkedPrefill:
    def test_chunked_cold_prompt_tokens_identical(self, engine, jax_srv):
        srv = engine.serve(dict(SERVING_CFG, prefill_chunk_tokens=4))
        rs = np.random.RandomState(47)
        prompts = [rs.randint(0, 512, (plen,)).astype(np.int32) for plen in (12, 9, 3)]
        want = oracle(jax_srv, [(p, 6) for p in prompts])
        for p, w in zip(prompts, want):
            req = srv.submit(p, max_new_tokens=6, seed=0)
            srv.run()
            assert req.tokens == w
        # 12 and 9 chunked (3 chunks each), 3 took the whole-prefill path
        st = srv.stats()
        assert st["chunk_prefills"] == 6 and st["prefills"] == 3
        srv.check_no_leaks()

    def test_chunked_prefill_does_not_stall_decode(self, engine, jax_srv):
        """While a long prompt pays out its prefill one chunk per step, a
        co-resident decode slot advances one token every step."""
        srv = engine.serve(dict(SERVING_CFG, prefill_chunk_tokens=4))
        rs = np.random.RandomState(53)
        short = rs.randint(0, 512, (3,)).astype(np.int32)
        long_p = rs.randint(0, 512, (12,)).astype(np.int32)
        want_short, want_long = oracle(jax_srv, [(short, 8), (long_p, 6)])
        r_short = srv.submit(short, max_new_tokens=8, seed=0)
        srv.step()  # short admitted (whole prefill: 3 < chunk) + 1 decode
        base_tokens = len(r_short.tokens)
        r_long = srv.submit(long_p, max_new_tokens=6, seed=0)
        srv.step()  # admits r_long: chunk 1 of 3 AND the neighbor's decode
        assert any(s.prefilling for s in srv.slots if s.request is not None)
        assert len(r_short.tokens) == base_tokens + 1
        steps_during_prefill = 1
        while any(s.prefilling for s in srv.slots if s.request is not None):
            before = len(r_short.tokens)
            srv.step()
            steps_during_prefill += 1
            if r_short.status != RequestStatus.FINISHED:
                assert len(r_short.tokens) == before + 1
        assert steps_during_prefill == 3  # 12-token prompt, 4-token chunks
        srv.run()
        assert r_short.tokens == want_short and r_long.tokens == want_long
        srv.check_no_leaks()

    def test_chunked_prefill_timeout_eviction_mid_prefill(self, engine):
        """A deadline that expires while a slot is still prefilling
        reclaims its pages without it ever joining the decode batch."""
        clock = FakeClock()
        srv = engine.serve(dict(SERVING_CFG, prefill_chunk_tokens=4), clock=clock)
        prompt = np.random.RandomState(59).randint(0, 512, (12,)).astype(np.int32)
        req = srv.submit(prompt, max_new_tokens=6, deadline_s=1.0)
        srv.step()  # admitted, first chunk in
        clock.t = 5.0
        srv.run()
        assert req.status == RequestStatus.TRUNCATED and req.tokens == []
        srv.check_no_leaks()

    def test_sampled_stream_is_chunking_invariant(self, engine, tree):
        """Only the final chunk samples, with the unchunked prefill's key, so
        a sampled first token (and the stream after it) does not depend on
        the chunk width; both streams are the JAX engine's."""
        prompt = np.random.RandomState(67).randint(0, 512, (12,)).astype(np.int32)
        streams = []
        jeng = _jax_engine(tree)
        for extra in ({}, {"prefill_chunk_tokens": 4}):
            conf = dict(SERVING_CFG, temperature=0.8, top_k=5, **extra)
            srv = engine.serve(conf)
            r = srv.submit(prompt, max_new_tokens=6, seed=5)
            srv.run()
            srv.check_no_leaks()
            streams.append(r.tokens)
            jsrv = jeng.serve(conf)
            jr = jsrv.submit(prompt, max_new_tokens=6, seed=5)
            jsrv.run()
            assert list(jr.tokens) == r.tokens
        assert streams[0] == streams[1]
