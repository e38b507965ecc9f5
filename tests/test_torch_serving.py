"""The port's continuous-batching ServingEngine on the CPU, held against the
JAX package's ServingEngine: the allocator cases, the 16-request mixed
suite token for token, and admission, backpressure, truncation and
deadlines mirroring ``tests/unit/test_serving.py`` (gpt2-tiny, fp32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.inference.engine import InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.runtime.config import NotPortedError, ServingConfig
from deepspeed_tpu_torch.serving import (
    PageAllocator,
    PageAllocatorError,
    RequestStatus,
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


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def tree():
    cfg = jgpt2.get_config("gpt2-tiny")
    return jax.tree.map(np.asarray, jgpt2.init_params(cfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def jax_srv(tree):
    cfg = jgpt2.get_config("gpt2-tiny")
    eng = JaxInferenceEngine(
        jgpt2.make_module(cfg), params=jax.tree.map(jnp.asarray, tree), dtype=jnp.float32
    )
    return eng.serve(SERVING_CFG)


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

    def test_sampled_streams_are_seeded_and_batch_independent(self, engine):
        """A sampled stream depends on its request's seed only: alone or
        co-batched with others, the draws are the same."""
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


@pytest.mark.parametrize("section", [
    {"speculative": {"enabled": True}},
    {"prefix_cache": {"enabled": True}},
    {"prefill_chunk_tokens": 8},
    {"kv_cache_dtype": "int8"},
    {"placement": {"tp": 2}},
    {"placement": {"disaggregate": True}},
    {"tiering": {"enabled": True}},
    {"fleet": {"enabled": True}},
    {"slo": {"classes": {"chat": {"ttft_target_s": 1.0}}}},
    {"retry_max": 2},
])
def test_unported_features_raise(section, engine):
    with pytest.raises(NotPortedError, match="not ported"):
        ServingConfig.from_dict(dict(SERVING_CFG, **section))
    with pytest.raises(NotPortedError):
        engine.serve(dict(SERVING_CFG, **section))


def test_features_switched_off_are_accepted():
    cfg = ServingConfig.from_dict(dict(
        SERVING_CFG, speculative={"enabled": False, "k": 4},
        placement={"tp": 1}, fleet={"enabled": False, "replicas": 3},
    ))
    assert cfg.max_slots == 4
    with pytest.raises(ValueError, match="unknown"):
        ServingConfig.from_dict({"max_slotz": 3})
