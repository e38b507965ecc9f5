"""The port's host KV tier on the CPU, held against the JAX package's
(``tests/unit/test_serving_tiering.py`` is the oracle): the host store's
crc, reservation, spill order and int8 scale sidecar; the 16-request mixed
suite (speculation, prefix sharing, chunked prefill) in f32 and int8 with
the tier on equal to the tier off and to the JAX engine's streams with its
tier on, spill and restore counts included; the drain across both tiers;
the restore path under pool pressure and through a corrupted buffer; the
D-before-F/E ordering of the heat ledger under a seeded lockstep fuzz;
the live-tier replay against the what-if simulator.

gpt2-tiny, fp32 and int8 pages, from the same numpy weights. Streams are
compared token for token and the tier's counters exactly.

Waiting for other items: the TP=2 mixed suite (ROADMAP queue 1 item 11),
Engine G's tiered protocol model (item 15) and the ``tools/kv_heat``
``--policy`` CLI (item 14); the live-tier replay is held against the
simulator's dict directly."""

import signal
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.inference.engine import InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.elasticity.preemption import PreemptionGuard
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfigError
from deepspeed_tpu_torch.serving import PageAllocator, PrefixCache, RequestStatus
from deepspeed_tpu_torch.serving.tiering import (
    HostPageStore,
    HostTierError,
    KVTieringEngine,
    replay_live_tier,
)
from deepspeed_tpu_torch.telemetry.kv_heat import (
    KVHeatLedger,
    KVHeatTracer,
    evaluate_spill_policies,
    load_heat_records,
)
from deepspeed_tpu_torch.utils.weights import params_from_numpy
from tests.torch_threads import one_torch_thread  # noqa: F401

BASE = {"max_slots": 4, "page_size": 4, "num_pages": 64, "max_prompt_len": 12,
        "max_new_tokens": 8}
ALL_FEATURES = {"speculative": {"enabled": True, "k": 3}, "prefix_cache": {"enabled": True},
                "prefill_chunk_tokens": 8}
TIERED = {"tiering": {"enabled": True, "host_budget_pages": 64}}
VOCAB = 512


@pytest.fixture(scope="module")
def tree():
    cfg = jgpt2.get_config("gpt2-tiny")
    return jax.tree.map(np.asarray, jgpt2.init_params(cfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def engine(tree):
    return dtt.init_inference(dtt.get_config("gpt2-tiny"), params=params_from_numpy(tree, "cpu"),
                              dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def jax_engine(tree):
    cfg = jgpt2.get_config("gpt2-tiny", attn_impl="jnp")
    return JaxInferenceEngine(jgpt2.make_module(cfg), params=jax.tree.map(jnp.asarray, tree),
                              dtype=jnp.float32)


def _mixed_requests(n=16, seed=7):
    rs = np.random.RandomState(seed)
    plens = [2, 5, 8, 12, 7, 3, 11, 4] * 2
    return [(rs.randint(0, VOCAB, (plens[i],)).astype(np.int32), 6 if i % 7 else (1, 3, 8)[i // 7])
            for i in range(n)]


def _streams(srv, reqs, seed0=0):
    subs = [srv.submit(p, max_new_tokens=n, seed=seed0 + i) for i, (p, n) in enumerate(reqs)]
    srv.run()
    return [list(r.tokens) for r in subs]


def _demote_all(srv):
    """Every index entry through the demotion path, the copies landed."""
    srv.prefix_cache.evict(keep=0)
    srv.tiering.flush()


def _finish(srv):
    srv.drain()
    srv.release_prefix_cache()
    srv.check_no_leaks()
    srv.tiering.close()


# ---------------------------------------------------------------------------
# config and the host store
# ---------------------------------------------------------------------------

def test_tiering_config(engine):
    with pytest.raises(DeepSpeedConfigError, match="prefix_cache"):
        engine.serve(dict(BASE, **TIERED))
    with pytest.raises(DeepSpeedConfigError, match="policy"):
        engine.serve(dict(BASE, prefix_cache={"enabled": True},
                          tiering={"enabled": True, "policy": "clairvoyant"}))
    srv = engine.serve(dict(BASE, prefix_cache={"enabled": True}, tiering={"enabled": True}))
    assert srv.tiering.store.budget_pages == srv.allocator.capacity  # 0 = auto
    assert len(srv.executables) == srv.expected_executables == 4
    assert srv.executables[-1].name == "serving_kv_restore"
    srv.tiering.close()
    off = engine.serve(dict(BASE))
    assert "kv_tiering" not in off.stats()
    assert off.host_metadata_breakdown()["kv_host_tier_bytes"] == 0


def _store(budget=4, dtype=torch.float32, quantized=False, crc=True):
    return HostPageStore(budget, n_layer=2, n_kv_head=1, page_size=4, head_dim=2,
                         dtype=dtype, quantized=quantized, crc=crc)


def test_host_page_store():
    """Round trip and accounting, crc mismatch as a cold miss, duplicate
    and full reservations, spill-order LRU, the int8 sidecar, and a bf16
    page checksummed through its 16-bit words."""
    st = _store()
    k = np.arange(16, dtype=np.float32).reshape(2, 1, 4, 2)
    st.put(("a",), 3, k, k * 2)
    assert ("a",) in st and len(st) == 1
    got_k, got_v, got_s = st.get(("a",))
    assert np.array_equal(got_k.numpy(), k) and np.array_equal(got_v.numpy(), k * 2)
    assert got_s is None
    assert st.used_bytes() == st.page_bytes == 2 * k.nbytes
    assert st.host_bytes() == st.page_bytes * st.budget_pages
    st.check_consistent()
    slot = st._entries[("a",)].slot
    st.k_codes[slot, 0, 0, 0, 0] += 1.0  # bit-rot the host buffer
    assert st.get(("a",)) is None and st.crc_failures == 1 and ("a",) not in st
    st.check_consistent()

    st = _store(budget=2)
    z = np.zeros((2, 1, 4, 2), np.float32)
    st.put(("a",), 0, z, z)
    with pytest.raises(HostTierError, match="already holds"):
        st.reserve(("a",), 1)
    st.put(("b",), 1, z, z)
    with pytest.raises(HostTierError, match="full"):
        st.reserve(("c",), 2)
    assert st.drop_lru()[0] == ("a",)  # first spilled goes first
    st.check_consistent()

    st = _store(dtype=torch.int8, quantized=True)
    q = np.full((2, 1, 4, 2), 7, np.int8)
    s = np.full((2, 1, 2), 0.5, np.float32)
    st.put(("q",), 0, q, q, s)
    assert np.array_equal(st.get(("q",))[2].numpy(), s)
    assert st.page_bytes == 2 * q.nbytes + s.nbytes

    st = _store(dtype=torch.bfloat16)
    kb = torch.linspace(-2, 2, 16).reshape(2, 1, 4, 2).to(torch.bfloat16)
    st.put(("b",), 0, kb, kb)
    assert torch.equal(st.get(("b",))[0], kb)
    slot = st._entries[("b",)].slot
    st.v_codes[slot].view(torch.int16)[0, 0, 0, 0] ^= 1  # one mantissa bit
    assert st.get(("b",)) is None and st.crc_failures == 1


# ---------------------------------------------------------------------------
# the headline: streams and counters, tier on vs off vs the JAX engine
# ---------------------------------------------------------------------------

_TIER_COUNTERS = ("spills", "restores", "restore_misses", "host_evictions", "orphan_drops",
                  "crc_failures", "spilled_bytes", "restored_bytes", "host_bytes", "host_pages")


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_mixed_suite_tier_on_equals_off_and_jax(engine, jax_engine, kv):
    """Speculation + prefix sharing + chunked prefill (+ int8 pages): the
    tier on re-emits the tier-off streams, and after demoting every
    cached prefix a resubmitted suite restores from the host with the same
    tokens; each stream, the tier's counters and the prefix cache's
    demotions and adoptions equal the JAX engine's on the same traffic."""
    cfg = dict(BASE, kv_cache_dtype=kv, **ALL_FEATURES)
    reqs = _mixed_requests()
    off = _streams(engine.serve(cfg), reqs)
    out = {}
    for name, eng in (("torch", engine), ("jax", jax_engine)):
        srv = eng.serve(dict(cfg, **TIERED))
        first = _streams(srv, reqs)
        _demote_all(srv)
        spills = srv.tiering.spills
        second = _streams(srv, reqs, seed0=0)
        st = srv.stats()
        out[name] = (first, second, spills,
                     {k: st["kv_tiering"][k] for k in _TIER_COUNTERS},
                     st["prefix_demotions"], st["prefix_adoptions"])
        if name == "torch":
            assert len(srv.executables) == srv.expected_executables == 4
        srv.drain()
        srv.release_prefix_cache()
        srv.check_no_leaks()
        srv.tiering.close()
    first, second, spills, counters, _, adoptions = out["torch"]
    assert first == off and second == off
    assert spills > 0 and counters["restores"] > 0 and adoptions > 0
    assert counters["crc_failures"] == 0
    assert out["torch"] == out["jax"]


# ---------------------------------------------------------------------------
# the drain across both tiers
# ---------------------------------------------------------------------------

def _tiered(engine, **extra):
    return engine.serve(dict(BASE, prefix_cache={"enabled": True}, **TIERED, **extra))


def test_mid_load_drain_deadline_zero_leak_free(engine):
    srv = _tiered(engine)
    rs = np.random.RandomState(3)
    for i in range(3):
        srv.submit(rs.randint(0, VOCAB, (8,)).astype(np.int32), max_new_tokens=4, seed=i)
    srv.run()
    _demote_all(srv)
    assert len(srv.tiering.store) > 0
    for i in range(6):
        srv.submit(rs.randint(0, VOCAB, (8,)).astype(np.int32), max_new_tokens=8, seed=10 + i)
    for _ in range(3):
        srv.step()
    srv.drain(deadline_s=0.0)
    srv.release_prefix_cache()
    srv.check_no_leaks()  # the cross-tier consistency too
    srv.tiering.close()


def test_drain_reconciles_heat_ledger_across_tiers(engine, tmp_path):
    srv = _tiered(engine)
    tracer = KVHeatTracer(str(tmp_path / "heat.jsonl"))
    srv.attach_heat(tracer)
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, VOCAB, (8,)).astype(np.int32) for _ in range(4)]
    for i, p in enumerate(prompts):
        srv.submit(p, max_new_tokens=4, seed=i)
    srv.run()
    _demote_all(srv)
    srv.submit(prompts[0], max_new_tokens=2, seed=99)  # restore traffic under the ledger
    srv.run()
    assert srv.tiering.restores > 0
    led = srv._heat_decode
    assert led.reconcile(srv.allocator, srv.prefix_cache, host_store=srv.tiering.store) is None
    srv.drain()
    srv.release_prefix_cache()
    srv.check_no_leaks()
    assert led.host_handles == srv.tiering.store.handles()
    srv.detach_heat()
    tracer.close()
    srv.tiering.close()


def test_crc_drop_reaches_heat_ledger(engine, tmp_path):
    """A crc-failed entry that ``get`` drops is a host drop in the ledger
    too (its V event): the ledger and the store keep the same handles, so
    the drain's cross-tier check holds after a corrupted restore."""
    srv = _tiered(engine)
    tracer = KVHeatTracer(str(tmp_path / "heat.jsonl"))
    srv.attach_heat(tracer)
    p = np.random.RandomState(17).randint(0, VOCAB, (12,)).astype(np.int32)
    r0 = srv.submit(p, max_new_tokens=3, seed=0)
    srv.run()
    _demote_all(srv)
    store = srv.tiering.store
    key = srv.prefix_cache.chain_keys(p)[0]
    store.k_codes[store._entries[key].slot, 0, 0, 0, 0] += 1.0
    n_v = sum(1 for ev in srv._heat_decode._events if ev[0] == "V")
    r1 = srv.submit(p, max_new_tokens=3, seed=0)
    srv.run()
    assert r1.tokens == r0.tokens and srv.tiering.stats()["crc_failures"] == 1
    assert sum(1 for ev in srv._heat_decode._events if ev[0] == "V") > n_v
    assert srv._heat_decode.host_handles == store.handles()
    _finish(srv)
    srv.detach_heat()
    tracer.close()


def test_sigterm_under_tiered_load_leak_free(engine):
    srv = _tiered(engine)
    rs = np.random.RandomState(5)
    reqs = [srv.submit(rs.randint(0, VOCAB, (8,)).astype(np.int32), max_new_tokens=6, seed=i)
            for i in range(5)]
    with PreemptionGuard() as guard:
        steps = 0
        while srv.queue or any(s.request is not None for s in srv.slots):
            srv.step()
            steps += 1
            if steps == 2:
                signal.raise_signal(signal.SIGTERM)
            if guard.should_stop():
                srv.drain(deadline_s=30.0)
                break
    assert all(r.done for r in reqs)
    assert {r.status for r in reqs} <= {RequestStatus.FINISHED, RequestStatus.PREEMPTED}
    srv.release_prefix_cache()
    srv.check_no_leaks()
    srv.tiering.close()


# ---------------------------------------------------------------------------
# the restore path
# ---------------------------------------------------------------------------

def test_restore_under_pool_pressure(engine):
    """A tight pool (the spill pump and the admission relief valve both
    engage), the sessions resubmitted after demotion: restores fire and
    every stream equals the roomy pool's."""
    roomy = dict(BASE, prefix_cache={"enabled": True})
    rs = np.random.RandomState(11)
    reqs = [(rs.randint(0, VOCAB, (12,)).astype(np.int32), 4) for _ in range(8)]
    base = _streams(engine.serve(roomy), reqs)
    srv = engine.serve(dict(roomy, num_pages=24, **TIERED))
    assert _streams(srv, reqs) == base
    _demote_all(srv)
    assert _streams(srv, reqs, seed0=0) == base
    st = srv.tiering.stats()
    assert st["restores"] > 0 and st["crc_failures"] == 0
    _finish(srv)


def test_corrupt_host_buffer_recomputes_cold(engine, tmp_path):
    """One flipped value in a spilled page: the crc turns the restore into
    a cold miss (counted), the prefix recomputes, and the tokens are the
    same; an intact restore is traced as a ``kv_restore`` event."""
    from deepspeed_tpu_torch.telemetry.request_trace import (
        WAIT_CAUSES,
        RequestTracer,
        load_request_records,
    )

    assert "kv_restore" in WAIT_CAUSES
    rs = np.random.RandomState(13)
    p = rs.randint(0, VOCAB, (12,)).astype(np.int32)
    srv = _tiered(engine)
    r0 = srv.submit(p, max_new_tokens=6, seed=0)
    srv.run()
    _demote_all(srv)
    store = srv.tiering.store
    key = srv.prefix_cache.chain_keys(p)[0]  # the chain root: the walk's first read
    assert key in store
    store.k_codes[store._entries[key].slot, 0, 0, 0, 0] += 1.0
    r1 = srv.submit(p, max_new_tokens=6, seed=0)
    srv.run()
    assert list(r1.tokens) == list(r0.tokens)
    st = srv.tiering.stats()
    assert st["crc_failures"] >= 1 and st["restore_misses"] >= 1
    _finish(srv)

    tracer = RequestTracer(str(tmp_path / "req.jsonl"))
    srv = engine.serve(dict(BASE, prefix_cache={"enabled": True}, **TIERED), tracer=tracer)
    srv.submit(p, max_new_tokens=2, seed=0)
    srv.run()
    _demote_all(srv)
    r2 = srv.submit(p, max_new_tokens=2, seed=0)
    srv.run()
    assert srv.tiering.restores > 0 and r2.prefix_shared_tokens > 0
    srv.drain()
    rec = next(r for r in load_request_records(tracer.file_path) if r.get("id") == r2.id)
    restores = [e for e in rec["events"] if e["e"] == "kv_restore"]
    assert restores and restores[0]["bytes"] == srv.tiering.store.page_bytes
    srv.release_prefix_cache()
    srv.check_no_leaks()
    srv.tiering.close()
    tracer.close()


def test_stats_and_host_metadata_itemize_host_bytes(engine):
    srv = _tiered(engine)
    srv.submit(np.random.RandomState(31).randint(0, VOCAB, (12,)).astype(np.int32),
               max_new_tokens=4, seed=0)
    srv.run()
    _demote_all(srv)
    st = srv.stats()["kv_tiering"]
    assert st["enabled"] and st["spills"] > 0
    assert st["host_bytes"] == srv.tiering.store.host_bytes()
    meta = srv.host_metadata_breakdown()
    assert meta["kv_host_tier_bytes"] == st["host_bytes"]
    assert meta["total_bytes"] >= meta["kv_host_tier_bytes"]
    assert srv.stats()["prefix_demotions"] == st["spills"]
    _finish(srv)


def test_close_with_spills_queued_ends_the_worker(engine):
    """close() while the spill worker is busy with one batch and a second
    batch waits behind it: the worker drains both and exits, and close()
    returns without waiting out its join timeout (the worker used to
    clear the wake close() had set and wait forever)."""
    import threading
    import time

    srv = _tiered(engine)
    rs = np.random.RandomState(37)
    for i in range(3):
        srv.submit(rs.randint(0, VOCAB, (12,)).astype(np.int32), max_new_tokens=4, seed=i)
    srv.run()
    tier, pc = srv.tiering, srv.prefix_cache
    assert len(pc) >= 2
    entered, gate = threading.Event(), threading.Event()
    seal = tier.store.seal

    def held_seal(hid):
        entered.set()
        gate.wait()
        seal(hid)

    tier.store.seal = held_seal
    pc.evict(keep=len(pc) - 1)  # batch 1: the worker takes it and holds
    assert entered.wait(5.0)
    pc.evict(keep=0)            # batch 2: queued behind it
    closer = threading.Thread(target=tier.close)
    t0 = time.perf_counter()
    closer.start()
    gate.set()
    closer.join(10.0)
    assert not closer.is_alive() and not tier._worker.is_alive()
    assert time.perf_counter() - t0 < 4.0
    assert tier.stats()["spills"] == srv.stats()["prefix_demotions"] >= 2
    tier.store.seal = seal
    srv.drain()
    srv.release_prefix_cache()
    srv.check_no_leaks()


# ---------------------------------------------------------------------------
# D lands before the F/E pair: a seeded lockstep fuzz
# ---------------------------------------------------------------------------

class _FakePSet:
    """CPU tensors standing in for the pools: what demote_begin reads."""

    def __init__(self, n_layer=2, pages=33, kv=1, page=2, d=2):
        g = torch.Generator().manual_seed(0)
        self.k_pool = torch.rand((n_layer, pages, kv, page, d), generator=g)
        self.v_pool = self.k_pool * 2
        self.scales = None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lockstep_fuzz_d_before_f_e(seed):
    """Seeded random walks over PageAllocator + PrefixCache with the tier
    as the demote sink: at every step the ledger's cross-tier mirror
    reconciles, and each demotion's D record is followed at once by its
    page's F then E."""
    rs = np.random.RandomState(seed)
    page = 2
    alloc = PageAllocator(num_pages=33)
    cache = PrefixCache(alloc, page_size=page, max_pages=12)
    led = KVHeatLedger("fuzz", alloc.capacity,
                       sink=SimpleNamespace(_seal=lambda led: None,
                                            _observe_lifetime=lambda pool, dt: None),
                       segment_events=1 << 30)
    alloc.heat = led
    cache.heat = led
    store = HostPageStore(8, n_layer=2, n_kv_head=1, page_size=page, head_dim=2,
                          dtype=torch.float32)
    pset = _FakePSet(page=page)
    tier = KVTieringEngine(store, pset)
    tier.ledger = led
    cache.demote_sink = tier
    cache.victim_order = tier.select_leaf
    try:
        live = []
        for _ in range(150):
            op = rs.randint(3)
            if op == 0 and alloc.free_pages >= 8:
                plen = int(rs.randint(1, 5)) * page
                prompt = rs.randint(0, 3, (plen,)).astype(np.int32)
                shared, _t, _cow = cache.lookup(prompt)
                if shared:
                    alloc.retain(shared)
                priv = alloc.alloc(plen // page + 1 - len(shared))
                pages = shared + priv
                cache.insert(prompt, pages[: plen // page])
                live.append(pages)
            elif op == 1 and live:
                alloc.free(live.pop(int(rs.randint(len(live)))))
            elif op == 2:
                cache.evict(need_free=int(rs.randint(0, 4)))
            tier.flush()
            assert led.reconcile(alloc, cache, host_store=store) is None
            store.check_consistent()
        for pages in live:
            alloc.free(pages)
        cache.clear()
        tier.flush()
        alloc.check_no_leaks()
        assert led.reconcile(alloc, cache, host_store=store) is None
        assert cache.demotions > 0
        # a spilled page's bytes are the pool's at the demotion
        for key, ent in store._entries.items():
            assert torch.equal(store.k_codes[ent.slot], pset.k_pool[:, ent.origin_page])
        evs = led._events
        d_seen = 0
        for i, ev in enumerate(evs):
            if ev[0] != "D":
                continue
            d_seen += 1
            p = ev[2]
            assert evs[i + 1][0] == "F" and p in evs[i + 1][2], evs[i:i + 3]
            assert evs[i + 2][0] == "E" and evs[i + 2][2] == p, evs[i:i + 3]
        assert d_seen == cache.demotions
    finally:
        tier.close()


# ---------------------------------------------------------------------------
# the live tier against the what-if simulator
# ---------------------------------------------------------------------------

def _scripted_trace(path, tracer_cls=KVHeatTracer):
    class Clock:
        t = 0.0

        def __call__(self):
            return self.t

    clk = Clock()
    tr = tracer_cls(str(path), clock=clk, flush_interval=1)
    led = tr.pool("decode", 16, page_size=4, page_bytes=2048)
    led._clock = clk
    led.seed({}, set(), 0.0)
    for rid in range(4):
        pages = list(range(rid * 3, rid * 3 + 3))
        led.alloc(pages)
        led.session_start(clk.t, rid % 2, rid, f"t{rid % 2}", pages)
        for s in range(4):
            clk.t += 0.25
            led.touch_step(clk.t, s + 1, [(rid % 2, pages[-1], len(pages))])
        led.register(pages[:1])
        clk.t += 0.5
        led.free(pages[1:])
    tr.flush()
    tr.close()
    return str(path)


@pytest.mark.parametrize("policy", ["idle_lru", "prefix_aware", "slot_priority"])
def test_replay_live_tier_matches_simulator_and_jax(tmp_path, policy):
    from deepspeed_tpu.serving.tiering import replay_live_tier as jax_replay
    from deepspeed_tpu.telemetry.kv_heat import load_heat_records as jax_load

    records = load_heat_records(_scripted_trace(tmp_path / "heat.jsonl"))
    sim = evaluate_spill_policies(records, "decode", resident_fraction=0.3,
                                  policies=(policy,))["policies"][policy]
    live = replay_live_tier(records, "decode", policy, resident_fraction=0.3)
    for field in sim:
        assert live.get(field) == sim[field], field
    assert live == jax_replay(jax_load(str(tmp_path / "heat.jsonl")), "decode", policy,
                              resident_fraction=0.3)
    with pytest.raises(HostTierError):
        replay_live_tier(records, "decode", "oracle")
