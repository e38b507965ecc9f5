"""int8 KV pages in the port's serving path on the CPU, mirroring
``tests/unit/test_serving_quant.py`` (gpt2-tiny, fp32 compute, the same
numpy weights in both packages):

- the four serving programs against the JAX package's with int8 pools:
  tokens equal, scales and dequantized pages to 1e-5;
- the 16-request mixed suite with ``kv_cache_dtype="int8"`` token-identical
  to the JAX ServingEngine's int8 streams; with speculation, the prefix
  cache and chunking on, identical to int8 without them and to the float32
  pool on the pinned seeds;
- inside the port: the verify step leaves the pool (codes and scales)
  bit-identical to sequential decode; a COW fork leaves the shared page's
  codes and scale row byte-identical; a prefix hit gives a cold engine's
  tokens; the pool's bytes are halved, counted on the tensors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.inference.engine import InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.ops.quantizer import dequantize_kv_pages as j_dequantize
from deepspeed_tpu.serving import model as jmodel
from deepspeed_tpu.serving.kv_cache import init_pools as j_init_pools
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops.quantizer import dequantize_kv_pages
from deepspeed_tpu_torch.serving import RequestStatus, init_pools, pool_bytes, scales_bytes
from deepspeed_tpu_torch.serving import model as tmodel
from deepspeed_tpu_torch.utils.weights import params_from_numpy

TOL = dict(atol=1e-5, rtol=1e-5)
PAGE, P = 4, 24
BASE = {"max_slots": 4, "page_size": 4, "num_pages": 64, "max_prompt_len": 12,
        "max_new_tokens": 8}
INT8 = dict(BASE, kv_cache_dtype="int8")
ALL_FEATURES = {"speculative": {"enabled": True, "k": 3}, "prefix_cache": {"enabled": True},
                "prefill_chunk_tokens": 8}


@pytest.fixture(scope="module")
def tree():
    cfg = jgpt2.get_config("gpt2-tiny")
    return jax.tree.map(np.asarray, jgpt2.init_params(cfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def jax_engine(tree):
    cfg = jgpt2.get_config("gpt2-tiny")
    return JaxInferenceEngine(jgpt2.make_module(cfg), params=jax.tree.map(jnp.asarray, tree),
                              dtype=jnp.float32)


@pytest.fixture(scope="module")
def engine(tree):
    return dtt.init_inference(dtt.get_config("gpt2-tiny"), params=params_from_numpy(tree, "cpu"),
                              dtype=torch.float32, device="cpu")


def _mixed_requests(vocab=512, n=16, seed=7):
    """test_serving_quant.py's 16-request mixed suite."""
    rs = np.random.RandomState(seed)
    plens = [2, 5, 8, 12, 7, 3, 11, 4] * 2
    return [(rs.randint(0, vocab, (plens[i],)).astype(np.int32),
             6 if i % 7 else (1, 3, 8)[i // 7]) for i in range(n)]


def _run(srv, reqs):
    subs = [srv.submit(p, max_new_tokens=n, seed=i) for i, (p, n) in enumerate(reqs)]
    srv.run()
    return subs


# ---------------------------------------------------------------------------
# the programs against the JAX package's
# ---------------------------------------------------------------------------

def _int8_pools(seed):
    """Random int8 codes and scales in both packages' layouts: [L, P, KV,
    page, D] codes and [L, P, KV, 2] scales (page 0 scratch included)."""
    cfg = jgpt2.get_config("gpt2-tiny")
    rs = np.random.RandomState(seed)
    shape = (cfg.n_layer, P, cfg.n_head, PAGE, cfg.head_dim)
    k = rs.randint(-127, 128, shape).astype(np.int8)
    v = rs.randint(-127, 128, shape).astype(np.int8)
    sc = (np.abs(rs.randn(cfg.n_layer, P, cfg.n_head, 2)) * 0.05).astype(np.float32)
    return k, v, sc


def _assert_pools_close(tk, tv, tsc, jk, jv, jsc, pages):
    """Scales to 1e-5 and the dequantized pages to 1e-5 (a code may sit
    one step apart where the two packages' K/V differ in the last bit)."""
    np.testing.assert_allclose(tsc.numpy()[:, pages], np.asarray(jsc)[:, pages], **TOL)
    for tp, jp, c in ((tk, jk, 0), (tv, jv, 1)):
        got = dequantize_kv_pages(tp[:, pages], tsc[:, pages][..., c]).numpy()
        want = np.asarray(j_dequantize(jnp.asarray(jp)[:, pages], jnp.asarray(jsc)[:, pages][..., c]))
        step = np.asarray(jsc)[:, pages][..., c][..., None, None]
        assert np.all(np.abs(got - want) <= 1e-5 + 1.001 * step)
        assert np.mean(tp[:, pages].numpy() == np.asarray(jp)[:, pages]) > 0.999


@pytest.mark.parametrize("plen", [1, 5, 12])
def test_int8_paged_prefill(tree, plen):
    jcfg, tcfg = jgpt2.get_config("gpt2-tiny"), tgpt2.get_config("gpt2-tiny")
    k, v, sc = _int8_pools(plen)
    ids = np.zeros((1, 12), np.int32)
    ids[0, :plen] = np.random.RandomState(plen).randint(0, 512, plen)
    page_ids = np.array([5, 2, 0], np.int32)
    jk, jv, jsc, jtok = jmodel.paged_prefill(
        jcfg, jax.tree.map(jnp.asarray, tree), jnp.asarray(ids), jnp.int32(plen),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(page_ids), jax.random.PRNGKey(0),
        scales=jnp.asarray(sc),
    )
    tk, tv, tsc = (torch.from_numpy(x.copy()) for x in (k, v, sc))
    ttok = tmodel.paged_prefill(tcfg, params_from_numpy(tree, "cpu"), torch.from_numpy(ids).long(),
                                plen, tk, tv, torch.from_numpy(page_ids), scales=tsc)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    _assert_pools_close(tk, tv, tsc, jk, jv, jsc, [5, 2])


def test_int8_paged_decode_steps(tree):
    """Three decode steps over four slots (one inactive on scratch),
    crossing page boundaries, so offset-0 writes set fresh scales."""
    jcfg, tcfg = jgpt2.get_config("gpt2-tiny"), tgpt2.get_config("gpt2-tiny")
    k, v, sc = _int8_pools(7)
    bt = np.array([[3, 4, 5, 6, 7], [0, 0, 0, 0, 0], [8, 9, 10, 11, 12],
                   [13, 14, 15, 16, 17]], np.int32)
    seq_lens = np.array([3, 0, 7, 15], np.int32)
    jparams, tparams = jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")
    jk, jv, jsc = jnp.asarray(k), jnp.asarray(v), jnp.asarray(sc)
    tk, tv, tsc = (torch.from_numpy(x.copy()) for x in (k, v, sc))
    tok = np.array([11, 0, 200, 77], np.int32)
    for step in range(3):
        sl = seq_lens + np.array([1, 0, 1, 1], np.int32) * step
        jk, jv, jsc, jnext = jmodel.paged_decode_step(
            jcfg, jparams, jnp.asarray(tok), jnp.asarray(sl), jk, jv, jnp.asarray(bt),
            jnp.zeros((4, 2), jnp.uint32), scales=jsc,
        )
        tnext = tmodel.paged_decode_step(tcfg, tparams, torch.from_numpy(tok),
                                         torch.from_numpy(sl), tk, tv, torch.from_numpy(bt),
                                         scales=tsc)
        np.testing.assert_array_equal(tnext.numpy(), np.asarray(jnext), err_msg=f"step {step}")
        tok = tnext.numpy().astype(np.int32)
    _assert_pools_close(tk, tv, tsc, jk, jv, jsc, list(range(3, 18)))


@pytest.mark.parametrize("start,plen,C", [(0, 3, 4), (4, 10, 8), (8, 12, 8)])
def test_int8_paged_chunk_prefill(tree, start, plen, C):
    jcfg, tcfg = jgpt2.get_config("gpt2-tiny"), tgpt2.get_config("gpt2-tiny")
    k, v, sc = _int8_pools(11 + start)
    row = np.array([[7, 3, 12]], np.int32)
    ids = np.zeros((1, C), np.int32)
    seg = np.random.RandomState(start).randint(0, 512, plen)[start: start + C]
    ids[0, : len(seg)] = seg
    page_ids = np.zeros((C // PAGE,), np.int32)
    avail = row[0, start // PAGE: start // PAGE + C // PAGE]
    page_ids[: len(avail)] = avail
    jk, jv, jsc, jtok = jmodel.paged_chunk_prefill(
        jcfg, jax.tree.map(jnp.asarray, tree), jnp.asarray(ids), jnp.int32(start),
        jnp.int32(plen), jnp.asarray(k), jnp.asarray(v), jnp.asarray(page_ids),
        jnp.asarray(row), jax.random.PRNGKey(0), scales=jnp.asarray(sc),
    )
    tk, tv, tsc = (torch.from_numpy(x.copy()) for x in (k, v, sc))
    ttok = tmodel.paged_chunk_prefill(
        tcfg, params_from_numpy(tree, "cpu"), torch.from_numpy(ids), start, plen, tk, tv,
        torch.from_numpy(page_ids), torch.from_numpy(row), scales=tsc,
    )
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    _assert_pools_close(tk, tv, tsc, jk, jv, jsc, [int(p) for p in avail])


def test_int8_paged_verify_step(tree):
    jcfg, tcfg = jgpt2.get_config("gpt2-tiny"), tgpt2.get_config("gpt2-tiny")
    k, v, sc = _int8_pools(5)
    bt = np.array([[3, 4, 5, 6, 7], [0, 0, 0, 0, 0], [8, 9, 10, 11, 12],
                   [13, 14, 15, 16, 17]], np.int32)
    seq_lens = np.array([3, 0, 9, 18], np.int32)
    tokens = np.random.RandomState(3).randint(0, 512, (4, 4)).astype(np.int32)
    tokens[1] = 0
    jk, jv, jsc, jgreedy = jmodel.paged_verify_step(
        jcfg, jax.tree.map(jnp.asarray, tree), jnp.asarray(tokens), jnp.asarray(seq_lens),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt), scales=jnp.asarray(sc),
    )
    tk, tv, tsc = (torch.from_numpy(x.copy()) for x in (k, v, sc))
    tgreedy = tmodel.paged_verify_step(
        tcfg, params_from_numpy(tree, "cpu"), torch.from_numpy(tokens),
        torch.from_numpy(seq_lens), tk, tv, torch.from_numpy(bt), scales=tsc,
    )
    np.testing.assert_array_equal(tgreedy.numpy(), np.asarray(jgreedy))
    # page 0 takes several writes in an order neither framework fixes
    _assert_pools_close(tk, tv, tsc, jk, jv, jsc, list(range(3, 18)))


def test_int8_verify_pool_is_bitwise_sequential_decode(tree):
    """Fed the sequential decode stream as its drafts, the verify step
    emits that stream and leaves the pool (codes and scales) bit-identical
    to three decode steps; slot 1's writes cross a page boundary, so an
    offset-0 token sets a scale that the next token in the same step codes
    against."""
    tcfg = tgpt2.get_config("gpt2-tiny")
    params = params_from_numpy(tree, "cpu")
    bt = torch.tensor([[3, 4, 5, 6, 7], [8, 9, 10, 11, 12]], dtype=torch.int32)
    seq0, tok0 = np.array([5, 11], np.int32), np.array([17, 300], np.int32)
    k, v, sc = _int8_pools(9)
    dk, dv, dsc = (torch.from_numpy(x.copy()) for x in (k, v, sc))
    stream = [tok0]
    for step in range(3):
        nxt = tmodel.paged_decode_step(tcfg, params, torch.from_numpy(stream[-1]),
                                       torch.from_numpy(seq0 + step), dk, dv, bt, scales=dsc)
        stream.append(nxt.numpy().astype(np.int32))
    vk, vv, vsc = (torch.from_numpy(x.copy()) for x in (k, v, sc))
    greedy = tmodel.paged_verify_step(tcfg, params, torch.from_numpy(np.stack(stream[:3], 1)),
                                      torch.from_numpy(seq0), vk, vv, bt, scales=vsc)
    np.testing.assert_array_equal(greedy.numpy(), np.stack(stream[1:], axis=1))
    for a, b in ((dk, vk), (dv, vv), (dsc, vsc)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("T", [1, 3, 6])
def test_token_writes_at_once_equal_writes_in_order(T):
    """The T-token write equals T one-token writes in order, codes and
    scales, on real pages: slots whose consecutive positions open a page
    (offset 0) in the middle of the step, cross two page boundaries, or
    never reach offset 0."""
    rs = np.random.RandomState(T)
    L, P, KV, page, D = 2, 16, 2, 4, 8
    k0 = torch.from_numpy(rs.randint(-127, 128, (L, P, KV, page, D)).astype(np.int8))
    sc0 = torch.from_numpy((np.abs(rs.randn(L, P, KV, 2)) * 0.05).astype(np.float32))
    bt = torch.tensor([[1, 2, 3], [4, 5, 6], [7, 8, 9]])
    seq = torch.tensor([2, 4, 5])
    pos = seq[:, None] + torch.arange(T)[None, :]
    pidx, poff = bt.gather(1, pos // page), pos % page
    vals = torch.from_numpy(rs.randn(3, T, KV, D).astype(np.float32) * 3)
    at_once_k, at_once_s = k0.clone(), sc0.clone()
    tmodel._write_pool_tokens(at_once_k, at_once_s, 1, pidx, poff, vals, 1)
    in_order_k, in_order_s = k0.clone(), sc0.clone()
    for t in range(T):
        tmodel._write_pool_tokens(in_order_k, in_order_s, 1, pidx[:, t:t + 1],
                                  poff[:, t:t + 1], vals[:, t:t + 1], 1)
    assert torch.equal(at_once_k, in_order_k) and torch.equal(at_once_s, in_order_s)
    assert not torch.equal(at_once_k, k0)


def test_int8_prefill_kv_within_half_a_scale_of_f32(tree):
    """Layer 0's dequantized prompt pages sit within half a scale of the
    float32 pool's exact values, and the greedy token matches
    (test_prefill_kv_tolerance_vs_f32)."""
    tcfg = tgpt2.get_config("gpt2-tiny")
    params = params_from_numpy(tree, "cpu")
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 512, (1, 8)))
    page_ids = torch.tensor([1, 2])
    kq, vq, sc = init_pools(tcfg.n_layer, 16, tcfg.n_head, 4, tcfg.head_dim, torch.int8)
    kf, vf, none = init_pools(tcfg.n_layer, 16, tcfg.n_head, 4, tcfg.head_dim, torch.float32)
    assert none is None
    tq = tmodel.paged_prefill(tcfg, params, ids, 8, kq, vq, page_ids, scales=sc)
    tf = tmodel.paged_prefill(tcfg, params, ids, 8, kf, vf, page_ids)
    assert int(tq[0]) == int(tf[0])
    for pool_q, pool_f, c in ((kq, kf, 0), (vq, vf, 1)):
        deq = dequantize_kv_pages(pool_q[0, page_ids], sc[0, page_ids, :, c])
        half = sc[0, page_ids, :, c][..., None, None] / 2
        assert bool(((deq - pool_f[0, page_ids]).abs() <= half + 1e-7).all())


# ---------------------------------------------------------------------------
# the ServingEngine
# ---------------------------------------------------------------------------

def test_mixed_suite_int8_matches_the_jax_engine_and_features_and_f32(engine, jax_engine):
    """(a) the port's int8 streams equal the JAX ServingEngine's int8
    streams; (b) with every feature on they equal plain int8 serving and
    (c) the float32 pool's streams on these pinned seeds; the accept
    length stays within 5% of the f32 run's; every engine drains
    leak-free."""
    reqs = _mixed_requests()
    jsrv = jax_engine.serve(INT8)
    jreqs = _run(jsrv, reqs)
    jsrv.check_no_leaks()
    plain_srv = engine.serve(INT8)
    plain = _run(plain_srv, reqs)
    feat_srv = engine.serve(dict(INT8, **ALL_FEATURES))
    feat = _run(feat_srv, reqs)
    f32_srv = engine.serve(dict(BASE, kv_cache_dtype="float32", **ALL_FEATURES))
    f32 = _run(f32_srv, reqs)
    for i, (a, b, c, j) in enumerate(zip(plain, feat, f32, jreqs)):
        assert a.status == RequestStatus.FINISHED
        assert a.tokens == [int(x) for x in j.tokens], f"request {i}: port vs JAX int8"
        assert b.tokens == a.tokens, f"request {i}: features on vs off"
        assert b.tokens == c.tokens, f"request {i}: int8 vs f32"
    acc_q = feat_srv.stats()["spec_accept_len_mean"]
    acc_f = f32_srv.stats()["spec_accept_len_mean"]
    assert abs(acc_q - acc_f) <= 0.05 * acc_f
    st = feat_srv.stats()
    assert st["kv_cache_dtype"] == "int8"
    assert st["chunk_prefills"] > 0 and st["spec_steps"] > 0
    for srv in (plain_srv, feat_srv, f32_srv):
        srv.release_prefix_cache()
        srv.check_no_leaks()


def test_cow_fork_leaves_original_page_and_scale_pristine(engine):
    srv = engine.serve(dict(INT8, prefix_cache={"enabled": True}, prefill_chunk_tokens=8))
    prompt = np.random.RandomState(3).randint(0, 512, (8,)).astype(np.int32)
    r1 = srv.submit(prompt, max_new_tokens=6, seed=0)
    srv.run()
    shared = list(srv.prefix_cache.held_pages)
    assert shared, "prompt pages should be indexed"
    k_before = srv.k_pool[:, shared].clone()
    v_before = srv.v_pool[:, shared].clone()
    s_before = srv.kv_scales[:, shared].clone()
    r2 = srv.submit(prompt, max_new_tokens=6, seed=0)
    srv.run()
    assert srv.allocator.cow_forks_total == 1 and r2.cow_forked
    assert r2.tokens == r1.tokens
    assert torch.equal(srv.k_pool[:, shared], k_before)
    assert torch.equal(srv.v_pool[:, shared], v_before)
    assert torch.equal(srv.kv_scales[:, shared], s_before)
    srv.release_prefix_cache()
    srv.check_no_leaks()


def test_prefix_hit_tokens_identical_to_cold_engine(engine):
    cfg = dict(INT8, prefix_cache={"enabled": True}, prefill_chunk_tokens=8)
    srv = engine.serve(cfg)
    rs = np.random.RandomState(5)
    head = rs.randint(0, 512, (8,)).astype(np.int32)
    srv.submit(head, max_new_tokens=4, seed=0)
    srv.run()
    p2 = np.concatenate([head, rs.randint(0, 512, (3,)).astype(np.int32)])
    r_hit = srv.submit(p2, max_new_tokens=6, seed=0)
    srv.run()
    assert r_hit.prefix_shared_tokens > 0
    cold = engine.serve(cfg)
    r_cold = cold.submit(p2, max_new_tokens=6, seed=0)
    cold.run()
    assert r_hit.tokens == r_cold.tokens


def test_pool_bytes_halved_on_the_tensors(tree):
    """The int8 pool's code bytes are exactly half of the bf16 pool's and
    its scales are L·P·KV·2·4 bytes, counted on the tensors themselves."""
    eng = dtt.init_inference(dtt.get_config("gpt2-tiny"), params=params_from_numpy(tree, "cpu"),
                             dtype=torch.bfloat16, device="cpu")
    q = eng.serve(INT8)
    b = eng.serve(BASE)
    assert q.k_pool.dtype == torch.int8 and b.k_pool.dtype == torch.bfloat16
    assert b.kv_scales is None and q.kv_scales.dtype == torch.float32

    def nbytes(t):
        return t.numel() * t.element_size()

    cfg = eng.model_config
    assert 2 * (nbytes(q.k_pool) + nbytes(q.v_pool)) == nbytes(b.k_pool) + nbytes(b.v_pool)
    want_scales = cfg.n_layer * BASE["num_pages"] * cfg.n_head * 2 * 4
    assert nbytes(q.kv_scales) == want_scales == scales_bytes(cfg.n_layer, 64, cfg.n_head)
    st_q, st_b = q.stats(), b.stats()
    assert st_q["kv_pool_bytes"] == nbytes(q.k_pool) + nbytes(q.v_pool)
    assert st_q["kv_pool_bytes"] * 2 == st_b["kv_pool_bytes"]
    assert st_q["kv_scales_bytes"] == want_scales and st_b["kv_scales_bytes"] == 0
    assert (st_q["kv_cache_dtype"], st_b["kv_cache_dtype"]) == ("int8", "bfloat16")


def test_init_pools_grows_scales_and_bytes_split():
    k, v, sc = init_pools(2, 8, 2, 4, 8, dtype=torch.int8)
    jk, jv, jsc = j_init_pools(2, 8, 2, 4, 8, dtype=jnp.int8)
    assert k.dtype == torch.int8 and tuple(sc.shape) == tuple(jsc.shape) == (2, 8, 2, 2)
    assert sc.dtype == torch.float32 and float(sc.abs().max()) == 0.0
    assert init_pools(2, 8, 2, 4, 8, dtype=torch.float32)[2] is None
    assert pool_bytes(2, 8, 2, 4, 8, itemsize=1) * 2 == pool_bytes(2, 8, 2, 4, 8, itemsize=2)
    assert scales_bytes(2, 8, 2) == 2 * 8 * 2 * 2 * 4


def test_bf16_int8_serving_finishes_and_drains(tree):
    """bf16 compute over an int8 pool (the card's configuration): every
    request finishes within vocab, features on and off agree."""
    eng = dtt.init_inference(dtt.get_config("gpt2-tiny"), params=params_from_numpy(tree, "cpu"),
                             dtype=torch.bfloat16, device="cpu")
    reqs = _mixed_requests(seed=11)
    plain = _run(eng.serve(INT8), reqs)
    feat_srv = eng.serve(dict(INT8, **ALL_FEATURES))
    feat = _run(feat_srv, reqs)
    for a, b, (_, n) in zip(plain, feat, reqs):
        assert a.status == RequestStatus.FINISHED and len(a.tokens) == n
        assert all(0 <= x < 512 for x in a.tokens)
        assert b.tokens == a.tokens
    feat_srv.release_prefix_cache()
    feat_srv.check_no_leaks()


def test_drain_zero_leak_under_load(engine):
    srv = engine.serve(dict(INT8, **ALL_FEATURES))
    rs = np.random.RandomState(11)
    for i in range(8):
        srv.submit(rs.randint(0, 512, (6,)).astype(np.int32), max_new_tokens=8, seed=i)
    srv.step()
    srv.drain(deadline_s=0.0)
    srv.release_prefix_cache()
    srv.check_no_leaks()
