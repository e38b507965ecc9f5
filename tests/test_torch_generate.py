"""Offline generation in the port on the CPU, mirroring
``tests/unit/test_inference.py::TestKVCacheDecode`` (gpt2-tiny, fp32, the
same numpy weights in both packages):

- ``forward_cached``: the prefill's logits equal the full forward's to
  1e-5, incremental decode equals recomputation to 1e-4;
- greedy ``InferenceEngine.generate`` token-identical to the JAX
  package's ``InferenceEngine.generate``, bucketed and unbucketed, at
  several prompt lengths, and the port's bucketed tokens equal its
  unbucketed ones;
- the ``max_len`` error, the ``max_new_tokens == 1`` edge, sampled
  generation equal to the JAX engine's, ``forward`` / ``engine(batch)``, the
  prompt buckets, and weight-only int8 accepted."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.inference.engine import InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops import decode_attention as tda
from deepspeed_tpu_torch.runtime.config import NotPortedError
from deepspeed_tpu_torch.utils.weights import params_from_numpy

VOCAB = 512


@pytest.fixture(scope="module")
def tree():
    cfg = jgpt2.get_config("gpt2-tiny")
    return jax.tree.map(np.asarray, jgpt2.init_params(cfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def cfg():
    return tgpt2.get_config("gpt2-tiny")


@pytest.fixture(scope="module")
def params(tree):
    return params_from_numpy(tree, "cpu")


@pytest.fixture(scope="module")
def jax_engine(tree):
    cfg = jgpt2.get_config("gpt2-tiny")
    return JaxInferenceEngine(jgpt2.make_module(cfg), params=jax.tree.map(jnp.asarray, tree),
                              dtype=jnp.float32)


@pytest.fixture(scope="module")
def engine(tree):
    return dtt.init_inference("gpt2-tiny", params=params_from_numpy(tree, "cpu"),
                              dtype=torch.float32, device="cpu")


def _ids(seed, shape):
    return np.random.RandomState(seed).randint(0, VOCAB, shape).astype(np.int32)


# ---- forward_cached ----------------------------------------------------------

def test_prefill_matches_full_forward(cfg, params, tree):
    ids = torch.from_numpy(_ids(0, (2, 12))).long()
    full = tgpt2.forward(cfg, params, ids)
    cache = tgpt2.init_cache(cfg, 2, 32, dtype=torch.float32)
    logits, cache = tgpt2.forward_cached(cfg, params, ids, cache)
    torch.testing.assert_close(logits, full[:, -1], atol=1e-5, rtol=1e-5)
    assert cache.pos == 12
    jfull = jgpt2.forward(jgpt2.get_config("gpt2-tiny"), jax.tree.map(jnp.asarray, tree),
                          jnp.asarray(ids.numpy()))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jfull[:, -1]), atol=1e-5, rtol=1e-5)


def test_incremental_decode_matches_recompute(cfg, params):
    rs = np.random.RandomState(1)
    ids = torch.from_numpy(rs.randint(0, VOCAB, (2, 8))).long()
    cache = tgpt2.init_cache(cfg, 2, 16, dtype=torch.float32)
    _, cache = tgpt2.forward_cached(cfg, params, ids, cache)
    for _ in range(3):
        nxt = torch.from_numpy(rs.randint(0, VOCAB, (2, 1))).long()
        dec, cache = tgpt2.forward_cached(cfg, params, nxt, cache)
        ids = torch.cat([ids, nxt], dim=1)
        full = tgpt2.forward(cfg, params, ids)[:, -1]
        torch.testing.assert_close(dec, full, atol=1e-4, rtol=1e-4)


def test_logits_at_reads_the_true_last_position(cfg, params):
    ids = torch.from_numpy(_ids(2, (2, 10))).long()
    padded = torch.zeros(2, 16, dtype=torch.long)
    padded[:, :10] = ids
    want, _ = tgpt2.forward_cached(cfg, params, ids, tgpt2.init_cache(cfg, 2, 20, torch.float32))
    got, cache = tgpt2.forward_cached(cfg, params, padded,
                                      tgpt2.init_cache(cfg, 2, 20, torch.float32), logits_at=9)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert cache.pos == 16


def test_generate_greedy_matches_recompute(cfg, params):
    ids = torch.from_numpy(_ids(2, (2, 6))).long()
    out = tgpt2.generate(cfg, params, ids, max_new_tokens=5, cache_dtype=torch.float32)
    ref = ids
    for _ in range(5):
        lg = tgpt2.forward(cfg, params, ref)[:, -1]
        ref = torch.cat([ref, lg.argmax(-1)[:, None]], dim=1)
    assert torch.equal(out, ref[:, 6:])
    assert tda.LAUNCHES["decode_attention"] == 0  # the CPU runs the plain version


# ---- InferenceEngine.generate against the JAX package's -----------------------

@pytest.mark.parametrize("S", [3, 6, 9, 17])
def test_generate_matches_jax_bucketed_and_unbucketed(S, tree, engine, jax_engine):
    """Greedy tokens equal the JAX engine's with its default power-of-two
    buckets (S=3 → 4, 6 → 8, 9 → 16, 17 → 32) and with bucketing off."""
    ids = _ids(S, (2, S))
    want = np.asarray(jax_engine.generate(ids, max_new_tokens=6))
    got = engine.generate(ids, max_new_tokens=6)
    np.testing.assert_array_equal(got, want)
    assert engine._prompt_bucket(S, 6) == jax_engine._prompt_bucket(S, 6)
    cfg_j = jgpt2.get_config("gpt2-tiny")
    jax_off = JaxInferenceEngine(jgpt2.make_module(cfg_j), params=jax.tree.map(jnp.asarray, tree),
                                 dtype=jnp.float32, config={"prompt_bucket_sizes": []})
    port_off = dtt.init_inference("gpt2-tiny", params=params_from_numpy(tree, "cpu"),
                                  dtype=torch.float32, device="cpu",
                                  config={"prompt_bucket_sizes": []})
    assert port_off._prompt_bucket(S, 6) is None
    unb = port_off.generate(ids, max_new_tokens=6)
    np.testing.assert_array_equal(unb, np.asarray(jax_off.generate(ids, max_new_tokens=6)))
    np.testing.assert_array_equal(unb, got)


def test_generate_one_new_token_edge(engine, jax_engine):
    ids = _ids(4, (3, 5))
    got = engine.generate(ids, max_new_tokens=1)
    assert got.shape == (3, 6)
    np.testing.assert_array_equal(got, np.asarray(jax_engine.generate(ids, max_new_tokens=1)))


def test_generate_padded_equals_unpadded(cfg, params):
    """The bucket's garbage K/V past the prompt never reaches a token."""
    ids = torch.from_numpy(_ids(5, (2, 7))).long()
    want = tgpt2.generate(cfg, params, ids, 8, cache_dtype=torch.float32)
    for bucket in (8, 16, 32):
        padded = torch.full((2, bucket), 77, dtype=torch.long)
        padded[:, :7] = ids
        got = tgpt2.generate(cfg, params, padded, 8, cache_dtype=torch.float32, prompt_len=7)
        assert torch.equal(got, want), f"bucket {bucket}"


def test_max_len_error_contract(cfg, params):
    ids = torch.zeros(1, 100, dtype=torch.long)
    with pytest.raises(ValueError, match="max_len"):
        tgpt2.generate(cfg, params, ids, max_new_tokens=40)  # 140 > n_positions 128
    with pytest.raises(ValueError, match="silently overwrite"):
        tgpt2.generate(cfg, params, ids[:, :10], max_new_tokens=8, max_len=12)
    with pytest.raises(ValueError, match="n_positions"):
        tgpt2.generate(cfg, params, torch.zeros(1, 120, dtype=torch.long), 10, prompt_len=100)


def test_sampled_generate_is_seeded_and_reproducible(engine, jax_engine):
    """Sampled tokens are the JAX engine's for the same seed (its keys:
    PRNGKey(seed) for the first token, split(fold_in(., 1), N - 1) after)."""
    ids = _ids(6, (2, 5))
    a = engine.generate(ids, max_new_tokens=8, temperature=1.0, seed=3, top_k=40, top_p=0.9)
    b = engine.generate(ids, max_new_tokens=8, temperature=1.0, seed=3, top_k=40, top_p=0.9)
    c = engine.generate(ids, max_new_tokens=8, temperature=1.0, seed=4, top_k=40, top_p=0.9)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.shape == (2, 13) and (a[:, 5:] < VOCAB).all() and (a[:, 5:] >= 0).all()
    np.testing.assert_array_equal(a[:, :5], ids)
    for seed, got in ((3, a), (4, c)):
        want = jax_engine.generate(ids, max_new_tokens=8, temperature=1.0, seed=seed, top_k=40,
                                   top_p=0.9)
        np.testing.assert_array_equal(got, np.asarray(want))


def test_forward_and_call_match_jax(engine, jax_engine):
    ids = _ids(7, (2, 9))
    want = np.asarray(jax_engine.forward({"input_ids": jnp.asarray(ids)}))
    np.testing.assert_allclose(engine.forward({"input_ids": ids}).numpy(), want,
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(engine({"input_ids": torch.from_numpy(ids)}).numpy(), want,
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("buckets", [None, [16, 64], [4]])
@pytest.mark.parametrize("S,new", [(1, 4), (5, 4), (16, 4), (30, 8), (100, 20), (120, 8)])
def test_prompt_buckets_match_jax(tree, buckets, S, new):
    cfg_j = jgpt2.get_config("gpt2-tiny")
    conf = {} if buckets is None else {"prompt_bucket_sizes": buckets}
    j = JaxInferenceEngine(jgpt2.make_module(cfg_j), params=jax.tree.map(jnp.asarray, tree),
                           dtype=jnp.float32, config=dict(conf))
    t = dtt.init_inference("gpt2-tiny", params=params_from_numpy(tree, "cpu"),
                           dtype=torch.float32, device="cpu", config=dict(conf))
    assert t._prompt_bucket(S, new) == j._prompt_bucket(S, new)


def test_config_keys_and_weight_only_int8(tree):
    """Weight-only int8 is ported: ``dtype="int8"`` (a string, torch.int8 or
    the config's dtype) quantizes the block weights with 1 group and
    computes in bf16; ``quantization_setting`` quantizes at the given dtype
    with its (last) group count. An unknown config key still raises."""
    eng = dtt.init_inference("gpt2-tiny", params=params_from_numpy(tree, "cpu"), device="cpu",
                             dtype=torch.float32,
                             config={"max_out_tokens": 256, "generate_cache_size": 4,
                                     "prompt_bucket_sizes": [8]})
    assert eng.max_tokens == 256 and eng._prompt_bucket(5, 4) == 8 and not eng.quantized
    for kw in ({"dtype": "int8"}, {"dtype": torch.int8}, {"config": {"dtype": "int8"}}):
        e = dtt.init_inference("gpt2-tiny", params=params_from_numpy(tree, "cpu"),
                               device="cpu", **kw)
        w = e.params["blocks"]["attn"]["c_attn_w"]
        assert e.quantized and e.dtype == torch.bfloat16 and e.quantize_groups == 1
        assert w.q.dtype == torch.int8 and w.q.shape == (2, 1, 64, 192)
        assert w.scale.dtype == torch.bfloat16 and e.params["wte"].dtype == torch.bfloat16
    for setting, groups in ((64, 64), ((True, 8), 8)):
        e = dtt.init_inference("gpt2-tiny", params=params_from_numpy(tree, "cpu"), device="cpu",
                               dtype=torch.float32, config={"quantization_setting": setting})
        w = e.params["blocks"]["mlp"]["c_fc_w"]
        assert e.quantized and e.quantize_groups == groups and e.dtype == torch.float32
        assert w.q.shape == (2, groups, 64 // groups, 256) and w.scale.dtype == torch.float32
    with pytest.raises(NotPortedError):
        dtt.init_inference("gpt2-tiny", device="cpu", config={
            "telemetry": {"enabled": True, "introspection": {"enabled": True}}})
