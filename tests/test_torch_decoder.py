"""The port's decoder (``models/decoder.py``) on the CPU, held against
``deepspeed_tpu.models.decoder`` axis by axis: learned (with OPT's offset),
rope (GPT-J interleaved and NeoX half split, partial ``rotary_dim``, θ),
alibi and no positions; sequential and parallel residuals, with and
without ``use_ln2``; gelu_new, gelu and relu; dense and SwiGLU MLPs; RMS
and layer norm; tied and untied heads with a bias; BLOOM's embedding
norm; ``attn_scale``; local windows that bite; GQA and MQA.

Each case feeds the same numpy tree (seeded) to both packages, fp32:
full-sequence logits within 2e-5, the prefill and one cached decode
step's logits within 2e-5, and greedy ``generate`` token for token, both
the function and ``init_inference(DecoderConfig, params).generate``. The
routes are JAX's: a full sequence goes to ``causal_attention`` (the flash
kernels on the card) with the window where one bites, a decode step to
``cached_attention`` (the decode kernel) unless alibi or a biting window
sends it to the plain grouped einsum."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.models import decoder as jdec
from deepspeed_tpu_torch.models import decoder as tdec
from deepspeed_tpu_torch.utils.weights import params_from_numpy
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 2e-5
BASE = dict(vocab_size=96, n_positions=40, n_embd=32, n_layer=2, n_head=4, ffn_dim=48)
CASES = {
    "opt_learned_relu": dict(pos_offset=2, activation="relu"),
    "gptj_rope_parallel_shared_ln": dict(
        pos_emb="rope", rope_style="gptj", rotary_dim=4, parallel_residual=True,
        use_ln2=False, tie_embeddings=False, lm_head_bias=True),
    "neox_rope_parallel_gelu": dict(
        pos_emb="rope", rope_style="neox", rotary_dim=2, parallel_residual=True,
        activation="gelu", tie_embeddings=False),
    "bloom_alibi_embed_ln": dict(pos_emb="alibi", embed_ln=True),
    "neo_local_windows_unscaled": dict(attn_scale=1.0, local_windows=(4, 0)),
    "mistral_gqa_swiglu_rms_window": dict(
        pos_emb="rope", rope_style="neox", norm="rmsnorm", mlp_type="swiglu", n_kv_head=2,
        rope_theta=50000.0, local_windows=(6, 6), tie_embeddings=False),
    "mqa_no_positions": dict(pos_emb="none", n_kv_head=1),
    "alibi_gqa": dict(pos_emb="alibi", n_kv_head=2),
}


def _tree(cfg, seed=0):
    rs = np.random.RandomState(seed)
    L, E, F, KVD = cfg.n_layer, cfg.n_embd, cfg.ffn_dim, cfg.kv_heads * cfg.head_dim

    def n(*shape):
        return (rs.standard_normal(shape) * 0.05).astype(np.float32)

    def ln(*lead):
        p = {"scale": (1.0 + n(*lead, E)).astype(np.float32)}
        if cfg.norm == "layernorm":
            p["bias"] = n(*lead, E)
        return p

    if cfg.mlp_type == "swiglu":
        mlp = {"fc_gate_w": n(L, E, F), "fc_in_w": n(L, E, F), "fc_out_w": n(L, F, E)}
    else:
        mlp = {"fc_in_w": n(L, E, F), "fc_in_b": n(L, F), "fc_out_w": n(L, F, E),
               "fc_out_b": n(L, E)}
    tree = {
        "wte": n(cfg.vocab_size, E),
        "ln_f": ln(),
        "blocks": {"ln_1": ln(L), "ln_2": ln(L), "mlp": mlp,
                   "attn": {"wq": n(L, E, E), "bq": n(L, E), "wk": n(L, E, KVD), "bk": n(L, KVD),
                            "wv": n(L, E, KVD), "bv": n(L, KVD), "wo": n(L, E, E),
                            "bo": n(L, E)}},
    }
    if cfg.pos_emb == "learned":
        tree["wpe"] = n(cfg.n_positions + cfg.pos_offset, E)
    if cfg.embed_ln:
        tree["emb_ln"] = ln()
    if not cfg.tie_embeddings:
        tree["lm_head_w"] = n(E, cfg.vocab_size)
        if cfg.lm_head_bias:
            tree["lm_head_b"] = n(cfg.vocab_size)
    return tree


def _pair(name):
    kw = dict(BASE, **CASES[name])
    tree = _tree(jdec.DecoderConfig(**kw))
    return (jdec.DecoderConfig(**kw), jax.tree.map(jnp.asarray, tree),
            tdec.DecoderConfig(**kw), params_from_numpy(tree, "cpu", torch.float32), tree)


@pytest.mark.parametrize("name", sorted(CASES))
def test_axis_against_jax(name):
    jcfg, jp, tcfg, tp, tree = _pair(name)
    ids = np.random.RandomState(1).randint(0, BASE["vocab_size"], (2, 12))
    # full-sequence logits
    ref = np.asarray(jdec.forward(jcfg, jp, jnp.asarray(ids, jnp.int32)))
    got = tdec.forward(tcfg, tp, torch.tensor(ids)).numpy()
    assert np.abs(got - ref).max() < TOL, np.abs(got - ref).max()
    # prefill + one cached decode step
    jc = jdec.init_cache(jcfg, 2, 20, dtype=jnp.float32)
    jl0, jc = jdec.forward_cached(jcfg, jp, jnp.asarray(ids[:, :9], jnp.int32), jc)
    jl1, _ = jdec.forward_cached(jcfg, jp, jnp.asarray(ids[:, 9:10], jnp.int32), jc)
    tc = tdec.init_cache(tcfg, 2, 20, dtype=torch.float32)
    tl0, tc = tdec.forward_cached(tcfg, tp, torch.tensor(ids[:, :9]), tc)
    tl1, tc = tdec.forward_cached(tcfg, tp, torch.tensor(ids[:, 9:10]), tc)
    assert int(tc.pos) == 10
    for a, b in ((tl0, jl0), (tl1, jl1)):
        assert np.abs(a.numpy() - np.asarray(b)).max() < TOL
    # greedy generate: the function and the engine's captured programs
    jnew = np.asarray(jdec.generate(jcfg, jp, jnp.asarray(ids, jnp.int32), 7,
                                    cache_dtype=jnp.float32))
    tnew = tdec.generate(tcfg, tp, torch.tensor(ids), 7, cache_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(tnew, jnew)
    eng = dtt.init_inference(tcfg, params=tree, dtype=torch.float32, device="cpu")
    assert eng.kind == "decoder"
    np.testing.assert_array_equal(eng.generate(ids, max_new_tokens=7)[:, 12:], jnew)
    np.testing.assert_allclose(eng({"input_ids": ids}).numpy(), ref, atol=TOL, rtol=0)


def test_sampled_generate_draws_jax_tokens():
    """``temperature > 0``: the port's draws are JAX's for the same key."""
    jcfg, jp, tcfg, tp, tree = _pair("mistral_gqa_swiglu_rms_window")
    ids = np.random.RandomState(2).randint(0, BASE["vocab_size"], (2, 5))
    jnew = np.asarray(jdec.generate(jcfg, jp, jnp.asarray(ids, jnp.int32), 6, temperature=0.8,
                                    rng=jax.random.PRNGKey(5), cache_dtype=jnp.float32,
                                    top_k=20))
    eng = dtt.init_inference(tcfg, params=tree, dtype=torch.float32, device="cpu")
    got = eng.generate(ids, max_new_tokens=6, temperature=0.8, seed=5, top_k=20)[:, 5:]
    np.testing.assert_array_equal(got, jnew)


def test_routes_are_jax(monkeypatch):
    """Which attention each call takes: a full sequence → causal_attention
    with the window only where it bites; a decode step → cached_attention
    when no window bites within the cache and there is no alibi; the rest
    → the plain grouped einsum (no kernel)."""
    calls = []
    real_causal, real_cached = tdec.causal_attention, tdec.cached_attention

    def causal(q, k, v, **kw):
        calls.append(("causal", q.shape[2], k.shape[2], kw.get("window")))
        return real_causal(q, k, v, **kw)

    def cached(q, kc, vc, pos, **kw):
        calls.append(("cached", q.shape[1], kc.shape[2], None))
        return real_cached(q, kc, vc, pos, **kw)

    monkeypatch.setattr(tdec, "causal_attention", causal)
    monkeypatch.setattr(tdec, "cached_attention", cached)
    ids = torch.tensor(np.random.RandomState(3).randint(0, BASE["vocab_size"], (1, 12)))

    def run(name, **over):
        cfg = dataclasses.replace(_pair(name)[2], **over)
        tp = _pair(name)[3]
        calls.clear()
        tdec.forward(cfg, tp, ids)
        full = list(calls)
        calls.clear()
        tdec.generate(cfg, tp, ids, 3, cache_dtype=torch.float32)
        return full, list(calls)

    full, gen = run("mistral_gqa_swiglu_rms_window")  # window 6 bites at S 12
    assert full == [("causal", 4, 2, 6)] * 2 and gen == []
    full, gen = run("mistral_gqa_swiglu_rms_window", local_windows=(64, 64))  # inert
    assert full == [("causal", 4, 2, None)] * 2 and gen == [("cached", 4, 2, None)] * 4
    full, gen = run("neo_local_windows_unscaled")  # layer 0 local (4), layer 1 global
    assert full == [("causal", 4, 4, 4), ("causal", 4, 4, None)] and gen == []
    full, gen = run("bloom_alibi_embed_ln")
    assert full == [] and gen == []
    full, gen = run("opt_learned_relu")
    assert full == [("causal", 4, 4, None)] * 2 and gen == [("cached", 4, 4, None)] * 4


def test_int8_tree_serves():
    """``quantize_bits=8`` on a decoder: the stacked block weights become
    int8 codes (``ops.quantizer``), and the engine's stream equals the
    dequantized tree's through the JAX decoder."""
    from deepspeed_tpu.ops.quantizer import quantize_tree as jquantize_tree

    jcfg, jp, tcfg, tp, tree = _pair("gptj_rope_parallel_shared_ln")
    ids = np.random.RandomState(4).randint(0, BASE["vocab_size"], (1, 6))
    eng = dtt.init_inference(tcfg, params=tree, dtype=torch.float32, device="cpu",
                             quantize_bits=8, quantize_groups=4)
    assert eng.quantized and eng.params["blocks"]["attn"]["wq"].q.dtype == torch.int8
    jq = jquantize_tree(jp, groups=4, dtype=jnp.float32)
    np.testing.assert_array_equal(eng.params["blocks"]["attn"]["wq"].q.numpy(),
                                  np.asarray(jq["blocks"]["attn"]["wq"].q))
    jnew = np.asarray(jdec.generate(jcfg, jq, jnp.asarray(ids, jnp.int32), 5,
                                    cache_dtype=jnp.float32))
    np.testing.assert_array_equal(eng.generate(ids, max_new_tokens=5)[:, 6:], jnew)


def test_refusals():
    with pytest.raises(ValueError, match="no initializer"):
        dtt.init_inference(tdec.DecoderConfig(**BASE), device="cpu")
    with pytest.raises(ValueError, match="local_windows"):
        tdec.DecoderConfig(**BASE, local_windows=(4,))
    eng = dtt.init_inference(_pair("opt_learned_relu")[2], params=_pair("opt_learned_relu")[4],
                             dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="gpt2 family"):
        eng.serve({"max_slots": 2})
