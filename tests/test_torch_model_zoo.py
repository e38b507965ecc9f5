"""The port's injection policies on the CPU, held against the JAX
package's and against HF transformers (``tests/unit/test_model_zoo.py``
is the oracle): OPT, BLOOM, GPT-J, GPT-Neo with local windows, GPT-NeoX,
LLaMA (GQA, MHA with another rope theta), Mistral's window map, BERT, the
Megatron state-dict convert, and Mixtral refused naming ROADMAP queue 1
item 12d.

Each HF model is built once from its config class with random weights.
Every policy's numpy tree equals the JAX policy's bit for bit; the
port's logits (``init_inference(model=hf_model)`` on the CPU, fp32) are
within 5e-3 of HF's (the oracle's tolerance) and within 2e-5 of the JAX
decoder's on the same tree; greedy streams are token-identical to HF's
``generate`` and to the JAX decoder's."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.models import decoder as jdecoder
from deepspeed_tpu.module_inject import replace_policy as jpolicy
from deepspeed_tpu_torch.models import decoder as tdecoder
from deepspeed_tpu_torch.module_inject import replace_policy as tpolicy
from deepspeed_tpu_torch.module_inject import replace_transformer_layer, revert_transformer_layer
from deepspeed_tpu_torch.runtime.config import NotPortedError
from deepspeed_tpu_torch.utils.weights import params_from_numpy, params_to_numpy
from tests.torch_threads import one_torch_thread  # noqa: F401

warnings.filterwarnings("ignore")
transformers = pytest.importorskip("transformers")

HF_TOL = 5e-3  # the oracle's tolerance against HF
JAX_TOL = 2e-5  # the same tree through both packages, fp32

MODELS = {
    "opt": ("OPTForCausalLM", "OPTConfig", dict(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=4, vocab_size=512,
        ffn_dim=256, max_position_embeddings=128, word_embed_proj_dim=64, dropout=0.0,
        activation_function="relu")),
    "bloom": ("BloomForCausalLM", "BloomConfig", dict(
        hidden_size=64, n_layer=2, n_head=4, vocab_size=512, hidden_dropout=0.0,
        attention_dropout=0.0)),
    "gptj": ("GPTJForCausalLM", "GPTJConfig", dict(
        n_embd=64, n_layer=2, n_head=4, vocab_size=512, rotary_dim=16, n_positions=128,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)),
    "gptneo": ("GPTNeoForCausalLM", "GPTNeoConfig", dict(
        hidden_size=64, num_layers=2, num_heads=4, vocab_size=512,
        attention_types=[[["global", "local"], 1]], max_position_embeddings=128,
        window_size=4, resid_dropout=0.0, embed_dropout=0.0, attention_dropout=0.0)),
    "neox": ("GPTNeoXForCausalLM", "GPTNeoXConfig", dict(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=4, vocab_size=512,
        intermediate_size=256, rotary_pct=0.25, max_position_embeddings=128,
        hidden_dropout=0.0, attention_dropout=0.0)),
    "llama_gqa": ("LlamaForCausalLM", "LlamaConfig", dict(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        intermediate_size=64, vocab_size=128, max_position_embeddings=64,
        rope_theta=10000.0, tie_word_embeddings=False)),
    "llama_mha_theta": ("LlamaForCausalLM", "LlamaConfig", dict(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        intermediate_size=64, vocab_size=128, max_position_embeddings=64,
        rope_theta=50000.0, tie_word_embeddings=False)),
    "mistral_window": ("MistralForCausalLM", "MistralConfig", dict(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        intermediate_size=64, vocab_size=128, max_position_embeddings=64, sliding_window=4)),
}


def _hf(cls_name, cfg_name, kw):
    torch.manual_seed(0)
    model = getattr(transformers, cls_name)(getattr(transformers, cfg_name)(**kw))
    model.eval()
    return model


class _Models(dict):
    """Each HF model built once, at its first use (a worker builds only
    the ones its tests use)."""

    def __missing__(self, name):
        self[name] = _hf(*MODELS[name])
        return self[name]


@pytest.fixture(scope="module")
def hf_models():
    return _Models()


def _tree_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _tree_equal(a[k], b[k])
    elif a is None:
        assert b is None
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_decoder_family_logits(name, hf_models):
    """The port's policy gives the JAX policy's tree and config; the port's
    injected engine's logits match HF's and the JAX decoder's."""
    hf = hf_models[name]
    kind, tcfg, tree = tpolicy.match_policy(hf).convert(hf)
    jkind, jcfg, jtree = jpolicy.match_policy(hf).convert(hf)
    assert kind == jkind == "decoder"
    _tree_equal(tree, jtree)
    for field in ("pos_emb", "rope_style", "rotary_dim", "activation", "parallel_residual",
                  "use_ln2", "tie_embeddings", "lm_head_bias", "embed_ln", "pos_offset",
                  "attn_scale", "local_windows", "norm", "mlp_type", "kv_heads", "rope_theta",
                  "layer_norm_epsilon"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    ids = np.random.RandomState(0).randint(0, tcfg.vocab_size, (2, 10))
    with torch.no_grad():
        ref = hf(torch.tensor(ids)).logits.numpy()
    eng = dtt.init_inference(hf, dtype=torch.float32, device="cpu")
    assert eng.kind == "decoder"
    ours = eng({"input_ids": ids}).numpy()
    jax_l = np.asarray(jdecoder.forward(jcfg, jax.tree.map(jnp.asarray, jtree),
                                        jnp.asarray(ids, jnp.int32)))
    assert np.abs(ours - ref).max() < HF_TOL, np.abs(ours - ref).max()
    assert np.abs(ours - jax_l).max() < JAX_TOL, np.abs(ours - jax_l).max()


@pytest.mark.parametrize("name", ["opt", "llama_gqa", "mistral_window"])
def test_greedy_generate_matches_hf_and_jax(name, hf_models):
    """``init_inference(model=hf).generate`` emits HF's greedy stream and
    the JAX decoder's, token for token (OPT as the oracle's engine test,
    LLaMA as its generate test; Mistral's window bites within the run)."""
    hf = hf_models[name]
    eng = dtt.init_inference(model=hf, dtype=torch.float32, device="cpu")
    ids = np.random.RandomState(1).randint(4, eng.model_config.vocab_size - 4, (1, 8))
    with torch.no_grad():
        ref = hf.generate(torch.tensor(ids), max_new_tokens=6, do_sample=False,
                          pad_token_id=1).numpy()
    ours = eng.generate(ids, max_new_tokens=6)
    np.testing.assert_array_equal(ours, ref)
    _, jcfg, jtree = jpolicy.match_policy(hf).convert(hf)
    jax_new = np.asarray(jdecoder.generate(jcfg, jax.tree.map(jnp.asarray, jtree),
                                           jnp.asarray(ids, jnp.int32), 6,
                                           cache_dtype=jnp.float32))
    np.testing.assert_array_equal(ours[:, ids.shape[1]:], jax_new)


def test_mistral_sliding_window_maps(hf_models):
    _, cfg, _ = tpolicy.match_policy(hf_models["mistral_window"]).convert(
        hf_models["mistral_window"])
    assert cfg.local_windows == (4, 4) and cfg.kv_heads == 2
    assert not tdecoder.windows_inert(cfg, 10) and tdecoder.windows_inert(cfg, 4)
    cache = tdecoder.init_cache(cfg, 1, 16, dtype=torch.float32)
    assert tuple(cache.k.shape) == (2, 1, 16, 2, 8)  # kv heads, not 4


def test_bert_injection():
    """BERT through the port's policy: the JAX policy's tree; the injected
    engine's hidden states (unmasked positions) and pooler within the
    oracle's tolerance of HF's and 2e-5 of the JAX encoder's."""
    hf = _hf("BertModel", "BertConfig", dict(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=4, vocab_size=512,
        intermediate_size=256, max_position_embeddings=128, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0))
    kind, cfg, tree = tpolicy.match_policy(hf).convert(hf)
    _, jcfg, jtree = jpolicy.match_policy(hf).convert(hf)
    assert kind == "bert"
    _tree_equal(tree, jtree)
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 512, (2, 10))
    mask = np.ones((2, 10), np.int64)
    mask[1, 7:] = 0
    with torch.no_grad():
        out = hf(torch.tensor(ids), attention_mask=torch.tensor(mask))
    eng = dtt.init_inference(hf, dtype=torch.float32, device="cpu")
    assert eng.kind == "bert"
    h = eng({"input_ids": ids, "attention_mask": mask}).numpy()
    keep = mask == 1
    assert np.abs(h[keep] - out.last_hidden_state.numpy()[keep]).max() < HF_TOL
    from deepspeed_tpu_torch.models import bert as tbert

    _, pooled = tbert.forward(eng.model_config, eng.params, torch.tensor(ids),
                              torch.tensor(mask))
    assert np.abs(pooled.numpy() - out.pooler_output.numpy()).max() < HF_TOL
    jh, jp = jbert.forward(jcfg, jax.tree.map(lambda x: None if x is None else jnp.asarray(x),
                                              jtree, is_leaf=lambda x: x is None),
                           jnp.asarray(ids, jnp.int32), jnp.asarray(mask), None)
    assert np.abs(h[keep] - np.asarray(jh)[keep]).max() < JAX_TOL
    assert np.abs(pooled.numpy() - np.asarray(jp)).max() < JAX_TOL
    # BERT has no cache: generate is the JAX engine's full-prefix recompute
    assert eng.generate(ids[:1, :4], max_new_tokens=2).shape == (1, 6)


def test_megatron_state_dict_convert():
    """A synthetic Megatron-LM GPT-2 state dict → the decoder: the JAX
    policy's tree, and logits equal to the JAX decoder's."""
    rs = np.random.RandomState(0)
    E, H, L, V, F, P = 32, 4, 2, 128, 128, 64
    sd = {
        "language_model.embedding.word_embeddings.weight": rs.randn(V, E) * 0.02,
        "language_model.embedding.position_embeddings.weight": rs.randn(P, E) * 0.02,
        "language_model.transformer.final_layernorm.weight": np.ones(E),
        "language_model.transformer.final_layernorm.bias": np.zeros(E),
    }
    for i in range(L):
        p = f"language_model.transformer.layers.{i}."
        sd.update({
            p + "input_layernorm.weight": np.ones(E), p + "input_layernorm.bias": np.zeros(E),
            p + "post_attention_layernorm.weight": np.ones(E),
            p + "post_attention_layernorm.bias": np.zeros(E),
            p + "attention.query_key_value.weight": rs.randn(3 * E, E) * 0.02,
            p + "attention.query_key_value.bias": np.zeros(3 * E),
            p + "attention.dense.weight": rs.randn(E, E) * 0.02,
            p + "attention.dense.bias": np.zeros(E),
            p + "mlp.dense_h_to_4h.weight": rs.randn(F, E) * 0.02,
            p + "mlp.dense_h_to_4h.bias": np.zeros(F),
            p + "mlp.dense_4h_to_h.weight": rs.randn(E, F) * 0.02,
            p + "mlp.dense_4h_to_h.bias": np.zeros(E),
        })
    kind, cfg, tree = tpolicy.MegatronLayerPolicy.convert_state_dict(sd, n_head=H)
    _, jcfg, jtree = jpolicy.MegatronLayerPolicy.convert_state_dict(sd, n_head=H)
    assert kind == "decoder" and cfg.n_layer == L and cfg.ffn_dim == F
    _tree_equal(tree, jtree)
    ids = rs.randint(0, V, (2, 8))
    ours = tdecoder.forward(cfg, params_from_numpy(tree, "cpu", torch.float32),
                            torch.tensor(ids)).numpy()
    ref = np.asarray(jdecoder.forward(jcfg, jax.tree.map(jnp.asarray, jtree),
                                      jnp.asarray(ids, jnp.int32)))
    assert ours.shape == (2, 8, V) and np.abs(ours - ref).max() < JAX_TOL


def test_mixtral_and_moe_refused():
    hf = _hf("MixtralForCausalLM", "MixtralConfig", dict(
        hidden_size=32, num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=2,
        intermediate_size=64, vocab_size=128, max_position_embeddings=64,
        num_local_experts=4, num_experts_per_tok=2, sliding_window=None))
    assert tpolicy.match_policy(hf) is tpolicy.HFMixtralLayerPolicy
    with pytest.raises(NotPortedError, match=r"item 12d\)"):
        dtt.init_inference(hf, dtype=torch.float32, device="cpu")
    with pytest.raises(NotPortedError, match=r"item 12d\)"):
        tdecoder.DecoderConfig(vocab_size=8, n_positions=8, n_embd=8, n_layer=1, n_head=2,
                               ffn_dim=8, mlp_type="moe_swiglu", moe_experts=4)


def test_gpt2_injection_int8_and_revert():
    """GPT-2 through its policy: the kind ``gpt2`` (served by the GPT-2
    model, kernels on the card), HF's logits; int8 through
    ``ops.quantizer`` as the engine's ``quantize_bits``; revert writes the
    tree back exactly; an int8 tree refuses to revert."""
    hf = _hf("GPT2LMHeadModel", "GPT2Config", dict(
        n_embd=64, n_layer=2, n_head=4, vocab_size=512, n_positions=128,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0))
    kind, cfg, params = replace_transformer_layer(hf, dtype=torch.float32)
    assert kind == "gpt2" and cfg.attn_impl == "auto"
    ids = np.random.RandomState(2).randint(0, 512, (2, 9))
    eng = dtt.init_inference(model=hf, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        ref = hf(torch.tensor(ids)).logits.numpy()
    assert np.abs(eng({"input_ids": ids}).numpy() - ref).max() < HF_TOL
    _, _, q = replace_transformer_layer(hf, dtype=torch.float32, quantize_bits=8,
                                        quantize_groups=4)
    e8 = dtt.init_inference(model=hf, dtype=torch.float32, device="cpu", quantize_bits=8,
                            quantize_groups=4)
    assert e8.quantized
    assert torch.equal(q["blocks"]["attn"]["c_attn_w"].q, e8.params["blocks"]["attn"]["c_attn_w"].q)
    with pytest.raises(ValueError, match="int8"):
        revert_transformer_layer(hf, q)
    before = {k: v.clone() for k, v in hf.state_dict().items()}
    bumped = {**params, "wte": params["wte"] + 1.0}
    revert_transformer_layer(hf, bumped)
    assert torch.equal(hf.transformer.wte.weight, before["transformer.wte.weight"] + 1.0)
    revert_transformer_layer(hf, params)
    for k, v in hf.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_numpy_trees_carry_none_subtrees():
    """An injected BERT without a pooler (``add_pooling_layer=False``)
    carries ``pooler: None``: the numpy → port parameter functions pass it
    through, and the engine serves the tree, the JAX policy's bit for bit."""
    hf = transformers.BertModel(transformers.BertConfig(
        hidden_size=32, num_hidden_layers=1, num_attention_heads=2, vocab_size=64,
        intermediate_size=64, max_position_embeddings=32), add_pooling_layer=False).eval()
    _, cfg, tree = tpolicy.match_policy(hf).convert(hf)
    _, _, jtree = jpolicy.match_policy(hf).convert(hf)
    assert tree["pooler"] is None
    _tree_equal(tree, jtree)
    params = params_from_numpy(tree, "cpu", torch.float32)
    assert params["pooler"] is None
    assert params_to_numpy(params)["pooler"] is None
    eng = dtt.init_inference(cfg, params=tree, dtype=torch.float32, device="cpu")
    ids = np.random.RandomState(5).randint(0, 64, (1, 6))
    with torch.no_grad():
        ref = hf(torch.tensor(ids)).last_hidden_state.numpy()
    assert np.abs(eng({"input_ids": ids}).numpy() - ref).max() < HF_TOL
