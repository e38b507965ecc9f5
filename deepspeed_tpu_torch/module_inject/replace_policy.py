"""Per-architecture injection policies: HF torch models → the port's
decoder, GPT-2 and BERT parameter trees (a copy of
``deepspeed_tpu/module_inject/replace_policy.py``, which the port may not
import; the JAX package's own is numpy-only too).

A policy converts the WHOLE model once: its torch weights → a stacked
(``[L, ...]``) numpy tree in the JAX package's layout plus the matching
model config, the same arrays the JAX package's policy returns. Then
``module_inject.replace_module`` puts them on the device in the serving
dtype, and the model's functions serve them (the kernels on the card).

Policies register in ``POLICY_REGISTRY``; ``match_policy`` picks by HF
class name, so ``init_inference(hf_model)`` needs no explicit policy.
``HFMixtralLayerPolicy`` matches Mixtral and refuses it: its MoE FFN is
ROADMAP queue 1 item 12d.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

PyTree = Any


def _t(x) -> np.ndarray:
    """torch tensor → a numpy fp32 copy (host-side; conversion happens
    once). A copy: the converted tree never aliases the HF module's
    weights, which ``revert`` writes."""
    return x.detach().cpu().float().numpy().copy()


def _stack(layers: List[np.ndarray]) -> np.ndarray:
    return np.stack(layers, axis=0)


class DSPolicy:
    """Base policy. Subclasses set ``hf_class_names`` and implement
    ``convert(hf_model) -> (model_kind, config, params)``."""

    hf_class_names: Tuple[str, ...] = ()

    @classmethod
    def matches(cls, hf_model) -> bool:
        return type(hf_model).__name__ in cls.hf_class_names

    @classmethod
    def convert(cls, hf_model):
        raise NotImplementedError


class HFGPT2LayerPolicy(DSPolicy):
    """transformers GPT2LMHeadModel / GPT2Model → models.gpt2 stacked params.

    HF GPT-2 uses Conv1D with weight stored [in, out] — identical to our
    matmul layout, so tensors map 1:1 (reference HFGPT2LayerPolicy:299 also
    relies on this orientation)."""

    hf_class_names = ("GPT2LMHeadModel", "GPT2Model")

    @classmethod
    def convert(cls, hf_model):
        from ..models.gpt2 import GPT2Config

        t = hf_model.transformer if hasattr(hf_model, "transformer") else hf_model
        hf_cfg = hf_model.config
        # the default attention: the kernels on the card, their plain
        # versions on the CPU (the JAX package pins its jnp route here)
        cfg = GPT2Config(
            vocab_size=hf_cfg.vocab_size,
            n_positions=hf_cfg.n_positions,
            n_embd=hf_cfg.n_embd,
            n_layer=hf_cfg.n_layer,
            n_head=hf_cfg.n_head,
            layer_norm_epsilon=hf_cfg.layer_norm_epsilon,
        )
        hs = list(t.h)
        params = {
            "wte": _t(t.wte.weight),
            "wpe": _t(t.wpe.weight),
            "ln_f": {"scale": _t(t.ln_f.weight), "bias": _t(t.ln_f.bias)},
            "blocks": {
                "ln_1": {
                    "scale": _stack([_t(h.ln_1.weight) for h in hs]),
                    "bias": _stack([_t(h.ln_1.bias) for h in hs]),
                },
                "ln_2": {
                    "scale": _stack([_t(h.ln_2.weight) for h in hs]),
                    "bias": _stack([_t(h.ln_2.bias) for h in hs]),
                },
                "attn": {
                    "c_attn_w": _stack([_t(h.attn.c_attn.weight) for h in hs]),
                    "c_attn_b": _stack([_t(h.attn.c_attn.bias) for h in hs]),
                    "c_proj_w": _stack([_t(h.attn.c_proj.weight) for h in hs]),
                    "c_proj_b": _stack([_t(h.attn.c_proj.bias) for h in hs]),
                },
                "mlp": {
                    "c_fc_w": _stack([_t(h.mlp.c_fc.weight) for h in hs]),
                    "c_fc_b": _stack([_t(h.mlp.c_fc.bias) for h in hs]),
                    "c_proj_w": _stack([_t(h.mlp.c_proj.weight) for h in hs]),
                    "c_proj_b": _stack([_t(h.mlp.c_proj.bias) for h in hs]),
                },
            },
        }
        return "gpt2", cfg, params

    @classmethod
    def revert(cls, hf_model, params) -> None:
        """Inverse of :meth:`convert`: unstack the layer dim and copy each
        tensor back into the torch module in place (Conv1D layout is already
        ours, so the mapping is exact — fine-tune here, export to HF)."""
        import torch

        t = hf_model.transformer if hasattr(hf_model, "transformer") else hf_model

        def put(dst, src) -> None:
            arr = np.asarray(src, dtype=np.float32)
            with torch.no_grad():
                dst.copy_(torch.from_numpy(arr).to(dst.dtype))

        put(t.wte.weight, params["wte"])
        put(t.wpe.weight, params["wpe"])
        put(t.ln_f.weight, params["ln_f"]["scale"])
        put(t.ln_f.bias, params["ln_f"]["bias"])
        blocks = params["blocks"]
        for i, h in enumerate(t.h):
            put(h.ln_1.weight, blocks["ln_1"]["scale"][i])
            put(h.ln_1.bias, blocks["ln_1"]["bias"][i])
            put(h.ln_2.weight, blocks["ln_2"]["scale"][i])
            put(h.ln_2.bias, blocks["ln_2"]["bias"][i])
            put(h.attn.c_attn.weight, blocks["attn"]["c_attn_w"][i])
            put(h.attn.c_attn.bias, blocks["attn"]["c_attn_b"][i])
            put(h.attn.c_proj.weight, blocks["attn"]["c_proj_w"][i])
            put(h.attn.c_proj.bias, blocks["attn"]["c_proj_b"][i])
            put(h.mlp.c_fc.weight, blocks["mlp"]["c_fc_w"][i])
            put(h.mlp.c_fc.bias, blocks["mlp"]["c_fc_b"][i])
            put(h.mlp.c_proj.weight, blocks["mlp"]["c_proj_w"][i])
            put(h.mlp.c_proj.bias, blocks["mlp"]["c_proj_b"][i])


def _linear_w(layer) -> np.ndarray:
    """torch Linear weight [out, in] → matmul layout [in, out]."""
    return _t(layer.weight).T


def _maybe_b(layer, n: int) -> np.ndarray:
    return _t(layer.bias) if getattr(layer, "bias", None) is not None else np.zeros(n, np.float32)


def _split_fused_qkv(w: np.ndarray, b: np.ndarray, n_head: int):
    """De-interleave a fused query_key_value Linear (BLOOM/NeoX layout:
    out dim organised [H, 3, D]) into plain q/k/v [E, E] + biases."""
    E3, E = w.shape  # torch [out, in]
    D = E // n_head
    wr = w.reshape(n_head, 3, D, E)
    br = b.reshape(n_head, 3, D)
    out = []
    for i in range(3):
        out.append((wr[:, i].reshape(E, E).T.copy(), br[:, i].reshape(E).copy()))
    return out  # [(wq [E,E] in×out, bq), (wk, bk), (wv, bv)]


def _tree_stack(dicts: List[Dict]) -> Dict:
    out = {}
    for k in dicts[0]:
        vals = [d[k] for d in dicts]
        out[k] = _tree_stack(vals) if isinstance(vals[0], dict) else _stack(vals)
    return out


class HFOPTLayerPolicy(DSPolicy):
    """transformers OPTForCausalLM → unified decoder (reference HFOPTLayerPolicy:435)."""

    hf_class_names = ("OPTForCausalLM", "OPTModel")

    @classmethod
    def convert(cls, hf_model):
        from ..models.decoder import DecoderConfig

        hc = hf_model.config
        assert hc.word_embed_proj_dim == hc.hidden_size, "OPT embed projection unsupported"
        assert getattr(hc, "do_layer_norm_before", True), "post-LN OPT unsupported"
        dec = hf_model.model.decoder if hasattr(hf_model, "model") else hf_model.decoder
        E, F = hc.hidden_size, hc.ffn_dim
        cfg = DecoderConfig(
            vocab_size=hc.vocab_size, n_positions=hc.max_position_embeddings,
            n_embd=E, n_layer=hc.num_hidden_layers, n_head=hc.num_attention_heads,
            ffn_dim=F, pos_emb="learned", pos_offset=2,
            activation="relu" if hc.activation_function == "relu" else "gelu",
            tie_embeddings=True,
        )

        def get(l):
            return {
                "ln_1": {"scale": _t(l.self_attn_layer_norm.weight), "bias": _t(l.self_attn_layer_norm.bias)},
                "ln_2": {"scale": _t(l.final_layer_norm.weight), "bias": _t(l.final_layer_norm.bias)},
                "attn": {
                    "wq": _linear_w(l.self_attn.q_proj), "bq": _maybe_b(l.self_attn.q_proj, E),
                    "wk": _linear_w(l.self_attn.k_proj), "bk": _maybe_b(l.self_attn.k_proj, E),
                    "wv": _linear_w(l.self_attn.v_proj), "bv": _maybe_b(l.self_attn.v_proj, E),
                    "wo": _linear_w(l.self_attn.out_proj), "bo": _maybe_b(l.self_attn.out_proj, E),
                },
                "mlp": {
                    "fc_in_w": _linear_w(l.fc1), "fc_in_b": _maybe_b(l.fc1, F),
                    "fc_out_w": _linear_w(l.fc2), "fc_out_b": _maybe_b(l.fc2, E),
                },
            }

        params = {
            "wte": _t(dec.embed_tokens.weight),
            "wpe": _t(dec.embed_positions.weight),
            "ln_f": {"scale": _t(dec.final_layer_norm.weight), "bias": _t(dec.final_layer_norm.bias)},
            "blocks": _tree_stack([get(l) for l in dec.layers]),
        }
        return "decoder", cfg, params


class BLOOMLayerPolicy(DSPolicy):
    """transformers BloomForCausalLM → unified decoder with ALiBi
    (reference BLOOMLayerPolicy:339)."""

    hf_class_names = ("BloomForCausalLM", "BloomModel")

    @classmethod
    def convert(cls, hf_model):
        from ..models.decoder import DecoderConfig

        hc = hf_model.config
        t = hf_model.transformer if hasattr(hf_model, "transformer") else hf_model
        E, H = hc.hidden_size, hc.n_head
        F = 4 * E
        cfg = DecoderConfig(
            vocab_size=hc.vocab_size, n_positions=4096, n_embd=E,
            n_layer=hc.n_layer, n_head=H, ffn_dim=F,
            pos_emb="alibi", activation="gelu_new", embed_ln=True,
            layer_norm_epsilon=hc.layer_norm_epsilon,
        )

        def get(l):
            (wq, bq), (wk, bk), (wv, bv) = _split_fused_qkv(
                _t(l.self_attention.query_key_value.weight),
                _t(l.self_attention.query_key_value.bias), H,
            )
            return {
                "ln_1": {"scale": _t(l.input_layernorm.weight), "bias": _t(l.input_layernorm.bias)},
                "ln_2": {"scale": _t(l.post_attention_layernorm.weight), "bias": _t(l.post_attention_layernorm.bias)},
                "attn": {
                    "wq": wq, "bq": bq, "wk": wk, "bk": bk, "wv": wv, "bv": bv,
                    "wo": _linear_w(l.self_attention.dense), "bo": _maybe_b(l.self_attention.dense, E),
                },
                "mlp": {
                    "fc_in_w": _linear_w(l.mlp.dense_h_to_4h), "fc_in_b": _maybe_b(l.mlp.dense_h_to_4h, F),
                    "fc_out_w": _linear_w(l.mlp.dense_4h_to_h), "fc_out_b": _maybe_b(l.mlp.dense_4h_to_h, E),
                },
            }

        params = {
            "wte": _t(t.word_embeddings.weight),
            "emb_ln": {"scale": _t(t.word_embeddings_layernorm.weight), "bias": _t(t.word_embeddings_layernorm.bias)},
            "ln_f": {"scale": _t(t.ln_f.weight), "bias": _t(t.ln_f.bias)},
            "blocks": _tree_stack([get(l) for l in t.h]),
        }
        return "decoder", cfg, params


class HFGPTJLayerPolicy(DSPolicy):
    """transformers GPTJForCausalLM → unified decoder with interleaved RoPE +
    parallel residual, single shared LN (reference HFGPTJLayerPolicy:174)."""

    hf_class_names = ("GPTJForCausalLM", "GPTJModel")

    @classmethod
    def convert(cls, hf_model):
        from ..models.decoder import DecoderConfig

        hc = hf_model.config
        t = hf_model.transformer if hasattr(hf_model, "transformer") else hf_model
        E, F = hc.n_embd, 4 * hc.n_embd
        cfg = DecoderConfig(
            vocab_size=hc.vocab_size, n_positions=hc.n_positions, n_embd=E,
            n_layer=hc.n_layer, n_head=hc.n_head, ffn_dim=F,
            pos_emb="rope", rope_style="gptj", rotary_dim=hc.rotary_dim or 0,
            activation="gelu_new", parallel_residual=True, use_ln2=False,
            tie_embeddings=False, lm_head_bias=True,
            layer_norm_epsilon=hc.layer_norm_epsilon,
        )

        def get(l):
            z = np.zeros(E, np.float32)
            return {
                "ln_1": {"scale": _t(l.ln_1.weight), "bias": _t(l.ln_1.bias)},
                "attn": {
                    "wq": _linear_w(l.attn.q_proj), "bq": z,
                    "wk": _linear_w(l.attn.k_proj), "bk": z,
                    "wv": _linear_w(l.attn.v_proj), "bv": z,
                    "wo": _linear_w(l.attn.out_proj), "bo": z,
                },
                "mlp": {
                    "fc_in_w": _linear_w(l.mlp.fc_in), "fc_in_b": _maybe_b(l.mlp.fc_in, F),
                    "fc_out_w": _linear_w(l.mlp.fc_out), "fc_out_b": _maybe_b(l.mlp.fc_out, E),
                },
            }

        params = {
            "wte": _t(t.wte.weight),
            "ln_f": {"scale": _t(t.ln_f.weight), "bias": _t(t.ln_f.bias)},
            "blocks": _tree_stack([get(l) for l in t.h]),
            "lm_head_w": _linear_w(hf_model.lm_head),
            "lm_head_b": _maybe_b(hf_model.lm_head, hc.vocab_size),
        }
        return "decoder", cfg, params


class HFGPTNEOLayerPolicy(DSPolicy):
    """transformers GPTNeoForCausalLM → unified decoder, unscaled attention +
    alternating local windows (reference HFGPTNEOLayerPolicy:129)."""

    hf_class_names = ("GPTNeoForCausalLM", "GPTNeoModel")

    @classmethod
    def convert(cls, hf_model):
        from ..models.decoder import DecoderConfig

        hc = hf_model.config
        t = hf_model.transformer if hasattr(hf_model, "transformer") else hf_model
        E, F = hc.hidden_size, hc.intermediate_size or 4 * hc.hidden_size
        windows = tuple(
            hc.window_size if at == "local" else 0 for at in hc.attention_layers
        )
        cfg = DecoderConfig(
            vocab_size=hc.vocab_size, n_positions=hc.max_position_embeddings,
            n_embd=E, n_layer=hc.num_layers, n_head=hc.num_heads, ffn_dim=F,
            pos_emb="learned", activation="gelu_new", attn_scale=1.0,
            local_windows=windows, layer_norm_epsilon=hc.layer_norm_epsilon,
        )

        def get(l):
            a = l.attn.attention
            z = np.zeros(E, np.float32)
            return {
                "ln_1": {"scale": _t(l.ln_1.weight), "bias": _t(l.ln_1.bias)},
                "ln_2": {"scale": _t(l.ln_2.weight), "bias": _t(l.ln_2.bias)},
                "attn": {
                    "wq": _linear_w(a.q_proj), "bq": z,
                    "wk": _linear_w(a.k_proj), "bk": z,
                    "wv": _linear_w(a.v_proj), "bv": z,
                    "wo": _linear_w(a.out_proj), "bo": _maybe_b(a.out_proj, E),
                },
                "mlp": {
                    "fc_in_w": _linear_w(l.mlp.c_fc), "fc_in_b": _maybe_b(l.mlp.c_fc, F),
                    "fc_out_w": _linear_w(l.mlp.c_proj), "fc_out_b": _maybe_b(l.mlp.c_proj, E),
                },
            }

        params = {
            "wte": _t(t.wte.weight),
            "wpe": _t(t.wpe.weight),
            "ln_f": {"scale": _t(t.ln_f.weight), "bias": _t(t.ln_f.bias)},
            "blocks": _tree_stack([get(l) for l in t.h]),
        }
        return "decoder", cfg, params


class GPTNEOXLayerPolicy(DSPolicy):
    """transformers GPTNeoXForCausalLM → unified decoder with half-split RoPE
    + parallel residual (reference GPTNEOXLayerPolicy:381)."""

    hf_class_names = ("GPTNeoXForCausalLM", "GPTNeoXModel")

    @classmethod
    def convert(cls, hf_model):
        from ..models.decoder import DecoderConfig

        hc = hf_model.config
        t = hf_model.gpt_neox if hasattr(hf_model, "gpt_neox") else hf_model
        E, H = hc.hidden_size, hc.num_attention_heads
        F = hc.intermediate_size
        D = E // H
        cfg = DecoderConfig(
            vocab_size=hc.vocab_size, n_positions=hc.max_position_embeddings,
            n_embd=E, n_layer=hc.num_hidden_layers, n_head=H, ffn_dim=F,
            pos_emb="rope", rope_style="neox", rotary_dim=int(D * hc.rotary_pct),
            activation="gelu", parallel_residual=bool(hc.use_parallel_residual),
            use_ln2=True, tie_embeddings=False, layer_norm_epsilon=hc.layer_norm_eps,
        )

        def get(l):
            (wq, bq), (wk, bk), (wv, bv) = _split_fused_qkv(
                _t(l.attention.query_key_value.weight),
                _t(l.attention.query_key_value.bias), H,
            )
            return {
                "ln_1": {"scale": _t(l.input_layernorm.weight), "bias": _t(l.input_layernorm.bias)},
                "ln_2": {"scale": _t(l.post_attention_layernorm.weight), "bias": _t(l.post_attention_layernorm.bias)},
                "attn": {
                    "wq": wq, "bq": bq, "wk": wk, "bk": bk, "wv": wv, "bv": bv,
                    "wo": _linear_w(l.attention.dense), "bo": _maybe_b(l.attention.dense, E),
                },
                "mlp": {
                    "fc_in_w": _linear_w(l.mlp.dense_h_to_4h), "fc_in_b": _maybe_b(l.mlp.dense_h_to_4h, F),
                    "fc_out_w": _linear_w(l.mlp.dense_4h_to_h), "fc_out_b": _maybe_b(l.mlp.dense_4h_to_h, E),
                },
            }

        params = {
            "wte": _t(t.embed_in.weight),
            "ln_f": {"scale": _t(t.final_layer_norm.weight), "bias": _t(t.final_layer_norm.bias)},
            "blocks": _tree_stack([get(l) for l in t.layers]),
            "lm_head_w": _linear_w(hf_model.embed_out),
        }
        return "decoder", cfg, params


class MegatronLayerPolicy(DSPolicy):
    """Megatron-LM GPT-2 checkpoints (state-dict based) → unified decoder
    (reference MegatronLayerPolicy:219). Megatron fuses QKV like NeoX
    ([H, 3, D] interleave) and uses learned positions + gelu."""

    hf_class_names = ()  # matched explicitly via convert_state_dict

    @classmethod
    def convert_state_dict(cls, sd: Dict[str, Any], n_head: int, n_positions: Optional[int] = None):
        from ..models.decoder import DecoderConfig

        pre = "model.language_model." if any(k.startswith("model.") for k in sd) else "language_model."
        emb = sd[f"{pre}embedding.word_embeddings.weight"]
        pos = sd[f"{pre}embedding.position_embeddings.weight"]
        tkeys = sorted(
            {int(k.split(".")[-3]) for k in sd if ".layers." in k and k.endswith("input_layernorm.weight")}
        )
        V, E = np.asarray(emb).shape
        F = np.asarray(sd[f"{pre}transformer.layers.0.mlp.dense_h_to_4h.weight"]).shape[0]
        cfg = DecoderConfig(
            vocab_size=V, n_positions=n_positions or np.asarray(pos).shape[0],
            n_embd=E, n_layer=len(tkeys), n_head=n_head, ffn_dim=F,
            pos_emb="learned", activation="gelu", tie_embeddings=True,
        )

        def get(i):
            p = f"{pre}transformer.layers.{i}."
            (wq, bq), (wk, bk), (wv, bv) = _split_fused_qkv(
                np.asarray(sd[p + "attention.query_key_value.weight"], np.float32),
                np.asarray(sd[p + "attention.query_key_value.bias"], np.float32), n_head,
            )
            return {
                "ln_1": {"scale": np.asarray(sd[p + "input_layernorm.weight"], np.float32),
                         "bias": np.asarray(sd[p + "input_layernorm.bias"], np.float32)},
                "ln_2": {"scale": np.asarray(sd[p + "post_attention_layernorm.weight"], np.float32),
                         "bias": np.asarray(sd[p + "post_attention_layernorm.bias"], np.float32)},
                "attn": {
                    "wq": wq, "bq": bq, "wk": wk, "bk": bk, "wv": wv, "bv": bv,
                    "wo": np.asarray(sd[p + "attention.dense.weight"], np.float32).T,
                    "bo": np.asarray(sd[p + "attention.dense.bias"], np.float32),
                },
                "mlp": {
                    "fc_in_w": np.asarray(sd[p + "mlp.dense_h_to_4h.weight"], np.float32).T,
                    "fc_in_b": np.asarray(sd[p + "mlp.dense_h_to_4h.bias"], np.float32),
                    "fc_out_w": np.asarray(sd[p + "mlp.dense_4h_to_h.weight"], np.float32).T,
                    "fc_out_b": np.asarray(sd[p + "mlp.dense_4h_to_h.bias"], np.float32),
                },
            }

        params = {
            "wte": np.asarray(emb, np.float32),
            "wpe": np.asarray(pos, np.float32),
            "ln_f": {"scale": np.asarray(sd[f"{pre}transformer.final_layernorm.weight"], np.float32),
                     "bias": np.asarray(sd[f"{pre}transformer.final_layernorm.bias"], np.float32)},
            "blocks": _tree_stack([get(i) for i in tkeys]),
        }
        return "decoder", cfg, params


class HFBertLayerPolicy(DSPolicy):
    """transformers BertModel → models.bert encoder (reference HFBertLayerPolicy:66)."""

    hf_class_names = ("BertModel", "BertForSequenceClassification", "BertForQuestionAnswering")

    @classmethod
    def convert(cls, hf_model):
        from ..models.bert import BertConfig as DSBertConfig

        bert = getattr(hf_model, "bert", hf_model)
        hc = hf_model.config
        E, F = hc.hidden_size, hc.intermediate_size
        cfg = DSBertConfig(
            vocab_size=hc.vocab_size, n_positions=hc.max_position_embeddings,
            n_embd=E, n_layer=hc.num_hidden_layers, n_head=hc.num_attention_heads,
            ffn_dim=F, type_vocab_size=hc.type_vocab_size,
            layer_norm_epsilon=hc.layer_norm_eps,
        )

        def get(l):
            return {
                "attn": {
                    "wq": _linear_w(l.attention.self.query), "bq": _maybe_b(l.attention.self.query, E),
                    "wk": _linear_w(l.attention.self.key), "bk": _maybe_b(l.attention.self.key, E),
                    "wv": _linear_w(l.attention.self.value), "bv": _maybe_b(l.attention.self.value, E),
                    "wo": _linear_w(l.attention.output.dense), "bo": _maybe_b(l.attention.output.dense, E),
                },
                "attn_ln": {"scale": _t(l.attention.output.LayerNorm.weight), "bias": _t(l.attention.output.LayerNorm.bias)},
                "mlp": {
                    "fc_in_w": _linear_w(l.intermediate.dense), "fc_in_b": _maybe_b(l.intermediate.dense, F),
                    "fc_out_w": _linear_w(l.output.dense), "fc_out_b": _maybe_b(l.output.dense, E),
                },
                "out_ln": {"scale": _t(l.output.LayerNorm.weight), "bias": _t(l.output.LayerNorm.bias)},
            }

        emb = bert.embeddings
        params = {
            "wte": _t(emb.word_embeddings.weight),
            "wpe": _t(emb.position_embeddings.weight),
            "wtt": _t(emb.token_type_embeddings.weight),
            "emb_ln": {"scale": _t(emb.LayerNorm.weight), "bias": _t(emb.LayerNorm.bias)},
            "blocks": _tree_stack([get(l) for l in bert.encoder.layer]),
            "pooler": {"w": _linear_w(bert.pooler.dense), "b": _maybe_b(bert.pooler.dense, E)}
            if getattr(bert, "pooler", None) is not None
            else None,
        }
        return "bert", cfg, params


class HFLlamaLayerPolicy(DSPolicy):
    """transformers LlamaForCausalLM / MistralForCausalLM → unified decoder
    with RMSNorm + SwiGLU + GQA + neox-style RoPE. Beyond the reference
    snapshot's zoo (its newest arch is BLOOM); Mistral adds a sliding
    window, mapped onto the decoder's per-layer ``local_windows``."""

    # bare LlamaModel/MistralModel are excluded: without lm_head the
    # serving conversion would be incomplete
    hf_class_names = ("LlamaForCausalLM", "MistralForCausalLM")

    @classmethod
    def convert(cls, hf_model):
        from ..models.decoder import DecoderConfig

        hc = hf_model.config
        t = hf_model.model if hasattr(hf_model, "model") else hf_model
        E = hc.hidden_size
        L = hc.num_hidden_layers
        window = int(getattr(hc, "sliding_window", 0) or 0)
        cfg = DecoderConfig(
            vocab_size=hc.vocab_size,
            n_positions=hc.max_position_embeddings,
            n_embd=E,
            n_layer=L,
            n_head=hc.num_attention_heads,
            ffn_dim=hc.intermediate_size,
            pos_emb="rope",
            rope_style="neox",
            rope_theta=float(getattr(hc, "rope_theta", 10000.0)),
            norm="rmsnorm",
            mlp_type="swiglu",
            n_kv_head=int(getattr(hc, "num_key_value_heads", hc.num_attention_heads)),
            tie_embeddings=bool(getattr(hc, "tie_word_embeddings", False)),
            layer_norm_epsilon=hc.rms_norm_eps,
            local_windows=(window,) * L if window else (),
        )

        def get(l):
            return {
                "ln_1": {"scale": _t(l.input_layernorm.weight)},
                "ln_2": {"scale": _t(l.post_attention_layernorm.weight)},
                "attn": {
                    "wq": _linear_w(l.self_attn.q_proj),
                    "wk": _linear_w(l.self_attn.k_proj),
                    "wv": _linear_w(l.self_attn.v_proj),
                    "wo": _linear_w(l.self_attn.o_proj),
                },
                "mlp": {
                    "fc_gate_w": _linear_w(l.mlp.gate_proj),
                    "fc_in_w": _linear_w(l.mlp.up_proj),
                    "fc_out_w": _linear_w(l.mlp.down_proj),
                },
            }

        params = {
            "wte": _t(t.embed_tokens.weight),
            "ln_f": {"scale": _t(t.norm.weight)},
            "blocks": _tree_stack([get(l) for l in t.layers]),
        }
        if not cfg.tie_embeddings:
            params["lm_head_w"] = _linear_w(hf_model.lm_head)
        return "decoder", cfg, params


class HFMixtralLayerPolicy(DSPolicy):
    """transformers MixtralForCausalLM: the JAX package converts it to the
    decoder with a per-layer SwiGLU MoE; here it matches and refuses
    (ROADMAP queue 1 item 12d)."""

    hf_class_names = ("MixtralForCausalLM",)

    @classmethod
    def convert(cls, hf_model):
        from ..runtime.config import NotPortedError

        raise NotPortedError(
            f"{type(hf_model).__name__}: the Mixtral policy's MoE FFN (decoder "
            "mlp_type='moe_swiglu') is not ported to deepspeed_tpu_torch yet (ROADMAP "
            "queue 1 item 12d)")


POLICY_REGISTRY: List[type] = [
    HFGPT2LayerPolicy,
    HFOPTLayerPolicy,
    BLOOMLayerPolicy,
    HFGPTJLayerPolicy,
    HFGPTNEOLayerPolicy,
    GPTNEOXLayerPolicy,
    HFLlamaLayerPolicy,
    HFMixtralLayerPolicy,
    HFBertLayerPolicy,
]


def register_policy(policy: type) -> type:
    POLICY_REGISTRY.append(policy)
    return policy


def match_policy(hf_model) -> Optional[type]:
    for pol in POLICY_REGISTRY:
        if pol.matches(hf_model):
            return pol
    return None
