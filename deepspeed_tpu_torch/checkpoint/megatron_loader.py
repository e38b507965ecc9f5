"""Megatron-style checkpoint ingestion: a Megatron-LM GPT state dict →
the GPT-2 parameter tree (counterpart of
``deepspeed_tpu/checkpoint/megatron_loader.py``).

Three steps over plain numpy dicts:

1. regrid: ``checkpoint/reshape.py`` merges the tp × pp shard grid into
   the full logical model;
2. name map: classic Megatron-LM GPT keys → the stacked ``[L, ...]``
   layout (torch Linear weights ``[out, in]`` transpose to ``[in, out]``);
3. reshard: the training engine's ``load_megatron_checkpoint``, which
   waits with ROADMAP queue 1 item 10b.

The QKV layout is the globally concatenated ``[3E, E]`` = ``[q; k; v]``
matrix (classic Megatron-LM before MCore). A checkpoint with per-head
interleaving must be de-interleaved first.

One difference from the JAX package, on purpose: a key outside the layers
is matched by its exact suffix at a ``.`` boundary, never by a substring.
The JAX copy files any key that merely contains ``word_embeddings`` (an
embedding-norm variant, say) under ``wte``, and raises on a tied
``output_layer`` / ``lm_head`` copy that ``reshape.py`` routes through the
pp regrid. Here the first is an unmapped key, and a head equal to
``wte`` is the tied copy and is dropped (an untied head raises: the GPT-2
tree ties its head).
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np

PyTree = Any

_LAYER_RE = re.compile(r"layers\.(\d+)\.(.+)$")

# megatron key within a layer → (block path, transpose?)
_LAYER_MAP = {
    "input_layernorm.weight": (("ln_1", "scale"), False),
    "input_layernorm.bias": (("ln_1", "bias"), False),
    "attention.query_key_value.weight": (("attn", "c_attn_w"), True),
    "attention.query_key_value.bias": (("attn", "c_attn_b"), False),
    "attention.dense.weight": (("attn", "c_proj_w"), True),
    "attention.dense.bias": (("attn", "c_proj_b"), False),
    "post_attention_layernorm.weight": (("ln_2", "scale"), False),
    "post_attention_layernorm.bias": (("ln_2", "bias"), False),
    "mlp.dense_h_to_4h.weight": (("mlp", "c_fc_w"), True),
    "mlp.dense_h_to_4h.bias": (("mlp", "c_fc_b"), False),
    "mlp.dense_4h_to_h.weight": (("mlp", "c_proj_w"), True),
    "mlp.dense_4h_to_h.bias": (("mlp", "c_proj_b"), False),
}

# a key outside the layers, by its exact suffix → its place in the tree
_TOP_MAP = {
    "word_embeddings.weight": ("wte",),
    "position_embeddings.weight": ("wpe",),
    "final_layernorm.weight": ("ln_f", "scale"),
    "final_layernorm.bias": ("ln_f", "bias"),
}
# an output head: the tied copy of wte
_HEAD_SUFFIXES = ("output_layer.weight", "lm_head.weight")


def _suffix(key: str, table) -> str:
    """The entry of ``table`` that ``key`` ends with at a ``.`` boundary,
    or ''."""
    for suf in table:
        if key == suf or key.endswith("." + suf):
            return suf
    return ""


def megatron_to_gpt2_tree(full_sd: Dict[str, Any]) -> Dict[str, Any]:
    """A full (tp- and pp-merged) Megatron GPT state dict → the stacked
    ``{wte, wpe, ln_f, blocks}`` numpy tree. The vocab is not padded here."""
    per_layer: Dict[int, Dict[str, Dict[str, np.ndarray]]] = {}
    out: Dict[str, Any] = {}
    heads = []
    for key, val in full_sd.items():
        arr = np.asarray(val)
        m = _LAYER_RE.search(key)
        if m:
            n, sub = int(m.group(1)), m.group(2)
            if sub not in _LAYER_MAP:
                raise KeyError(f"unmapped megatron layer key: {key}")
            (grp, name), transpose = _LAYER_MAP[sub]
            per_layer.setdefault(n, {}).setdefault(grp, {})[name] = arr.T if transpose else arr
        elif _suffix(key, _TOP_MAP):
            path = _TOP_MAP[_suffix(key, _TOP_MAP)]
            if len(path) == 1:
                out[path[0]] = arr
            else:
                out.setdefault(path[0], {})[path[1]] = arr
        elif _suffix(key, _HEAD_SUFFIXES):
            heads.append((key, arr))
        else:
            raise KeyError(f"unmapped megatron key: {key}")
    for key, arr in heads:
        if "wte" not in out or arr.shape != out["wte"].shape or not np.array_equal(arr, out["wte"]):
            raise KeyError(f"megatron key {key}: an untied output head; the GPT-2 tree ties "
                           "its head to word_embeddings")
    L = len(per_layer)
    assert sorted(per_layer) == list(range(L)), f"non-contiguous layers: {sorted(per_layer)}"
    blocks: Dict[str, Any] = {}
    for grp in ("ln_1", "ln_2", "attn", "mlp"):
        blocks[grp] = {name: np.stack([per_layer[i][grp][name] for i in range(L)])
                       for name in per_layer[0][grp]}
    out["blocks"] = blocks
    return out


def gpt2_tree_to_megatron(params: PyTree) -> Dict[str, np.ndarray]:
    """Inverse: the stacked tree (numpy, or tensors) → a full Megatron-style
    state dict."""
    def host(x):
        return x.detach().float().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)

    inv = {(grp, name): (sub, transpose) for sub, ((grp, name), transpose) in _LAYER_MAP.items()}
    out: Dict[str, np.ndarray] = {
        "embedding.word_embeddings.weight": host(params["wte"]),
        "embedding.position_embeddings.weight": host(params["wpe"]),
        "final_layernorm.weight": host(params["ln_f"]["scale"]),
        "final_layernorm.bias": host(params["ln_f"]["bias"]),
    }
    for grp, tensors in params["blocks"].items():
        for name, stacked in tensors.items():
            sub, transpose = inv[(grp, name)]
            stacked = host(stacked)
            for i in range(stacked.shape[0]):
                out[f"layers.{i}.{sub}"] = stacked[i].T if transpose else stacked[i]
    return out


def megatron_shards_to_gpt2_tree(shards) -> Dict[str, Any]:
    """A single full dict, a tp row ``[dict]``, or a pp × tp grid
    ``[[dict]]`` → merged and mapped."""
    from .reshape import merge_pp_state_dicts, merge_tp_state_dicts

    if isinstance(shards, dict):
        full = shards
    elif shards and isinstance(shards[0], dict):
        full = merge_tp_state_dicts(shards)
    else:
        full = merge_pp_state_dicts([merge_tp_state_dicts(row) for row in shards])
    return megatron_to_gpt2_tree(full)
