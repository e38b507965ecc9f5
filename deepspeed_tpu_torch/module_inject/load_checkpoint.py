"""Layer-streaming HF checkpoint loader: no torch module is built
(counterpart of ``deepspeed_tpu/module_inject/load_checkpoint.py``).

The checkpoint's shards (safetensors or torch ``.bin``, with or without
an index file) are opened lazily; each tensor is read once, written into
its slot of the stacked parameter tree in the target dtype, and released.
The peak host memory is the final tree plus one tensor, against the whole
fp32 model plus its converted copy on the policy path.

Per-architecture key maps register like the injection policies
(:func:`register_checkpoint_map`); GPT-2's ships built in. Other
architectures convert through ``replace_transformer_layer`` from a live
module, or register a map.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Tuple

import torch

PyTree = Any


class _CkptReader:
    """Lazy tensor access across sharded safetensors / torch ``.bin``
    files of one directory."""

    def __init__(self, model_dir: str):
        self.dir = model_dir
        self._key_to_file: Dict[str, str] = {}
        self._open: Dict[str, Any] = {}
        names = os.listdir(model_dir)
        st = sorted(f for f in names if f.endswith(".safetensors"))
        bins = sorted(f for f in names if f.endswith(".bin"))
        for index in ("model.safetensors.index.json", "pytorch_model.bin.index.json"):
            path = os.path.join(model_dir, index)
            if os.path.exists(path):
                with open(path) as f:
                    self._key_to_file.update(json.load(f)["weight_map"])
                break
        else:
            if not st and not bins:
                raise FileNotFoundError(f"no checkpoint files in {model_dir}")
            for f in st or bins:
                for k in self._handle(f).keys():
                    self._key_to_file[k] = f

    def _handle(self, f: str):
        """The open shard ``f``: a safetensors handle, or a ``.bin`` state
        dict mapped from disk (its storages stay there until sliced)."""
        h = self._open.get(f)
        if h is None:
            path = os.path.join(self.dir, f)
            if f.endswith(".safetensors"):
                from safetensors import safe_open

                h = safe_open(path, framework="pt")
            else:
                h = torch.load(path, map_location="cpu", mmap=True, weights_only=True)
            self._open[f] = h
        return h

    def keys(self):
        return self._key_to_file.keys()

    def get(self, key: str) -> torch.Tensor:
        """The tensor ``key`` in its stored dtype (the caller casts once)."""
        f = self._key_to_file[key]
        h = self._handle(f)
        return h.get_tensor(key) if f.endswith(".safetensors") else h[key]


# arch name → (match(config_dict) -> bool, loader(reader, config_dict, dtype))
_CKPT_MAPS: Dict[str, Tuple[Callable, Callable]] = {}


def register_checkpoint_map(name: str, match, loader) -> None:
    _CKPT_MAPS[name] = (match, loader)


def load_checkpoint_streamed(model_dir: str, dtype: torch.dtype = torch.bfloat16
                             ) -> Tuple[str, Any, PyTree]:
    """Stream an HF checkpoint directory (its ``config.json`` and shards)
    into ``(kind, model_config, params)``, the tree on the host in
    ``dtype``: the alternative to ``replace_transformer_layer`` for a model
    too big to build as a torch module."""
    with open(os.path.join(model_dir, "config.json")) as f:
        hf_cfg = json.load(f)
    reader = _CkptReader(model_dir)
    for _name, (match, loader) in _CKPT_MAPS.items():
        if match(hf_cfg):
            return loader(reader, hf_cfg, dtype)
    raise ValueError(
        f"no streaming checkpoint map for model_type={hf_cfg.get('model_type')}; "
        "registered: " + ", ".join(_CKPT_MAPS) + ". Use replace_transformer_layer "
        "or register_checkpoint_map.")


# ---------------------------------------------------------------------------
# GPT-2: transformer.h.{i}.* → the stacked blocks
# ---------------------------------------------------------------------------

def _load_gpt2(reader: _CkptReader, hf_cfg: dict, dtype) -> Tuple[str, Any, PyTree]:
    from ..models.gpt2 import GPT2Config

    L, E = hf_cfg["n_layer"], hf_cfg["n_embd"]
    cfg = GPT2Config(vocab_size=hf_cfg["vocab_size"], n_positions=hf_cfg["n_positions"],
                     n_embd=E, n_layer=L, n_head=hf_cfg["n_head"],
                     layer_norm_epsilon=hf_cfg.get("layer_norm_epsilon", 1e-5))
    pref = "transformer." if any(k.startswith("transformer.") for k in reader.keys()) else ""

    def g(key):
        return reader.get(pref + key).to(dtype)

    def empty(*shape):
        return torch.empty(shape, dtype=dtype)

    # the stacked leaves in the TARGET dtype; each layer's tensors are read,
    # written into their rows and dropped (HF's Conv1D stores [in, out]:
    # already the x @ W layout)
    blocks = {
        "ln_1": {"scale": empty(L, E), "bias": empty(L, E)},
        "ln_2": {"scale": empty(L, E), "bias": empty(L, E)},
        "attn": {"c_attn_w": empty(L, E, 3 * E), "c_attn_b": empty(L, 3 * E),
                 "c_proj_w": empty(L, E, E), "c_proj_b": empty(L, E)},
        "mlp": {"c_fc_w": empty(L, E, 4 * E), "c_fc_b": empty(L, 4 * E),
                "c_proj_w": empty(L, 4 * E, E), "c_proj_b": empty(L, E)},
    }
    per_layer = [
        ("ln_1.weight", "ln_1", "scale"), ("ln_1.bias", "ln_1", "bias"),
        ("ln_2.weight", "ln_2", "scale"), ("ln_2.bias", "ln_2", "bias"),
        ("attn.c_attn.weight", "attn", "c_attn_w"), ("attn.c_attn.bias", "attn", "c_attn_b"),
        ("attn.c_proj.weight", "attn", "c_proj_w"), ("attn.c_proj.bias", "attn", "c_proj_b"),
        ("mlp.c_fc.weight", "mlp", "c_fc_w"), ("mlp.c_fc.bias", "mlp", "c_fc_b"),
        ("mlp.c_proj.weight", "mlp", "c_proj_w"), ("mlp.c_proj.bias", "mlp", "c_proj_b"),
    ]
    for i in range(L):
        for suffix, grp, name in per_layer:
            blocks[grp][name][i].copy_(g(f"h.{i}.{suffix}"))
    params = {
        "wte": g("wte.weight"),
        "wpe": g("wpe.weight"),
        "ln_f": {"scale": g("ln_f.weight"), "bias": g("ln_f.bias")},
        "blocks": blocks,
    }
    return "gpt2", cfg, params


register_checkpoint_map("gpt2", lambda c: c.get("model_type") == "gpt2", _load_gpt2)
