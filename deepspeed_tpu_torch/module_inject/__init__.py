"""Model surgery and weight mapping (counterpart of
``deepspeed_tpu.module_inject``): the HF injection policies and the
conversion of a live HF module (``replace_policy``, ``replace_module``),
the layer-streaming checkpoint loader (``load_checkpoint``), and the
serving placements' tensor-parallel slices (``tp_shard``)."""

from .load_checkpoint import load_checkpoint_streamed, register_checkpoint_map
from .replace_module import replace_transformer_layer, revert_transformer_layer
from .replace_policy import POLICY_REGISTRY, DSPolicy, HFGPT2LayerPolicy, match_policy, register_policy
from .tp_shard import local_slice, permute_qkv_for_tp, tp_shard_serving_params

__all__ = ["DSPolicy", "HFGPT2LayerPolicy", "POLICY_REGISTRY", "load_checkpoint_streamed",
           "local_slice", "match_policy", "permute_qkv_for_tp", "register_checkpoint_map",
           "register_policy", "replace_transformer_layer", "revert_transformer_layer",
           "tp_shard_serving_params"]
