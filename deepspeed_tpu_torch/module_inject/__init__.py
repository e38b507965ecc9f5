"""Weight mapping for the serving placements (counterpart of
``deepspeed_tpu.module_inject``'s ``tp_shard``). The HF injection
policies are not ported: ROADMAP queue 1 item 12."""

from .tp_shard import local_slice, permute_qkv_for_tp, tp_shard_serving_params

__all__ = ["local_slice", "permute_qkv_for_tp", "tp_shard_serving_params"]
