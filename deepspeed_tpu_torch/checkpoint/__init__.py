"""Checkpointing (counterpart of ``deepspeed_tpu/checkpoint/``): the
pluggable engine, the non-resilient save/load and the Megatron TP/PP
regridding of numpy state dicts (``reshape``). The universal and reference
checkpoint readers (``universal_checkpoint``, ``deepspeed_checkpoint``,
Orbax readers in the JAX package) wait for ROADMAP queue 1 item 10b, and
``megatron_loader`` for item 12."""

from .engine import (
    CheckpointEngine,
    TorchCheckpointEngine,
    load_train_state,
    read_latest_tag,
    save_train_state,
)
from .reshape import (
    merge_pp_state_dicts,
    merge_tp_state_dicts,
    reshape_2d,
    reshape_tp,
    split_pp_state_dict,
    split_tp_state_dict,
)

__all__ = [
    "CheckpointEngine",
    "TorchCheckpointEngine",
    "load_train_state",
    "read_latest_tag",
    "save_train_state",
    "merge_pp_state_dicts",
    "merge_tp_state_dicts",
    "reshape_2d",
    "reshape_tp",
    "split_pp_state_dict",
    "split_tp_state_dict",
]
