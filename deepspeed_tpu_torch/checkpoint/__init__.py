"""Checkpointing (counterpart of ``deepspeed_tpu/checkpoint/``): the
pluggable engine and the non-resilient save/load. The TP/dp regridding
(``reshape``, ``universal_checkpoint``, ``deepspeed_checkpoint``) waits for
ROADMAP queue 1 item 10, and ``megatron_loader`` for item 12."""

from .engine import (
    CheckpointEngine,
    TorchCheckpointEngine,
    load_train_state,
    read_latest_tag,
    save_train_state,
)

__all__ = [
    "CheckpointEngine",
    "TorchCheckpointEngine",
    "load_train_state",
    "read_latest_tag",
    "save_train_state",
]
