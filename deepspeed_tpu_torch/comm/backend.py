"""Pluggable communication backend shell (counterpart of
``deepspeed_tpu/comm/backend.py``, the reference's ``Backend`` ABC). The
port's one backend is :class:`~.torch.TorchBackend`: ``torch.distributed``
on NCCL for the card and gloo for the CPU."""

from __future__ import annotations


class Backend:
    def __init__(self, name: str = "backend", rank: int = 0, size: int = 1):
        self.name = name
        self.world_group = None
        self.world_size = size
        self.world_rank = rank
        self.initialized = False

    def is_initialized(self) -> bool:
        return self.initialized

    def new_group(self, ranks):
        raise NotImplementedError

    def init_process_group(self):
        self.initialized = True

    def destroy_process_group(self):
        self.initialized = False
