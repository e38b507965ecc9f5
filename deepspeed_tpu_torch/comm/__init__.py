"""Collectives over ``torch.distributed`` (counterpart of
``deepspeed_tpu.comm``, the same exported names). The compressed
collectives (``comm/compressed.py`` in the JAX package) are not ported:
ROADMAP queue 1 item 12."""

from . import comm
from .comm import (
    CommsLogger,
    TorchBackend,
    all_gather,
    all_reduce,
    all_to_all,
    all_to_all_grad,
    axis_index,
    axis_size,
    barrier,
    broadcast,
    comms_logger,
    configure,
    copy_to_group,
    destroy_process_group,
    get_local_rank,
    get_rank,
    get_world_size,
    group_name,
    init_distributed,
    is_initialized,
    log_summary,
    name_group,
    ppermute,
    record,
    reduce_scatter,
    reduce_from_group,
    ring_shift,
    send_recv,
    subgroup,
)
