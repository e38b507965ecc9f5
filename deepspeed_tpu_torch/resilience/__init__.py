"""Fault-tolerance plane (counterpart of ``deepspeed_tpu/resilience/``): a
training or serving run survives its failures.

Three coupled parts, all opt-in through the ``resilience`` config section:

- :mod:`.writer` / :mod:`.manifest`: async checkpointing with an atomic,
  checksummed commit protocol (snapshot to pinned host memory on the step
  path, background write, ``<tag>.tmp`` → fsync → rename → atomic
  ``latest``), byte-compatible with the JAX package's tags;
- :mod:`.recovery`: manifest-validated restore that walks back across
  corrupt and torn tags, and the in-memory :class:`RollbackManager` behind
  the watchdog's ``rollback`` policy;
- :mod:`.faults`: seeded deterministic fault injection (NaN loss,
  crash mid-checkpoint, SIGTERM, serving-slot stalls), so every recovery
  path above is exercised by tests.

Serving-side resilience (graceful drain, retry with backoff) lives on
:class:`~deepspeed_tpu_torch.serving.scheduler.ServingEngine`; the
preemption grace-window flush on
:class:`~deepspeed_tpu_torch.elasticity.preemption.PreemptionGuard`.
"""

from .faults import FaultInjected, FaultInjector
from .manifest import (
    CheckpointIntegrityError,
    atomic_write_text,
    find_latest_valid,
    validate_tag,
    write_tag,
)
from .recovery import (
    RollbackLimitError,
    RollbackManager,
    is_resilient_dir,
    load_resilient_state,
)
from .writer import AsyncCheckpointWriter, snapshot_to_host

__all__ = [
    "AsyncCheckpointWriter",
    "CheckpointIntegrityError",
    "FaultInjected",
    "FaultInjector",
    "RollbackLimitError",
    "RollbackManager",
    "atomic_write_text",
    "find_latest_valid",
    "is_resilient_dir",
    "load_resilient_state",
    "snapshot_to_host",
    "validate_tag",
    "write_tag",
]
