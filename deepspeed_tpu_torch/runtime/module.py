"""The model abstraction the engine trains (counterpart of
``deepspeed_tpu/runtime/module.py``): a bundle of plain functions over a
parameter tree (nested dict of tensors)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

PyTree = Any
Batch = Any

# loss_fn(params, batch, rng, train) -> (scalar loss, metrics dict); rng is
# a threefry key (ops/prng.py), the micro-batch's in training: in the
# engine's step a device key table (see ModuleSpec.key_table)
LossFn = Callable[[PyTree, Batch, Any, bool], Tuple[Any, Dict[str, Any]]]


@dataclass
class ModuleSpec:
    """A trainable model.

    Attributes:
      init: ``generator -> params``, the tree on the generator's device.
      loss_fn: ``(params, batch, rng, train) -> (loss, metrics)``, ``rng``
        the micro-batch's JAX key (dropout).
      apply_fn: optional inference forward ``(params, batch) -> outputs``.
      key_table: optional ``host key [2] -> uint32 [T, 2]``, every key the
        loss draws from under that key. The engine's training step derives
        each micro-batch's table on the host, uploads the step's tables in
        one copy, and calls ``loss_fn`` with the device table (int32 ``[T,
        2]``). Without one the loss gets the micro-batch key itself as a
        device key (int32 ``[2]``).
      loss_norm: optional ``host batch -> f32 [k]``, the loss's global
        denominator, taken by the engine over a whole micro-batch of every
        rank (JAX's loss over the global batch).
      logical_axes: optional tree matching params, each leaf a tuple of
        logical axis names (JAX's field): the engine's tensor-parallel
        placement (``runtime.zero.partitioning``). A model without it
        refuses ``mesh.tp > 1``.
      seq_labels: optional ``host batch -> int64 [B, S]``, the next-token
        labels at every position (-100: nothing predicted), taken on the
        whole host batch before the engine cuts its sequence over ``sp``
        (the shift GSPMD did across shards); handed to the loss as the
        batch leaf ``"__labels__"``. A model without it refuses
        ``mesh.sp > 1``.
      checkpointing: optional ``(partition_activations, cpu_checkpointing)
        -> ModuleSpec``, the model with the ``activation_checkpointing``
        section's two options turned on (beside its own). A model without
        it refuses the section with either option on.
    """

    init: Callable[[Any], PyTree]
    loss_fn: LossFn
    apply_fn: Optional[Callable] = None
    key_table: Optional[Callable[[Any], Any]] = None
    loss_norm: Optional[Callable[[Any], Any]] = None
    logical_axes: Optional[PyTree] = None
    seq_labels: Optional[Callable[[Any], Any]] = None
    checkpointing: Optional[Callable[[bool, bool], "ModuleSpec"]] = None
