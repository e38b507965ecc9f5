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
    """

    init: Callable[[Any], PyTree]
    loss_fn: LossFn
    apply_fn: Optional[Callable] = None
    key_table: Optional[Callable[[Any], Any]] = None
    loss_norm: Optional[Callable[[Any], Any]] = None
