"""The model abstraction the engine trains (counterpart of
``deepspeed_tpu/runtime/module.py``): a bundle of plain functions over a
parameter tree (nested dict of tensors)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

PyTree = Any
Batch = Any

# loss_fn(params, batch, rng, train) -> (scalar loss, metrics dict); rng is
# a [2] threefry key (ops/prng.py), the micro-batch's in training
LossFn = Callable[[PyTree, Batch, Any, bool], Tuple[Any, Dict[str, Any]]]


@dataclass
class ModuleSpec:
    """A trainable model.

    Attributes:
      init: ``generator -> params``, the tree on the generator's device.
      loss_fn: ``(params, batch, rng, train) -> (loss, metrics)``, ``rng``
        the micro-batch's JAX key (dropout).
      apply_fn: optional inference forward ``(params, batch) -> outputs``.
    """

    init: Callable[[Any], PyTree]
    loss_fn: LossFn
    apply_fn: Optional[Callable] = None
