"""OnDevice: build a model's parameters without memory ("meta"), or
straight onto a device (counterpart of ``deepspeed_tpu/utils/init_on_device.py``,
the reference's ``utils/init_on_device.py:81``).

``OnDevice(device="meta").init(init_fn, *args)`` runs the initializer
under torch's fake-tensor mode, which carries shapes and dtypes through
every op without storage or compute, and returns the tree as ``meta``
tensors: JAX's ``jax.eval_shape`` of the same initializer, leaf for leaf.
With a device (a string or ``torch.device``) the initializer runs for real
and its leaves land there; ``dtype`` casts the floating leaves either way.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from .weights import tree_map


class OnDevice:
    """Where (and in what dtype) ``init`` materializes params::

        with OnDevice(dtype=torch.bfloat16, device="meta") as ctx:
            abstract = ctx.init(module.init, generator)   # meta tensors
        with OnDevice(device="cuda") as ctx:
            params = ctx.init(module.init, generator)     # on the card
    """

    def __init__(self, dtype: Optional[Any] = None, device: Any = "meta", enabled: bool = True):
        self.dtype = dtype
        self.device = device
        self.enabled = enabled

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _dtype(self, t: torch.Tensor) -> torch.dtype:
        return self.dtype if (self.dtype is not None and t.is_floating_point()) else t.dtype

    def init(self, init_fn, *args):
        """Run ``init_fn(*args)`` under this context's placement."""
        if not self.enabled:
            return init_fn(*args)
        if str(self.device) == "meta":
            from torch._subclasses.fake_tensor import FakeTensorMode

            with FakeTensorMode(allow_non_fake_inputs=True):
                tree = init_fn(*args)
            return tree_map(lambda t: torch.empty(tuple(t.shape), dtype=self._dtype(t),
                                                  device="meta"), tree)
        try:
            device = torch.device(self.device)
        except (RuntimeError, TypeError) as e:
            raise ValueError(f"OnDevice: unknown device {self.device!r} (use 'meta', a "
                             "device string or a torch.device)") from e
        return tree_map(lambda t: t.to(device=device, dtype=self._dtype(t)), init_fn(*args))
