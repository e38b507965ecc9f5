"""Parameter trees between numpy and torch.

The port keeps the JAX package's parameter layout (a nested dict, stacked
``blocks`` ``[L, ...]``, the ``x @ W`` convention), so a tree that left the
JAX package as numpy arrays can be handed to the port unchanged and both
packages compute with the same weights.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

PyTree = Any


def _leaf_from_numpy(x, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    x = np.ascontiguousarray(x)
    if not x.flags.writeable:  # e.g. a view of a JAX array: copy, never alias
        x = x.copy()
    if x.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own; the bits travel as uint16
        t = torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(x)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree: PyTree, device, dtype: Optional[torch.dtype] = None) -> PyTree:
    """Nested dict of array-likes → the same dict of tensors on ``device``;
    floating leaves are cast to ``dtype`` when it is given."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    return _leaf_from_numpy(tree, device, dtype)


def params_to_numpy(params: PyTree) -> PyTree:
    """Nested dict of tensors → the same dict of numpy arrays on the host.
    bfloat16 leaves come back as float32 (exact: every bfloat16 value is a
    float32 value), since numpy has no bfloat16."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    t = params.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def tree_map(fn, tree: PyTree) -> PyTree:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)
