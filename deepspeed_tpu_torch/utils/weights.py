"""Parameter trees between numpy and torch.

The port keeps the JAX package's parameter layout (a nested dict, stacked
``blocks`` ``[L, ...]``, the ``x @ W`` convention), so a tree that left the
JAX package as numpy arrays can be handed to the port unchanged and both
packages compute with the same weights. A quantized leaf (the JAX
package's ``QuantizedWeight`` / ``AsymQuantizedWeight``, or a dict of
exactly ``q``/``scale`` or ``q``/``scale``/``zero_point``) becomes the
port's named tuple of the same fields, its codes and scales unchanged, so
both packages compute from the same codes.
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


_QUANT_FIELDS = (("q", "scale"), ("q", "scale", "zero_point"))


def _quantized_fields(x) -> Optional[tuple]:
    """The fields of a quantized leaf (a named tuple or dict of exactly
    ``q``/``scale`` or ``q``/``scale``/``zero_point``), else None."""
    if _is_namedtuple(x):
        fields = tuple(x._fields)
    elif isinstance(x, dict):
        fields = tuple(f for f in ("q", "scale", "zero_point") if f in x)
        if len(fields) != len(x):
            return None
    else:
        return None
    return fields if fields in _QUANT_FIELDS else None


def params_from_numpy(tree: PyTree, device, dtype: Optional[torch.dtype] = None) -> PyTree:
    """Nested dict of array-likes → the same dict of tensors on ``device``;
    floating leaves are cast to ``dtype`` when it is given. Quantized
    leaves become ``ops.quantizer`` named tuples, their codes and scales
    as given (never cast)."""
    fields = _quantized_fields(tree)
    if fields is not None:
        from ..ops.quantizer import AsymQuantizedWeight, QuantizedWeight

        cls = QuantizedWeight if len(fields) == 2 else AsymQuantizedWeight
        get = tree.__getitem__ if isinstance(tree, dict) else (lambda f: getattr(tree, f))
        return cls(*[_leaf_from_numpy(get(f), device, None) for f in fields])
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    return _leaf_from_numpy(tree, device, dtype)


def params_to_numpy(params: PyTree) -> PyTree:
    """Nested dict of tensors → the same dict of numpy arrays on the host.
    bfloat16 leaves come back as float32 (exact: every bfloat16 value is a
    float32 value), since numpy has no bfloat16."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if _is_namedtuple(params):
        return type(params)(*[params_to_numpy(v) for v in params])
    t = params.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn, tree: PyTree) -> PyTree:
    """``fn`` over the leaves of a nested dict; a named tuple (a quantized
    weight) is a node whose fields are leaves."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*[tree_map(fn, v) for v in tree])
    return fn(tree)


def tree_leaves(tree: PyTree) -> list:
    """The leaves of a nested dict (keys in sorted order, as ``jax.tree.leaves``
    orders a dict) or list of tensors."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]
