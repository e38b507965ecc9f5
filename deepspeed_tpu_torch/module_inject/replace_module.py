"""Model surgery: an HF torch model → the port's model functions
(counterpart of ``deepspeed_tpu/module_inject/replace_module.py``).

The whole model converts once through its injection policy
(``replace_policy.py``) into a stacked parameter tree; the tree goes to
the device in the serving dtype, or as weight-only int8 codes through
``ops.quantizer.quantize_tree``, and the model's functions (``models/``)
serve it, the kernels on the card. :func:`revert_transformer_layer` is the
reverse surgery: a converted tree written back into the HF module.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..utils.logging import log_dist
from ..utils.weights import params_from_numpy, tree_map
from .replace_policy import match_policy

PyTree = Any


def replace_transformer_layer(hf_model, policy: Optional[type] = None,
                              dtype: torch.dtype = torch.bfloat16, quantize_bits: int = 0,
                              quantize_groups: int = 1) -> Tuple[str, Any, PyTree]:
    """Convert an HF torch model through its injection policy → ``(kind,
    config, params)``: kind ``"gpt2"``, ``"decoder"`` or ``"bert"``, the
    port's config of that model, and the tree on the host.
    ``quantize_bits=8`` stores the stacked block weights as int8 codes with
    per-group scales in ``dtype`` (the JAX package's ``GroupQuantizer``
    analog); every other float leaf is cast to ``dtype``."""
    pol = policy or match_policy(hf_model)
    if pol is None:
        raise ValueError(
            f"no injection policy for {type(hf_model).__name__}; known: the classes of "
            "module_inject.replace_policy.POLICY_REGISTRY (register more via "
            "module_inject.replace_policy.register_policy)")
    kind, cfg, params_np = pol.convert(hf_model)
    log_dist(f"module_inject: {type(hf_model).__name__} → {kind} via {pol.__name__}")
    params = params_from_numpy(params_np, "cpu", torch.float32)
    if int(quantize_bits) == 8:
        from ..ops.quantizer import quantize_tree

        return kind, cfg, quantize_tree(params, groups=int(quantize_groups), dtype=dtype)
    if int(quantize_bits) != 0:
        raise ValueError(f"quantize_bits={quantize_bits}: 0 or 8")
    return kind, cfg, tree_map(lambda p: p.to(dtype) if p.is_floating_point() else p, params)


def revert_transformer_layer(hf_model, params: PyTree, policy: Optional[type] = None):
    """Write a converted (possibly fine-tuned) tree BACK into the HF model,
    in place, through the policy's ``revert`` (GPT-2's mapping is one to
    one, so it round-trips exactly) → ``hf_model``. An int8 tree cannot
    go back."""
    from ..ops.quantizer import AsymQuantizedWeight, QuantizedWeight

    pol = policy or match_policy(hf_model)
    if pol is None:
        raise ValueError(f"no injection policy matches {type(hf_model).__name__}")
    if not hasattr(pol, "revert"):
        raise NotImplementedError(
            f"{pol.__name__} defines no inverse mapping (revert); only policies with a "
            "declared revert write weights back into the HF model")

    def host(x):
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items()}
        if isinstance(x, (QuantizedWeight, AsymQuantizedWeight)):
            raise ValueError(
                "cannot revert int8-quantized params (replace_transformer_layer with "
                "quantize_bits>0); convert with quantize_bits=0 to round-trip")
        return x.detach().float().cpu().numpy() if torch.is_tensor(x) else x

    pol.revert(hf_model, host(params))
    log_dist(f"revert_transformer_layer: restored HF weights via {pol.__name__}")
    return hf_model
