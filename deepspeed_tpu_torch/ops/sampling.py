"""Token sampling for autoregressive decode (counterpart of
``deepspeed_tpu/ops/sampling.py``).

The masks follow the JAX package's rules exactly: top-k keeps exactly k
tokens, ties going to the lowest index; top-p keeps the smallest prefix of
the probability-sorted vocab whose mass reaches ``p``, backed off by a
relative 1e-6 so a prefix whose mass equals ``p`` does not leak one more
token. A sampled draw comes from a ``torch.Generator``; it is not the JAX
package's threefry draw for the same seed.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG = -1e30


def _sort_desc(logits: torch.Tensor):
    # stable: equal logits keep their index order, so ties rank lowest-first
    return torch.sort(logits, dim=-1, descending=True, stable=True)


def top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep exactly the k highest logits per row, mask the rest to -1e30."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    idx = _sort_desc(logits)[1][..., :k]
    keep = torch.zeros_like(logits, dtype=torch.bool).scatter_(-1, idx, True)
    return torch.where(keep, logits, torch.full_like(logits, NEG))


def top_p_mask(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering; the argmax always survives."""
    if p >= 1.0:
        return logits
    sorted_logits, sort_idx = _sort_desc(logits)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1) - probs  # exclusive: the first survives
    keep_sorted = cum < p * (1.0 - 1e-6)
    masked_sorted = torch.where(
        keep_sorted, sorted_logits, torch.full_like(sorted_logits, NEG)
    )
    return torch.empty_like(logits).scatter_(-1, sort_idx, masked_sorted)


def sample_logits(
    logits: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """[N, V] logits → [N] token ids. temperature <= 0 is greedy (argmax,
    first index on ties); otherwise one draw per row from ``generator``."""
    logits = logits.float()
    if not temperature or temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    logits = top_k_mask(logits, int(top_k))
    logits = top_p_mask(logits, float(top_p))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0]
