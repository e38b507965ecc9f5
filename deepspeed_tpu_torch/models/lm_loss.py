"""Shared next-token cross-entropy (counterpart of
``deepspeed_tpu/models/lm_loss.py``): one shift/mask convention for every
LM loss path. The full-logits path is ported; the sequence-chunked path
(``ce_chunk > 0``) is not yet and raises."""

from __future__ import annotations

import torch

from ..runtime.config import NotPortedError


def shift_labels_mask(batch):
    """Next-token shift with ignore-index (-100) and attention masking →
    ``(labels [B, S-1] clamped >= 0, mask f32 [B, S-1])``."""
    ids = batch["input_ids"]
    labels = batch.get("labels", ids)[:, 1:]
    mask = (labels != -100).float()
    if "attention_mask" in batch:
        mask = mask * batch["attention_mask"][:, 1:].float()
    return labels.clamp_min(0), mask


def mask_pad_vocab(logits, logical_vocab):
    """-1e30 in the padded vocab columns (``>= logical_vocab``), so a padded
    embedding contributes nothing to softmax and its rows get zero grad. A
    no-op when the logits are unpadded or ``logical_vocab`` is None."""
    V = logits.shape[-1]
    if logical_vocab is None or V == int(logical_vocab):
        return logits
    col = torch.arange(V, device=logits.device)
    return logits.masked_fill(col >= int(logical_vocab), -1e30)


def token_loss(logits_full, batch, logical_vocab=None):
    """Shifted CE from full logits ``[B, S, V]`` → ``(mean nll, ntokens)``,
    in f32."""
    logits = logits_full[:, :-1]
    labels, mask = shift_labels_mask(batch)
    lf = mask_pad_vocab(logits.float(), logical_vocab)
    logz = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, labels[..., None].long())[..., 0]
    nll = (logz - gold) * mask
    ntokens = mask.sum()
    return nll.sum() / ntokens.clamp_min(1.0), ntokens


def head_token_loss(project, h, batch, ce_chunk: int = 0, logical_vocab=None):
    """Head projection (``project``: ``[..., E] -> [..., V]``) + shifted CE
    from final hidden states."""
    if ce_chunk > 0:
        raise NotPortedError(
            f"ce_chunk={ce_chunk}: the sequence-chunked cross-entropy is not ported "
            "to deepspeed_tpu_torch yet (ROADMAP queue 1 item 5)"
        )
    return token_loss(project(h), batch, logical_vocab)
