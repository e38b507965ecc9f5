"""Shared next-token cross-entropy (counterpart of
``deepspeed_tpu/models/lm_loss.py``): one shift/mask convention for every
LM loss path, full-logits or sequence-chunked (``ce_chunk > 0``), which
never holds more than one chunk's ``[B, C, V]`` logits: each chunk's logits
are recomputed in backward. The mean's denominator is the batch's token
count, or under data parallelism the global micro-batch's
(:func:`loss_count`), which the engine passes as ``batch["__norm__"]``."""

from __future__ import annotations

import numpy as np
import torch

from ..runtime.activation_checkpointing import checkpoint


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


def loss_count(batch) -> float:
    """The loss's token count of a host batch (numpy leaves): the sum of
    :func:`shift_labels_mask`'s mask, in f32. Under data parallelism the
    engine takes it over the global micro-batch, so every rank divides by
    the global count, as JAX's loss over the whole batch does."""
    labels = np.asarray(batch.get("labels", batch["input_ids"]))[:, 1:]
    mask = (labels != -100).astype(np.float32)
    if "attention_mask" in batch:
        mask = mask * np.asarray(batch["attention_mask"])[:, 1:].astype(np.float32)
    return float(mask.sum(dtype=np.float32))


def _denominator(batch, ntokens):
    """``max(ntokens, 1)``, or the global count the engine put in the
    batch (``"__norm__"``, already at least 1)."""
    norm = batch.get("__norm__")
    return ntokens.clamp_min(1.0) if norm is None else norm[0]


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
    return nll.sum() / _denominator(batch, ntokens), ntokens


def chunked_token_loss(project, h, batch, ce_chunk: int, logical_vocab=None):
    """Shifted CE from final hidden states ``h [B, S, E]`` in sequence
    chunks of ``ce_chunk`` positions → ``(mean nll, ntokens)``, the value of
    :func:`token_loss` on ``project(h)``. ``h`` is used unsliced: labels and
    mask are padded back to S columns with a 0 mask at the final position,
    whose logits then add exactly 0. Each chunk reduces to its nll sum,
    added in order; its logits are recomputed in backward."""
    labels, mask = shift_labels_mask(batch)
    labels = torch.nn.functional.pad(labels, (0, 1))
    mask = torch.nn.functional.pad(mask, (0, 1))
    S, C = h.shape[1], int(ce_chunk)

    def chunk_nll(hc, lc, mc):
        logits = mask_pad_vocab(project(hc).float(), logical_vocab)
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, lc[..., None].long())[..., 0]
        return ((logz - gold) * mc).sum()

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S, C):
        total = total + checkpoint(chunk_nll, h[:, i:i + C], labels[:, i:i + C],
                                   mask[:, i:i + C])
    ntokens = mask.sum()
    return total / _denominator(batch, ntokens), ntokens


def head_token_loss(project, h, batch, ce_chunk: int = 0, logical_vocab=None):
    """Head projection (``project``: ``[..., E] -> [..., V]``) + shifted CE
    from final hidden states; sequence-chunked when ``ce_chunk > 0``."""
    if ce_chunk > 0:
        return chunked_token_loss(project, h, batch, ce_chunk, logical_vocab)
    return token_loss(project(h), batch, logical_vocab)
