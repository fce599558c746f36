"""Vocab cross-entropy against the tied embedding, fp32.

Counterpart of ``youku_mplug_tpu/ops/cross_entropy.py``: the logits are
fp32 sums of bf16 products (bf16 x bf16 is exact in fp32, so an fp32
matmul of the bf16-rounded operands equals the JAX package's bf16 dot
with fp32 accumulation), the CE is fp32, and the label-smoothed form is
the ``v / (v - 1)`` one.  ``lm_cross_entropy`` can stream the sequence in
chunks, recomputing each chunk's logits in the backward
(``torch.utils.checkpoint``) so that only one ``[B, chunk, V]`` slab is
live, as ``jax.checkpoint`` does there.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def cross_entropy_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                              label_smoothing: float = 0.0) -> torch.Tensor:
    """Per-position CE. logits [..., V] (any float dtype), labels [...]
    int; computed in fp32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = logits.gather(-1, labels[..., None].long())[..., 0]
    loss = lse - label_logit
    if label_smoothing > 0.0:
        v = logits.shape[-1]
        smooth_loss = lse - logits.mean(-1)
        loss = (1.0 - label_smoothing) * loss + (
            label_smoothing * v / (v - 1)) * (smooth_loss - loss / v)
    return loss


def lm_cross_entropy(hidden: torch.Tensor, embedding: torch.Tensor,
                     labels: torch.Tensor, *, chunk: int = 0) -> torch.Tensor:
    """Per-position LM loss with tied-embedding logits.  hidden [B, S, H];
    embedding [V, H]; labels [B, S], already shifted.  Returns fp32
    losses [B, S].  ``chunk > 0`` (dividing S, and below it) streams the
    sequence in chunks of that size."""
    def compute(hid, lab):
        logits = hid.float() @ embedding.to(hid.dtype).float().t()
        return cross_entropy_with_logits(logits, lab)

    s = hidden.shape[1]
    if chunk <= 0 or s <= chunk or s % chunk != 0:
        return compute(hidden, labels)
    return torch.cat([
        checkpoint(compute, hidden[:, i:i + chunk], labels[:, i:i + chunk],
                   use_reentrant=False)
        for i in range(0, s, chunk)], dim=1)


def masked_mean_loss(losses: torch.Tensor,
                     loss_mask: torch.Tensor) -> torch.Tensor:
    """sum(losses * mask) / max(sum(mask), 1)."""
    mask = loss_mask.float()
    return (losses * mask).sum() / mask.sum().clamp_min(1.0)
