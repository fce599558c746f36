"""Vocab cross-entropy against the tied embedding, fp32.

Counterpart of ``youku_mplug_tpu/ops/cross_entropy.py``: the logits are
fp32 sums of bf16 products (bf16 x bf16 is exact in fp32, so an fp32
matmul of the bf16-rounded operands equals the JAX package's bf16 dot
with fp32 accumulation), the CE is fp32, and the label-smoothed form is
the ``v / (v - 1)`` one.  ``lm_cross_entropy`` can stream the sequence in
chunks, recomputing each chunk's logits in the backward
(``torch.utils.checkpoint``) so that only one ``[B, chunk, V]`` slab is
live, as ``jax.checkpoint`` does there.

On a model shard the table holds this rank's contiguous ``V / m`` rows
(``vocab_parallel_cross_entropy``, Megatron's vocab-parallel CE): each
rank takes the logits of its slice alone, the log-sum-exp comes from the
local max, an ``all_reduce(MAX)``, the local sums of exp and one
``all_reduce(SUM)`` (which also carries the label's logit from the rank
that owns it, and the logits' sum for label smoothing), and the backward
on the local slice is softmax minus the one-hot (and the smoothing's
uniform term), so no ``[N, V]`` array is ever built.  Under ``ce_chunk``
a chunk's collectives rerun in the backward's recompute, in the same
order on every rank.  ``gathered_cross_entropy`` is its plain version:
the logits gathered to the full vocab, then the dense CE.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from youku_mplug_tpu_torch.parallel.data_parallel import (
    DataGroup,
    sum_over_data,
)
from youku_mplug_tpu_torch.parallel.tensor_parallel import (
    ModelGroup,
    copy_to_model,
    gather_vocab_logits,
)


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


def _smoothing_weights(label_smoothing: float, v: int):
    """(a, b) of the smoothed CE ``a * nll + b * (lse - mean(logits))``,
    the ``v / (v - 1)`` form above; a + b = 1."""
    b = label_smoothing * v / (v - 1)
    return 1.0 - label_smoothing - label_smoothing / (v - 1), b


class _VocabParallelCE(torch.autograd.Function):
    """Per-position CE of fp32 logits split over the vocab: [N, V / m]
    local logits, [N] global labels."""

    @staticmethod
    def forward(ctx, logits, labels, tp, label_smoothing):
        rows = logits.shape[-1]
        v = rows * tp.size
        mx = logits.detach().amax(-1)
        dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=tp.group)
        local = labels - tp.index * rows
        inside = (local >= 0) & (local < rows)
        picked = logits.gather(-1, local.clamp(0, rows - 1)[..., None]
                               )[..., 0] * inside
        sums = torch.stack([(logits - mx[..., None]).exp().sum(-1), picked,
                            logits.sum(-1)])
        dist.all_reduce(sums, group=tp.group)
        lse = mx + sums[0].log()
        loss = lse - sums[1]
        if label_smoothing > 0.0:
            a, b = _smoothing_weights(label_smoothing, v)
            loss = a * loss + b * (lse - sums[2] / v)
        ctx.save_for_backward(logits, lse, local, inside)
        ctx.smoothing, ctx.v = label_smoothing, v
        return loss

    @staticmethod
    def backward(ctx, grad):
        logits, lse, local, inside = ctx.saved_tensors
        g = (logits - lse[..., None]).exp()  # softmax on this slice
        a = 1.0
        if ctx.smoothing > 0.0:
            a, b = _smoothing_weights(ctx.smoothing, ctx.v)
            g = g - b / ctx.v
        rows = torch.arange(g.shape[0], device=g.device)
        g[rows[inside], local[inside]] -= a
        return g * grad[..., None], None, None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 tp: Optional[ModelGroup],
                                 label_smoothing: float = 0.0
                                 ) -> torch.Tensor:
    """Per-position fp32 CE of logits [..., V / m] over this rank's vocab
    slice (labels [...] global ids); ``cross_entropy_with_logits`` without
    a model group."""
    if tp is None or tp.size <= 1:
        return cross_entropy_with_logits(logits, labels, label_smoothing)
    lead = logits.shape[:-1]
    out = _VocabParallelCE.apply(logits.float().reshape(-1, logits.shape[-1]),
                                 labels.reshape(-1).long(), tp,
                                 float(label_smoothing))
    return out.reshape(lead)


def gathered_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           tp: Optional[ModelGroup],
                           label_smoothing: float = 0.0) -> torch.Tensor:
    """The plain version of ``vocab_parallel_cross_entropy``: the slices
    gathered to [..., V] on every rank, then the dense CE."""
    return cross_entropy_with_logits(gather_vocab_logits(logits.float(), tp),
                                     labels, label_smoothing)


def lm_cross_entropy(hidden: torch.Tensor, embedding: torch.Tensor,
                     labels: torch.Tensor, *, chunk: int = 0,
                     tp: Optional[ModelGroup] = None,
                     ce=vocab_parallel_cross_entropy) -> torch.Tensor:
    """Per-position LM loss with tied-embedding logits.  hidden [B, S, H];
    embedding [V, H] (on a model shard ``tp``, this rank's [V / m, H]
    rows); labels [B, S], already shifted.  Returns fp32 losses [B, S].
    ``chunk > 0`` (dividing S, and below it) streams the sequence in
    chunks of that size.  ``ce``: the CE of the logits (the plain
    ``gathered_cross_entropy`` in the tests)."""
    def compute(hid, lab):
        hid = copy_to_model(hid, tp)  # the tied logits: column-parallel
        logits = hid.float() @ embedding.to(hid.dtype).float().t()
        return ce(logits, lab, tp)

    s = hidden.shape[1]
    if chunk <= 0 or s <= chunk or s % chunk != 0:
        return compute(hidden, labels)
    return torch.cat([
        checkpoint(compute, hidden[:, i:i + chunk], labels[:, i:i + chunk],
                   use_reentrant=False)
        for i in range(0, s, chunk)], dim=1)


def masked_mean_loss(losses: torch.Tensor, loss_mask: torch.Tensor,
                     dp: Optional[DataGroup] = None) -> torch.Tensor:
    """sum(losses * mask) / max(sum(mask), 1); under a data group ``dp``
    this rank's share of the global batch's masked mean: its sum over the
    mask's sum across the data ranks (the shares add up to the mean)."""
    mask = loss_mask.float()
    return (losses * mask).sum() / sum_over_data(mask.sum(),
                                                 dp).clamp_min(1.0)
