"""Generation config, the sampling filter and the front-padded
query-prefix layout.

Counterpart of ``youku_mplug_tpu/models/generation.py`` for what the
serving engine and speculative decoding need (``GenerationConfig``,
``top_k_top_p_filter``, ``_build_prefix``); batched ``generate`` and beam
search are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

NEG_INF = -1.0e7


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 100
    eos_id: int = 7
    pad_id: int = 7
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 0.9
    beam_size: int = 5
    length_penalty: float = 0.0  # 0 == reference ranking (sum logprobs)


def top_k_top_p_filter(logits: torch.Tensor, top_k: int = 0,
                       top_p: float = 0.0) -> torch.Tensor:
    """Set the filtered logits to NEG_INF, as the JAX package does: below
    the k-th largest (``top_k > 0``), then, for ``0 < top_p < 1``, below
    the smallest logit whose exclusive cumulative probability (sorted
    descending) is under ``top_p``."""
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if 0.0 < top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        keep_sorted = (torch.cumsum(probs, dim=-1) - probs) < top_p
        thresh = torch.where(keep_sorted, sorted_logits,
                             float("inf")).amin(-1, keepdim=True)
        logits = torch.where(logits < thresh, NEG_INF, logits)
    return logits


def gumbel_argmax(logits: torch.Tensor,
                  generator: torch.Generator) -> torch.Tensor:
    """One categorical draw per row of ``logits`` (unnormalized log
    probabilities) as the argmax of logits plus Gumbel noise from
    ``generator``: the law of ``jax.random.categorical``, with no host
    synchronization (a CUDA graph captures it).  Returns int32 [...]."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return (logits - torch.log(-torch.log(u))).argmax(-1).to(torch.int32)


def _build_prefix(model, prompt_ids: torch.Tensor, prompt_len: torch.Tensor,
                  query_embeds, pad_id: int, prompt_embeds=None):
    """Front-padded prefill embeddings.

    Layout per sample: [pad x k_i | queries (nq) | prompt tokens (len_i)]
    with k_i = P - len_i, so every sample's last prompt token lands at the
    same position.  Pad rows are zero embeddings.  prompt_embeds
    [B, P, H]: pre-built prompt embeddings (video features spliced in,
    models/owl.py) that replace the token-embedding lookup, right-aligned
    the same way.  Returns (embeds [B, nq+P, H], valid_from [B],
    pos_offset [B]); both are k."""
    b, p = prompt_ids.shape
    dev = prompt_ids.device
    nq = 0 if query_embeds is None else query_embeds.shape[1]
    k = (p - prompt_len).to(torch.long)  # [B]

    # right-align the tokens within the P-wide buffer
    j = torch.arange(p, device=dev)[None, :]
    src = (j - k[:, None]).clamp(0, p - 1)
    if prompt_embeds is not None:
        h = prompt_embeds.shape[-1]
        tok_emb = prompt_embeds.gather(1, src[..., None].expand(b, p, h))
        tok_emb = torch.where((j >= k[:, None])[..., None], tok_emb,
                              torch.zeros((), dtype=tok_emb.dtype,
                                          device=dev))
    else:
        shifted = torch.where(j >= k[:, None], prompt_ids.gather(1, src),
                              torch.full_like(prompt_ids, pad_id))
        tok_emb = model.embed(shifted)
    h = tok_emb.shape[-1]
    total = nq + p
    jj = torch.arange(total, device=dev)[None, :, None]
    kk = k[:, None, None]

    tok_idx = (torch.arange(total, device=dev)[None, :] - nq).clamp(0, p - 1)
    tok_part = tok_emb.gather(1, tok_idx.expand(b, total)[..., None]
                              .expand(b, total, h))
    zero = torch.zeros((), dtype=tok_emb.dtype, device=dev)
    if query_embeds is None:
        return torch.where(jj < kk, zero, tok_part), k, k
    q_idx = (torch.arange(total, device=dev)[None, :] - k[:, None]).clamp(
        0, nq - 1)
    q_part = query_embeds.to(tok_emb.dtype).gather(
        1, q_idx[..., None].expand(b, total, h))
    embeds = torch.where(jj < kk, zero,
                         torch.where(jj < kk + nq, q_part, tok_part))
    return embeds, k, k
