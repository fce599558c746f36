"""Batched autoregressive generation: greedy, sampled and beam search
over the stacked KV cache.

Counterpart of ``youku_mplug_tpu/models/generation.py``, for the GPT-3
captioner and the Bloom instruct decoder alike.  Prompts of
different lengths are front-padded (pads before the query prefix,
``_build_prefix``) and hidden by a per-sample ``valid_from`` and position
offset, so the batch decodes in lock-step.  The prefill is one chunk
through ``decode_step`` (plain attention over the layer view); every later
step is ``decode_step`` with S = 1, which on the card runs the decode
kernel with its cache write in one launch per layer.  The JAX package's
``lax.while_loop`` becomes a Python loop whose stop rule is read on the
host each step; ``decode_steps`` in the result counts the S = 1 steps
run.  Beam search keeps the JAX package's 2K candidates, finished pool,
``length_penalty`` (0: the sum of log-probs, the reference's ranking) and
stop rule, and reorders the cache in place (``_gather_beams``); each of
its top-k selections breaks ties by the lower index, as ``lax.top_k``
does.  On a model shard (``parallel/sharding.shard_params``) the logits
are the gathered full vocabulary on every model rank, so every rank
picks, samples and ranks beams alike, and the reorder moves the rows of
the rank's own heads.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from youku_mplug_tpu_torch.ops import kv_cache as kvc

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


def generate(model, prompt_ids: torch.Tensor, prompt_len: torch.Tensor,
             query_embeds=None, config: GenerationConfig = GenerationConfig(),
             generator: Optional[torch.Generator] = None,
             prompt_embeds=None):
    """Batched generation on ``model``: any decoder with ``embed`` /
    ``logits`` / ``init_cache`` / ``decode_step`` (``GPT3LM``, or
    ``BloomLM`` under mPLUG-Owl's ``generate_instruct``, whose ALiBi
    ignores the position offset).  prompt_ids [B, P]
    right-padded, prompt_len [B] their true lengths (callers drop the
    trailing eos); query_embeds [B, nq, H] the prefix before the prompt;
    prompt_embeds [B, P, H] pre-built prompt embeddings in place of the
    token lookup.  Greedy or sampled (``do_sample``; draws from
    ``generator``) when ``beam_size <= 1`` or sampling, else beam search.
    Returns {"sequences": int32 [B, max_new_tokens] (pad after eos),
    "scores": fp32 [B] (0 unless beam search), "decode_steps": the S = 1
    decode steps run, "nonfinite_logits": the logit rows (of the prefill
    and every step) holding a value that is not finite}."""
    with torch.inference_mode():
        if config.do_sample or config.beam_size <= 1:
            return _sample(model, prompt_ids, prompt_len, query_embeds,
                           prompt_embeds, config, generator)
        return _beam_search(model, prompt_ids, prompt_len, query_embeds,
                            prompt_embeds, config)


def _sample(model, prompt_ids, prompt_len, query_embeds, prompt_embeds,
            config: GenerationConfig, generator):
    b, p = prompt_ids.shape
    dev = prompt_ids.device
    nq = 0 if query_embeds is None else query_embeds.shape[1]
    prefix_len = nq + p
    max_new = config.max_new_tokens
    if generator is None and config.do_sample:
        generator = torch.Generator(dev).manual_seed(0)
    embeds, valid_from, pos_offset = _build_prefix(
        model, prompt_ids, prompt_len, query_embeds, config.pad_id,
        prompt_embeds)
    cache = model.init_cache(b, prefix_len + max_new, device=dev)
    logits, cache = model.decode_step(embeds, cache, 0, valid_from,
                                      pos_offset)

    def pick(logits):
        logits = logits.float() / config.temperature
        if not config.do_sample:
            return logits.argmax(-1).to(torch.int32)
        logits = top_k_top_p_filter(logits, config.top_k, config.top_p)
        return gumbel_argmax(logits, generator)

    seqs = torch.full((b, max_new), config.pad_id, dtype=torch.int32,
                      device=dev)
    seqs[:, 0] = pick(logits)
    nonfinite = _nonfinite(logits)
    done = seqs[:, 0] == config.eos_id
    t = 1
    while t < max_new and not bool(done.all()):
        emb = model.embed(seqs[:, t - 1:t].long())
        logits, cache = model.decode_step(emb, cache, prefix_len + t - 1,
                                          valid_from, pos_offset)
        nonfinite += _nonfinite(logits)
        nxt = torch.where(done, config.pad_id, pick(logits))
        seqs[:, t] = nxt
        done |= nxt == config.eos_id
        t += 1
    return {"sequences": seqs,
            "scores": torch.zeros(b, dtype=torch.float32, device=dev),
            "decode_steps": t - 1, "nonfinite_logits": int(nonfinite)}


def _nonfinite(logits: torch.Tensor) -> torch.Tensor:
    """The rows of ``logits`` holding a value that is not finite, counted
    on the device (read once, at the end)."""
    return (~torch.isfinite(logits)).any(-1).sum()


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last dim: the k largest, equal values in
    index order (a stable descending sort; ``torch.topk`` promises no
    order among ties, and the finished pool is full of NEG_INF)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _gather_beams(cache, beam_idx: torch.Tensor, b: int, k: int,
                  prefix_len: int = 0):
    """Reorder the beam rows of every cache leaf whose dim 1 is B*K (the
    bf16 tensor [L, B*K, M, 2nd], or both leaves of the int8 dict: rows
    [L, B*K, M, 2nd] and scales [L, B*K, M, 2n]) in
    place: row b*K + j takes row b*K + beam_idx[b, j].  prefix_len > 0:
    rows [0, prefix_len) of dim 2 hold the prefill, identical across a
    sample's beams, so only the tail [prefix_len, M) is gathered and
    written back into the same storage (the decode kernel reads and
    writes the cache in place).  Returns the cache."""
    flat = (torch.arange(b, device=beam_idx.device)[:, None] * k
            + beam_idx).reshape(-1)
    for x in kvc.leaves(cache):
        if x is None or x.dim() < 2 or x.shape[1] != b * k:
            continue
        if prefix_len and x.dim() >= 3 and x.shape[2] > prefix_len:
            x = x[:, :, prefix_len:]
        x.copy_(x.index_select(1, flat.to(x.device)))
    return cache


def _beam_search(model, prompt_ids, prompt_len, query_embeds, prompt_embeds,
                 config: GenerationConfig):
    b, p = prompt_ids.shape
    dev = prompt_ids.device
    kb = config.beam_size
    nq = 0 if query_embeds is None else query_embeds.shape[1]
    prefix_len = nq + p
    max_new = config.max_new_tokens
    eos, lp = config.eos_id, config.length_penalty

    embeds, valid_from, pos_offset = _build_prefix(
        model, prompt_ids, prompt_len, query_embeds, config.pad_id,
        prompt_embeds)
    # every beam of a sample starts from its prefill: tile to [B*K, ...]
    valid_t = valid_from.repeat_interleave(kb, 0)
    off_t = pos_offset.repeat_interleave(kb, 0)
    cache = model.init_cache(b * kb, prefix_len + max_new, device=dev)
    logits, cache = model.decode_step(embeds.repeat_interleave(kb, 0), cache,
                                      0, valid_t, off_t)
    v = logits.shape[-1]
    nonfinite = _nonfinite(logits)

    def penalize(scores, length: int):
        if lp == 0.0:
            return scores
        return scores / torch.tensor(float(length), dtype=torch.float32,
                                     device=dev) ** lp

    def rows(x, idx):  # x [B, n, ...] at idx [B, m] along dim 1
        return x.gather(1, idx.reshape(*idx.shape, *[1] * (x.dim() - 2))
                        .expand(*idx.shape, *x.shape[2:]))

    logp = torch.log_softmax(logits.float(), -1).reshape(b, kb, v)
    # step 0: only beam 0 is a real candidate (every beam is the same)
    top_scores, top_tokens = _top_k(logp[:, 0], kb)
    top_tokens = top_tokens.to(torch.int32)
    neg = torch.full_like(top_scores, NEG_INF)
    alive_seq = torch.full((b, kb, max_new), config.pad_id,
                           dtype=torch.int32, device=dev)
    alive_seq[:, :, 0] = top_tokens
    alive_score = torch.where(top_tokens == eos, neg, top_scores)
    fin_score = torch.where(top_tokens == eos, penalize(top_scores, 1), neg)
    fin_seq = torch.where((top_tokens == eos)[..., None], alive_seq,
                          torch.zeros_like(alive_seq))

    def running(t):
        best_alive = penalize(alive_score.amax(1), max_new if lp > 0 else 1)
        return t < max_new and bool((best_alive
                                     > fin_score.amin(1)).any())

    t = 1
    while running(t):
        emb = model.embed(alive_seq[:, :, t - 1].reshape(b * kb, 1).long())
        logits, cache = model.decode_step(emb, cache, prefix_len + t - 1,
                                          valid_t, off_t)
        nonfinite += _nonfinite(logits)
        logp = torch.log_softmax(logits.float(), -1).reshape(b, kb, v)
        cand = (alive_score[:, :, None] + logp).reshape(b, kb * v)
        # 2K candidates, so K survive however many end in eos
        top2k_score, top2k_idx = _top_k(cand, 2 * kb)
        beam_idx, tok_idx = top2k_idx // v, (top2k_idx % v).to(torch.int32)
        is_eos = tok_idx == eos
        # eos candidates join the finished pool, penalized by their length
        new_fin = torch.where(is_eos, penalize(top2k_score, t + 1),
                              torch.full_like(top2k_score, NEG_INF))
        all_fin_score = torch.cat([fin_score, new_fin], 1)
        all_fin_seq = torch.cat([fin_seq, rows(alive_seq, beam_idx)], 1)
        fin_score, keep = _top_k(all_fin_score, kb)
        fin_seq = rows(all_fin_seq, keep)
        # the best K candidates that do not end in eos stay alive
        alive_score, pick = _top_k(
            torch.where(is_eos, torch.full_like(top2k_score, NEG_INF),
                        top2k_score), kb)
        new_beam = beam_idx.gather(1, pick)
        alive_seq = rows(alive_seq, new_beam)
        alive_seq[:, :, t] = tok_idx.gather(1, pick)
        _gather_beams(cache, new_beam, b, kb, prefix_len=prefix_len)
        t += 1

    # open beams join the finished pool
    all_scores = torch.cat([fin_score, penalize(alive_score, max(t, 1))], 1)
    all_seqs = torch.cat([fin_seq, alive_seq], 1)
    best_score, best = _top_k(all_scores, 1)
    return {"sequences": rows(all_seqs, best)[:, 0],
            "scores": best_score[:, 0], "decode_steps": t - 1,
            "nonfinite_logits": int(nonfinite)}
