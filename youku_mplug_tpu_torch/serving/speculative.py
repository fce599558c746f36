"""Speculative decoding: a draft proposes k tokens, the target verifies
them in ONE chunked ``decode_step``.

Counterpart of ``youku_mplug_tpu/serving/speculative.py``.  Greedy
speculative decoding is exact: the committed sequence equals target-only
greedy decoding for any draft.  Each round:

1. the draft proposes ``d_0..d_{k-1}`` autoregressively (k decode steps
   of one token: on the card the decode kernel, K5 with its cache write);
2. the target runs one ``decode_step(..., return_all=True)`` on
   ``[last, d_0..d_{k-1}]`` (plain attention over the cache, as the JAX
   package's S > 1 path) and takes its choice at every position;
3. the agreeing prefix (length ``a``) is committed plus the target's own
   token at position ``a`` (greedy), or the rejection scheme of
   ``_spec_accept`` decides (``do_sample``);
4. both caches keep their rows for committed tokens; rows written for
   rejected proposals sit past ``cache_len``, are masked, and are
   overwritten by later rounds.

Per-sample accepted counts differ, so lengths are [B] tensors throughout.
The JAX package's ``lax.while_loop`` is a Python loop over rounds here,
which reads one flag from the device a round.

On a model shard (a decoder cut by ``parallel/sharding.shard_params``,
as the JAX package runs both functions under ``jax.set_mesh``) every
model rank runs the same rounds: the logits of the prefill, of the
draft's steps and of the verify chunk are the gathered full vocabulary
on every rank (``TiedEmbedding.attend``, for a [B, k+1, V] chunk as for
one token), so the ranks pick, accept and commit the same tokens; with
``do_sample`` they draw the same numbers when they share the generator's
seed (the serve CLI seeds it by the data coordinate, as the engine's);
the round's flag is checked equal over the model group
(``tensor_parallel.agree_over_model``) before it steers another round.
``twin_draft`` builds the draft the serve CLI uses: the target's first
layers, as views of its stacked weights.

``ngram_speculative_generate`` is the draft-free variant (greedy only):
proposals are the continuation of the most recent earlier occurrence of
the sequence's trailing n-gram in its own history (``_ngram_propose``),
and the full-acceptance bonus token is committed, since there is no draft
cache to keep aligned.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from youku_mplug_tpu_torch.models.generation import (
    GenerationConfig,
    _build_prefix,
    gumbel_argmax,
    top_k_top_p_filter,
)
from youku_mplug_tpu_torch.models.gpt3 import GPT3LM
from youku_mplug_tpu_torch.parallel.sharding import copy_shard_state
from youku_mplug_tpu_torch.parallel.tensor_parallel import agree_over_model


def _spec_accept(generator: torch.Generator, drafts: torch.Tensor,
                 p_draft: torch.Tensor, p_target: torch.Tensor):
    """Rejection-sampling acceptance (Leviathan et al.), for a batch of
    samples: drafts [B, k] proposal tokens, p_draft [B, k, V] the draft's
    (filtered) probabilities they were drawn from, p_target [B, k+1, V]
    the target's (filtered) probabilities at every chunk position.

    Returns (commit [B, k+1], n_commit [B]): the accepted prefix, then one
    token drawn from the residual max(p_t - p_d, 0) at the first
    rejection.  n_commit is capped at k: when every draft is accepted the
    bonus target sample is forgone, because committing it would advance
    the draft cache past the rows it wrote (the k-th proposal is never fed
    back while proposing).  Accepted tokens are valid target samples by
    the scheme, so the cap costs throughput, never exactness."""
    b, k = drafts.shape
    idx = drafts.long()[..., None]
    pt_d = p_target[:, :k].gather(-1, idx)[..., 0]
    pd_d = p_draft.gather(-1, idx)[..., 0]
    u = torch.rand((b, k), generator=generator, device=drafts.device)
    accept = u * pd_d < pt_d                    # u < p_t/p_d, no div-by-0
    a = torch.cumprod(accept.int(), dim=1).sum(1)             # [B] 0..k
    # residual at the rejection position (p_target[k] when a == k:
    # everything accepted, the bonus token is a plain target sample)
    rows = torch.arange(b, device=drafts.device)
    p_t_a = p_target[rows, a]
    p_d_a = torch.where((a < k)[:, None], p_draft[rows, a.clamp_max(k - 1)],
                        0.0)
    residual = (p_t_a - p_d_a).clamp_min(0.0)
    residual = residual / residual.sum(-1, keepdim=True).clamp_min(1e-20)
    extra = gumbel_argmax(torch.log(residual + 1e-20), generator)
    pos = torch.arange(k + 1, device=drafts.device)[None]
    commit = torch.where(pos < a[:, None],
                         torch.cat([drafts, drafts[:, -1:]], 1),
                         extra[:, None])
    return commit.int(), (a + 1).clamp_max(k)


def _commit_round(st: dict, commit: torch.Tensor, n_commit: torch.Tensor,
                  config: GenerationConfig, hist: Optional[torch.Tensor] =
                  None, cur: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Commit a round's tokens: mask them by EOS and max_new, write the
    live ones into ``st["seqs"]`` (and ``hist`` at ``cur``), update
    ``done`` and ``last``.  Returns n_live [B] (0 for a done sample)."""
    b, width = commit.shape
    max_new = config.max_new_tokens
    idx = torch.arange(width, device=commit.device)[None]
    is_eos = commit == config.eos_id
    no_earlier_eos = (torch.cumsum(is_eos.int(), 1) - is_eos.int()) == 0
    live = ((idx < n_commit[:, None]) & ~st["done"][:, None]
            & no_earlier_eos & (st["t"][:, None] + idx < max_new))
    n_live = live.sum(1).int()
    rows = torch.arange(b, device=commit.device)
    for j in range(width):
        tgt = (st["t"] + j).clamp(0, max_new - 1).long()
        st["seqs"][rows, tgt] = torch.where(live[:, j], commit[:, j],
                                            st["seqs"][rows, tgt])
        if hist is not None:
            htgt = (cur + j).clamp(0, hist.shape[1] - 1).long()
            hist[rows, htgt] = torch.where(live[:, j], commit[:, j],
                                           hist[rows, htgt])
    hit_eos = (live & is_eos).any(1)
    new_last = commit.gather(1, (n_live - 1).clamp(0, width - 1).long()
                             [:, None])[:, 0]
    st["last"] = torch.where(n_live > 0, new_last, st["last"])
    st["done"] = st["done"] | hit_eos | (st["t"] + n_live >= max_new)
    return n_live


def _more_rounds(st: dict, max_new: int, model: GPT3LM) -> bool:
    """Whether a sample still decodes: the round's one flag from the
    device, the same on every model rank of a shard."""
    more = not bool((st["done"] | (st["t"] >= max_new)).all())
    return agree_over_model(more, model.word_embeddings.tp,
                            st["done"].device)


def _result(st: dict, rounds: int, b: int, max_new: int) -> dict:
    # tokens per verify round (1.0 = no speedup): the draft's figure of
    # merit
    committed = int((st["t"].clamp_max(max_new) - 1).sum())
    return {"sequences": st["seqs"],
            "scores": torch.zeros(b, device=st["seqs"].device),
            "rounds": rounds,
            "tokens_per_round": committed / max(rounds * b, 1)}


@torch.inference_mode()
def speculative_generate(model: GPT3LM, draft_model: GPT3LM,
                         prompt_ids: torch.Tensor, prompt_len: torch.Tensor,
                         config: GenerationConfig = GenerationConfig(),
                         speculate_len: int = 4, query_embeds=None,
                         generator: Optional[torch.Generator] = None
                         ) -> dict:
    """Speculative decoding of prompt_ids [B, P] (right-padded, true
    lengths prompt_len [B]) with ``draft_model`` proposing
    ``speculate_len`` tokens a round.  Greedy (``do_sample`` False): the
    same tokens as target-only greedy decoding.  ``do_sample``: every
    committed token is distributed as a plain target sample under the same
    temperature / top-k / top-p filtering (``_spec_accept``), draws from
    ``generator`` (seeded 0 on the prompt's device when omitted).

    query_embeds [B, nq, H] (the visual prefix) feed the target only; the
    draft conditions on the text prompt alone (a worse draft lowers the
    acceptance rate, never correctness).  Returns {"sequences" [B,
    max_new] int32 padded with pad_id, "scores", "rounds",
    "tokens_per_round"}."""
    sample = bool(config.do_sample)
    dev = prompt_ids.device
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)

    def t_probs(logits):
        logits = logits.float() / config.temperature
        return torch.softmax(top_k_top_p_filter(logits, config.top_k,
                                                config.top_p), -1)

    k = speculate_len
    b, p = prompt_ids.shape
    nq = 0 if query_embeds is None else query_embeds.shape[1]
    max_new = config.max_new_tokens

    # ---- target and draft prefill (the draft: text prompt only) -------
    embeds, valid_from, pos_offset = _build_prefix(
        model, prompt_ids, prompt_len, query_embeds, config.pad_id)
    t_cache = model.init_cache(b, nq + p + max_new + k + 1, device=dev)
    t_logits, _ = model.decode_step(embeds, t_cache, 0, valid_from,
                                    pos_offset)
    d_embeds, d_valid_from, d_pos_offset = _build_prefix(
        draft_model, prompt_ids, prompt_len, None, config.pad_id)
    d_cache = draft_model.init_cache(b, p + max_new + k + 1, device=dev)
    draft_model.decode_step(d_embeds, d_cache, 0, d_valid_from,
                            d_pos_offset)

    if sample:
        first = gumbel_argmax(torch.log(t_probs(t_logits) + 1e-20),
                              generator)
    else:
        first = t_logits.float().argmax(-1).int()
    seqs = torch.full((b, max_new), config.pad_id, dtype=torch.int32,
                      device=dev)
    seqs[:, 0] = first
    # invariant at the top of every round: `last[i]` is committed but NOT
    # yet written into either cache; cache rows < len are written
    st = {"t": torch.ones(b, dtype=torch.int32, device=dev), "seqs": seqs,
          "t_len": torch.full((b,), nq + p, dtype=torch.int32, device=dev),
          "d_len": torch.full((b,), p, dtype=torch.int32, device=dev),
          "last": first, "done": first == config.eos_id}
    rounds = 0
    while _more_rounds(st, max_new, model):
        # ---- 1. the draft proposes k tokens --------------------------
        tok, length = st["last"], st["d_len"]
        drafts, d_probs = [], []
        for _ in range(k):
            logits, _ = draft_model.decode_step(
                draft_model.embed(tok[:, None].long()), d_cache, length,
                d_valid_from, d_pos_offset)
            if sample:
                probs = t_probs(logits)
                tok = gumbel_argmax(torch.log(probs + 1e-20), generator)
                d_probs.append(probs)
            else:
                tok = logits.float().argmax(-1).int()
            drafts.append(tok)
            length = length + 1
        drafts = torch.stack(drafts, 1)                        # [B, k]

        # ---- 2. the target verifies the chunk in one step ------------
        chunk = torch.cat([st["last"][:, None], drafts], 1)
        logits, _ = model.decode_step(model.embed(chunk.long()), t_cache,
                                      st["t_len"], valid_from, pos_offset,
                                      return_all=True)
        if sample:
            commit, n_commit = _spec_accept(
                generator, drafts, torch.stack(d_probs, 1), t_probs(logits))
        else:
            greedy = logits.float().argmax(-1).int()           # [B, k+1]
            agree = drafts == greedy[:, :k]
            accepted = torch.cumprod(agree.int(), 1).sum(1)    # [B] 0..k
            idx = torch.arange(k + 1, device=dev)[None]
            commit = torch.where(
                idx < accepted[:, None],
                torch.cat([drafts, drafts[:, -1:]], 1),
                greedy.gather(1, accepted.clamp_max(k).long()[:, None]))
            # cap at k: on full acceptance the bonus token is forgone so
            # the draft cache never runs past its written rows
            n_commit = (accepted + 1).clamp_max(k)
        was_done = st["done"]
        n_live = _commit_round(st, commit, n_commit, config)
        # the verify chunk wrote rows for [last, drafts]: `last` and the
        # accepted drafts are history now (the final commit is next
        # round's `last`, not yet fed); done samples stop advancing
        adv = torch.where(was_done, 0, n_live)
        st["t"] = st["t"] + adv
        st["t_len"] = st["t_len"] + adv
        st["d_len"] = st["d_len"] + adv
        rounds += 1
    return _result(st, rounds, b, max_new)


def _ngram_propose(hist: torch.Tensor, cur: torch.Tensor, n: int, k: int,
                   lo: torch.Tensor) -> torch.Tensor:
    """Propose k continuation tokens per sample by suffix n-gram lookup.

    hist [B, L] token history (pads allowed outside [lo, cur)), cur [B]
    one past the last valid token, lo [B] first valid index.  Returns
    proposals [B, k]: the tokens that followed the most recent earlier
    match of hist[cur-n : cur]; falls back to repeating the last k tokens
    when no match exists (quality only — never correctness)."""
    b, length = hist.shape
    cur, lo = cur.long(), lo.long()
    idx = torch.arange(length, device=hist.device)[None]          # [1, L]
    match = torch.ones((b, length), dtype=torch.bool, device=hist.device)
    for j in range(n):
        # candidate n-gram ending at m: hist[m - (n-1) + j] vs suffix[j]
        sfx = hist.gather(1, (cur - n + j).clamp_min(0)[:, None])  # [B, 1]
        shift = (idx - (n - 1) + j).clamp(0, length - 1).expand(b, length)
        match &= hist.gather(1, shift) == sfx
    # valid candidates: the whole n-gram inside [lo, cur), strictly
    # earlier than the suffix itself
    valid = (idx - (n - 1) >= lo[:, None]) & (idx < (cur - 1)[:, None])
    best = torch.where(match & valid, idx, -1).amax(1)             # [B]
    # fallback: repeat the tail (best+1..best+k reads the last k tokens)
    best = torch.where(best < 0, cur - 1 - k, best)
    take = (best[:, None] + 1 + torch.arange(k, device=hist.device)[None]
            ).clamp(0, length - 1)
    return hist.gather(1, take)


@torch.inference_mode()
def ngram_speculative_generate(model: GPT3LM, prompt_ids: torch.Tensor,
                               prompt_len: torch.Tensor,
                               config: GenerationConfig = GenerationConfig(),
                               speculate_len: int = 8, ngram: int = 2,
                               query_embeds=None) -> dict:
    """Greedy prompt-lookup decoding: token for token the target's greedy
    output.  speculate_len can run higher than the model-draft path (8 vs
    4): proposals are free, so a long miss costs only the wasted tail of
    one verify chunk.  Returns what ``speculative_generate`` returns."""
    if config.do_sample:
        raise ValueError("ngram speculative decoding is greedy-only")
    k = speculate_len
    dev = prompt_ids.device
    b, p = prompt_ids.shape
    nq = 0 if query_embeds is None else query_embeds.shape[1]
    max_new = config.max_new_tokens

    embeds, valid_from, pos_offset = _build_prefix(
        model, prompt_ids, prompt_len, query_embeds, config.pad_id)
    t_cache = model.init_cache(b, nq + p + max_new + k + 1, device=dev)
    t_logits, _ = model.decode_step(embeds, t_cache, 0, valid_from,
                                    pos_offset)
    first = t_logits.float().argmax(-1).int()

    # history: [pad x k_i | prompt | committed tokens], the prompt right-
    # aligned at width p (the layout _build_prefix feeds the cache), so
    # the valid history is hist[valid_from : p + t]
    j = torch.arange(p, device=dev)[None]
    src = (j - valid_from[:, None]).clamp(0, p - 1)
    shifted = torch.where(j >= valid_from[:, None],
                          prompt_ids.gather(1, src), config.pad_id)
    hist = torch.full((b, p + max_new + k + 1), config.pad_id,
                      dtype=torch.int32, device=dev)
    hist[:, :p] = shifted
    hist[:, p] = first
    seqs = torch.full((b, max_new), config.pad_id, dtype=torch.int32,
                      device=dev)
    seqs[:, 0] = first
    st = {"t": torch.ones(b, dtype=torch.int32, device=dev), "seqs": seqs,
          "t_len": torch.full((b,), nq + p, dtype=torch.int32, device=dev),
          "last": first, "done": first == config.eos_id}
    rounds = 0
    while _more_rounds(st, max_new, model):
        cur = p + st["t"]  # one past the last committed token in hist
        drafts = _ngram_propose(hist, cur, ngram, k, valid_from).int()
        chunk = torch.cat([st["last"][:, None], drafts], 1)
        logits, _ = model.decode_step(model.embed(chunk.long()), t_cache,
                                      st["t_len"], valid_from, pos_offset,
                                      return_all=True)
        greedy = logits.float().argmax(-1).int()               # [B, k+1]
        accepted = torch.cumprod((drafts == greedy[:, :k]).int(), 1).sum(1)
        idx = torch.arange(k + 1, device=dev)[None]
        commit = torch.where(
            idx < accepted[:, None], torch.cat([drafts, drafts[:, -1:]], 1),
            greedy.gather(1, accepted.clamp_max(k).long()[:, None]))
        # no draft cache to protect: the bonus token is committed too
        n_live = _commit_round(st, commit, accepted + 1, config, hist, cur)
        # t_len counts the cache rows of the committed history but `last`:
        # net advance n_live, as in the model-draft path (0 when done)
        st["t"] = st["t"] + n_live
        st["t_len"] = st["t_len"] + n_live
        rounds += 1
    return _result(st, rounds, b, max_new)


def twin_draft(lm: GPT3LM, layers: int) -> GPT3LM:
    """A draft for ``speculative_generate``: a ``GPT3LM`` of the first
    ``layers`` layers of ``lm`` whose parameters (and int8 scales) are
    views of ``lm``'s — its stacked [L] layer tensors sliced, the
    embeddings and final norm shared; nothing is copied.  The twin of a
    model shard is the same shard of the shallower model: each of its
    modules carries the target's shard state (the model group ``tp``, the
    ``mesh``, the split and adapter cuts), so its heads are the rank's
    local heads and its embedding and logits the vocab-parallel lookup
    and gather."""
    if not isinstance(lm, GPT3LM):
        raise TypeError(f"twin_draft takes a GPT3LM, got {type(lm).__name__}")
    depth = lm.cfg.num_hidden_layers
    if not 1 <= layers <= depth:
        raise ValueError(f"draft layers {layers} outside 1..{depth}")
    with torch.device("meta"):
        draft = GPT3LM(dataclasses.replace(lm.cfg, num_hidden_layers=layers),
                       lm.policy)

    def view(name, t):
        return t[:layers] if name.startswith("decoder.layers.") else t

    for name, p in lm.named_parameters():
        mod, _, attr = name.rpartition(".")
        setattr(draft.get_submodule(mod), attr, nn.Parameter(
            view(name, p.detach()), requires_grad=p.requires_grad))
    for name, buf in lm.named_buffers():
        mod, _, attr = name.rpartition(".")
        draft.get_submodule(mod).register_buffer(attr, view(name, buf))
    return copy_shard_state(lm, draft).train(lm.training)
