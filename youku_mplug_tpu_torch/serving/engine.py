"""Continuous-batching serving engine for the GPT-3 and Bloom decoders.

Counterpart of ``youku_mplug_tpu/serving/engine.py``: a fixed pool of
slots shares one stacked KV cache [L, num_slots, M, 2*hidden] (bf16, or
the int8 dict of ``ops/kv_cache.py`` when the model's config says
``kv_cache_dtype: int8``), allocated once and written in place; every slot
sits at its own sequence length.  Prefill runs one request's front-padded
[queries | prompt] chunk (or its pre-built prompt embeddings, the Owl
instruct path) into its slot, eagerly; decode advances ALL slots (inactive
slots compute too and are ignored on the host — their repeated write lands
at a masked position and is overwritten when the slot is reused).
Requests are admitted whenever a slot is free, between dispatches.  Prompt
widths are padded to a small set of buckets.

Decoding modes, as in the JAX package:

- ``step`` decodes one token for every slot; ``step_many(k)`` decodes up
  to k in one dispatch (multi-step scheduling), k clamped so no slot
  overruns the cache, tokens past a slot's EOS or max_new trimmed on the
  host;
- ``_pick`` takes the argmax of the logits over the temperature, or with
  ``do_sample`` one draw from the ``top_k_top_p_filter``-ed distribution
  (Gumbel-max with the engine's ``torch.Generator``);
- ``step_lookup(k)`` is greedy prompt-lookup speculation: each slot
  proposes k tokens from its own history (``_lookup_propose``), one chunk
  of k+1 tokens per slot is verified by ``decode_step(..., return_all=
  True)`` (plain attention, as the JAX package's S > 1 path), and the
  agreeing prefix plus the target's next token is committed.

A dispatch of k decode steps is, on the card, one replay of a CUDA graph
captured for that k (the counterpart of the JAX package's one compiled
program per k): k repetitions of embed -> ``decode_step`` -> ``_pick``
with ``cache_len`` advanced on the device, reading static int32 input
buffers (copied from a pinned host array before the replay) and writing a
static [k, B] token buffer.  All graphs share one memory pool; the first
capture is preceded by one eager warm-up step on the capture stream
(cuBLAS workspaces, the kernel library's build).  A capture or replay that
fails raises; CPU tensors, and a model shard's, run the same k-step
body eagerly.  Kernel wrappers count their launches when Python calls them, so
each graph records its capture's counts and every replay adds them: the
counters keep counting launches sent to the device.  A graph reads the
model's parameters in their storage: LoRA adapters left unmerged run in
the same replay, and adapters or weights copied in place after the
capture (``ops/lora.inject_adapters``, a checkpoint restore) reach every
later replay; replacing a parameter tensor (``p.data = ...``) would not.

On a model shard (a GPT-3 or Bloom decoder cut by
``parallel/sharding.shard_params``, ``model > 1``) the engine dispatches
every decode step eagerly and captures no CUDA graph (``graph_replays``
stays 0): gloo's collectives cannot be captured, and a capture of NCCL's
cannot be tested with one card.  The cache holds the rank's own heads
(Bloom's decode kernel takes their slice of the ALiBi ladder), and the
logits every rank picks from are the gathered full vocabulary
(``parallel/tensor_parallel.gather_vocab_logits``), so the model ranks
pick the same tokens, sampled ones too (one generator seed a data rank).
Prompt-lookup speculation (``step_lookup``) runs there as ``step`` does,
eagerly: the verify chunk's [B, k+1, V] logits are the gathered full
vocabulary too, so every model rank commits the same tokens and proposes
the same drafts from the same histories.
Under ``model == 1`` nothing changes.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from youku_mplug_tpu_torch.models.generation import (
    GenerationConfig,
    _build_prefix,
    gumbel_argmax,
    top_k_top_p_filter,
)
from youku_mplug_tpu_torch.models.bloom import BloomLM
from youku_mplug_tpu_torch.models.gpt3 import GPT3LM
from youku_mplug_tpu_torch.ops import decode_attention as dec
from youku_mplug_tpu_torch.ops import flash_attention as fa
from youku_mplug_tpu_torch.ops import kv_cache as kvc
from youku_mplug_tpu_torch.parallel.tensor_parallel import model_parallel

# the kernel wrappers' launch counters (function, attribute)
COUNTERS = tuple(
    (fn, attr) for fn, attrs in (
        (dec.write_decode_attention, ("launches", "alibi_launches",
                                      "int8_launches",
                                      "int8_alibi_launches",
                                      "d128_launches")),
        (fa.flash_attention_packed, ("launches", "d96_launches",
                                     "d128_launches", "alibi_launches")),
        (fa.flash_attention, ("launches", "d96_launches", "d128_launches",
                              "alibi_launches")))
    for attr in attrs)


def _counts() -> List[int]:
    return [getattr(fn, attr) for fn, attr in COUNTERS]


@dataclasses.dataclass
class _Slot:
    rid: int
    max_new: int
    tokens: List[int]
    done: bool = False


@dataclasses.dataclass
class FinishedRequest:
    rid: int
    tokens: List[int]


@dataclasses.dataclass
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    tokens: torch.Tensor   # the static [k, B] output
    launches: List[int]    # counter deltas of one replay (COUNTERS order)


class ServingEngine:
    """Slot-based continuous batching over a shared stacked KV cache.

    Usage::

        eng = ServingEngine(model, num_slots=8, max_len=256)
        rid = eng.submit([12, 7, 91], query_embeds=None)
        for fin in eng.run_to_completion(steps_per_dispatch=8):
            print(fin.rid, fin.tokens)

    ``generator``: the ``torch.Generator`` sampling draws come from (the
    JAX engine's ``rng``), on the model's device; seeded 0 when omitted.
    """

    def __init__(self, model: Union[GPT3LM, BloomLM], *,
                 num_slots: int = 8,
                 max_len: int = 256,
                 prefill_buckets: Sequence[int] = (8, 16, 32, 64),
                 config: GenerationConfig = GenerationConfig(),
                 generator: Optional[torch.Generator] = None):
        self.model = model
        self.device = model.word_embeddings.embedding.device
        self.num_slots = num_slots
        self.max_len = max_len
        self.buckets = tuple(sorted(prefill_buckets))
        self.config = config
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        self.generator = generator

        self.cache = model.init_cache(num_slots, max_len, device=self.device)
        # a model shard dispatches eagerly (see the module docstring)
        self.eager = model_parallel(model)
        self.cache_len = np.zeros((num_slots,), np.int32)
        self.valid_from = np.zeros((num_slots,), np.int32)
        self.pos_offset = np.zeros((num_slots,), np.int32)
        self.last_token = np.full((num_slots,), config.pad_id, np.int32)
        # the decode inputs (rows: cache_len, valid_from, pos_offset,
        # last_token) in a static device buffer, staged through host
        # memory (pinned on the card)
        cuda = self.device.type == "cuda"
        self._staging = torch.zeros((4, num_slots), dtype=torch.int32,
                                    pin_memory=cuda)
        self._inputs = torch.zeros((4, num_slots), dtype=torch.int32,
                                   device=self.device)
        # count of non-finite logit rows seen (kept on the device; reading
        # it synchronizes)
        self._nonfinite = torch.zeros((), dtype=torch.int64,
                                      device=self.device)
        self._graphs: Dict[int, _Graph] = {}
        self._pool = None
        self._stream = None
        self.graph_replays = 0
        self.decode_steps = 0      # decode steps run on the device
        self.graph_pool_bytes = 0  # device memory the graphs' pool took
        self.capture_s = 0.0       # host s capturing (with the warm-up)

        self._slots: List[Optional[_Slot]] = [None] * num_slots
        self._queue: collections.deque = collections.deque()
        self._rid = itertools.count()
        # per-slot token history (prompt + committed tokens) for
        # prompt-lookup speculation (step_lookup)
        self._hist: List[List[int]] = [[] for _ in range(num_slots)]

    # ------------------------------------------------------------------
    # device programs
    # ------------------------------------------------------------------

    def _pick(self, logits: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        logits = logits.float() / cfg.temperature
        self._nonfinite += (~torch.isfinite(logits)).any(-1).sum()
        if not cfg.do_sample:
            return logits.argmax(-1).to(torch.int32)
        return gumbel_argmax(top_k_top_p_filter(logits, cfg.top_k,
                                                cfg.top_p), self.generator)

    @torch.inference_mode()
    def _prefill_impl(self, slot: int, prompt_ids: torch.Tensor,
                      prompt_len: torch.Tensor, query_embeds,
                      prompt_embeds=None):
        """Run one request's prompt into its slot's cache rows (in place,
        through a view of the slot in every cache leaf).  prompt_ids
        [1, P] right-padded; prompt_len [1]; query_embeds [1, nq, H] or
        None; prompt_embeds [1, P, H] or None (pre-built prompt
        embeddings).  Returns
        (first_token, valid_from) as tensors."""
        sub = kvc.slot_view(self.cache, slot)
        embeds, valid_from, pos_offset = _build_prefix(
            self.model, prompt_ids, prompt_len, query_embeds,
            self.config.pad_id, prompt_embeds)
        logits, _ = self.model.decode_step(embeds, sub, 0, valid_from,
                                           pos_offset)
        return self._pick(logits)[0], valid_from[0]

    @torch.inference_mode()
    def _decode_impl(self, cache_len, valid_from, pos_offset, last_token):
        """One token step for every slot; returns the picked tokens [B]."""
        emb = self.model.embed(last_token[:, None].long())
        logits, _ = self.model.decode_step(emb, self.cache, cache_len,
                                           valid_from, pos_offset)
        return self._pick(logits)

    @torch.inference_mode()
    def _decode_many_impl(self, k: int) -> torch.Tensor:
        """``k`` decode steps from the static inputs, each step's tokens
        fed to the next and ``cache_len`` advanced on the device: the body
        a graph captures (run eagerly on the CPU).  Returns [k, B] int32.
        """
        cache_len, valid_from, pos_offset, last = self._inputs
        toks = []
        for _ in range(k):
            last = self._decode_impl(cache_len, valid_from, pos_offset, last)
            toks.append(last)
            cache_len = cache_len + 1
        return torch.stack(toks)

    @torch.inference_mode()
    def _verify(self, drafts: torch.Tensor) -> torch.Tensor:
        """Greedy chunk verification for prompt-lookup speculation: feed
        [last, d_0..d_{k-1}] per slot in ONE decode_step, return the
        target's greedy choice at every position [B, k+1].  Rows written
        for rejected proposals land past the host-advanced cache_len and
        are masked or overwritten — the engine's partial-write contract."""
        cache_len, valid_from, pos_offset, last = self._inputs
        chunk = torch.cat([last[:, None], drafts], dim=1)
        logits, _ = self.model.decode_step(
            self.model.embed(chunk.long()), self.cache, cache_len,
            valid_from, pos_offset, return_all=True)
        self._nonfinite += (~torch.isfinite(logits)).any(-1).sum()
        return logits.argmax(-1).to(torch.int32)

    def _stage(self) -> None:
        """Host state -> the static device inputs (one copy)."""
        self._staging.numpy()[:] = (self.cache_len, self.valid_from,
                                    self.pos_offset, self.last_token)
        self._inputs.copy_(self._staging, non_blocking=True)

    def _capture(self, k: int) -> _Graph:
        """Capture the k-step body into a CUDA graph in the engine's pool,
        recording its launch counts (no kernel runs while capturing)."""
        t0 = time.perf_counter()
        dev = self.device
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(dev)
            # one eager step first on the capture stream: it builds the
            # kernel library and allocates cuBLAS's workspace
            self._stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(self._stream):
                self._decode_many_impl(1)
            torch.cuda.current_stream(dev).wait_stream(self._stream)
            self.decode_steps += 1
        graph = torch.cuda.CUDAGraph()
        if self.config.do_sample:
            # else every replay would draw the captured numbers again
            graph.register_generator_state(self.generator)
        before = _counts()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
            reserved = torch.cuda.memory_reserved(dev)
            tokens = self._decode_many_impl(k)
            self.graph_pool_bytes += torch.cuda.memory_reserved(dev) \
                - reserved
        launches = [a - b for a, b in zip(_counts(), before)]
        for (fn, attr), n in zip(COUNTERS, before):
            setattr(fn, attr, n)
        self.capture_s += time.perf_counter() - t0
        return _Graph(graph, tokens, launches)

    def _replay(self, k: int) -> torch.Tensor:
        g = self._graphs.get(k)
        if g is None:
            g = self._graphs[k] = self._capture(k)
        g.graph.replay()
        for (fn, attr), n in zip(COUNTERS, g.launches):
            setattr(fn, attr, getattr(fn, attr) + n)
        self.graph_replays += 1
        return g.tokens

    def _launch(self, k: int) -> torch.Tensor:
        """Launch k decode steps of every slot from the host state: a replay
        of the k-step graph, or for CPU tensors and on a model shard the
        eager body.  Returns the tokens [k, B] on the device."""
        self._stage()
        toks = self._decode_many_impl(k) \
            if self.device.type == "cpu" or self.eager else self._replay(k)
        self.decode_steps += k
        return toks

    # ------------------------------------------------------------------
    # host scheduler
    # ------------------------------------------------------------------

    def submit(self, prompt_ids: Sequence[int], query_embeds=None,
               max_new_tokens: Optional[int] = None,
               prompt_embeds=None) -> int:
        """Enqueue a request. prompt_ids: true tokens (no padding);
        query_embeds: optional [nq, H] visual prefix; prompt_embeds:
        optional [len(prompt_ids), H] pre-built prompt embeddings that
        replace the token-embedding lookup (media features spliced in).
        Returns the id."""
        if prompt_embeds is not None \
                and prompt_embeds.shape[0] != len(prompt_ids):
            raise ValueError(f"prompt_embeds has {prompt_embeds.shape[0]} "
                             f"rows for {len(prompt_ids)} prompt ids")
        rid = next(self._rid)
        self._queue.append((rid, list(prompt_ids), query_embeds,
                            max_new_tokens or self.config.max_new_tokens,
                            prompt_embeds))
        return rid

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds largest bucket "
                         f"{self.buckets[-1]}")

    def _admit(self):
        for slot in range(self.num_slots):
            if self._slots[slot] is not None or not self._queue:
                continue
            rid, ids, qe, max_new, pe = self._queue.popleft()
            p = self._bucket(len(ids))
            nq = 0 if qe is None else qe.shape[0]
            padded = np.full((1, p), self.config.pad_id, np.int64)
            padded[0, :len(ids)] = ids
            qe_dev = None if qe is None else torch.as_tensor(
                qe, device=self.device)[None]
            pe_dev = None
            if pe is not None:
                # right-padded to the bucket; _build_prefix right-aligns by
                # the true length and zeroes the padding
                pe = torch.as_tensor(pe, device=self.device)
                pe_dev = pe.new_zeros(1, p, pe.shape[-1])
                pe_dev[0, :len(ids)] = pe
            first, vf = self._prefill_impl(
                slot, torch.from_numpy(padded).to(self.device),
                torch.tensor([len(ids)], device=self.device), qe_dev, pe_dev)
            first = int(first)
            # the slot's length is the bucket width, not the true length
            self.cache_len[slot] = nq + p
            self.valid_from[slot] = int(vf)
            self.pos_offset[slot] = int(vf)
            self.last_token[slot] = first
            st = _Slot(rid=rid, max_new=max_new, tokens=[first])
            st.done = (first == self.config.eos_id or max_new <= 1)
            self._slots[slot] = st
            self._hist[slot] = list(ids) + [first]

    def _begin(self) -> Tuple[List[FinishedRequest], int]:
        """Admit pending requests and harvest the slots that finished at
        prefill (eos first token).  Returns (those requests, the longest
        active slot's cache_len, or -1 when no slot is active)."""
        self._admit()
        finished = [self._finish(slot) for slot, st in enumerate(self._slots)
                    if st is not None and st.done]
        live = [int(self.cache_len[s]) for s, st in enumerate(self._slots)
                if st is not None]
        return finished, max(live, default=-1)

    def _commit(self, slot: int, tokens) -> bool:
        """Append ``tokens`` to the slot's request until one ends it (EOS,
        max_new, or the cache's last row); returns whether it ended."""
        st = self._slots[slot]
        for tok in tokens:
            tok = int(tok)
            st.tokens.append(tok)
            self._hist[slot].append(tok)
            self.cache_len[slot] += 1
            self.last_token[slot] = tok
            if (tok == self.config.eos_id or len(st.tokens) >= st.max_new
                    or int(self.cache_len[slot]) >= self.max_len - 1):
                return True
        return False

    def step(self) -> List[FinishedRequest]:
        """Admit pending requests, run ONE decode step for all slots (on
        the card one replay of the k = 1 graph), and return the requests
        that finished."""
        return self._decode_steps(1)

    def step_many(self, k: int) -> List[FinishedRequest]:
        """Like :meth:`step`, but advances all slots up to ``k`` tokens in
        ONE dispatch.  k is clamped so no slot can overrun the cache;
        tokens past a slot's EOS / max_new are trimmed on the host."""
        if k <= 1:
            return self.step()
        return self._decode_steps(k)

    def _decode_steps(self, k: int) -> List[FinishedRequest]:
        finished, longest = self._begin()
        if longest < 0:
            return finished
        k_eff = max(1, min(k, self.max_len - 1 - longest))
        toks = self._launch(k_eff).cpu().numpy()
        for slot, st in enumerate(self._slots):
            if st is not None and self._commit(slot, toks[:, slot]):
                finished.append(self._finish(slot))
        return finished

    @staticmethod
    def _lookup_propose(hist: List[int], n: int, k: int) -> List[int]:
        """Host-side prompt lookup: continuation of the most recent
        earlier occurrence of the trailing n-gram; falls back to
        repeating the tail (proposal quality only, never correctness)."""
        length = len(hist)
        if length >= n + 1:
            sfx = hist[length - n:]
            # scan candidates right-to-left, most recent match first
            for m in range(length - 2, n - 2, -1):
                if hist[m - n + 1:m + 1] == sfx:
                    out = hist[m + 1:m + 1 + k]
                    if out:
                        return (out + out[-1:] * k)[:k]
                    break
        tail = hist[-k:] if hist else [0]
        return (tail + tail[-1:] * k)[:k]

    def step_lookup(self, k: int, ngram: int = 2) -> List[FinishedRequest]:
        """Continuous batching + prompt-lookup speculation: every active
        slot proposes k tokens from its own history and ONE chunked verify
        commits the agreeing prefix plus one target token — 1..k+1 tokens
        per slot per dispatch, exactly the greedy output of ``step``.
        Greedy-only."""
        if self.config.do_sample:
            raise ValueError("step_lookup is greedy-only")
        finished, longest = self._begin()
        if longest < 0:
            return finished
        # clamp so no live slot's k+1 chunk can overrun the cache (an
        # inactive slot's rows past M are dropped: ops/kv_cache.py)
        k_eff = max(1, min(k, self.max_len - 2 - longest))
        drafts = np.zeros((self.num_slots, k_eff), np.int32)
        for slot, st in enumerate(self._slots):
            if st is not None:
                drafts[slot] = self._lookup_propose(self._hist[slot],
                                                    ngram, k_eff)
        self._stage()
        greedy = self._verify(torch.from_numpy(drafts).to(self.device))
        greedy = greedy.cpu().numpy()                     # [B, k_eff+1]
        for slot, st in enumerate(self._slots):
            if st is None:
                continue
            a = 0
            while a < k_eff and drafts[slot, a] == greedy[slot, a]:
                a += 1
            if self._commit(slot, list(drafts[slot, :a]) + [greedy[slot, a]]):
                finished.append(self._finish(slot))
        return finished

    def _finish(self, slot: int) -> FinishedRequest:
        st = self._slots[slot]
        self._slots[slot] = None
        toks = st.tokens
        if self.config.eos_id in toks:
            toks = toks[:toks.index(self.config.eos_id)]
        return FinishedRequest(rid=st.rid, tokens=toks)

    @property
    def idle(self) -> bool:
        return not self._queue and all(s is None for s in self._slots)

    @property
    def nonfinite_logits(self) -> int:
        """Logit rows with a NaN or inf so far (prefill and decode)."""
        return int(self._nonfinite)

    def run_to_completion(self, max_steps: int = 100000,
                          steps_per_dispatch: int = 1,
                          lookup_k: int = 0, ngram: int = 2
                          ) -> List[FinishedRequest]:
        """Drain the engine.  lookup_k > 0 uses prompt-lookup speculative
        steps (``step_lookup``); otherwise (multi-)step decode."""
        out: List[FinishedRequest] = []
        for _ in range(max_steps):
            if self.idle:
                break
            if lookup_k > 0:
                out.extend(self.step_lookup(lookup_k, ngram))
            else:
                out.extend(self.step_many(steps_per_dispatch))
        return out
