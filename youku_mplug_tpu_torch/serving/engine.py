"""Continuous-batching serving engine for the GPT-3 and Bloom decoders.

Counterpart of ``youku_mplug_tpu/serving/engine.py`` (single-step
scheduling, greedy decoding): a fixed pool of slots shares one stacked KV
cache [L, num_slots, M, 2*hidden] (bf16, or the int8 dict of
``ops/kv_cache.py`` when the model's config says ``kv_cache_dtype:
int8``); every slot sits at its own sequence length.  Prefill runs one
request's front-padded [queries | prompt] chunk (or its pre-built prompt
embeddings, the Owl instruct path) into its slot, writing the slot's rows
of the cache in place; decode advances ALL slots one token in one step
(inactive slots compute too and are ignored on the host — their repeated write lands at a masked
position and is overwritten when the slot is reused).  Requests are
admitted whenever a slot is free.  Prompt widths are padded to a small
set of buckets.  Multi-step dispatch, prompt-lookup speculation and
sampling are not ported yet.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from youku_mplug_tpu_torch.models.generation import (
    GenerationConfig,
    _build_prefix,
)
from youku_mplug_tpu_torch.models.bloom import BloomLM
from youku_mplug_tpu_torch.models.gpt3 import GPT3LM
from youku_mplug_tpu_torch.ops import kv_cache as kvc


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


class ServingEngine:
    """Slot-based continuous batching over a shared stacked KV cache.

    Usage::

        eng = ServingEngine(model, num_slots=8, max_len=256)
        rid = eng.submit([12, 7, 91], query_embeds=None)
        for fin in eng.run_to_completion():
            print(fin.rid, fin.tokens)
    """

    def __init__(self, model: Union[GPT3LM, BloomLM], *,
                 num_slots: int = 8,
                 max_len: int = 256,
                 prefill_buckets: Sequence[int] = (8, 16, 32, 64),
                 config: GenerationConfig = GenerationConfig()):
        if config.do_sample:
            raise NotImplementedError(
                "sampling is not ported yet; greedy only")
        self.model = model
        self.device = model.word_embeddings.embedding.device
        self.num_slots = num_slots
        self.max_len = max_len
        self.buckets = tuple(sorted(prefill_buckets))
        self.config = config

        self.cache = model.init_cache(num_slots, max_len, device=self.device)
        self.cache_len = np.zeros((num_slots,), np.int32)
        self.valid_from = np.zeros((num_slots,), np.int32)
        self.pos_offset = np.zeros((num_slots,), np.int32)
        self.last_token = np.full((num_slots,), config.pad_id, np.int32)
        # count of non-finite logit rows seen (kept on the device; reading
        # it synchronizes)
        self._nonfinite = torch.zeros((), dtype=torch.int64,
                                      device=self.device)

        self._slots: List[Optional[_Slot]] = [None] * num_slots
        self._queue: collections.deque = collections.deque()
        self._rid = itertools.count()

    # ------------------------------------------------------------------
    # device programs
    # ------------------------------------------------------------------

    def _pick(self, logits: torch.Tensor) -> torch.Tensor:
        logits = logits.float() / self.config.temperature
        self._nonfinite += (~torch.isfinite(logits)).any(-1).sum()
        return logits.argmax(-1).to(torch.int32)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

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
        """One token step for every slot; returns the greedy tokens [B]."""
        emb = self.model.embed(last_token[:, None].long())
        logits, _ = self.model.decode_step(emb, self.cache, cache_len,
                                           valid_from, pos_offset)
        return self._pick(logits)

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
                slot, self._dev(padded),
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

    def step(self) -> List[FinishedRequest]:
        """Admit pending requests, run ONE decode step for all slots, and
        return the requests that finished."""
        self._admit()
        finished: List[FinishedRequest] = []
        # harvest slots that finished at prefill time (eos first token)
        for slot, st in enumerate(self._slots):
            if st is not None and st.done:
                finished.append(self._finish(slot))
        if all(s is None for s in self._slots):
            return finished

        nxt = self._decode_impl(
            self._dev(self.cache_len), self._dev(self.valid_from),
            self._dev(self.pos_offset), self._dev(self.last_token))
        nxt = nxt.cpu().numpy()
        for slot, st in enumerate(self._slots):
            if st is None:
                continue
            tok = int(nxt[slot])
            st.tokens.append(tok)
            self.cache_len[slot] += 1
            self.last_token[slot] = tok
            if (tok == self.config.eos_id
                    or len(st.tokens) >= st.max_new
                    or int(self.cache_len[slot]) >= self.max_len - 1):
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

    def run_to_completion(self, max_steps: int = 100000
                          ) -> List[FinishedRequest]:
        """Drain the engine, one decode step at a time."""
        out: List[FinishedRequest] = []
        for _ in range(max_steps):
            if self.idle:
                break
            out.extend(self.step())
        return out
