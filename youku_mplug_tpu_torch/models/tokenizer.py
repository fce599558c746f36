"""Token ids without a trained vocabulary.

The JAX package's ``ToyTokenizer`` (youku_mplug_tpu/models/tokenizer.py),
which synthetic-data runs use: a deterministic character hash with the
same special ids, ``tokenize_prompt`` (the (prompt, text) segments) and
``detokenize`` (the ids as space-joined numbers); and ``BatchTokenizer``:
strings or (prompt, text) pairs to numpy int32 ids padded to
``max_length`` or to the longest (``padding="longest"``), with the
attention mask and, for pairs, each sample's prompt length; ``decode``
turns ids back into text.  The trained JiebaBPE tokenizer is not ported
yet: ``build_tokenizer`` raises where a run names its files.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np


class ToyTokenizer:
    def __init__(self, vocab_size: int = 25600):
        self.vocab_size = vocab_size
        self.bos_id = 1
        self.eos_id = 2
        self.pad_id = 2

    def _ids(self, text: str) -> List[int]:
        return [3 + (ord(c) * 2654435761) % (self.vocab_size - 3)
                for c in text]

    def tokenize(self, text: str) -> List[int]:
        """[bos] + one id per character + [eos]."""
        return [self.bos_id] + self._ids(text) + [self.eos_id]

    def tokenize_prompt(self, prompt_text: str, text: str):
        """The (bos, prompt, text, eos) id segments of a pair."""
        return ([self.bos_id], self._ids(prompt_text), self._ids(text),
                [self.eos_id])

    def detokenize(self, token_ids) -> str:
        """The ids but bos and eos, as space-joined numbers (the hash has
        no inverse)."""
        return " ".join(str(int(t)) for t in token_ids
                        if int(t) not in (self.bos_id, self.eos_id))


def load_tokenizer(model_dir: str, vocab_size: int) -> ToyTokenizer:
    """The run's tokenizer: a model directory with a ``tokenizer.json``
    asks for the JiebaBPE one, which is not ported (toy ids in its place
    would be wrong text); otherwise the toy tokenizer over ``vocab_size``
    ids."""
    if model_dir and os.path.exists(os.path.join(model_dir,
                                                 "tokenizer.json")):
        raise NotImplementedError(
            f"{model_dir} holds a JiebaBPE tokenizer (tokenizer.json), "
            "which is not ported yet")
    return ToyTokenizer(vocab_size=vocab_size)


class BatchTokenizer:
    """Batch pad / truncate with prompt-length tracking; numpy int32
    arrays out."""

    def __init__(self, tokenizer, max_length: int = 128):
        self.tokenizer = tokenizer
        self.max_length = max_length

    def decode(self, tokens) -> str:
        return self.tokenizer.detokenize(
            np.asarray(tokens).reshape(-1).tolist())

    def _pad(self, ids: Sequence[int], max_length: int):
        ids = list(ids)[:max_length]
        n = len(ids)
        return ids + [self.tokenizer.pad_id] * (max_length - n), n

    def _truncate_prompt(self, segs, max_length: int):
        """Shorten the prompt first and the text only as a last resort.
        Returns (ids, prompt length, length)."""
        bos, prompt, text, eos = [list(s) for s in segs]
        total = len(bos) + len(prompt) + len(text) + len(eos)
        if total <= max_length:
            return bos + prompt + text + eos, len(prompt), total
        room = max_length - len(text) - 2
        if room >= 0 and len(prompt) >= room:
            prompt = prompt[:room]
        else:
            text = text[:max_length - 2 - len(prompt)]
        ids = bos + prompt + text + eos
        return ids, len(prompt), len(ids)

    def _rows(self, seqs, max_length: int):
        ids = np.full((len(seqs), max_length), self.tokenizer.pad_id,
                      np.int32)
        mask = np.zeros((len(seqs), max_length), np.int32)
        for i, seq in enumerate(seqs):
            row, n = self._pad(seq, max_length)
            ids[i] = row
            mask[i, :n] = 1
        return {"input_ids": ids, "attention_mask": mask}

    def __call__(self, data, padding: str = "max_length",
                 max_length: Optional[int] = None
                 ) -> Dict[str, np.ndarray]:
        """Strings -> ``input_ids`` and ``attention_mask`` [B, L]; (prompt,
        text) pairs -> the same plus ``prompt_lengths`` [B].  L is
        ``max_length`` (default the tokenizer's), or with
        ``padding="longest"`` the longest string's length up to it."""
        max_length = max_length or self.max_length
        if isinstance(data, str):
            data = [data]
        if isinstance(data[0], str):
            toks = [self.tokenizer.tokenize(t) for t in data]
            if padding == "longest":
                max_length = min(max(len(t) for t in toks), max_length)
            return self._rows(toks, max_length)
        seqs, plens = [], []
        for prompt_text, text in data:
            ids, plen, _ = self._truncate_prompt(
                self.tokenizer.tokenize_prompt(prompt_text, text),
                max_length)
            seqs.append(ids)
            plens.append(plen)
        return {**self._rows(seqs, max_length),
                "prompt_lengths": np.asarray(plens, np.int32)}
