"""Tokenizers of the GPT-3 decoder, and batch padding.

Counterpart of ``youku_mplug_tpu/models/tokenizer.py``:
``JiebaBPETokenizer``, the trained one (jieba word cuts fed to a HF
``tokenizers`` BPE read from a model directory's ``tokenizer.json``;
``<sep>`` is bos, ``<|endoftext|>`` eos and pad); ``ToyTokenizer``, which
synthetic-data runs use (a deterministic character hash with the same
special ids; ``detokenize`` gives the ids as space-joined numbers); and
``BatchTokenizer``: strings or (prompt, text) pairs to numpy int32 ids
padded to ``max_length`` or to the longest (``padding="longest"``), with
the attention mask and, for pairs, each sample's prompt length;
``decode`` turns ids back into text.  The BERT family's (mPLUG and
ALPRO): ``BertWordPieceTokenizer`` (a ``vocab.txt`` through HF
``tokenizers``) and ``ToyBertTokenizer`` (the toy hash with BERT's special
ids: ``[PAD]`` 0, ``[CLS]`` 101 bos, ``[SEP]`` 102 eos, ``[MASK]`` 103,
ids from 104).  ``load_tokenizer`` takes the
JiebaBPE one wherever the model directory holds a ``tokenizer.json``:
jieba and ``tokenizers`` are imported in its constructor, so where they
are missing the run fails with the ImportError, never with toy ids in
their place.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Union

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


class JiebaBPETokenizer:
    """jieba's word cuts, each a pre-token of the BPE in
    ``tokenizer_json_file``."""

    def __init__(self, tokenizer_json_file: str):
        from tokenizers import Tokenizer

        self.tokenizer = Tokenizer.from_file(tokenizer_json_file)
        import logging

        import jieba

        jieba.setLogLevel(logging.INFO)
        self.jieba = jieba
        vocab = self.tokenizer.get_vocab(with_added_tokens=True)
        self.eod_id = vocab["<|endoftext|>"]
        self.bos_id = vocab["<sep>"]
        self.pad_id = self.eod_id
        self.eos_id = self.eod_id

    @property
    def vocab_size(self) -> int:
        return self.tokenizer.get_vocab_size(with_added_tokens=True)

    def _bpe(self, text: str) -> List[int]:
        seg = list(self.jieba.cut(text))
        return self.tokenizer.encode(
            seg, is_pretokenized=True, add_special_tokens=True).ids

    def tokenize(self, text: str, add_special_tokens: bool = True
                 ) -> List[int]:
        ids = self._bpe(text)
        if add_special_tokens:
            ids = [self.bos_id] + ids + [self.eos_id]
        return ids

    def tokenize_prompt(self, prompt_text: str, text: str):
        """The (bos, prompt, text, eos) id segments of a pair."""
        return ([self.bos_id], self._bpe(prompt_text), self._bpe(text),
                [self.eos_id])

    def detokenize(self, token_ids) -> str:
        return self.tokenizer.decode([int(t) for t in token_ids],
                                     skip_special_tokens=True)


class BertWordPieceTokenizer:
    """BERT WordPiece tokenization of ``vocab_file`` (HF ``tokenizers``):
    ``[CLS]`` starts, ``[SEP]`` ends, ``[PAD]`` pads."""

    def __init__(self, vocab_file: str, lowercase: bool = True):
        from tokenizers import BertWordPieceTokenizer as _HF

        self.tokenizer = _HF(vocab_file, lowercase=lowercase)
        vocab = self.tokenizer.get_vocab()
        self.pad_id = vocab.get("[PAD]", 0)
        self.bos_id = vocab.get("[CLS]", 101)
        self.eos_id = vocab.get("[SEP]", 102)
        self.mask_id = vocab.get("[MASK]", 103)
        self.eod_id = self.eos_id

    @property
    def vocab_size(self) -> int:
        return self.tokenizer.get_vocab_size()

    def tokenize(self, text: str, add_special_tokens: bool = True
                 ) -> List[int]:
        return self.tokenizer.encode(
            text, add_special_tokens=add_special_tokens).ids

    def tokenize_prompt(self, prompt_text: str, text: str):
        """The (bos, prompt, text, eos) id segments of a pair."""
        p = self.tokenizer.encode(prompt_text, add_special_tokens=False).ids
        t = self.tokenizer.encode(text, add_special_tokens=False).ids
        return ([self.bos_id], p, t, [self.eos_id])

    def detokenize(self, token_ids) -> str:
        return self.tokenizer.decode([int(t) for t in token_ids],
                                     skip_special_tokens=True)


class ToyBertTokenizer(ToyTokenizer):
    """The toy hash over ids 104 .. V - 1 with BERT's special ids, for
    synthetic mPLUG / ALPRO runs."""

    def __init__(self, vocab_size: int = 30522):
        super().__init__(vocab_size)
        self.pad_id = 0
        self.bos_id = 101
        self.eos_id = 102
        self.mask_id = 103
        self.eod_id = 102

    def _ids(self, text: str) -> List[int]:
        return [104 + (ord(c) * 2654435761) % (self.vocab_size - 104)
                for c in text]


def load_tokenizer(model_dir: str, vocab_size: int
                   ) -> Union[JiebaBPETokenizer, ToyTokenizer]:
    """The run's tokenizer: JiebaBPE where ``model_dir`` holds a
    ``tokenizer.json``, else the toy tokenizer over ``vocab_size`` ids."""
    tok_json = os.path.join(model_dir or "", "tokenizer.json")
    if model_dir and os.path.exists(tok_json):
        return JiebaBPETokenizer(tok_json)
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
