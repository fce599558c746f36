"""Token ids without a trained vocabulary.

The JAX package's ``ToyTokenizer`` (youku_mplug_tpu/models/tokenizer.py),
which synthetic-data runs use: a deterministic character hash with the
same special ids; and ``BatchTokenizer``'s string path padded to
``max_length`` (pad or truncate, with the attention mask).  The trained
JiebaBPE tokenizer, the (prompt, text) pair path, ``padding="longest"``
and text decoding are not ported yet.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np


class ToyTokenizer:
    def __init__(self, vocab_size: int = 25600):
        self.vocab_size = vocab_size
        self.bos_id = 1
        self.eos_id = 2
        self.pad_id = 2

    def tokenize(self, text: str) -> List[int]:
        """[bos] + one id per character + [eos]."""
        ids = [3 + (ord(c) * 2654435761) % (self.vocab_size - 3)
               for c in text]
        return [self.bos_id] + ids + [self.eos_id]


def load_tokenizer(model_dir: str, vocab_size: int) -> ToyTokenizer:
    """The run's tokenizer: a model directory with a ``tokenizer.json``
    asks for the JiebaBPE one, which is not ported; otherwise the toy
    tokenizer over ``vocab_size`` ids."""
    if model_dir and os.path.exists(os.path.join(model_dir,
                                                 "tokenizer.json")):
        raise NotImplementedError("the JiebaBPE tokenizer is not ported yet")
    return ToyTokenizer(vocab_size=vocab_size)


class BatchTokenizer:
    """Strings -> numpy int32 ``input_ids`` and ``attention_mask``
    [B, max_length], padded with the pad id or truncated."""

    def __init__(self, tokenizer, max_length: int = 128):
        self.tokenizer = tokenizer
        self.max_length = max_length

    def __call__(self, texts: Sequence[str]) -> Dict[str, np.ndarray]:
        ids = np.full((len(texts), self.max_length), self.tokenizer.pad_id,
                      np.int32)
        mask = np.zeros((len(texts), self.max_length), np.int32)
        for i, text in enumerate(texts):
            t = self.tokenizer.tokenize(text)[:self.max_length]
            ids[i, :len(t)] = t
            mask[i, :len(t)] = 1
        return {"input_ids": ids, "attention_mask": mask}
