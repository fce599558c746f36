"""Token ids without a trained vocabulary.

The JAX package's ``ToyTokenizer`` (youku_mplug_tpu/models/tokenizer.py),
which synthetic-data runs use: a deterministic character hash with the
same special ids.  The trained JiebaBPE tokenizer and text decoding are
not ported yet.
"""

from __future__ import annotations

from typing import List


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
