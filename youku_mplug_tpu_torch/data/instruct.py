"""Instruction prompts for the mPLUG-Owl video path.

The prompt helpers of ``youku_mplug_tpu/data/instruct.py``, copied
because that module's package imports the JAX loader: the Human/AI
conversation template with one ``<|video|>`` placeholder, its expansion
into ``num_media_tokens`` media positions, the right-padded batch, and
the whitespace hash tokenizer of synthetic runs (the ids depend on
Python's string hash, so they are the JAX package's within one process).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

VIDEO_PLACEHOLDER = "<|video|>"

CONVERSATION_TEMPLATE = (
    "The following is a conversation between a curious human and AI "
    "assistant. The assistant gives helpful, detailed, and polite "
    "answers to the user's questions.\n"
    "Human: <|video|>\n"
    "Human: {question}\n"
    "AI: ")


def format_prompt(question: str) -> str:
    """Wrap a bare question in the Human/AI template."""
    return CONVERSATION_TEMPLATE.format(question=question)


def expand_video_prompt(prompt: str, tokenizer, num_queries: int,
                        media_id: int = 0) -> Tuple[List[int], List[int]]:
    """Tokenize ``prompt``, each ``<|video|>`` expanded into
    ``num_queries`` media positions (id ``media_id``); the text segments
    around it are tokenized on their own.  Returns (ids, media_mask)."""
    ids: List[int] = []
    media: List[int] = []
    for i, seg in enumerate(prompt.split(VIDEO_PLACEHOLDER)):
        if i > 0:
            ids.extend([media_id] * num_queries)
            media.extend([1] * num_queries)
        if seg:
            toks = tokenizer.encode(seg, add_special_tokens=False)
            ids.extend(toks)
            media.extend([0] * len(toks))
    return ids, media


def build_instruct_batch(prompts: Sequence[str], tokenizer,
                         num_queries: int, pad_id: int,
                         max_length: int = 0):
    """Expanded prompts right-padded to a common length.  Returns
    dict(input_ids [B, P] int32, media_mask [B, P] int32, prompt_len [B]
    int32).  Every prompt must hold exactly one ``<|video|>``."""
    rows = [expand_video_prompt(p, tokenizer, num_queries)
            for p in prompts]
    for p, (ids, media) in zip(prompts, rows):
        if sum(media) != num_queries:
            raise ValueError(
                f"prompt must contain exactly one {VIDEO_PLACEHOLDER}: "
                f"{p[:80]!r}")
    p_max = max(len(ids) for ids, _ in rows)
    if max_length:
        p_max = max(p_max, max_length)
    b = len(rows)
    input_ids = np.full((b, p_max), pad_id, np.int32)
    media_mask = np.zeros((b, p_max), np.int32)
    prompt_len = np.zeros((b,), np.int32)
    for i, (ids, media) in enumerate(rows):
        input_ids[i, :len(ids)] = ids
        media_mask[i, :len(media)] = media
        prompt_len[i] = len(ids)
    return {"input_ids": input_ids, "media_mask": media_mask,
            "prompt_len": prompt_len}


class WhitespaceTokenizer:
    """Whitespace tokens hashed into a fixed vocabulary, for tests and
    synthetic runs (not for real checkpoints)."""

    def __init__(self, vocab_size: int, eos_id: int = 2, pad_id: int = 3,
                 reserved: int = 8):
        self.vocab_size = vocab_size
        self.eos_id = eos_id
        self.pad_id = pad_id
        self._reserved = reserved

    def encode(self, text: str, add_special_tokens: bool = False):
        span = self.vocab_size - self._reserved
        return [self._reserved + (hash(w) % span) for w in text.split()]

    def decode(self, ids, skip_special_tokens: bool = True):
        return " ".join(f"<{int(i)}>" for i in ids
                        if int(i) >= self._reserved)
