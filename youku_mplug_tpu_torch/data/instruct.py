"""Instruction prompts and data for the mPLUG-Owl video path.

Counterpart of ``youku_mplug_tpu/data/instruct.py``: the Human/AI
conversation template with one ``<|video|>`` placeholder, its expansion
into ``num_media_tokens`` media positions, the right-padded serving
batch, the (question, answer) training batch with its prompt mask,
``InstructJsonlDataset`` (jsonl rows of a video, a question and an
answer, each clip decoded from its file), and the whitespace hash
tokenizer of synthetic runs (the ids depend on Python's string hash, so
they are the JAX package's within one process).
"""

from __future__ import annotations

import json
import os
from typing import List, Sequence, Tuple

import numpy as np

from youku_mplug_tpu_torch.data.video_decode import read_frames

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


def build_instruct_train_batch(examples: Sequence[Tuple[str, str]],
                               tokenizer, num_queries: int, pad_id: int,
                               eos_id: int, max_length: int = 0):
    """(question-or-prompt, answer) pairs -> rows ``[prompt (media
    expanded) ; answer ; eos]`` right-padded.  Returns dict(input_ids,
    attention_mask, media_mask, prompt_mask), all [B, S] int32;
    ``prompt_mask`` covers the instruction span (media included), so only
    the answer and its eos are supervised.  ``max_length > 0`` truncates
    answers (never the prompt) to fit, and raises when the prompt alone
    leaves no room for one."""
    rows = []
    for q, a in examples:
        prompt = q if VIDEO_PLACEHOLDER in q else format_prompt(q)
        p_ids, p_media = expand_video_prompt(prompt, tokenizer, num_queries)
        if sum(p_media) != num_queries:
            raise ValueError(
                f"prompt must contain exactly one {VIDEO_PLACEHOLDER}: "
                f"{prompt[:80]!r}")
        a_ids = list(tokenizer.encode(a, add_special_tokens=False))
        a_ids.append(eos_id)
        if max_length and len(p_ids) + len(a_ids) > max_length:
            keep = max_length - len(p_ids)
            if keep < 1:
                raise ValueError(
                    f"prompt is {len(p_ids)} tokens, leaving no room for "
                    f"an answer under max_length={max_length}: {q[:80]!r}")
            a_ids = a_ids[:keep - 1] + [eos_id]
        rows.append((p_ids, p_media, a_ids))

    s_max = max(len(p) + len(a) for p, _, a in rows)
    b = len(rows)
    input_ids = np.full((b, s_max), pad_id, np.int32)
    attention = np.zeros((b, s_max), np.int32)
    media_mask = np.zeros((b, s_max), np.int32)
    prompt_mask = np.zeros((b, s_max), np.int32)
    for i, (p_ids, p_media, a_ids) in enumerate(rows):
        n_p, n = len(p_ids), len(p_ids) + len(a_ids)
        input_ids[i, :n_p] = p_ids
        input_ids[i, n_p:n] = a_ids
        attention[i, :n] = 1
        media_mask[i, :n_p] = p_media
        prompt_mask[i, :n_p] = 1
    return {"input_ids": input_ids, "attention_mask": attention,
            "media_mask": media_mask, "prompt_mask": prompt_mask}


class InstructJsonlDataset:
    """jsonl rows ``{"video": path, "question": text, "answer": text}``
    (``"prompt"`` may stand for ``"question"``: a conversation already in
    the template), ``video`` under ``video_root`` when that is set.  Each
    sample decodes ``num_frames`` frames (``rand`` in training, else
    ``middle``) from a generator seeded by (seed, epoch, index) in
    training and (seed, index) otherwise, then the transform."""

    def __init__(self, jsonl_path: str, video_root: str = "",
                 transform=None, num_frames: int = 8, train: bool = True,
                 seed: int = 0, decode_short_side: int = 0):
        with open(jsonl_path) as f:
            self.rows = [json.loads(ln) for ln in f if ln.strip()]
        self.video_root = video_root
        self.transform = transform
        self.num_frames = num_frames
        self.train = train
        self.seed = seed
        self.decode_short_side = decode_short_side
        self._epoch = 0

    def set_epoch(self, epoch):
        self._epoch = epoch

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, index):
        r = self.rows[index]
        rng = np.random.default_rng(
            (self.seed, self._epoch, index) if self.train
            else (self.seed, index))
        path = r["video"]
        if self.video_root:
            path = os.path.join(self.video_root, path)
        frames = read_frames(path, num_frames=self.num_frames,
                             sample="rand" if self.train else "middle",
                             rng=rng, short_side=self.decode_short_side)
        if self.transform is not None:
            frames = self.transform(frames, rng=rng)
        return {"video": frames,
                "question": r.get("prompt") or r.get("question", ""),
                "answer": r.get("answer", ""), "index": index}


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
