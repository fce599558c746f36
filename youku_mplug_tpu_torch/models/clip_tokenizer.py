"""CLIP's byte-level BPE text tokenizer, on the standard library alone.

Counterpart of ``youku_mplug_tpu/models/clip_tokenizer.py`` (the
published ``simple_tokenizer`` contract): the text is cleaned (HTML
entities unescaped twice, whitespace collapsed, lower case), split into
pieces (the specials, the contractions ``'s 't 're 've 'm 'll 'd``, runs
of letters, single digits, runs of anything else but whitespace), each
piece's utf-8 bytes mapped to printable characters and merged lowest
rank first with ``</w>`` marking a word's end, over the 49,408-entry
vocab [256 bytes; 256 bytes + ``</w>``; 48,894 merges;
``<|startoftext|>``; ``<|endoftext|>``].  ``tokenize`` makes the
77-token rows a CLIP text tower reads.

No ``regex`` and no ``ftfy`` (the card's machine may lack both): the
split that JAX writes with ``regex``'s ``\\p{L}`` / ``\\p{N}`` classes is
a scan over ``unicodedata`` categories (L* letters, N* numbers; after
the cleaning only the plain space is whitespace), and the cleaning is
JAX's without ``ftfy.fix_text``, as JAX runs where ftfy is absent: for
text that is not mis-encoded the ids are the same.

The merge table is data shipped with every public CLIP release and is
not in the repository: it loads from ``bpe_path``, ``$CLIP_BPE_PATH`` or
``bpe_simple_vocab_16e6.txt.gz`` in the working directory, as the
published ``.gz`` or an HF checkpoint's ``merges.txt`` (the file or its
directory).
"""

from __future__ import annotations

import gzip
import html
import os
import unicodedata
from functools import lru_cache
from typing import Iterable, List, Sequence, Union

import numpy as np

SOT = "<|startoftext|>"
EOT = "<|endoftext|>"
CONTEXT_LENGTH = 77
# 49,408 ids minus the 512 byte forms and the 2 specials
_NUM_MERGES = 49408 - 512 - 2
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def find_bpe_vocab(bpe_path: str = "") -> str:
    """The merge table's path: ``bpe_path``, else ``$CLIP_BPE_PATH``,
    else ``bpe_simple_vocab_16e6.txt.gz`` in the working directory."""
    candidates = ([bpe_path] if bpe_path else []) + \
        ([os.environ["CLIP_BPE_PATH"]] if "CLIP_BPE_PATH" in os.environ
         else []) + ["bpe_simple_vocab_16e6.txt.gz"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise FileNotFoundError(
        "CLIP BPE vocab (bpe_simple_vocab_16e6.txt.gz) not found; pass "
        "bpe_path= or set CLIP_BPE_PATH (the file ships with every "
        "public CLIP release)")


@lru_cache()
def byte_unicode_table() -> dict:
    """utf-8 byte -> printable character (the GPT-2 / CLIP remapping):
    the printable ranges map to themselves, the other bytes to 0x100 and
    up; the insertion order is the vocab's id order."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("¡"), ord("¬") + 1))
            + list(range(ord("®"), ord("ÿ") + 1)))
    table = {b: chr(b) for b in keep}
    bump = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + bump)
            bump += 1
    return table


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return " ".join(text.split()).strip().lower()


def _kind(c: str) -> str:
    """'L' letter, 'N' number, 'S' whitespace, 'P' anything else."""
    if c.isspace():
        return "S"
    cat = unicodedata.category(c)[0]
    return cat if cat in "LN" else "P"


def split_pieces(text: str) -> List[str]:
    """JAX's ``regex`` split of cleaned text, as a left-to-right scan:
    at each position the first alternative that matches (a special, a
    contraction, a run of letters, one number, a run of other non-space
    characters); whitespace separates pieces and is dropped."""
    out, i, n = [], 0, len(text)
    while i < n:
        for special in (SOT, EOT):
            if text.startswith(special, i):
                out.append(special)
                i += len(special)
                break
        else:
            for c in _CONTRACTIONS:
                if text.startswith(c, i):
                    out.append(c)
                    i += len(c)
                    break
            else:
                kind = _kind(text[i])
                if kind == "S":
                    i += 1
                    continue
                j = i + 1
                if kind != "N":  # a run of letters, or of the rest
                    while j < n and _kind(text[j]) == kind:
                        j += 1
                out.append(text[i:j])
                i = j
    return out


def _adjacent_pairs(word: Sequence[str]):
    return set(zip(word[:-1], word[1:]))


class CLIPTokenizer:
    """Byte-level BPE with the CLIP vocab layout and merge order."""

    def __init__(self, bpe_path: str = ""):
        path = find_bpe_vocab(bpe_path)
        if os.path.isdir(path):  # an HF checkpoint's directory
            path = os.path.join(path, "merges.txt")
        if path.endswith(".gz"):
            with gzip.open(path) as f:
                text = f.read().decode("utf-8")
        else:
            with open(path, encoding="utf-8") as f:
                text = f.read()
        rows = text.split("\n")
        # both formats start with a "#version" row; a table without one
        # gets a pad row so that the slice below is the same
        if "#version" not in rows[0]:
            rows = [""] + rows
        # every row in range takes a vocab slot, however it splits
        merges = [tuple(r.split()) for r in rows[1:_NUM_MERGES + 1]]
        if len(merges) != _NUM_MERGES:
            raise ValueError(
                f"{path}: expected {_NUM_MERGES} merge rows, got "
                f"{len(merges)} — not a CLIP merge table")
        self.rank = {m: i for i, m in enumerate(merges)}
        self.byte_enc = byte_unicode_table()
        self.byte_dec = {c: b for b, c in self.byte_enc.items()}
        base = list(self.byte_enc.values())
        vocab = (base + [c + "</w>" for c in base]
                 + ["".join(m) for m in merges] + [SOT, EOT])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.sot_id = self.encoder[SOT]
        self.eot_id = self.encoder[EOT]
        self._cache = {SOT: SOT, EOT: EOT}

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def _merge_word(self, token: str) -> str:
        """Merges lowest rank first until none applies; the last symbol
        carries ``</w>``."""
        if token in self._cache:
            return self._cache[token]
        word: tuple = tuple(token[:-1]) + (token[-1] + "</w>",)
        if len(word) == 1:
            return word[0]
        pairs = _adjacent_pairs(word)
        while pairs:
            best = min(pairs, key=lambda p: self.rank.get(p, 1 << 60))
            if best not in self.rank:
                break
            a, b = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if (word[i] == a and i + 1 < len(word)
                        and word[i + 1] == b):
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
            if len(word) == 1:
                break
            pairs = _adjacent_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for piece in split_pieces(_clean(text)):
            mapped = "".join(self.byte_enc[b]
                             for b in piece.encode("utf-8"))
            ids.extend(self.encoder[t]
                       for t in self._merge_word(mapped).split(" "))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytearray(self.byte_dec[c] for c in text
                        if c in self.byte_dec)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


@lru_cache()
def _default_tokenizer(bpe_path: str = "") -> CLIPTokenizer:
    return CLIPTokenizer(bpe_path)


def tokenize(texts: Union[str, Sequence[str]],
             context_length: int = CONTEXT_LENGTH,
             truncate: bool = False, bpe_path: str = "") -> np.ndarray:
    """[B, context_length] int32 rows ``<sot> tokens <eot> 0 ...``; a row
    too long raises, or with ``truncate`` keeps its first
    ``context_length - 1`` ids and the ``<eot>``."""
    if isinstance(texts, str):
        texts = [texts]
    tk = _default_tokenizer(bpe_path)
    out = np.zeros((len(texts), context_length), np.int32)
    for i, text in enumerate(texts):
        row = [tk.sot_id] + tk.encode(text) + [tk.eot_id]
        if len(row) > context_length:
            if not truncate:
                raise RuntimeError(
                    f"Input {texts[i]} is too long for context length "
                    f"{context_length}")
            row = row[:context_length - 1] + [tk.eot_id]
        out[i, :len(row)] = row
    return out
