"""HF tokenizer files (``tokenizer.json``) read through ``tokenizers``
alone: BloomZ's ``BloomTokenizerFast`` as ``transformers.AutoTokenizer.
from_pretrained`` builds it, without ``transformers``.

What ``from_pretrained`` does to the file's tokenizer, and this module
does too:

- the special tokens: BloomTokenizerFast's defaults (``<unk>``, ``<s>``,
  ``</s>``, ``<pad>``), overridden by ``tokenizer_config.json``; where
  that file has no ``added_tokens_decoder`` (the older layout), then by
  ``special_tokens_map.json`` (a name or an AddedToken dict each; its
  ``additional_special_tokens`` join the config's);
- the added tokens: every entry of ``added_tokens_decoder`` that the
  file lacks, in id order, then every special token above that is not
  yet an added token (it becomes one, keeping its vocabulary id where it
  has one), so both are split out of the text before the model's
  pre-tokenizer and the special ones are dropped by ``decode(...,
  skip_special_tokens=True)``;
- ``add_prefix_space`` (default off): a top-level pre-tokenizer flag that
  differs is set to it, and when it is on every flag of the
  pre-tokenizer and the decoder is turned on (BloomTokenizerFast's
  rewrite); truncation and padding are off;
- ``clean_up_tokenization_spaces`` (Bloom's default: off) joins " ." and
  the like after decoding.

``encode(text, add_special_tokens=False)`` and ``decode(ids,
skip_special_tokens=True)`` are the two calls the instruct runner makes
(prompt segments in, answers out).  An id outside the vocabulary decodes
to nothing, as in ``tokenizers`` and ``transformers`` alike: a seeded
model's ids over BloomZ's 250880 rows mostly fall outside a small test
vocabulary.
"""

from __future__ import annotations

import json
import os
from typing import List, Sequence, Union

TOKENIZER_FILE = "tokenizer.json"
CONFIG_FILE = "tokenizer_config.json"
SPECIAL_TOKENS_FILE = "special_tokens_map.json"
# BloomTokenizerFast's constructor defaults
BLOOM_SPECIAL_TOKENS = {"unk_token": "<unk>", "bos_token": "<s>",
                        "eos_token": "</s>", "pad_token": "<pad>"}
# transformers' SPECIAL_TOKENS_ATTRIBUTES, in its order
SPECIAL_TOKEN_KEYS = ("bos_token", "eos_token", "unk_token", "sep_token",
                      "pad_token", "cls_token", "mask_token")
ADDED_TOKEN_FIELDS = ("content", "single_word", "lstrip", "rstrip",
                      "normalized", "special")


def _read_json(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _added_token(value: Union[str, dict], special: bool):
    from tokenizers import AddedToken

    if isinstance(value, str):
        return AddedToken(value, special=special)
    kw = {k: value[k] for k in ADDED_TOKEN_FIELDS[1:] if k in value}
    kw["special"] = special or bool(kw.get("special", False))
    return AddedToken(value["content"], **kw)


def _content(value: Union[str, dict]) -> str:
    return value if isinstance(value, str) else value["content"]


def _set_prefix_space(tree, on: bool):
    """Every ``add_prefix_space`` flag in a pre-tokenizer or decoder JSON
    tree set to ``on``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "add_prefix_space":
                tree[k] = on
            else:
                _set_prefix_space(v, on)
    elif isinstance(tree, list):
        for v in tree:
            _set_prefix_space(v, on)


def clean_up_tokenization(text: str) -> str:
    """transformers' ``clean_up_tokenization``: the spaces English
    tokenizers leave before punctuation and contractions removed."""
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
                 (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"),
                 (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
        text = text.replace(a, b)
    return text


class HFTokenizer:
    """The tokenizer of a directory holding ``tokenizer.json`` (beside it,
    where present, ``tokenizer_config.json`` and
    ``special_tokens_map.json``), or of that file itself."""

    def __init__(self, path: str):
        from tokenizers import Tokenizer

        directory = path if os.path.isdir(path) else os.path.dirname(path)
        file = (os.path.join(path, TOKENIZER_FILE) if os.path.isdir(path)
                else path)
        if not os.path.isfile(file):
            raise FileNotFoundError(f"no {TOKENIZER_FILE} at {path}")
        config = _read_json(os.path.join(directory, CONFIG_FILE))
        special = dict(BLOOM_SPECIAL_TOKENS)
        special.update({k: config[k] for k in SPECIAL_TOKEN_KEYS
                        if config.get(k) is not None})
        extra = list(config.get("additional_special_tokens") or [])
        added = config.get("added_tokens_decoder")
        if added is None:  # the older layout: the special tokens map
            for k, v in _read_json(os.path.join(
                    directory, SPECIAL_TOKENS_FILE)).items():
                if k == "additional_special_tokens":
                    extra += [t for t in v or [] if _content(t) not in
                              {_content(e) for e in extra}]
                elif k in SPECIAL_TOKEN_KEYS and v is not None:
                    special[k] = v

        tok = Tokenizer.from_file(file)
        prefix_space = bool(config.get("add_prefix_space", False))
        tree = json.loads(tok.to_str())
        pre = tree.get("pre_tokenizer") or {}
        if pre.get("add_prefix_space", prefix_space) != prefix_space:
            pre["add_prefix_space"] = prefix_space
        if prefix_space:
            for part in ("pre_tokenizer", "decoder"):
                _set_prefix_space(tree.get(part), True)
        tok = Tokenizer.from_str(json.dumps(tree))
        tok.no_truncation()
        tok.no_padding()

        present = {t.content for t in tok.get_added_tokens_decoder()
                   .values()}
        to_add = []
        for _, value in sorted((int(i), v) for i, v in (added or {}).items()):
            if value["content"] not in present:
                to_add.append(_added_token(value, False))
                present.add(value["content"])
        names = [special[k] for k in SPECIAL_TOKEN_KEYS if k in special]
        for value in names + extra:
            if _content(value) not in present:
                to_add.append(_added_token(value, True))
                present.add(_content(value))
        if to_add:
            tok.add_tokens(to_add)
        self._tok = tok
        self.clean_up_tokenization_spaces = bool(
            config.get("clean_up_tokenization_spaces", False))
        self.eos_id = tok.token_to_id(_content(special["eos_token"]))
        self.pad_id = tok.token_to_id(_content(special["pad_token"]))
        self.vocab_size = tok.get_vocab_size(with_added_tokens=True)

    def encode(self, text: str, add_special_tokens: bool = False
               ) -> List[int]:
        return self._tok.encode(
            text, add_special_tokens=add_special_tokens).ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True
               ) -> str:
        text = self._tok.decode([int(i) for i in ids],
                                skip_special_tokens=skip_special_tokens)
        return (clean_up_tokenization(text)
                if self.clean_up_tokenization_spaces else text)
