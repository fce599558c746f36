"""HF tokenizer files the tests build with ``tokenizers`` (nothing is
downloaded): a ``tokenizer.json`` trained on a small Chinese and English
corpus, with ``tokenizer_config.json`` and ``special_tokens_map.json``
beside it, in BloomZ's form (``BloomTokenizerFast``; ids 0-3 are
``<unk>``, ``<s>``, ``</s>``, ``<pad>``, so eos 2 and pad 3 as in the Bloom
config).

``byte_level=True`` gives Bloom's pipeline (its split regex, then byte
level BPE); the vocabulary holds at least the 256 byte symbols.
``byte_level=False`` gives a character BPE under a Metaspace
pre-tokenizer (``<unk>`` for unseen characters), whose vocabulary fits
the tiny models' 128 rows.

The merges are learned here, not by ``tokenizers``' trainer, whose ties
between equally frequent pairs fall differently in every process: the
most frequent pair wins, ties going to the smallest pair, so one call
writes the same files in every run (a test's outcome then does not hang
on the trainer's hash seed).
"""

import collections
import json
import os

CORPUS = [
    "The following is a conversation between a curious human and AI "
    "assistant. The assistant gives helpful, detailed, and polite answers "
    "to the user's questions.",
    "Human: What is in the video?", "Human: What happens next?",
    "AI: a man is playing the guitar on the stage .",
    "a small cat sits on a mat and the dog runs in the park",
    "一只猫在沙发上睡觉", "两个人在公园里跑步", "视频里有什么？",
]
# Bloom's pre-tokenizer split (tokenizer.json of bigscience/bloom)
BLOOM_SPLIT = " ?[^(\\s|[.,!?…。，、।۔،])]+"
SPECIALS = ["<unk>", "<s>", "</s>", "<pad>"]


def write_tokenizer_dir(path, vocab_size, byte_level=True, added=(),
                        extra_specials=(), config=None, fill_to=0):
    """Train and write the files under ``path`` (created); ``added``:
    plain added tokens, ``extra_specials``: more special tokens, named in
    ``special_tokens_map.json`` only (the loader adds them); ``config``:
    keys merged into ``tokenizer_config.json``; ``fill_to``: byte-level
    word pieces " w<id>" that no merge reaches appended to the model's
    vocabulary up to that many ids (as chip_smoke.py fills its tokenizer
    to BloomZ's 250880), before the added tokens.  Returns ``path``."""
    from tokenizers import (AddedToken, Regex, Tokenizer, decoders, models,
                            pre_tokenizers)

    os.makedirs(path, exist_ok=True)
    if byte_level:
        pre = pre_tokenizers.Sequence([
            pre_tokenizers.Split(Regex(BLOOM_SPLIT), "isolated"),
            pre_tokenizers.ByteLevel(add_prefix_space=False,
                                     use_regex=False)])
        decoder = decoders.ByteLevel()
    else:
        pre, decoder = pre_tokenizers.Metaspace(), decoders.Metaspace()
    words = collections.Counter(
        piece for text in CORPUS * 4
        for piece, _ in pre.pre_tokenize_str(text))
    if byte_level:
        alphabet = sorted(pre_tokenizers.ByteLevel.alphabet())
    else:
        chars = collections.Counter()
        for w, n in words.items():
            for c in w:
                chars[c] += n
        alphabet = sorted(sorted(chars, key=lambda c: (-chars[c], c))[:48])
    vocab, merges = _learn_bpe(words, alphabet, vocab_size)
    tok = Tokenizer(models.BPE(vocab=vocab, merges=merges,
                               unk_token=None if byte_level else "<unk>"))
    tok.pre_tokenizer, tok.decoder = pre, decoder
    tok.add_special_tokens(SPECIALS)
    if fill_to:
        tree = json.loads(tok.to_str())
        vocab = tree["model"]["vocab"]
        vocab.update({f"\u0120w{i}": i for i in range(len(vocab), fill_to)})
        tok = Tokenizer.from_str(json.dumps(tree))
    if added:
        tok.add_tokens([AddedToken(t, special=False) for t in added])
    tok.save(os.path.join(path, "tokenizer.json"))
    cfg = {"tokenizer_class": "BloomTokenizerFast", "add_prefix_space": False,
           "padding_side": "left", "bos_token": "<s>", "eos_token": "</s>",
           "unk_token": "<unk>", "pad_token": "<pad>"}
    cfg.update(config or {})
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(cfg, f)
    specials = {"bos_token": "<s>", "eos_token": "</s>",
                "unk_token": "<unk>", "pad_token": "<pad>"}
    if extra_specials:
        specials["additional_special_tokens"] = list(extra_specials)
    with open(os.path.join(path, "special_tokens_map.json"), "w") as f:
        json.dump(specials, f)
    return path


def _learn_bpe(words, alphabet, vocab_size):
    """(vocab: token -> id, merges) of a BPE over ``words`` (piece ->
    count): the specials, the alphabet, then merges of the most frequent
    adjacent pair (ties to the smallest) until ``vocab_size`` tokens."""
    vocab = {t: i for i, t in enumerate(SPECIALS + list(alphabet))}
    seqs = {w: [c if c in vocab else None for c in w] for w in words}
    merges = []
    while len(vocab) < vocab_size:
        pairs = collections.Counter()
        for w, seq in seqs.items():
            for a, b in zip(seq, seq[1:]):
                if a is not None and b is not None:
                    pairs[(a, b)] += words[w]
        if not pairs:
            break
        best = min(pairs, key=lambda p: (-pairs[p], p))
        merges.append(best)
        vocab[best[0] + best[1]] = len(vocab)
        for w, seq in seqs.items():
            out, i = [], 0
            while i < len(seq):
                if i + 1 < len(seq) and (seq[i], seq[i + 1]) == best:
                    out.append(best[0] + best[1])
                    i += 2
                else:
                    out.append(seq[i])
                    i += 1
            seqs[w] = out
    return vocab, merges
