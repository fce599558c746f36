"""The port's HF tokenizer files (``models/hf_tokenizer.py``, read through
``tokenizers`` alone) against ``transformers.AutoTokenizer`` on
directories the test builds (``tokenizer.json`` with
``tokenizer_config.json`` and ``special_tokens_map.json``, in
``BloomTokenizerFast``'s form): ids bitwise and decoded text equal, on
Chinese and English prompts with special and added tokens, byte-level
and character BPEs; ids outside the vocabulary (a seeded model's, over
BloomZ's 250880 rows) decode to nothing in both; the runner's
``answer`` (decode, then strip) equal to the JAX runner's."""

import numpy as np
import pytest

from youku_mplug_tpu_torch.models.hf_tokenizer import HFTokenizer
from tests.hf_tokenizer_files import write_tokenizer_dir

TEXTS = [
    "The following is a conversation between a curious human and AI "
    "assistant.\nHuman: <|video|>\nHuman: What is in the video?\nAI: ",
    "一只小狗在公园里跑步", "视频里有什么？ a dog runs in the park .",
    "<s>Human: hi</s><pad> <mask> it's <|x|>ok , isn't it ?",
    "", "  two  spaces ", "未见过的字词组合 zebra 123 ☃",
]
ADDED = ["<|x|>", "<|video|>"]
SPECIAL = ["<mask>"]
CASES = {
    "byte_level": dict(vocab_size=600, byte_level=True),
    "char_bpe": dict(vocab_size=120, byte_level=False),
    "prefix_space": dict(vocab_size=600, byte_level=True,
                         config={"add_prefix_space": True}),
    "clean_up": dict(vocab_size=600, byte_level=True,
                     config={"clean_up_tokenization_spaces": True}),
    "filled": dict(vocab_size=600, byte_level=True, fill_to=3000),
    "config_added": dict(vocab_size=600, byte_level=True, config={
        "added_tokens_decoder": {"700": {
            "content": "<|extra|>", "lstrip": False, "rstrip": False,
            "normalized": False, "single_word": False,
            "special": True}}}),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request, tmp_path_factory):
    from transformers import AutoTokenizer

    d = write_tokenizer_dir(tmp_path_factory.mktemp(request.param),
                            added=ADDED, extra_specials=SPECIAL,
                            **CASES[request.param])
    return HFTokenizer(str(d)), AutoTokenizer.from_pretrained(str(d))


@pytest.mark.parametrize("text", TEXTS)
def test_ids_and_text_equal_transformers(pair, text):
    port, hf = pair
    ids = port.encode(text, add_special_tokens=False)
    assert ids == hf.encode(text, add_special_tokens=False)
    for skip in (True, False):
        assert port.decode(ids, skip_special_tokens=skip) == \
            hf.decode(ids, skip_special_tokens=skip)


def test_vocabulary_and_added_tokens_equal_transformers(pair):
    """The whole vocabulary, and every added token with its flags (the
    specials among them), as transformers' backend holds them."""
    port, hf = pair
    assert port.vocab_size == len(hf)
    assert (port.eos_id, port.pad_id) == (hf.eos_token_id,
                                          hf.pad_token_id) == (2, 3)
    assert port._tok.get_vocab(with_added_tokens=True) == hf.get_vocab()
    assert {i: repr(t) for i, t in
            port._tok.get_added_tokens_decoder().items()} == \
        {i: repr(t) for i, t in
         hf.backend_tokenizer.get_added_tokens_decoder().items()}


def test_ids_past_the_vocabulary_decode_to_nothing(pair):
    """A seeded model's answer: ids across BloomZ's 250880 rows, most of
    them outside the built vocabulary, with pad and eos dropped as the
    runner drops them; decoded and stripped as both runners do."""
    port, hf = pair
    rng = np.random.default_rng(5)
    keep = np.concatenate([rng.integers(0, 250880, 48),
                           rng.integers(0, port.vocab_size, 16)])
    rng.shuffle(keep)
    keep = keep[(keep != 2) & (keep != 3)].astype(np.int32)
    got = port.decode(keep, skip_special_tokens=True).strip()
    assert got == hf.decode(keep, skip_special_tokens=True).strip()
    inside = [int(i) for i in keep if i < port.vocab_size]
    assert got == port.decode(inside).strip()
