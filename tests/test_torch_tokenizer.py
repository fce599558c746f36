"""The port's JiebaBPE tokenizer against the JAX package's, on a
``tokenizer.json`` the test trains with ``tokenizers``: ids, the prompt
segments, ``BatchTokenizer``'s padding and truncation, and the text
decoded back; ``load_tokenizer`` takes it wherever the model directory
holds a ``tokenizer.json``, and without jieba fails with the ImportError
(never toy ids)."""

import sys

import numpy as np
import pytest

from youku_mplug_tpu.models import tokenizer as jtok
from youku_mplug_tpu_torch.models import tokenizer as ttok

CORPUS = [
    "一只猫在沙发上睡觉", "两个人在公园里跑步", "视频标题：今天的天气很好",
    "视频类目：体育", "a man is playing the guitar on the stage",
    "小狗在草地上追逐皮球", "这个视频与标题匹配吗？", "厨师正在厨房里做饭",
]
TEXTS = ["一只小狗在公园里跑步", "a dog runs in the park", "",
         "视频标题：猫 视频类目：", "未见过的字词组合 zebra 123"]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers
    from tokenizers import trainers

    d = tmp_path_factory.mktemp("gpt3_tok")
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(CORPUS * 4, trainers.BpeTrainer(
        vocab_size=400, special_tokens=["<|endoftext|>", "<sep>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    tok.save(str(d / "tokenizer.json"))
    return d


@pytest.fixture(scope="module")
def pair(model_dir):
    path = str(model_dir / "tokenizer.json")
    return ttok.JiebaBPETokenizer(path), jtok.JiebaBPETokenizer(path)


def test_special_ids_and_vocab(pair):
    port, jax_ = pair
    for attr in ("bos_id", "eos_id", "pad_id", "eod_id", "vocab_size"):
        assert getattr(port, attr) == getattr(jax_, attr), attr
    assert port.bos_id != port.eos_id == port.pad_id


@pytest.mark.parametrize("text", TEXTS)
@pytest.mark.parametrize("special", [True, False])
def test_ids_and_text_equal(pair, text, special):
    port, jax_ = pair
    ids = port.tokenize(text, add_special_tokens=special)
    assert ids == jax_.tokenize(text, add_special_tokens=special)
    assert port.detokenize(ids) == jax_.detokenize(ids)
    if text and special:
        assert ids[0] == port.bos_id and ids[-1] == port.eos_id
        assert port.detokenize(ids).replace(" ", "") == text.replace(" ", "")


@pytest.mark.parametrize("prompt,text", [("视频标题：猫 视频类目：", "体育"),
                                         ("", "一只猫"), ("question", "")])
def test_prompt_segments_equal(pair, prompt, text):
    port, jax_ = pair
    assert port.tokenize_prompt(prompt, text) == \
        jax_.tokenize_prompt(prompt, text)


@pytest.mark.parametrize("max_length", [6, 12, 40])
@pytest.mark.parametrize("padding", ["max_length", "longest"])
def test_batch_tokenizer_equal(pair, max_length, padding):
    """Strings padded to max_length or the longest, and (prompt, text)
    pairs truncated prompt first: ids, mask and prompt lengths."""
    port = ttok.BatchTokenizer(pair[0], max_length=max_length)
    jax_ = jtok.BatchTokenizer(pair[1], max_length=max_length)
    got, want = port(TEXTS, padding=padding), jax_(TEXTS, padding=padding)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    pairs = [("视频标题：" + t, "体育") for t in TEXTS] + [
        ("短", "一只小狗在公园里跑步 a dog runs in the park")]
    got, want = port(pairs), jax_(pairs)
    for k in ("input_ids", "attention_mask", "prompt_lengths"):
        np.testing.assert_array_equal(got[k], want[k])
    for row in got["input_ids"]:
        assert port.decode(row) == jax_.decode(row)


def test_load_tokenizer_takes_the_model_directory(model_dir, tmp_path):
    tok = ttok.load_tokenizer(str(model_dir), vocab_size=64)
    assert isinstance(tok, ttok.JiebaBPETokenizer)
    assert tok.tokenize(TEXTS[0]) == jtok.JiebaBPETokenizer(
        str(model_dir / "tokenizer.json")).tokenize(TEXTS[0])
    toy = ttok.load_tokenizer(str(tmp_path), vocab_size=64)
    assert isinstance(toy, ttok.ToyTokenizer) and toy.vocab_size == 64
    assert isinstance(ttok.load_tokenizer("", 64), ttok.ToyTokenizer)


def test_a_named_tokenizer_without_jieba_raises(model_dir, monkeypatch):
    """Where jieba is missing (the card's machine), a run that names a
    tokenizer.json fails: no toy ids in its place."""
    monkeypatch.setitem(sys.modules, "jieba", None)
    with pytest.raises(ImportError):
        ttok.load_tokenizer(str(model_dir), vocab_size=64)
