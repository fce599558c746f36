"""The port's CLIP tokenizer (standard library only) against the JAX
package's (``models/clip_tokenizer.py``, on ``regex``), bitwise, on a
48,894-row ``merges.txt`` the test builds: BPE merges learned from a
small corpus (so they apply to real words, CJK and digits included),
then unique filler rows that no text reaches, behind the ``#version``
header of an HF checkpoint (as JAX's ``test_hf_merges_txt_format``
writes it).  Encode, decode and ``tokenize`` (77-token rows, truncation)
on text with CJK, digits, contractions, punctuation and HTML entities;
the vocab; the ``.gz`` format; and the module's imports."""

import collections
import gzip
import subprocess
import sys

import numpy as np
import pytest

from youku_mplug_tpu.models import clip_tokenizer as jtok
from youku_mplug_tpu_torch.models import clip_tokenizer as ttok

CORPUS = [
    "a photo of a cat sitting on the mat",
    "the quick brown fox jumps over the lazy dog",
    "it's a dog's life, isn't it? we're they'll you've i'd",
    "视频标题：一只猫 在 玩耍 中文 english 123 4567 89",
    "naïve café déjà-vu résumé",
    "&amp;lt;tag&gt; html entities &quot;quoted&quot;",
    "supercalifragilisticexpialidocious antidisestablishmentarianism",
    "photos of cats and dogs playing in the garden at 10:30pm!!!",
]
TEXTS = CORPUS + [
    "A PHOTO OF A CAT!!!",
    "it's won't we're I'll they'd i'm you've",
    "hello,   world...  123 456 7",
    "mixed 中文 english 123 和 数字 2024年",
    "emoji 🚀🔥 test",
    "&amp;amp;amp; &#39;s &#x4e2d;",
    "",
    "   ",
    "a" * 300,
    "<|startoftext|> specials pass through <|endoftext|>",
    "tabs\tand\nnewlines  collapse",
    "x²³ ½ ⅷ ٣ numbers",
    "don't!!'s?? ''ll",
]


def _learn_merges(n: int):
    """Up to ``n`` BPE merges over CORPUS's pieces, most frequent pair
    first (ties by the pair), in CLIP's byte-mapped symbols, until every
    corpus word is one symbol."""
    enc = ttok.byte_unicode_table()
    words = collections.Counter()
    for text in CORPUS:
        for piece in ttok.split_pieces(ttok._clean(text)):
            mapped = "".join(enc[b] for b in piece.encode("utf-8"))
            words[tuple(mapped[:-1]) + (mapped[-1] + "</w>",)] += 1
    merges = []
    while len(merges) < n:
        pairs = collections.Counter()
        for w, c in words.items():
            for p in zip(w[:-1], w[1:]):
                pairs[p] += c
        if not pairs:
            break
        best = min(pairs, key=lambda p: (-pairs[p], p))
        merges.append(best)
        merged = collections.Counter()
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += c
        words = merged
    return merges


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """(an HF checkpoint directory holding merges.txt, the same rows as a
    published-style .gz)."""
    learned = _learn_merges(1000)
    # filler: symbols of the bytes 0x00-0x1f (never in cleaned text)
    filler = [(chr(0x100 + i % 32) + str(i), chr(0x101 + i % 31))
              for i in range(jtok._NUM_MERGES - len(learned))]
    rows = [" ".join(m) for m in learned + filler]
    d = tmp_path_factory.mktemp("clip_bpe")
    (d / "merges.txt").write_text("\n".join(["#version: 0.2"] + rows),
                                  encoding="utf-8")
    gz = d / "bpe_simple_vocab_16e6.txt.gz"
    with gzip.open(gz, "wb") as f:
        f.write("\n".join(["bpe_simple_vocab_16e6.txt#version: 0.2"] + rows
                          ).encode("utf-8"))
    assert 150 < len(learned) < 1000  # every corpus word merged whole
    return str(d), str(gz)


@pytest.fixture(scope="module")
def pair(tables):
    return jtok.CLIPTokenizer(tables[0]), ttok.CLIPTokenizer(tables[0])


def test_vocab_matches_jax(pair, tables):
    jt, tt = pair
    assert tt.vocab_size == jt.vocab_size == 49408
    assert tt.encoder == jt.encoder
    assert (tt.sot_id, tt.eot_id) == (jt.sot_id, jt.eot_id) == (49406,
                                                                49407)
    gz = ttok.CLIPTokenizer(tables[1])
    assert gz.encoder == tt.encoder and gz.rank == tt.rank


@pytest.mark.parametrize("i", range(len(TEXTS)))
def test_encode_and_decode_match_jax(pair, i):
    jt, tt = pair
    text = TEXTS[i]
    ids = tt.encode(text)
    assert ids == jt.encode(text)
    assert tt.decode(ids) == jt.decode(ids)
    if text.strip():
        assert len(ids) > 0


def test_learned_merges_apply(pair):
    """The table's merges reach the corpus: common words take one id."""
    _, tt = pair
    assert len(tt.encode("the")) == 1 and len(tt.encode("photo")) <= 2
    assert len(tt.encode("the cat")) < len("the cat")


def test_split_matches_jax_regex(pair):
    jt, _ = pair
    for text in TEXTS:
        clean = ttok._clean(text)
        assert ttok.split_pieces(clean) == jt._pat.findall(clean), text


def test_tokenize_rows_match_jax(tables):
    path = tables[0]
    rows = ttok.tokenize(TEXTS[:-4] + TEXTS[-3:], bpe_path=path,
                         truncate=True)
    want = jtok.tokenize(TEXTS[:-4] + TEXTS[-3:], bpe_path=path,
                         truncate=True)
    assert rows.dtype == want.dtype == np.int32
    assert rows.shape[1] == 77 and np.array_equal(rows, want)
    long = TEXTS[TEXTS.index("a" * 300)]
    assert rows[TEXTS.index(long)][-1] == 49407  # truncation keeps <eot>
    with pytest.raises(RuntimeError, match="too long"):
        ttok.tokenize(" ".join(["cat"] * 80), bpe_path=path)
    with pytest.raises(RuntimeError, match="too long"):
        jtok.tokenize(" ".join(["cat"] * 80), bpe_path=path)
    assert np.array_equal(ttok.tokenize("a photo", bpe_path=path),
                          jtok.tokenize("a photo", bpe_path=path))


def test_module_imports_neither_regex_nor_ftfy(tmp_path):
    """Imported and run in a fresh interpreter where ``regex`` and
    ``ftfy`` cannot be imported."""
    code = (
        "import sys\n"
        "sys.modules['regex'] = None\n"
        "sys.modules['ftfy'] = None\n"
        "from youku_mplug_tpu_torch.models import clip_tokenizer as t\n"
        "assert t.split_pieces(t._clean(\"It's 12 cats!\")) == "
        "[\"it\", \"'s\", \"1\", \"2\", \"cats\", \"!\"]\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    src = open(ttok.__file__).read()
    assert "import regex" not in src and "import ftfy" not in src


def test_missing_table_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("CLIP_BPE_PATH", raising=False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="CLIP_BPE_PATH"):
        ttok.CLIPTokenizer()
    (tmp_path / "short.txt").write_text("#version: 0.2\na b\n")
    with pytest.raises(ValueError, match="not a CLIP merge table"):
        ttok.CLIPTokenizer(str(tmp_path / "short.txt"))
