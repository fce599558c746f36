"""The port's copy of the caption metrics (youku_mplug_tpu_torch.evals)
against the JAX package's on the same records: every value equal (the
same pure-Python arithmetic)."""

import numpy as np
import pytest

from youku_mplug_tpu import evals as jev
from youku_mplug_tpu_torch import evals as tev

RECORDS = {
    "chinese": [
        {"video_id": "a", "pred_caption": "一个男人在弹吉他",
         "gold_caption": ["一个男人在弹吉他", "男子弹奏吉他"]},
        {"video_id": "b", "pred_caption": "女孩在跳舞",
         "gold_caption": ["一个女孩在舞台上跳舞"]},
        {"video_id": "c", "pred_caption": "猫",
         "gold_caption": ["一只猫在睡觉", "猫咪睡觉"]},
        {"video_id": "a", "pred_caption": "重复的记录",
         "gold_caption": ["不计入"]},
    ],
    "latin and digits": [
        {"video_id": "0", "pred_caption": "1234512",
         "gold_caption": ["synthetic clip 0"]},
        {"video_id": "1", "pred_caption": "synthetic clip 1",
         "gold_caption": ["synthetic clip 1"]},
    ],
    "random": [
        {"video_id": str(i),
         "pred_caption": "".join(np.random.default_rng(i).choice(
             list("天地人你我他大小上下"), size=1 + i % 7)),
         "gold_caption": ["".join(np.random.default_rng(100 + i).choice(
             list("天地人你我他大小上下"), size=3 + i % 5))
             for _ in range(1 + i % 3)]} for i in range(12)],
}


@pytest.mark.parametrize("name", sorted(RECORDS))
def test_caption_eval_matches_jax(name):
    records = RECORDS[name]
    got, want = tev.caption_eval(records), jev.caption_eval(records)
    assert got == want
    assert set(got) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "ROUGE_L",
                        "CIDEr", "METEOR"}
    assert all(np.isfinite(v) for v in got.values())


@pytest.mark.parametrize("name", sorted(RECORDS))
def test_each_metric_matches_jax(name):
    records = RECORDS[name]
    hyps = [tev.normalize_chinese(r["pred_caption"]) for r in records]
    refs = [[tev.normalize_chinese(c) for c in r["gold_caption"]]
            for r in records]
    assert hyps == [jev.normalize_chinese(r["pred_caption"])
                    for r in records]
    assert tev.bleu(hyps, refs) == jev.bleu(hyps, refs)
    assert tev.rouge_l(hyps, refs) == jev.rouge_l(hyps, refs)
    assert tev.cider(hyps, refs) == jev.cider(hyps, refs)
    gts = {i: r for i, r in enumerate(refs)}
    res = {i: [h] for i, h in enumerate(hyps)}
    assert tev.Meteor().compute_score(gts, res) == \
        jev.Meteor().compute_score(gts, res)


def test_perfect_captions_score_one():
    records = [{"video_id": str(i), "pred_caption": c, "gold_caption": [c]}
               for i, c in enumerate(["一个男人在弹吉他", "女孩在跳舞很开心"])]
    got = tev.caption_eval(records)
    assert got["Bleu_1"] == pytest.approx(1.0)
    assert got["ROUGE_L"] == pytest.approx(1.0)
