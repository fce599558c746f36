"""Evaluation metrics, pure Python/numpy.

Covers the reference's metric surface without its Java/pycocoevalcap
dependencies (reference: downstream/run_cls_distributed_gpt3.py cal_metric:
250-263, run_retrieval_distributed_gpt3.py itm_eval:296-345,
run_caption_distributed_gpt3.py normalize/cal_metric:238-300 which shells
out to pycocoevalcap BLEU/CIDEr/ROUGE):

- top-k accuracy
- retrieval R@1/5/10 (v2t & t2v) with multi-ground-truth support
- Chinese char-level normalization (CJK-only, space-joined chars)
- corpus BLEU-4 (brevity penalty + uniform-geometric n-gram precision,
  the BLEU definition pycocoevalcap implements; "closest" reference
  length option included)
- ROUGE-L (LCS F-score with beta=1.2, as in the coco toolkit)
- CIDEr (tf-idf weighted 1-4-gram cosine consensus, sigma=6 length
  gaussian, as in the coco toolkit)

METEOR lives in evals/meteor.py (pure-python reimplementation — the
reference's jar is absent upstream, .MISSING_LARGE_BLOBS); on the
char-normalized Chinese tokens it runs exact-stage only (stemming is
identity, synonyms off), which is the meaningful restriction there.
"""

from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from typing import Dict, List, Sequence

import numpy as np


def topk_accuracy(scores: np.ndarray, labels: np.ndarray,
                  topk=(1, 5)) -> List[float]:
    """precision@k in percent (reference run_cls cal_metric:250-263)."""
    scores = np.asarray(scores)
    labels = np.asarray(labels)
    maxk = max(topk)
    pred = np.argsort(-scores, axis=1)[:, :maxk]
    correct = pred == labels[:, None]
    return [100.0 * correct[:, :k].any(axis=1).mean() for k in topk]


def itm_eval(scores_v2t: np.ndarray, scores_t2v: np.ndarray,
             txt2vid: Dict[int, Sequence[int]] | Dict[int, int],
             vid2txt: Dict[int, Sequence[int]]) -> Dict[str, float]:
    """Retrieval R@K (reference run_retrieval itm_eval:296-345)."""
    ranks = np.zeros(scores_v2t.shape[0])
    for i, score in enumerate(scores_v2t):
        inds = np.argsort(score)[::-1]
        pos = [int(np.where(inds == t)[0][0]) for t in vid2txt[i]]
        ranks[i] = min(pos)
    tr1, tr5, tr10 = [100.0 * (ranks < k).mean() for k in (1, 5, 10)]

    ranks = np.zeros(scores_t2v.shape[0])
    for i, score in enumerate(scores_t2v):
        inds = np.argsort(score)[::-1]
        gt = txt2vid[i]
        gt = gt[0] if isinstance(gt, (list, tuple)) else gt
        ranks[i] = int(np.where(inds == gt)[0][0])
    vr1, vr5, vr10 = [100.0 * (ranks < k).mean() for k in (1, 5, 10)]

    tr_mean = (tr1 + tr5 + tr10) / 3
    vr_mean = (vr1 + vr5 + vr10) / 3
    return {"txt_r1": tr1, "txt_r5": tr5, "txt_r10": tr10,
            "txt_r_mean": tr_mean, "vid_r1": vr1, "vid_r5": vr5,
            "vid_r10": vr10, "vid_r_mean": vr_mean,
            "r_mean": (tr_mean + vr_mean) / 2}


def normalize_chinese(text: str) -> str:
    """Keep CJK chars only, space-separated (reference run_caption:238)."""
    text = re.sub(r"[^一-龥]+", "", text)
    return " ".join(list(text))


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def bleu(hypotheses: List[str], references: List[List[str]],
         max_n: int = 4) -> List[float]:
    """Corpus BLEU-1..max_n with closest-length brevity penalty."""
    assert len(hypotheses) == len(references)
    clipped = np.zeros(max_n)
    totals = np.zeros(max_n)
    hyp_len = 0
    ref_len = 0
    for hyp, refs in zip(hypotheses, references):
        h = hyp.split()
        rs = [r.split() for r in refs]
        hyp_len += len(h)
        # closest reference length
        ref_len += min((abs(len(r) - len(h)), len(r)) for r in rs)[1]
        for n in range(1, max_n + 1):
            h_ng = _ngrams(h, n)
            max_ref = Counter()
            for r in rs:
                for ng, c in _ngrams(r, n).items():
                    max_ref[ng] = max(max_ref[ng], c)
            clipped[n - 1] += sum(min(c, max_ref[ng])
                                  for ng, c in h_ng.items())
            totals[n - 1] += max(sum(h_ng.values()), 0)
    bp = 1.0 if hyp_len > ref_len else math.exp(
        1 - ref_len / max(hyp_len, 1))
    scores = []
    log_sum = 0.0
    for n in range(max_n):
        p = clipped[n] / totals[n] if totals[n] > 0 else 0.0
        log_sum += math.log(p) if p > 0 else -1e10
        scores.append(bp * math.exp(log_sum / (n + 1)))
    return scores


def _lcs(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b):
            cur.append(prev[j] + 1 if x == y else max(cur[j], prev[j + 1]))
        prev = cur
    return prev[-1]


def rouge_l(hypotheses: List[str], references: List[List[str]],
            beta: float = 1.2) -> float:
    """Mean ROUGE-L F-score (coco toolkit semantics: max over refs)."""
    scores = []
    for hyp, refs in zip(hypotheses, references):
        h = hyp.split()
        # coco toolkit: max precision and max recall taken SEPARATELY
        # across references, F computed from those maxima
        precs, recs = [], []
        for ref in refs:
            r = ref.split()
            lcs = _lcs(h, r)
            precs.append(lcs / len(h) if h else 0.0)
            recs.append(lcs / len(r) if r else 0.0)
        pmax, rmax = max(precs, default=0.0), max(recs, default=0.0)
        if pmax and rmax:
            f = ((1 + beta ** 2) * pmax * rmax) / (rmax + beta ** 2 * pmax)
        else:
            f = 0.0
        scores.append(f)
    return float(np.mean(scores)) if scores else 0.0


def cider(hypotheses: List[str], references: List[List[str]],
          max_n: int = 4, sigma: float = 6.0) -> float:
    """CIDEr (tf-idf n-gram consensus, coco toolkit semantics)."""
    assert len(hypotheses) == len(references)
    num_docs = len(references)

    # document frequency over reference sets
    df: List[Counter] = [Counter() for _ in range(max_n)]
    ref_ngrams = []
    for refs in references:
        per_ref = [[_ngrams(r.split(), n + 1) for n in range(max_n)]
                   for r in refs]
        ref_ngrams.append(per_ref)
        for n in range(max_n):
            seen = set()
            for counts in per_ref:
                seen |= set(counts[n])
            for ng in seen:
                df[n][ng] += 1

    log_n = math.log(max(num_docs, 1.0))

    def tfidf_vec(counts: Counter, n: int):
        # coco semantics: RAW count * idf (no tf normalization), idf
        # clipped at df>=1
        vec = {}
        norm = 0.0
        for ng, c in counts.items():
            w = float(c) * (log_n - math.log(max(df[n][ng], 1.0)))
            vec[ng] = w
            norm += w * w
        return vec, math.sqrt(norm)

    scores = []
    for hyp, refs, per_ref in zip(hypotheses, references, ref_ngrams):
        h_tokens = hyp.split()
        hyp_counts = [_ngrams(h_tokens, n + 1) for n in range(max_n)]
        score_n = np.zeros(max_n)
        for ref, ref_counts in zip(refs, per_ref):
            # length penalty uses the UNIGRAM length delta for every n
            delta = float(len(h_tokens) - len(ref.split()))
            gauss = math.exp(-(delta ** 2) / (2 * sigma ** 2))
            for n in range(max_n):
                hv, hn = tfidf_vec(hyp_counts[n], n)
                rv, rn = tfidf_vec(ref_counts[n], n)
                # clipped cosine (coco: min(h, r) * r)
                num = sum(min(hv.get(ng, 0.0), rv[ng]) * rv[ng]
                          for ng in rv)
                sim = num / (hn * rn) if hn and rn else 0.0
                score_n[n] += sim * gauss
        score_n /= max(len(per_ref), 1)
        scores.append(10.0 * float(np.mean(score_n)))
    return float(np.mean(scores)) if scores else 0.0


def caption_eval(results: List[dict]) -> Dict[str, float]:
    """COCO-style caption metrics over [{"video_id", "pred_caption",
    "gold_caption": [...]}] with Chinese char normalization (reference
    run_caption cal_metric:244-300); dedupes by video_id."""
    seen = set()
    hyps, refs = [], []
    for each in results:
        vid = each["video_id"]
        if vid in seen:
            continue
        seen.add(vid)
        hyps.append(normalize_chinese(each["pred_caption"]))
        refs.append([normalize_chinese(c) for c in each["gold_caption"]])
    bleu_scores = bleu(hyps, refs)
    return {
        "Bleu_1": bleu_scores[0],
        "Bleu_2": bleu_scores[1],
        "Bleu_3": bleu_scores[2],
        "Bleu_4": bleu_scores[3],
        "ROUGE_L": rouge_l(hyps, refs),
        "CIDEr": cider(hyps, refs),
        "METEOR": _meteor(hyps, refs),
    }


def _meteor(hyps: List[str], refs: List[List[str]]) -> float:
    from youku_mplug_tpu_torch.evals.meteor import Meteor

    gts = {i: r for i, r in enumerate(refs)}
    res = {i: [h] for i, h in enumerate(hyps)}
    return Meteor().compute_score(gts, res)[0] if hyps else 0.0


def ref_evaluation(refer, results: List[dict],
                   tokenize=None) -> Dict[str, float]:
    """Referring-expression generation eval (reference
    refTools/evaluation/refEvaluation.py:17-80): ``results`` is
    [{"ref_id", "sent"}]; each generated sentence is scored against the
    ref's ground-truth expressions with BLEU-1..4 / ROUGE-L / CIDEr
    (METEOR dropped: its jar is absent upstream and char-level Chinese
    eval makes it meaningless).  ``refer`` is a data.refer.Refer;
    ``tokenize`` optionally maps a raw sentence to a token string
    (default: whitespace lowering, the PTB tokenizer's effect on the
    already-clean refexp corpus)."""
    tok = tokenize or (lambda s: " ".join(s.lower().strip().split()))
    hyps, refs = [], []
    for res in results:
        ref = refer.refs[res["ref_id"]]
        hyps.append(tok(res["sent"]))
        refs.append([tok(s["sent"]) for s in ref["sentences"]])
    bleu_scores = bleu(hyps, refs)
    return {
        "Bleu_1": bleu_scores[0],
        "Bleu_2": bleu_scores[1],
        "Bleu_3": bleu_scores[2],
        "Bleu_4": bleu_scores[3],
        "ROUGE_L": rouge_l(hyps, refs),
        "CIDEr": cider(hyps, refs),
    }
