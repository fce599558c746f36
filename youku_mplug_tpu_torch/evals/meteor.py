"""METEOR metric, pure python (no Java jars).

The reference ships a subprocess wrapper around meteor-1.5.jar
(reference: refTools/evaluation/meteor/meteor.py:15-75) — but the jar
itself is absent upstream (.MISSING_LARGE_BLOBS), so the reference's
METEOR path cannot actually run.  This module implements the metric from
the published algorithm (Banerjee & Lavie 2005; Denkowski & Lavie 2014
universal parameters alpha=0.9, beta=3.0, gamma=0.5):

1. staged unigram alignment — exact first, then optional stem matches,
   then optional synonym matches; within a stage each hypothesis word
   greedily takes the first unmatched reference word (the same strategy
   as NLTK's implementation, against which tests pin exact equality),
2. fragmentation penalty gamma * (chunks / matches)^beta,
3. F-mean P*R / (alpha*P + (1-alpha)*R), score = fmean * (1 - penalty),
4. multi-reference: best single reference per segment,
5. corpus score from summed sufficient statistics (matches / lengths /
   chunks accumulated over segments — how the official jar aggregates,
   NOT a mean of segment scores).

For the project's Chinese captions the tokens are characters (the same
whitespace-token contract as evals/metrics.py BLEU/ROUGE), stemming is
identity and synonyms are off — exact-stage METEOR.  English users can
pass ``stemmer=nltk.PorterStemmer().stem`` and a synonym callable.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

Stemmer = Callable[[str], str]
Synonyms = Callable[[str], set]


def _align(hyp: List[str], ref: List[str],
           stemmer: Optional[Stemmer] = None,
           synonyms: Optional[Synonyms] = None
           ) -> List[Tuple[int, int]]:
    """Staged greedy unigram alignment -> [(hyp_idx, ref_idx), ...]."""
    h_left = list(enumerate(hyp))
    r_left = list(enumerate(ref))
    matches: List[Tuple[int, int]] = []

    def stage(match_fn):
        # scan both lists back-to-front (NLTK's convention — pinned by the
        # oracle tests; the official jar instead beam-searches for minimum
        # chunks, a heuristic neither greedy reproduces exactly)
        for i in range(len(h_left) - 1, -1, -1):
            hi, hw = h_left[i]
            for j in range(len(r_left) - 1, -1, -1):
                ri, rw = r_left[j]
                if match_fn(hw, rw):
                    matches.append((hi, ri))
                    h_left.pop(i)
                    r_left.pop(j)
                    break

    stage(lambda a, b: a == b)
    if stemmer is not None:
        stage(lambda a, b: stemmer(a) == stemmer(b))
    if synonyms is not None:
        stage(lambda a, b: b in synonyms(a) or a in synonyms(b))
    return sorted(matches)


def _count_chunks(matches: List[Tuple[int, int]]) -> int:
    """Minimum runs of contiguous-and-monotone matched unigrams."""
    if not matches:
        return 0
    chunks = 1
    for (h0, r0), (h1, r1) in zip(matches, matches[1:]):
        if not (h1 == h0 + 1 and r1 == r0 + 1):
            chunks += 1
    return chunks


def segment_stats(hypothesis: Sequence[str], references: List[Sequence[str]],
                  stemmer: Optional[Stemmer] = None,
                  synonyms: Optional[Synonyms] = None,
                  alpha: float = 0.9, beta: float = 3.0, gamma: float = 0.5
                  ) -> Tuple[int, int, int, int]:
    """-> (matches, hyp_len, ref_len, chunks) for the best reference."""
    hyp = list(hypothesis)
    best = None
    for ref in references:
        ref = list(ref)
        m = _align(hyp, ref, stemmer, synonyms)
        st = (len(m), len(hyp), len(ref), _count_chunks(m))
        if best is None or _score_from_stats(
                *st, alpha=alpha, beta=beta, gamma=gamma) > \
                _score_from_stats(*best, alpha=alpha, beta=beta,
                                  gamma=gamma):
            best = st
    return best if best is not None else (0, len(hyp), 0, 0)


def _score_from_stats(m: int, hlen: int, rlen: int, chunks: int, *,
                      alpha: float, beta: float, gamma: float) -> float:
    if m == 0 or hlen == 0 or rlen == 0:
        return 0.0
    p = m / hlen
    r = m / rlen
    fmean = p * r / (alpha * p + (1 - alpha) * r)
    frag = chunks / m
    return fmean * (1.0 - gamma * frag ** beta)


def meteor_score(hypothesis: str, references: List[str],
                 stemmer: Optional[Stemmer] = None,
                 synonyms: Optional[Synonyms] = None,
                 alpha: float = 0.9, beta: float = 3.0,
                 gamma: float = 0.5) -> float:
    """Single-segment METEOR over whitespace tokens."""
    st = segment_stats(hypothesis.split(), [r.split() for r in references],
                       stemmer, synonyms, alpha, beta, gamma)
    return _score_from_stats(*st, alpha=alpha, beta=beta, gamma=gamma)


class Meteor:
    """Drop-in scorer with the reference wrapper's interface
    (compute_score(gts, res) -> (corpus_score, per_segment_scores);
    refTools/evaluation/meteor/meteor.py:28-46)."""

    def __init__(self, stemmer: Optional[Stemmer] = None,
                 synonyms: Optional[Synonyms] = None, alpha: float = 0.9,
                 beta: float = 3.0, gamma: float = 0.5):
        self.stemmer = stemmer
        self.synonyms = synonyms
        self.alpha, self.beta, self.gamma = alpha, beta, gamma

    def compute_score(self, gts: Dict, res: Dict):
        assert gts.keys() == res.keys()
        scores = []
        tot_m = tot_h = tot_r = tot_c = 0
        for k in gts:
            assert len(res[k]) == 1
            st = segment_stats(
                res[k][0].split(), [g.split() for g in gts[k]],
                self.stemmer, self.synonyms, self.alpha, self.beta,
                self.gamma)
            scores.append(_score_from_stats(
                *st, alpha=self.alpha, beta=self.beta, gamma=self.gamma))
            tot_m += st[0]
            tot_h += st[1]
            tot_r += st[2]
            tot_c += st[3]
        # corpus score from summed stats (the jar's aggregation), with the
        # official convention that a fully-contiguous corpus (every match
        # one chunk spanning everything) still pays its measured frag
        corpus = _score_from_stats(tot_m, tot_h, tot_r, tot_c,
                                   alpha=self.alpha, beta=self.beta,
                                   gamma=self.gamma)
        return corpus, scores

    def method(self):
        return "METEOR"
