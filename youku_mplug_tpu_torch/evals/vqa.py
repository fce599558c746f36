"""Counterpart of ``youku_mplug_tpu/evals/vqa.py``, a copy of the JAX
package's module (pure Python).

VQA accuracy protocol (reference vqaTools/vqaEval.py:1-183).

The standard VQAv2 evaluation: normalize answers (contractions, digit
words, punctuation, articles), then accuracy per question =
min(#annotators-matching/3, 1), averaged (optionally per answer type).
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence

_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't",
    "couldve": "could've", "couldnt": "couldn't", "didnt": "didn't",
    "doesnt": "doesn't", "dont": "don't", "hadnt": "hadn't",
    "hasnt": "hasn't", "havent": "haven't", "hed": "he'd", "hes": "he's",
    "howd": "how'd", "howll": "how'll", "hows": "how's", "Id": "I'd",
    "Im": "I'm", "Ive": "I've", "isnt": "isn't", "itd": "it'd",
    "itll": "it'll", "lets": "let's", "maam": "ma'am",
    "mightve": "might've", "mustve": "must've", "shant": "shan't",
    "shed": "she'd", "shes": "she's", "shouldve": "should've",
    "shouldnt": "shouldn't", "thats": "that's", "thered": "there'd",
    "therere": "there're", "theres": "there's", "theyd": "they'd",
    "theyll": "they'll", "theyre": "they're", "theyve": "they've",
    "twas": "'twas", "wasnt": "wasn't", "wed": "we'd", "weve": "we've",
    "werent": "weren't", "whatll": "what'll", "whatre": "what're",
    "whats": "what's", "whatve": "what've", "whens": "when's",
    "whered": "where'd", "wheres": "where's", "whereve": "where've",
    "whod": "who'd", "wholl": "who'll", "whos": "who's",
    "whove": "who've", "whyll": "why'll", "whyre": "why're",
    "whys": "why's", "wont": "won't", "wouldve": "would've",
    "wouldnt": "wouldn't", "yall": "y'all", "youd": "you'd",
    "youll": "you'll", "youre": "you're", "youve": "you've",
}
_DIGITS = {"none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
           "four": "4", "five": "5", "six": "6", "seven": "7",
           "eight": "8", "nine": "9", "ten": "10"}
_ARTICLES = {"a", "an", "the"}
_PUNCT = list(";/[]\"{}()=+\\_-><@`,?!")
_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(\d)(,)(\d)")


def normalize_answer(ans: str) -> str:
    ans = ans.replace("\n", " ").replace("\t", " ").strip().lower()
    ans = _COMMA_STRIP.sub(r"\1\3", ans)
    for p in _PUNCT:
        ans = ans.replace(p, "" if p != "-" else " ")
    ans = _PERIOD_STRIP.sub("", ans)
    words = []
    for w in ans.split():
        w = _DIGITS.get(w, w)
        if w in _ARTICLES:
            continue
        words.append(_CONTRACTIONS.get(w, w))
    return " ".join(words)


def vqa_accuracy(predictions: Dict[int, str],
                 annotations: Dict[int, Sequence[str]]) -> float:
    """predictions: question_id -> answer; annotations: question_id ->
    list of (typically 10) human answers.  Returns accuracy in percent."""
    accs: List[float] = []
    for qid, pred in predictions.items():
        gts = [normalize_answer(a) for a in annotations.get(qid, [])]
        p = normalize_answer(pred)
        if not gts:
            continue
        # leave-one-out over annotators, standard protocol
        per = []
        for i in range(len(gts)):
            others = gts[:i] + gts[i + 1:]
            per.append(min(1.0, sum(1 for g in others if g == p) / 3.0))
        accs.append(sum(per) / len(per))
    return 100.0 * sum(accs) / max(len(accs), 1)
