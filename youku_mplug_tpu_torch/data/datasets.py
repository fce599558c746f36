"""Video-text datasets: annotation files, decoding with retries, the
clip transform; and the synthetic clips of smoke runs.

Counterpart of ``youku_mplug_tpu/data/datasets.py``.  The annotation
formats are JAX's: a CSV whose ``<id>:FILE`` column names the video, a
JSON list, or jsonl.  Each sample draws from its own generator
``default_rng((seed * 1_000_003 + epoch) * 2_654_435_761 + index)``, so
a sample is the same whatever thread or process decodes it.  A decode
that fails is tried 3 times; then ``PretrainVideoDataset`` draws another
index (up to 20 times) and the downstream datasets walk to the next one.
Samples carry uint8 (T, H, W, 3) clips; they are normalized on the
device (``ops/preprocess.py``).

One deliberate difference from JAX (ROADMAP.md, Queue 3): JAX's CSV
reader keeps only the id and the first other column (as ``caption``),
which leaves a three-column cls CSV (``video_id:FILE, video_title,
category_id``) with no title and the label -1.  Here a CSV with more
columns than those two also keeps every column under its own header
name; a two-column CSV, JSON and jsonl give JAX's rows.  A remote
``video_root`` (``oss://``, ``http(s)://``) is read as in JAX: each
video is spooled to a local cache by ``data/remote_io.fetch`` and decoded
from there, and a failed decode evicts the spool before the next try.

``SyntheticVideoDataset`` gives the samples of JAX's, bit for bit (the
same per-index generator, caption, ``label`` (index mod
``num_classes``), ``match_id`` and ``index``); ``SyntheticRetrievalSplit``
adds the fields the retrieval evaluations read from a split.
``QAVideoDataset`` (video question answering, with ``pre_question``)
gives JAX's samples too.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List

import numpy as np

from youku_mplug_tpu_torch.data import remote_io
from youku_mplug_tpu_torch.data.video_decode import read_frames


def load_jsonl(path: str) -> List[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def pre_caption(caption: str, max_words: int = 0) -> str:
    """Lower case, punctuation stripped, dashes and slashes to spaces,
    whitespace collapsed, at most ``max_words`` words."""
    caption = re.sub(r"([,.'!?\"()*#:;~])", "", caption.lower())
    caption = caption.replace("-", " ").replace("/", " ").replace(
        "<person>", "person")
    caption = re.sub(r"\s{2,}", " ", caption)
    caption = caption.rstrip("\n").strip(" ")
    if max_words > 0:
        words = caption.split(" ")
        if len(words) > max_words:
            caption = " ".join(words[:max_words])
    return caption


def pre_question(question: str, max_words: int = 0) -> str:
    """Lower case, punctuation stripped, dashes and slashes to spaces,
    trailing spaces dropped, at most ``max_words`` words (JAX
    ``datasets.py:338-347``)."""
    question = re.sub(r"([,.'!?\"()*#:;~])", "", question.lower())
    question = question.replace("-", " ").replace("/", " ")
    question = question.rstrip(" ")
    if max_words > 0:
        words = question.split(" ")
        if len(words) > max_words:
            question = " ".join(words[:max_words])
    return question


def _read_annotations(ann_file, id_key="video_id", text_key="caption"):
    """Rows of one file or a list of files (CSV, jsonl, else JSON).  A
    CSV row is ``{id_key: <the :FILE column>, text_key: <the first other
    column>}``, and where the file has more columns, every column but
    the id under its own header name too (the module docstring)."""
    files = ann_file if isinstance(ann_file, (list, tuple)) else [ann_file]
    if not all(files):
        raise ValueError(f"no annotation file given ({ann_file!r}): set the "
                         "YAML's train_file / val_file / test_file, or pass "
                         "--synthetic_data")
    ann = []
    for f in files:
        if f.endswith(".csv"):
            import pandas as pd

            df = pd.read_csv(f)
            id_col = next(c for c in df.columns if c.endswith(":FILE"))
            text_col = next(c for c in df.columns if not c.endswith(":FILE"))
            rows = [{id_key: v, text_key: t}
                    for v, t in zip(df[id_col], df[text_col])]
            named = [c for c in df.columns if c != id_col]
            if len(named) > 1:
                for row, values in zip(rows, zip(*(df[c] for c in named))):
                    row.update(zip(named, values))
            ann += rows
        elif f.endswith(".jsonl"):
            ann += load_jsonl(f)
        else:
            with open(f) as fh:
                ann += json.load(fh)
    return ann


class VideoDataset:
    """Annotation rows -> decoded, transformed uint8 clips, with
    retries.  ``decode_size`` > 0 resizes frames to that square while
    decoding, ``decode_short_side`` > 0 their short side (at the source's
    aspect), so the transforms work on small frames."""

    def __init__(self, ann: List[dict], video_root: str, transform=None,
                 num_frames: int = 8, sample: str = "rand", seed: int = 0,
                 decode_size: int = 0, decode_short_side: int = 0):
        self.ann = ann
        self.video_root = video_root
        self.transform = transform
        self.num_frames = num_frames
        self.sample = sample
        self.seed = seed
        self.epoch = 0
        self.decode_size = decode_size
        self.decode_short_side = decode_short_side

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return len(self.ann)

    def _rng(self, index: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.seed * 1_000_003 + self.epoch) * 2_654_435_761 + index)

    def _video_path(self, ann: dict) -> str:
        """``video_root/<id>``; an id without an extension takes the
        first of .mp4, .avi, .mkv, .webm that exists; under a remote root
        the object's URI."""
        vid = ann.get("video_id") or ann.get("clip_name")
        if remote_io.is_remote(self.video_root):
            return self.video_root.rstrip("/") + "/" + str(vid)
        path = os.path.join(self.video_root, str(vid))
        if not os.path.splitext(path)[1]:
            for ext in (".mp4", ".avi", ".mkv", ".webm"):
                if os.path.exists(path + ext):
                    return path + ext
        return path

    def _decode(self, ann: dict, rng) -> np.ndarray:
        kw = {}
        if ann.get("start_time") is not None and ann.get(
                "end_time") is not None:
            kw = {"start_time": ann["start_time"],
                  "end_time": ann["end_time"]}
        return read_frames(
            remote_io.fetch(self._video_path(ann)),
            num_frames=self.num_frames,
            sample=self.sample, rng=rng,
            width=self.decode_size, height=self.decode_size,
            short_side=self.decode_short_side, **kw)

    def _load_clip(self, index: int, retries: int = 3):
        """The index's clip, decoded and transformed; each of
        ``retries`` tries draws on from the same generator."""
        rng = self._rng(index)
        err = None
        for _ in range(retries):
            try:
                clip = self._decode(self.ann[index], rng)
                if self.transform is not None:
                    clip = self.transform(clip, rng=rng)
                return clip
            except Exception as e:  # a broken file: try again
                err = e
                # a corrupt spool would fail every try: fetch it again
                remote_io.evict(self._video_path(self.ann[index]))
        raise IOError(f"decode failed for index {index}: {err}")

    def _walk(self, index: int, make):
        """``make(index)``, walking to the next index (wrapping) while a
        decode fails, once round the dataset."""
        orig = index
        for _ in range(len(self)):
            try:
                return make(index)
            except Exception:
                index = 0 if index == len(self) - 1 else index + 1
                if index == orig:
                    break
        raise IOError("all decode attempts failed")


class PretrainVideoDataset(VideoDataset):
    """(clip, caption) pairs; a failed index draws another at random, up
    to 20 times."""

    def __init__(self, ann_file, video_root, transform=None, num_frames=8,
                 max_words=30, seed=0, **kw):
        ann = _read_annotations(ann_file)
        for a in ann:
            if "title" in a and "caption" not in a:
                a["caption"] = a.pop("title")
        super().__init__(ann, video_root, transform, num_frames, seed=seed,
                         **kw)
        self.max_words = max_words

    def __getitem__(self, index: int):
        rng = self._rng(index)
        for _ in range(20):
            try:
                clip = self._load_clip(index)
                text = pre_caption(str(self.ann[index]["caption"]),
                                   self.max_words)
                return {"video": clip, "text": text, "index": index}
            except Exception:
                index = int(rng.integers(0, len(self)))
        raise IOError("too many decode failures")


class RetrievalVideoDataset(VideoDataset):
    """(clip, caption, match_id); an evaluation split also holds every
    caption (``text``) and the clip <-> text maps ``vid2txt`` and
    ``txt2vid``.  ``has_multi_vision_gt``: clips sharing a caption share
    a match id."""

    def __init__(self, ann_file, video_root, transform=None, num_frames=4,
                 max_words=80, has_multi_vision_gt=False, train=True,
                 seed=0, **kw):
        ann = _read_annotations(ann_file, id_key="clip_name")
        super().__init__(ann, video_root, transform, num_frames,
                         sample="rand" if train else "middle", seed=seed,
                         **kw)
        self.max_words = max_words
        self.train = train
        self.has_multi_vision_gt = has_multi_vision_gt
        self.match_ids: Dict[Any, int] = {}
        for a in self.ann:
            key = a["caption"] if has_multi_vision_gt else a["clip_name"]
            self.match_ids.setdefault(key, len(self.match_ids))
        self.text: List[str] = []
        self.txt2vid: Dict[int, List[int]] = {}
        self.vid2txt: Dict[int, List[int]] = {}
        for vi, a in enumerate(self.ann):
            caps = a["caption"] if isinstance(a["caption"], list) else [
                a["caption"]]
            self.vid2txt[vi] = []
            for c in caps:
                ti = len(self.text)
                self.text.append(pre_caption(str(c), self.max_words))
                self.vid2txt[vi].append(ti)
                self.txt2vid[ti] = [vi]

    def _sample(self, index: int):
        clip = self._load_clip(index)
        a = self.ann[index]
        cap = a["caption"] if not isinstance(a["caption"], list) \
            else a["caption"][0]
        key = a["caption"] if self.has_multi_vision_gt else a["clip_name"]
        return {"video": clip, "text": pre_caption(str(cap), self.max_words),
                "match_id": self.match_ids[key], "index": index}

    def __getitem__(self, index: int):
        return self._walk(index, self._sample)


class CaptionVideoDataset(VideoDataset):
    """(clip, caption, golden captions, video id); a list of captions
    gives every one as gold and the first as the text."""

    def __init__(self, ann_file, video_root, transform=None, num_frames=16,
                 max_words=80, train=True, prompt="", seed=0, **kw):
        ann = _read_annotations(ann_file)
        super().__init__(ann, video_root, transform, num_frames,
                         sample="rand" if train else "middle", seed=seed,
                         **kw)
        self.max_words = max_words
        self.train = train
        self.prompt = prompt

    def _sample(self, index: int):
        clip = self._load_clip(index)
        a = self.ann[index]
        cap = a.get("caption") or a.get("golden_caption") or ""
        if isinstance(cap, list):
            golden = [pre_caption(str(c), self.max_words) for c in cap]
            cap = cap[0]
        else:
            golden = [pre_caption(str(cap), self.max_words)]
        vid = a.get("video_id") or a.get("clip_name")
        return {"video": clip, "text": pre_caption(str(cap), self.max_words),
                "golden": golden, "video_id": str(vid), "index": index}

    def __getitem__(self, index: int):
        return self._walk(index, self._sample)


class ClsVideoDataset(VideoDataset):
    """(clip, title, label) for the category prediction; a row without a
    label gives -1."""

    def __init__(self, ann_file, video_root, transform=None, num_frames=8,
                 max_words=80, train=True, seed=0, **kw):
        ann = _read_annotations(ann_file)
        super().__init__(ann, video_root, transform, num_frames,
                         sample="rand" if train else "middle", seed=seed,
                         **kw)
        self.max_words = max_words
        self.train = train

    def _sample(self, index: int):
        clip = self._load_clip(index)
        a = self.ann[index]
        title = a.get("video_title") or a.get("title") or ""
        label = a.get("category_id", a.get("label", -1))
        return {"video": clip, "text": pre_caption(str(title), self.max_words),
                "label": int(label), "index": index}

    def __getitem__(self, index: int):
        return self._walk(index, self._sample)


class SyntheticVideoDataset:
    """Procedural uint8 (T, H, W, 3) clips with a caption, one per
    index."""

    def __init__(self, length: int = 64, num_frames: int = 8,
                 size: int = 224, num_classes: int = 5):
        self.length = length
        self.num_frames = num_frames
        self.size = size
        self.num_classes = num_classes

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return self.length

    def __getitem__(self, index):
        rng = np.random.default_rng(index)
        t, s = self.num_frames, self.size
        base = rng.integers(0, 255, size=(1, s, s, 3), dtype=np.uint8)
        drift = np.arange(t, dtype=np.int16)[:, None, None, None] * 3
        clip = ((base.astype(np.int16) + drift) % 256).astype(np.uint8)
        label = index % self.num_classes
        return {"video": clip,
                "text": f"synthetic clip {index} class {label}",
                "label": label, "match_id": index, "index": index,
                "golden": [f"synthetic clip {index}"],
                "video_id": str(index)}


class SyntheticRetrievalSplit(SyntheticVideoDataset):
    """A retrieval evaluation split of synthetic clips: ``text`` (clip i's
    caption ``synthetic clip i``), and ``vid2txt`` / ``txt2vid``, each clip
    matching its own text (JAX ``cli/run_retrieval.py:31-40``)."""

    def __init__(self, length: int = 16, num_frames: int = 8,
                 size: int = 224):
        super().__init__(length=length, num_frames=num_frames, size=size)
        self.text = [f"synthetic clip {i}" for i in range(length)]
        self.vid2txt = {i: [i] for i in range(length)}
        self.txt2vid = {i: [i] for i in range(length)}


class QAVideoDataset(VideoDataset):
    """Video question answering (JAX ``datasets.py:350-395``): train
    yields (clip, question, answers, weights), test (clip, question,
    question_id) with ``answer_list`` the candidates; a failed decode
    walks to the next index."""

    def __init__(self, ann_file, video_root, transform=None, num_frames=16,
                 max_ques_words=30, split="train", eos="[SEP]",
                 answer_list="", seed=0, **kw):
        ann = _read_annotations(ann_file)
        super().__init__(ann, video_root, transform, num_frames,
                         sample="rand" if split == "train" else "middle",
                         seed=seed, **kw)
        self.split = split
        self.eos = eos
        self.max_ques_words = 50 if split == "test" else max_ques_words
        self.answer_list = []
        if split == "test" and answer_list:
            if answer_list.endswith(".json"):
                with open(answer_list) as f:
                    self.answer_list = list(json.load(f).keys())
            else:
                self.answer_list = sorted(
                    {x["answer"] for x in load_jsonl(answer_list)})
        for idx, a in enumerate(self.ann):
            a["question_id"] = idx

    def __getitem__(self, index):
        def make(i):
            clip = self._load_clip(i)
            a = self.ann[i]
            question = pre_question(str(a["question"]), self.max_ques_words)
            if self.split == "train":
                return {"video": clip, "question": question,
                        "answers": [str(a["answer"]) + self.eos],
                        "weights": [1.0], "index": i}
            return {"video": clip, "question": question,
                    "question_id": int(a["question_id"]), "index": i}
        return self._walk(index, make)
