"""Counterpart of ``youku_mplug_tpu/data/image_datasets.py``: the same
samples, bit for bit, from the port's copies of the annotation reader,
``pre_caption`` / ``pre_question`` and the transforms.

Image-text datasets (the legacy image path of the reference).

Covers the annotation formats of reference dataset/caption_dataset.py
(pretrain_dataset_4m: json lists of {"image", "caption"}; re_train/eval
retrieval) and dataset/vqa_dataset.py ({"image", "question", "answer"}),
decoding stills with cv2 and reusing the clip transforms on single-frame
"clips" so the augment stack is shared with the video path.
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from youku_mplug_tpu_torch.data.datasets import (
    _read_annotations,
    pre_caption,
    pre_question,
)


def read_image(path: str, size: int = 0) -> np.ndarray:
    """-> (H, W, C) uint8 RGB."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f"cannot read image: {path}")
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if size:
        img = cv2.resize(img, (size, size), interpolation=cv2.INTER_CUBIC)
    return img


class ImageTextDataset:
    """(image, caption) pretrain pairs (reference pretrain_dataset_4m,
    caption_dataset.py) with next-index retry."""

    def __init__(self, ann_file, image_root: str = "", transform=None,
                 max_words: int = 30, seed: int = 0, mim_transform=None):
        self.ann = _read_annotations(ann_file, id_key="image")
        self.image_root = image_root
        self.transform = transform
        self.mim_transform = mim_transform
        self.max_words = max_words
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return len(self.ann)

    def _rng(self, index):
        return np.random.default_rng(
            (self.seed * 1_000_003 + self.epoch) * 2_654_435_761 + index)

    def __getitem__(self, index: int):
        orig = index
        for _ in range(len(self)):
            a = self.ann[index]
            path = os.path.join(self.image_root,
                                str(a.get("image") or a.get("video_id")))
            try:
                img = read_image(path)
                clip = img[None]  # 1-frame "clip" for the shared transforms
                cap = a.get("caption")
                if isinstance(cap, list):
                    cap = cap[self._rng(index).integers(0, len(cap))]
                cap = pre_caption(str(cap), self.max_words)
                if self.mim_transform is not None:
                    # COCA/MIM path (reference DataAugmentationForPretrain):
                    # two-resolution shared-box crop + blockwise patch mask
                    out = self.mim_transform(clip, rng=self._rng(index))
                    return {"image": out["patches"][0],
                            "image_target": out["visual_tokens"][0],
                            "bool_masked_pos": out["mask"].reshape(-1),
                            "text": cap, "index": index}
                if self.transform is not None:
                    clip = self.transform(clip, rng=self._rng(index))
                return {"image": clip[0],
                        "text": cap,
                        "index": index}
            except Exception:
                index = 0 if index == len(self) - 1 else index + 1
                if index == orig:
                    break
        raise IOError("all image reads failed")


class VQAImageDataset:
    """VQA triplets (reference dataset/vqa_dataset.py): train yields
    (image, question, answers, weights); test yields
    (image, question, question_id)."""

    def __init__(self, ann_file, image_root: str = "", transform=None,
                 split: str = "train", max_ques_words: int = 30,
                 answer_list: str = "", eos: str = "[SEP]", seed: int = 0):
        self.ann = _read_annotations(ann_file, id_key="image")
        self.image_root = image_root
        self.transform = transform
        self.split = split
        self.max_ques_words = 50 if split == "test" else max_ques_words
        self.eos = eos
        self.seed = seed
        self.epoch = 0
        self.answer_list: List[str] = []
        if split == "test" and answer_list:
            self.answer_list = json.load(open(answer_list)) \
                if answer_list.endswith(".json") else \
                [l.strip() for l in open(answer_list)]
        for i, a in enumerate(self.ann):
            a.setdefault("question_id", i)

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return len(self.ann)

    def __getitem__(self, index: int):
        a = self.ann[index]
        img = read_image(os.path.join(self.image_root, str(a["image"])))
        clip = img[None]
        if self.transform is not None:
            rng = np.random.default_rng(self.seed + index)
            clip = self.transform(clip, rng=rng)
        question = pre_question(str(a["question"]), self.max_ques_words)
        if self.split == "train":
            answers = a.get("answer")
            answers = answers if isinstance(answers, list) else [answers]
            weights = a.get("weight", [1.0 / len(answers)] * len(answers))
            return {"image": clip[0], "question": question,
                    "answers": [str(x) + self.eos for x in answers],
                    "weights": list(weights), "index": index}
        return {"image": clip[0], "question": question,
                "question_id": int(a["question_id"]), "index": index}


class NLVRDataset:
    """NLVR2 (two images + statement -> bool; reference
    dataset/nlvr_dataset.py): json of {"images": [a, b], "sentence",
    "label": "True"/"False"}."""

    def __init__(self, ann_file, image_root: str = "", transform=None,
                 max_words: int = 30, seed: int = 0):
        self.ann = _read_annotations(ann_file, id_key="images")
        self.image_root = image_root
        self.transform = transform
        self.max_words = max_words
        self.seed = seed

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return len(self.ann)

    def __getitem__(self, index):
        a = self.ann[index]
        rng = np.random.default_rng(self.seed + index)
        imgs = []
        for rel in a["images"]:
            img = read_image(os.path.join(self.image_root, str(rel)))[None]
            if self.transform is not None:
                img = self.transform(img, rng=rng)
            imgs.append(img[0])
        label = a["label"]
        label = int(label) if not isinstance(label, str) else \
            int(str(label).lower() == "true")
        return {"image0": imgs[0], "image1": imgs[1],
                "text": pre_caption(str(a["sentence"]), self.max_words),
                "label": label, "index": index}


class VEDataset:
    """SNLI-VE (image + hypothesis -> entail/neutral/contradict; reference
    dataset/ve_dataset.py): {"image", "sentence", "label"}."""

    LABELS = {"entailment": 0, "neutral": 1, "contradiction": 2}

    def __init__(self, ann_file, image_root: str = "", transform=None,
                 max_words: int = 30, seed: int = 0):
        self.ann = _read_annotations(ann_file, id_key="image")
        self.image_root = image_root
        self.transform = transform
        self.max_words = max_words
        self.seed = seed

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return len(self.ann)

    def __getitem__(self, index):
        a = self.ann[index]
        rng = np.random.default_rng(self.seed + index)
        img = read_image(os.path.join(self.image_root, str(a["image"])))
        clip = img[None]
        if self.transform is not None:
            clip = self.transform(clip, rng=rng)
        label = a["label"]
        label = self.LABELS.get(str(label), label)
        return {"image": clip[0],
                "text": pre_caption(str(a["sentence"]), self.max_words),
                "label": int(label), "index": index}


class GroundingDataset:
    """Referring-expression grounding (reference
    dataset/grounding_dataset.py): {"image", "text"/"sentence",
    "bbox": [x, y, w, h]}.

    train=True runs the reference's box-aware augmentation pipeline
    (vg_transforms: scale jitter / box-preserving crop / hflip with
    left-right word swap / color jitter / mean-pad to square); eval is a
    deterministic long-side resize + center pad.  Targets come out as
    cxcywh normalized to the padded square, plus the pad mask."""

    def __init__(self, ann_file, image_root: str = "", transform=None,
                 image_res: int = 224, max_words: int = 30, seed: int = 0,
                 train: bool = False, aug_scale: bool = True,
                 aug_crop: bool = True, aug_blur: bool = False,
                 aug_translate: bool = False):
        from youku_mplug_tpu_torch.data.vg_transforms import (
            vg_test_transform,
            vg_train_transform,
        )

        self.ann = _read_annotations(ann_file, id_key="image")
        self.image_root = image_root
        self.transform = transform  # legacy clip-transform override
        self.image_res = image_res
        self.max_words = max_words
        self.seed = seed
        self.train = train
        self.epoch = 0
        self.vg_transform = (
            vg_train_transform(image_res, aug_scale=aug_scale,
                               aug_crop=aug_crop, aug_blur=aug_blur,
                               aug_translate=aug_translate)
            if train else vg_test_transform(image_res))

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return len(self.ann)

    def __getitem__(self, index):
        a = self.ann[index]
        rng = np.random.default_rng(
            (self.seed + index) * (self.epoch + 1) if self.train
            else self.seed + index)
        img = read_image(os.path.join(self.image_root, str(a["image"])))
        text = pre_caption(str(a.get("text") or a.get("sentence") or ""),
                           self.max_words)
        x, y, w, h = a["bbox"]
        if self.transform is not None:
            # legacy path: plain clip transform, box relative to original
            h0, w0 = img.shape[:2]
            clip = self.transform(img[None], rng=rng)
            box = np.asarray([(x + w / 2) / w0, (y + h / 2) / h0,
                              w / w0, h / h0], np.float32)
            return {"image": clip[0], "text": text, "box": box,
                    "index": index}
        box_xyxy = np.asarray([x, y, x + w, y + h], np.float32)
        img, mask, box, text = self.vg_transform(img, box_xyxy, text, rng)
        return {"image": img, "pad_mask": mask, "text": text,
                "box": box, "index": index}
