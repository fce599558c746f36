"""Counterpart of ``youku_mplug_tpu/data/refer.py``, a copy of the JAX
package's module (the standard library only).

RefCOCO/RefCOCO+/RefCOCOg referring-expression dataset API.

Same on-disk contract as the reference's refTools/refer_python3.py:1-252
(REFER class): a ``<root>/<dataset>/refs(<split_by>).p`` pickle of ref
records and a ``<root>/<dataset>/instances.json`` with COCO-style
images/annotations/categories.  The query surface is re-designed as a
plain indexed store (snake_case methods; the reference's camelCase
names are kept as aliases so its recipes run unchanged) — no plotting
or skimage baggage, no module-level prints.

A ref record:  {ref_id, ann_id, image_id, category_id, split,
sentences: [{sent_id, sent, tokens}, ...]}.
"""

from __future__ import annotations

import itertools
import json
import os
import pickle


class Refer:
    """Indexed access to refs / anns / images / categories / sentences."""

    def __init__(self, data_root: str, dataset: str = "refcoco",
                 split_by: str = "unc"):
        if dataset not in ("refcoco", "refcoco+", "refcocog", "refclef"):
            raise ValueError(f"unknown refer dataset {dataset!r}")
        self.dataset = dataset
        data_dir = os.path.join(data_root, dataset)
        if dataset == "refclef":
            self.image_dir = os.path.join(data_root, "images/saiapr_tc-12")
        else:
            self.image_dir = os.path.join(
                data_root, "images/mscoco/images/train2014")

        with open(os.path.join(data_dir, f"refs({split_by}).p"), "rb") as f:
            self.refs_list = pickle.load(f)
        with open(os.path.join(data_dir, "instances.json")) as f:
            inst = json.load(f)
        self.anns_list = inst["annotations"]

        self.anns = {a["id"]: a for a in inst["annotations"]}
        self.imgs = {i["id"]: i for i in inst["images"]}
        self.cats = {c["id"]: c["name"] for c in inst["categories"]}
        self.img_to_anns: dict = {}
        for a in inst["annotations"]:
            self.img_to_anns.setdefault(a["image_id"], []).append(a)

        self.refs: dict = {}
        self.img_to_refs: dict = {}
        self.cat_to_refs: dict = {}
        self.ref_to_ann: dict = {}
        self.ann_to_ref: dict = {}
        self.sents: dict = {}
        self.sent_to_ref: dict = {}
        self.sent_to_tokens: dict = {}
        for ref in self.refs_list:
            rid = ref["ref_id"]
            self.refs[rid] = ref
            self.img_to_refs.setdefault(ref["image_id"], []).append(ref)
            self.cat_to_refs.setdefault(ref["category_id"], []).append(ref)
            self.ref_to_ann[rid] = self.anns[ref["ann_id"]]
            self.ann_to_ref[ref["ann_id"]] = ref
            for sent in ref["sentences"]:
                self.sents[sent["sent_id"]] = sent
                self.sent_to_ref[sent["sent_id"]] = ref
                self.sent_to_tokens[sent["sent_id"]] = sent["tokens"]

    # ------------------------------------------------------------------

    @staticmethod
    def _as_list(x):
        return x if isinstance(x, (list, tuple)) else [x]

    def get_ref_ids(self, image_ids=(), cat_ids=(), ref_ids=(),
                    split: str = ""):
        """Filter refs; split follows the reference's conventions
        (testA/testB/testC match by final letter, 'test' by prefix)."""
        image_ids = self._as_list(image_ids)
        cat_ids = self._as_list(cat_ids)
        ref_ids = self._as_list(ref_ids)
        if image_ids:
            refs = list(itertools.chain.from_iterable(
                self.img_to_refs.get(i, []) for i in image_ids))
        else:
            refs = self.refs_list
        if cat_ids:
            refs = [r for r in refs if r["category_id"] in cat_ids]
        if ref_ids:
            refs = [r for r in refs if r["ref_id"] in ref_ids]
        if split:
            if split in ("testA", "testB", "testC"):
                refs = [r for r in refs if split[-1] in r["split"]]
            elif split in ("testAB", "testBC", "testAC"):
                refs = [r for r in refs if r["split"] == split]
            elif split == "test":
                refs = [r for r in refs if r["split"].startswith("test")]
            elif split in ("train", "val"):
                refs = [r for r in refs if r["split"] == split]
            else:
                raise ValueError(f"no such split {split!r}")
        return [r["ref_id"] for r in refs]

    def get_ann_ids(self, image_ids=(), cat_ids=(), ref_ids=()):
        image_ids = self._as_list(image_ids)
        cat_ids = self._as_list(cat_ids)
        ref_ids = self._as_list(ref_ids)
        if image_ids:
            anns = list(itertools.chain.from_iterable(
                self.img_to_anns.get(i, []) for i in image_ids))
        else:
            anns = self.anns_list
        if cat_ids:
            anns = [a for a in anns if a["category_id"] in cat_ids]
        ids = [a["id"] for a in anns]
        if ref_ids:
            keep = {self.refs[r]["ann_id"] for r in ref_ids}
            ids = [i for i in ids if i in keep]
        return ids

    def get_img_ids(self, ref_ids=()):
        ref_ids = self._as_list(ref_ids)
        if ref_ids:
            return sorted({self.refs[r]["image_id"] for r in ref_ids})
        return list(self.imgs.keys())

    def get_cat_ids(self):
        return list(self.cats.keys())

    def load_refs(self, ref_ids):
        return [self.refs[r] for r in self._as_list(ref_ids)]

    def load_anns(self, ann_ids):
        return [self.anns[a] for a in self._as_list(ann_ids)]

    def load_imgs(self, image_ids):
        return [self.imgs[i] for i in self._as_list(image_ids)]

    def load_cats(self, cat_ids):
        return [self.cats[c] for c in self._as_list(cat_ids)]

    def get_ref_box(self, ref_id):
        """[x, y, w, h] of the referred object's annotation."""
        return self.ref_to_ann[ref_id]["bbox"]

    # reference-compatible camelCase surface (refer_python3.py API)
    getRefIds = get_ref_ids
    getAnnIds = get_ann_ids
    getImgIds = get_img_ids
    getCatIds = get_cat_ids
    loadRefs = load_refs
    loadAnns = load_anns
    loadImgs = load_imgs
    loadCats = load_cats
    getRefBox = get_ref_box

    # attribute aliases matching the reference's index names
    @property
    def Refs(self):
        return self.refs

    @property
    def Anns(self):
        return self.anns

    @property
    def Imgs(self):
        return self.imgs

    @property
    def Cats(self):
        return self.cats

    @property
    def refToAnn(self):
        return self.ref_to_ann

    @property
    def imgToRefs(self):
        return self.img_to_refs


REFER = Refer  # reference class name
