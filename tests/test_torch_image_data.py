"""The port's image-era data and evaluation modules against the JAX
package's, bitwise, on the same inputs: the image datasets on JPEGs the
test writes with cv2 (``data/image_datasets.py``), the MIM transform and
its parts per seed (``data/pretrain_transforms.py``),
``data/vg_transforms.py``, ``Refer`` on the fixture of JAX's
``tests/test_refer.py``, ``evals/grounding.py`` and ``evals/vqa.py``,
``QAVideoDataset`` and ``pre_question``, ``LengthBalancedLoader``, and
``remote_io`` against a local ``http.server`` and a fake ``oss2`` module
(as JAX's ``tests/test_remote_io.py``), with a dataset reading its clips
from the fake bucket."""

import http.server
import json
import os
import sys
import threading
import types

import cv2
import numpy as np
import pytest

from tests.test_refer import make_dataset
from youku_mplug_tpu.data import datasets as jds
from youku_mplug_tpu.data import image_datasets as jimg
from youku_mplug_tpu.data import loader as jloader
from youku_mplug_tpu.data import native_decode
from youku_mplug_tpu.data import pretrain_transforms as jpt
from youku_mplug_tpu.data import refer as jrefer
from youku_mplug_tpu.data import remote_io as jremote
from youku_mplug_tpu.data import transforms as jtf
from youku_mplug_tpu.data import vg_transforms as jvg
from youku_mplug_tpu.evals import grounding as jgr
from youku_mplug_tpu.evals import vqa as jvqa
from youku_mplug_tpu_torch.data import datasets as tds
from youku_mplug_tpu_torch.data import image_datasets as timg
from youku_mplug_tpu_torch.data import loader as tloader
from youku_mplug_tpu_torch.data import pretrain_transforms as tpt
from youku_mplug_tpu_torch.data import refer as trefer
from youku_mplug_tpu_torch.data import remote_io as tremote
from youku_mplug_tpu_torch.data import transforms as ttf
from youku_mplug_tpu_torch.data import vg_transforms as tvg
from youku_mplug_tpu_torch.evals import grounding as tgr
from youku_mplug_tpu_torch.evals import vqa as tvqa


@pytest.fixture(autouse=True)
def jax_on_cv2(monkeypatch):
    """JAX's video reader on its cv2 path, as the port's."""
    monkeypatch.setattr(native_decode, "available", lambda: False)


def same(a, b):
    """Equal samples: the same keys, arrays bitwise with their dtype."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


def _image(k, h=90, w=120):
    yy, xx = np.mgrid[:h, :w]
    return np.stack([(xx * 3 + 17 * k) % 256, (yy * 5 + 40 * k) % 256,
                     (xx + yy + 9 * k) % 256], -1).astype(np.uint8)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """JPEGs im0..5.jpg (varied sizes) and one annotation file per
    dataset; missing.jpg is named and absent."""
    d = tmp_path_factory.mktemp("images")
    for k in range(6):
        cv2.imwrite(str(d / f"im{k}.jpg"), _image(k, 80 + 8 * k, 120 - 6 * k))
    files = {
        "it.json": [{"image": "im0.jpg", "caption": "A Cat, on-the mat!"},
                    {"image": "missing.jpg", "caption": "bad"},
                    {"image": "im1.jpg", "caption": ["multi", "Caps two"]},
                    {"image": "im2.jpg", "caption": "x " * 40}],
        "vqa.json": [{"image": "im0.jpg", "question": "What color-is it?",
                      "answer": "gray"},
                     {"image": "im3.jpg", "question": "How many?",
                      "answer": ["two", "2"], "weight": [0.7, 0.3]}],
        "nlvr.json": [{"images": ["im0.jpg", "im1.jpg"],
                       "sentence": "Two dogs/left.", "label": "True"},
                      {"images": ["im2.jpg", "im4.jpg"],
                       "sentence": "none", "label": 0}],
        "ve.json": [{"image": "im5.jpg", "sentence": "A man.",
                     "label": "neutral"},
                    {"image": "im1.jpg", "sentence": "b", "label": 2}],
        "ground.json": [{"image": "im0.jpg", "text": "the LEFT dog",
                         "bbox": [10, 12, 40, 30]},
                        {"image": "im4.jpg", "sentence": "a cat on top",
                         "bbox": [5, 5, 60, 50]},
                        {"image": "im2.jpg", "text": "person",
                         "bbox": [30, 20, 50, 40]}],
    }
    for name, rows in files.items():
        with open(d / name, "w") as f:
            json.dump(rows, f)
    with open(d / "answers.json", "w") as f:
        json.dump(["gray", "two", "red"], f)
    return d


def test_read_image_matches_jax(images):
    for size in (0, 48):
        same(timg.read_image(str(images / "im3.jpg"), size),
             jimg.read_image(str(images / "im3.jpg"), size))
    with pytest.raises(IOError):
        timg.read_image(str(images / "missing.jpg"))


@pytest.mark.parametrize("epoch", [0, 2])
def test_image_text_dataset_bitwise(images, epoch):
    port, jax_ = (timg.ImageTextDataset(str(images / "it.json"),
                                        str(images), transform=tf,
                                        max_words=8, seed=3)
                  for tf in (ttf.train_transform(32),
                             jtf.train_transform(32)))
    for ds in (port, jax_):
        ds.set_epoch(epoch)
    for i in range(len(port)):
        same(port[i], jax_[i])
    assert port[1]["index"] == 2  # past the missing file


def test_image_text_dataset_mim_bitwise(images):
    kw = dict(input_size=64, second_size=32, window_size=4,
              num_mask_patches=6)
    port = timg.ImageTextDataset(str(images / "it.json"), str(images),
                                 mim_transform=tpt.MIMPretrainTransform(
                                     **kw))
    jax_ = jimg.ImageTextDataset(str(images / "it.json"), str(images),
                                 mim_transform=jpt.MIMPretrainTransform(
                                     **kw))
    for i in (0, 2, 3):
        s = port[i]
        same(s, jax_[i])
        assert s["image"].shape == (64, 64, 3)
        assert s["image_target"].shape == (32, 32, 3)
        assert s["bool_masked_pos"].sum() == 6


@pytest.mark.parametrize("split", ["train", "test"])
def test_vqa_image_dataset_bitwise(images, split):
    port, jax_ = (mod.VQAImageDataset(
        str(images / "vqa.json"), str(images), transform=tf, split=split,
        answer_list=str(images / "answers.json"), seed=2)
        for mod, tf in ((timg, ttf.test_transform(24)),
                        (jimg, jtf.test_transform(24))))
    assert port.answer_list == jax_.answer_list
    for i in range(len(port)):
        same(port[i], jax_[i])


def test_nlvr_ve_grounding_legacy_bitwise(images):
    for name, ann in (("NLVRDataset", "nlvr.json"), ("VEDataset", "ve.json"),
                      ("GroundingDataset", "ground.json")):
        port = getattr(timg, name)(str(images / ann), str(images),
                                   transform=ttf.train_transform(24), seed=5)
        jax_ = getattr(jimg, name)(str(images / ann), str(images),
                                   transform=jtf.train_transform(24), seed=5)
        for i in range(len(port)):
            same(port[i], jax_[i])


@pytest.mark.parametrize("train", [True, False])
def test_grounding_dataset_vg_path_bitwise(images, train):
    kw = dict(image_res=48, seed=1, train=train, aug_blur=train,
              aug_translate=train)
    port = timg.GroundingDataset(str(images / "ground.json"), str(images),
                                 **kw)
    jax_ = jimg.GroundingDataset(str(images / "ground.json"), str(images),
                                 **kw)
    for epoch in (0, 1):
        port.set_epoch(epoch)
        jax_.set_epoch(epoch)
        for i in range(len(port)):
            s = port[i]
            same(s, jax_[i])
            assert s["image"].shape == (48, 48, 3)


@pytest.mark.parametrize("num", [1, 75, 118, 196])
def test_blockwise_masking_generator_bitwise(num):
    port = tpt.BlockwiseMaskingGenerator(14, num)
    jax_ = jpt.BlockwiseMaskingGenerator(14, num)
    for seed in range(4):
        m = port(np.random.default_rng(seed))
        same(m, jax_(np.random.default_rng(seed)))
        assert m.sum() == num


def test_mim_transform_and_crop_bitwise():
    clip = np.random.default_rng(0).integers(0, 256, (1, 120, 160, 3),
                                             dtype=np.uint8)
    for seed in range(4):
        same(tpt.TwoResolutionRandomResizedCrop(64, second_size=32)(
            clip, rng=np.random.default_rng(seed)),
            jpt.TwoResolutionRandomResizedCrop(64, second_size=32)(
                clip, rng=np.random.default_rng(seed)))
        for rand_aug in (True, False):
            kw = dict(input_size=224, second_size=112, rand_aug=rand_aug)
            same(tpt.MIMPretrainTransform(**kw)(
                clip, rng=np.random.default_rng(seed)),
                jpt.MIMPretrainTransform(**kw)(
                    clip, rng=np.random.default_rng(seed)))
    out = tpt.MIMPretrainTransform(224, 112)(clip,
                                             rng=np.random.default_rng(9))
    assert out["mask"].shape == (14, 14) and out["mask"].sum() == 75


def test_vg_transforms_bitwise():
    img = _image(3, 96, 128)
    box = np.asarray([20.0, 30.0, 70.0, 80.0], np.float32)
    for fn, args in ((lambda m, *a: m.resize_long_side(*a), (img, box, 64)),
                     (lambda m, *a: m.resize_short_side(*a), (img, box, 64)),
                     (lambda m, *a: m.hflip(*a),
                      (img, box, "the left one, not right")),
                     (lambda m, *a: m.crop(*a), (img, box, 10, 12, 50, 60)),
                     (lambda m, *a: m.normalize_and_pad(*a), (img, box, 160))):
        same(fn(tvg, *args), fn(jvg, *args))
    for seed in range(5):
        for name, args in (("random_size_crop", (img, box, 40, 90)),
                           ("color_jitter", (img,)),
                           ("gaussian_blur", (img,))):
            same(getattr(tvg, name)(*args, rng=np.random.default_rng(seed)),
                 getattr(jvg, name)(*args, rng=np.random.default_rng(seed)))
        same(tvg.normalize_and_pad(img, box, 160, np.random.default_rng(
            seed), aug_translate=True), jvg.normalize_and_pad(
            img, box, 160, np.random.default_rng(seed), aug_translate=True))
        for text in ("a dog", "the dog on the left"):
            kw = dict(aug_blur=True, aug_translate=bool(seed % 2))
            same(tvg.vg_train_transform(64, **kw)(
                img, box, text, np.random.default_rng(seed)),
                jvg.vg_train_transform(64, **kw)(
                    img, box, text, np.random.default_rng(seed)))
    same(tvg.vg_test_transform(64)(img, box, "x"),
         jvg.vg_test_transform(64)(img, box, "x"))


def test_refer_matches_jax(tmp_path):
    root = make_dataset(tmp_path)
    port, jax_ = trefer.Refer(root, "refcoco", "unc"), \
        jrefer.Refer(root, "refcoco", "unc")
    for split in ("", "train", "val", "test", "testA", "testB"):
        same(port.get_ref_ids(split=split), jax_.get_ref_ids(split=split))
    for kw in ({}, {"image_ids": [100]}, {"cat_ids": [1]},
               {"ref_ids": [1, 3]}):
        same(port.get_ref_ids(**kw), jax_.get_ref_ids(**kw))
        same(port.get_ann_ids(**kw), jax_.get_ann_ids(**kw))
    same(sorted(port.get_img_ids(ref_ids=[1, 3])),
         sorted(jax_.get_img_ids(ref_ids=[1, 3])))
    same(list(port.get_cat_ids()), list(jax_.get_cat_ids()))
    for rid in (1, 2, 3, 4):
        same(port.get_ref_box(rid), jax_.get_ref_box(rid))
        same(port.load_refs([rid]), jax_.load_refs([rid]))
    same(port.load_anns([10, 13]), jax_.load_anns([10, 13]))
    same(port.load_imgs([101]), jax_.load_imgs([101]))
    same(port.load_cats([2]), jax_.load_cats([2]))
    same(port.sent_to_tokens, jax_.sent_to_tokens)
    same(port.getRefIds(split="val"), jax_.getRefIds(split="val"))
    same(port.refToAnn[4], jax_.refToAnn[4])
    same(port.imgToRefs[100], jax_.imgToRefs[100])


def test_grounding_eval_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    a = np.concatenate([rng.uniform(0, 0.5, (6, 2)),
                        rng.uniform(0.1, 0.5, (6, 2))], 1).astype(np.float32)
    b = a + rng.normal(0, 0.05, a.shape).astype(np.float32)
    for fn in ("cxcywh_to_xyxy", "xyxy_to_cxcywh"):
        same(getattr(tgr, fn)(a), getattr(jgr, fn)(a))
    xa, xb = tgr.cxcywh_to_xyxy(a), tgr.cxcywh_to_xyxy(b)
    same(tgr.box_iou(xa, xb), jgr.box_iou(xa, xb))
    same(tgr.generalized_box_iou(xa, xb), jgr.generalized_box_iou(xa, xb))
    same(tgr.grounding_accuracy(a, b), jgr.grounding_accuracy(a, b))
    root = make_dataset(tmp_path)
    dets = {"100": [[2, 3, 20, 24, 0.9], [40, 8, 16, 30, 0.8]],
            "101": [[10, 20, 30, 20, 0.9], [0, 0, 10, 10, 0.5]],
            "102": [[0, 0, 32, 24, 0.9], [32, 24, 30, 20, 0.5]]}
    results = [{"ref_id": r, "pred": rng.random((24, 24)).astype(
        np.float32)} for r in (1, 2, 3, 4)]
    for alpha in (0.25, 0.5):
        same(tgr.grounding_eval_masks(results, dets, trefer.Refer(root),
                                      alpha),
             jgr.grounding_eval_masks(results, dets, jrefer.Refer(root),
                                      alpha))
    m = np.zeros((48, 64), np.float32)
    m[8:38, 40:56] = 1.0
    same(tgr.rank_detections(m, dets["100"], 0.5),
         jgr.rank_detections(m, dets["100"], 0.5))


def test_vqa_eval_matches_jax():
    answers = ["A Dog!", "two", "isnt", "1,000", "the cat's  toy.",
               "3.5", "none\tat all", "yes-no", "an apple"]
    for a in answers:
        assert tvqa.normalize_answer(a) == jvqa.normalize_answer(a)
    preds = {0: "dog", 1: "cat", 2: "Two", 3: "x"}
    anns = {0: ["dog"] * 10, 1: ["dog"] * 7 + ["cat"] * 3,
            2: ["2"] * 4 + ["3"] * 6, 4: ["y"]}
    assert tvqa.vqa_accuracy(preds, anns) == jvqa.vqa_accuracy(preds, anns)


def _write_clip(path, k, n=12, size=(48, 40)):
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 8, size)
    yy, xx = np.mgrid[:size[1], :size[0]]
    for i in range(n):
        w.write(np.stack([(xx * 4 + 40 * k) % 256, (yy * 5 + 3 * i) % 256,
                          (xx + yy + 7 * k) % 256], -1).astype(np.uint8))
    w.release()


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("qa_clips")
    for k in range(3):
        _write_clip(d / f"vid{k}.mp4", k)
    rows = [{"video_id": "vid0.mp4", "question": "What IS this?!",
             "answer": "a test"},
            {"video_id": "broken.mp4", "question": "x/y-z", "answer": "q"},
            {"video_id": "vid2.mp4", "question": "color?", "answer": "gray"}]
    with open(d / "qa.jsonl", "w") as f:
        f.write("\n".join(json.dumps(r) for r in rows) + "\n")
    return d


@pytest.mark.parametrize("split", ["train", "test"])
def test_qa_video_dataset_bitwise(clips, split):
    kw = dict(num_frames=3, split=split, seed=4,
              answer_list=str(clips / "qa.jsonl"))
    port = tds.QAVideoDataset(str(clips / "qa.jsonl"), str(clips),
                              transform=ttf.train_transform(24), **kw)
    jax_ = jds.QAVideoDataset(str(clips / "qa.jsonl"), str(clips),
                              transform=jtf.train_transform(24), **kw)
    assert port.answer_list == jax_.answer_list
    for i in range(len(port)):
        same(port[i], jax_[i])
    assert port[1]["index"] == 2  # past the broken clip


def test_pre_question_matches_jax():
    for q in ("What IS this?!", "a-b/c  d ", "x " * 40, "中文？ yes."):
        for n in (0, 3, 30):
            assert tds.pre_question(q, n) == jds.pre_question(q, n)


def test_length_balanced_loader_matches_jax():
    class Lengths(tds.SyntheticVideoDataset):
        def get_item_length(self, i):
            return (i * 37) % 50

    class JLengths(jds.SyntheticVideoDataset):
        def get_item_length(self, i):
            return (i * 37) % 50

    port = tloader.LengthBalancedLoader(Lengths(length=83, num_frames=1,
                                                size=4), 4, num_bucket=5,
                                        seed=2)
    jax_ = jloader.LengthBalancedLoader(JLengths(length=83, num_frames=1,
                                                 size=4), 4, num_bucket=5,
                                        seed=2, num_workers=1,
                                        process_index=0, process_count=1)
    for epoch in (0, 1):
        port.set_epoch(epoch)
        jax_.set_epoch(epoch)
        assert len(port) == len(jax_)
        got = [b["index"] for b in port]
        want = [b["index"] for b in jax_]
        same(got, want)
    lengths = [(i * 37) % 50 for i in range(83)]
    for rank in range(3):
        same(tloader.length_balanced_shard_indices(lengths, 1, rank, 3, 4, 7),
             jloader.length_balanced_shard_indices(lengths, 1, rank, 3, 4, 7))


@pytest.fixture
def fake_oss2(monkeypatch):
    """An in-memory ``oss2``, for both packages' remote_io."""
    store = {}

    class _Obj:
        def __init__(self, data):
            self._d = data

        def read(self):
            return self._d

    class Auth:
        def __init__(self, ak, sk):
            self.ak, self.sk = ak, sk

    class Bucket:
        def __init__(self, auth, endpoint, name):
            assert auth.ak and auth.sk and endpoint
            self.name = name

        def get_object(self, key):
            if (self.name, key) not in store:
                raise KeyError(key)
            return _Obj(store[(self.name, key)])

    mod = types.ModuleType("oss2")
    mod.Auth, mod.Bucket = Auth, Bucket
    monkeypatch.setitem(sys.modules, "oss2", mod)
    for rio in (tremote, jremote):
        rio._BUCKETS.clear()
        rio.configure_oss({"vids": {"AK": "k", "SK": "s",
                                    "ENDPOINT": "http://e"}})
    yield store
    for rio in (tremote, jremote):
        rio._BUCKETS.clear()
        rio._OSS_INFO.clear()


def test_remote_io_oss_matches_jax(fake_oss2, tmp_path, monkeypatch):
    fake_oss2[("vids", "a/b.mp4")] = b"hello-video"
    for rio in (tremote, jremote):
        assert rio.is_remote("oss://b/k.mp4") and not rio.is_remote("/x")
        assert rio.read_bytes("oss://vids/a/b.mp4") == b"hello-video"
        # the bucket's KeyError is a configuration error: not retried
        with pytest.raises(KeyError):
            rio.read_bytes("oss://vids/none.mp4", retries=2, backoff=0.0)
        with pytest.raises(IOError, match="after 2 tries"):
            rio.read_bytes(str(tmp_path / "absent.bin"), retries=2,
                           backoff=0.0)
    port = tremote.fetch("oss://vids/a/b.mp4", cache_dir=str(tmp_path / "t"))
    jax_ = jremote.fetch("oss://vids/a/b.mp4", cache_dir=str(tmp_path / "j"))
    assert os.path.basename(port) == os.path.basename(jax_)
    assert open(port, "rb").read() == b"hello-video"
    tremote.evict("oss://vids/a/b.mp4", cache_dir=str(tmp_path / "t"))
    assert not os.path.exists(port)
    for v in ("OSS_ACCESS_KEY_ID", "OSS_ACCESS_KEY_SECRET", "OSS_ENDPOINT"):
        monkeypatch.delenv(v, raising=False)
    with pytest.raises(KeyError, match="no credentials"):
        tremote.read_bytes("oss://unknown-bucket/k.mp4")
    monkeypatch.setitem(sys.modules, "oss2", None)
    tremote._BUCKETS.clear()
    with pytest.raises(ImportError, match="oss2"):
        tremote.read_bytes("oss://vids/a/b.mp4")


def test_remote_io_http_matches_jax(tmp_path):
    (tmp_path / "v.bin").write_bytes(b"HTTPDATA")

    class H(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **k):
            super().__init__(*a, directory=str(tmp_path), **k)

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/v.bin"
        assert tremote.read_bytes(url) == jremote.read_bytes(url)
        p = tremote.fetch(url, cache_dir=str(tmp_path / "c"))
        assert open(p, "rb").read() == b"HTTPDATA"
        assert tremote.fetch(url, cache_dir=str(tmp_path / "c")) == p
        assert tremote.fetch(str(tmp_path / "v.bin")) == str(
            tmp_path / "v.bin")
    finally:
        srv.shutdown()
        srv.server_close()


def test_dataset_remote_root_matches_jax(fake_oss2, clips, tmp_path,
                                         monkeypatch):
    """A PretrainVideoDataset on an oss:// root decodes each clip through
    the spool cache, the same samples as JAX's."""
    for k in range(3):
        fake_oss2[("vids", f"c/vid{k}.mp4")] = (clips / f"vid{k}.mp4"
                                                ).read_bytes()
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps([{"video_id": f"vid{k}.mp4",
                                "caption": f"clip {k}"} for k in range(3)]))
    monkeypatch.setattr(tremote, "DEFAULT_CACHE", str(tmp_path / "ts"))
    monkeypatch.setattr(jremote, "DEFAULT_CACHE", str(tmp_path / "js"))
    port = tds.PretrainVideoDataset(str(ann), "oss://vids/c/", num_frames=2,
                                    transform=ttf.test_transform(16))
    jax_ = jds.PretrainVideoDataset(str(ann), "oss://vids/c/", num_frames=2,
                                    transform=jtf.test_transform(16))
    for i in range(3):
        same(port[i], jax_[i])
    assert len(os.listdir(tmp_path / "ts")) == 3
