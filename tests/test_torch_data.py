"""The port's file-backed input path against the JAX package's, on clips
the tests write: the frame samplers, cv2 decoding (JAX held on its cv2
path, so both decode through the same library), the clip transforms,
the four video datasets, the instruct jsonl dataset, the threaded
``Loader`` against ``ShardedLoader`` on one process, and ``MetaLoader``.
All bitwise, but for the port's CSV repair, shown beside JAX's rows."""

import json
import os
import tarfile
import threading

import cv2
import numpy as np
import pytest

from youku_mplug_tpu.data import datasets as jds
from youku_mplug_tpu.data import instruct as jinstruct
from youku_mplug_tpu.data import loader as jloader
from youku_mplug_tpu.data import native_decode
from youku_mplug_tpu.data import samplers as jsamplers
from youku_mplug_tpu.data import transforms as jtf
from youku_mplug_tpu.data import video_decode as jvd
from youku_mplug_tpu_torch.data import datasets as tds
from youku_mplug_tpu_torch.data import instruct as tinstruct
from youku_mplug_tpu_torch.data import loader as tloader
from youku_mplug_tpu_torch.data import samplers as tsamplers
from youku_mplug_tpu_torch.data import transforms as ttf
from youku_mplug_tpu_torch.data import video_decode as tvd

N_CLIPS = 6
N_FRAMES = 25


@pytest.fixture(autouse=True)
def jax_on_cv2(monkeypatch):
    """JAX's read_frames decodes through libav where its native reader
    loads, which differs from cv2 by up to 2 a channel: hold it on cv2."""
    monkeypatch.setattr(native_decode, "available", lambda: False)


def write_clip(path, k, n=N_FRAMES, size=(64, 48), fourcc="mp4v"):
    """A clip whose frame i has a band of grey level 9 i and a textured
    rest (so that the augment ops have something to move)."""
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), 10, size)
    yy, xx = np.mgrid[:size[1], :size[0]]
    for i in range(n):
        frame = np.stack([(xx * 4 + k * 40) % 256, (yy * 5 + i * 3) % 256,
                          (xx + yy + 7 * k) % 256], -1).astype(np.uint8)
        frame[:8] = (i * 9) % 256
        w.write(frame)
    w.release()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Clips vid0..5.mp4 (one broken), a tar holding two of them, and one
    annotation file per format."""
    d = tmp_path_factory.mktemp("videos")
    for k in range(N_CLIPS):
        write_clip(str(d / f"vid{k}.mp4"), k)
    (d / "broken.mp4").write_bytes(b"not a video")
    with tarfile.open(d / "pack.tar", "w") as tf:
        for k in (1, 2):
            tf.add(d / f"vid{k}.mp4", arcname=f"clips/vid{k}.mp4")
    caps = ["A dog runs, fast!", "a cat-sleeps", "一只猫在睡觉", "Two/three",
            "the end.", "(x) y"]
    (d / "pretrain.csv").write_text(
        "video_id:FILE,title\n"
        + "".join(f"vid{k}.mp4,{c.replace(',', ' ')}\n"
                  for k, c in enumerate(caps)))
    (d / "pretrain.json").write_text(json.dumps(
        [{"video_id": f"vid{k}", "caption": c} for k, c in enumerate(caps)]
        + [{"video_id": "vid3.mp4", "caption": "timed", "start_time": 0.5,
            "end_time": 2.0}]))
    (d / "caption.jsonl").write_text("".join(
        json.dumps({"video_id": f"vid{k}.mp4", "golden_caption":
                    [c, c.upper()] if k % 2 else c}, ensure_ascii=False)
        + "\n" for k, c in enumerate(caps)))
    (d / "cls.csv").write_text(
        "video_id:FILE,video_title,category_id\n"
        + "".join(f"vid{k}.mp4,标题{k},{k % 3}\n" for k in range(N_CLIPS)))
    (d / "cls.jsonl").write_text("".join(
        json.dumps({"video_id": f"vid{k}.mp4", "video_title": f"t {k}",
                    "label": k % 4}) + "\n" for k in range(N_CLIPS)))
    (d / "retrieval.jsonl").write_text("".join(
        json.dumps({"clip_name": f"vid{k}.mp4",
                    "caption": [caps[k], caps[(k + 1) % N_CLIPS]]
                    if k == 2 else caps[k % 4]}) + "\n"
        for k in range(N_CLIPS)))
    # the broken file second: the walk and the resample step over it
    (d / "with_broken.jsonl").write_text("".join(
        json.dumps({"video_id": v, "caption": f"c {i}", "clip_name": v,
                    "video_title": f"t {i}", "category_id": i})
        + "\n" for i, v in enumerate(["vid0.mp4", "broken.mp4", "vid1.mp4",
                                      "vid2.mp4"])))
    (d / "numeric.csv").write_text(
        "video_id:FILE,title\n" + "".join(f"{k},cap {k}\n"
                                          for k in range(1, 4)))
    for k in range(1, 4):
        os.link(d / f"vid{k}.mp4", d / f"{k}.mp4")
    (d / "instruct.jsonl").write_text("".join(
        json.dumps({"video": f"vid{k}.mp4", "question": f"what is {k}?",
                    "answer": f"clip {k}"}) + "\n" for k in range(4))
        + json.dumps({"video": "vid4.mp4", "prompt": "Human: <|video|>\nAI: ",
                      "answer": "x"}) + "\n")
    return d


# --------------------------------------------------------------- samplers


SAMPLER_CASES = [  # (num_frames, vlen, sample, fix_start, fps, max_frames)
    (4, 100, "rand", None, 1.0, -1), (8, 3, "rand", None, 1.0, -1),
    (4, 5, "rand", None, 1.0, -1), (4, 100, "middle", None, 1.0, -1),
    (8, 3, "middle", None, 1.0, -1), (4, 100, "rand", 2, 1.0, -1),
    (4, 100, "fps0.5", None, 10.0, 3), (4, 250, "fps2", None, 25.0, -1),
    (4, 100, "interval", None, 30.0, -1), (1, 100, "interval", None, 1.0, -1),
    (16, 40, "interval", None, 25.0, -1)]


@pytest.mark.parametrize("case", SAMPLER_CASES, ids=str)
def test_get_frame_indices_equal(case):
    n, vlen, sample, fix_start, fps, max_frames = case
    for seed in range(3):
        got = tsamplers.get_frame_indices(
            n, vlen, sample, fix_start, fps, max_frames,
            rng=np.random.default_rng(seed))
        want = jsamplers.get_frame_indices(
            n, vlen, sample, fix_start, fps, max_frames,
            rng=np.random.default_rng(seed))
        assert got == want


@pytest.mark.parametrize("case", [(4, 100, 10.0, 1.0, 5.0),
                                  (8, 20, 10.0, 0.5, 0.9),
                                  (4, 30, 25.0, 2.0, 9.0)], ids=str)
def test_get_frame_indices_start_end_equal(case):
    n, vlen, fps, start, end = case
    for seed in range(3):
        assert tsamplers.get_frame_indices_start_end(
            n, vlen, fps, start, end, rng=np.random.default_rng(seed)) == \
            jsamplers.get_frame_indices_start_end(
                n, vlen, fps, start, end, rng=np.random.default_rng(seed))


def test_unknown_sample_mode_raises():
    with pytest.raises(ValueError, match="unknown sample mode"):
        tsamplers.get_frame_indices(4, 10, "bogus")


# ---------------------------------------------------------------- decoding


READ_CASES = [dict(sample="middle"), dict(sample="rand"),
              dict(sample="fps5", max_num_frames=6),
              dict(short_side=32), dict(width=40, height=30),
              dict(start_time=0.5, end_time=1.8), dict(num_frames=40)]


@pytest.mark.parametrize("kw", READ_CASES, ids=str)
def test_read_frames_bitwise(files, kw):
    kw = {"num_frames": 4, **kw}
    path = str(files / "vid3.mp4")
    got = tvd.read_frames(path, rng=np.random.default_rng(7), **kw)
    want = jvd.read_frames(path, rng=np.random.default_rng(7), **kw)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_read_frames_decodes_the_sampled_frames(files):
    """Each frame's band holds its index: the sampler's indices are the
    frames decoded, within mp4v's error."""
    idx = tsamplers.get_frame_indices(6, N_FRAMES, "middle")
    frames = tvd.read_frames(str(files / "vid2.mp4"), 6, "middle")
    bands = frames[:, 2:6, :, :].astype(np.float64).mean((1, 2, 3))
    np.testing.assert_allclose(bands, np.asarray(idx) * 9.0, atol=3.0)


def test_read_frames_tar_member(files, tmp_path, monkeypatch):
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    path = str(files / "pack.tar") + "/clips/vid2.mp4"
    got = tvd.read_frames(path, 4, "rand", rng=np.random.default_rng(3))
    want = jvd.read_frames(path, 4, "rand", rng=np.random.default_rng(3))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tvd.read_frames(
        str(files / "vid2.mp4"), 4, "rand", rng=np.random.default_rng(3)))
    cache = tmp_path / tvd.TAR_CACHE
    assert [p.name for p in cache.rglob("*.mp4")] == ["vid2.mp4"]


def test_short_side_dims_equal():
    for h, w, s in ((48, 64, 32), (64, 48, 32), (48, 64, 48), (360, 640,
                                                              288), (9, 9,
                                                                     0)):
        assert tvd._short_side_dims(h, w, s) == jvd._short_side_dims(h, w, s)


def test_unreadable_file_raises(files):
    with pytest.raises(IOError, match="cannot open video"):
        tvd.read_frames(str(files / "broken.mp4"))


# -------------------------------------------------------------- transforms


def _clip(seed=0, t=3, h=48, w=64):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([xx * 3, yy * 5, xx + yy], -1)[None]
    noise = rng.integers(0, 40, size=(t, h, w, 3))
    return ((base + noise) % 256).astype(np.uint8)


@pytest.mark.parametrize("name", sorted(jtf.AUG_OPS))
@pytest.mark.parametrize("level", [0, 3, 5, 10])
def test_augment_ops_bitwise(name, level):
    frame = _clip()[0]
    fn, arg = ttf.AUG_OPS[name]
    jfn, jarg = jtf.AUG_OPS[name]
    assert arg(level) == jarg(level)
    np.testing.assert_array_equal(fn(frame.copy(), *arg(level)),
                                  jfn(frame.copy(), *jarg(level)))


TRANSFORMS = {
    "randaugment": lambda m: m.TemporalConsistentRandAugment(n=2, m=5),
    "randaugment_train_ops": lambda m: m.TemporalConsistentRandAugment(
        n=3, m=7, augs=m.RAND_TRANSFORMS),
    "resized_crop": lambda m: m.RandomResizedCrop(32),
    "resized_crop_narrow": lambda m: m.RandomResizedCrop(
        (24, 40), scale=(0.9, 1.0), ratio=(3.0, 4.0),
        interpolation="bilinear"),
    "flip": lambda m: m.RandomHorizontalFlip(0.5),
    "resize": lambda m: m.Resize(24, "nearest"),
    "center_crop": lambda m: m.CenterCrop((20, 30)),
    "train": lambda m: m.train_transform(32),
    "test": lambda m: m.test_transform(32),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_clip_transforms_bitwise(name):
    port, jax_ = TRANSFORMS[name](ttf), TRANSFORMS[name](jtf)
    for seed in range(4):
        clip = _clip(seed)
        got = port(clip.copy(), rng=np.random.default_rng(seed))
        want = jax_(clip.copy(), rng=np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["const", "rand", "pixel"])
@pytest.mark.parametrize("cube", [True, False])
def test_random_erasing_bitwise(mode, cube):
    kw = dict(probability=0.7, mode=mode, max_count=3, cube=cube)
    x = ttf.normalize(ttf.clip_to_tensor(_clip(1))).transpose(1, 2, 3, 0)
    np.testing.assert_array_equal(
        x, jtf.normalize(jtf.clip_to_tensor(_clip(1))).transpose(1, 2, 3, 0))
    for seed in range(4):
        got = ttf.RandomErasing(**kw)(x.copy(), rng=np.random.default_rng(
            seed))
        want = jtf.RandomErasing(**kw)(x.copy(), rng=np.random.default_rng(
            seed))
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- datasets


def _same_sample(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k], k


def _datasets(files, name):
    """(port dataset, JAX dataset) of one kind on the written files."""
    root = str(files)
    cases = {
        "pretrain_csv": lambda m, tf: m.PretrainVideoDataset(
            str(files / "pretrain.csv"), root, tf.train_transform(32),
            num_frames=3, seed=5),
        "pretrain_json": lambda m, tf: m.PretrainVideoDataset(
            str(files / "pretrain.json"), root, tf.train_transform(32),
            num_frames=3, seed=5, max_words=2),
        "pretrain_two_files": lambda m, tf: m.PretrainVideoDataset(
            [str(files / "pretrain.csv"), str(files / "pretrain.json")],
            root, None, num_frames=2, decode_short_side=32),
        "retrieval_train": lambda m, tf: m.RetrievalVideoDataset(
            str(files / "retrieval.jsonl"), root, tf.train_transform(32),
            num_frames=3, train=True, seed=2),
        "retrieval_eval": lambda m, tf: m.RetrievalVideoDataset(
            str(files / "retrieval.jsonl"), root, tf.test_transform(32),
            num_frames=3, train=False),
        "retrieval_multi_gt": lambda m, tf: m.RetrievalVideoDataset(
            str(files / "pretrain.csv"), root, tf.test_transform(32),
            num_frames=2, train=False, has_multi_vision_gt=True),
        "caption_train": lambda m, tf: m.CaptionVideoDataset(
            str(files / "caption.jsonl"), root, tf.train_transform(32),
            num_frames=3, train=True, seed=9, decode_size=40),
        "caption_test": lambda m, tf: m.CaptionVideoDataset(
            str(files / "caption.jsonl"), root, tf.test_transform(32),
            num_frames=3, train=False),
        "cls_jsonl": lambda m, tf: m.ClsVideoDataset(
            str(files / "cls.jsonl"), root, tf.train_transform(32),
            num_frames=2, train=True, seed=4),
    }
    return cases[name](tds, ttf), cases[name](jds, jtf)


@pytest.mark.parametrize("name", [
    "pretrain_csv", "pretrain_json", "pretrain_two_files",
    "retrieval_train", "retrieval_eval", "retrieval_multi_gt",
    "caption_train", "caption_test", "cls_jsonl"])
def test_dataset_samples_bitwise(files, name):
    port, jax_ = _datasets(files, name)
    assert port.ann == jax_.ann
    for attr in ("text", "vid2txt", "txt2vid", "match_ids"):
        assert getattr(port, attr, None) == getattr(jax_, attr, None)
    for epoch in (0, 2):
        port.set_epoch(epoch)
        jax_.set_epoch(epoch)
        for i in range(len(jax_)):
            _same_sample(port[i], jax_[i])


@pytest.mark.parametrize("kind", ["pretrain", "retrieval", "caption", "cls"])
def test_a_broken_file_is_walked_past_as_in_jax(files, kind):
    """Row 1 names a file cv2 cannot open: after its 3 tries, pretrain
    draws another index from the sample's generator, the others take the
    next index."""
    ann = str(files / "with_broken.jsonl")
    cls = {"pretrain": "PretrainVideoDataset",
           "retrieval": "RetrievalVideoDataset",
           "caption": "CaptionVideoDataset", "cls": "ClsVideoDataset"}[kind]
    port = getattr(tds, cls)(ann, str(files), ttf.test_transform(32),
                             num_frames=2, seed=3)
    jax_ = getattr(jds, cls)(ann, str(files), jtf.test_transform(32),
                             num_frames=2, seed=3)
    got, want = port[1], jax_[1]
    _same_sample(got, want)
    assert got["index"] != 1
    if kind != "pretrain":
        assert got["index"] == 2
    calls = []
    real = tds.read_frames
    tds.read_frames = lambda path, **kw: calls.append(path) or real(path,
                                                                    **kw)
    try:
        port._load_clip(0)
        with pytest.raises(IOError, match="decode failed for index 1"):
            port._load_clip(1)
    finally:
        tds.read_frames = real
    assert [os.path.basename(c) for c in calls] == ["vid0.mp4"] + [
        "broken.mp4"] * 3


def test_csv_reader_keeps_the_cls_columns_jax_drops(files):
    """The one deliberate difference: JAX reads a three-column cls CSV as
    {video_id, caption} (title under caption, no label); the port keeps
    those keys as they are and every column under its own name too."""
    path = str(files / "cls.csv")
    jrows = jds._read_annotations(path)
    trows = tds._read_annotations(path)
    assert jrows[0] == {"video_id": "vid0.mp4", "caption": "标题0"}
    assert trows[0] == {"video_id": "vid0.mp4", "caption": "标题0",
                        "video_title": "标题0", "category_id": 0}
    for j, t in zip(jrows, trows):
        assert {k: t[k] for k in j} == j
    jcls = jds.ClsVideoDataset(path, str(files), num_frames=2, train=False)
    tcls = tds.ClsVideoDataset(path, str(files), num_frames=2, train=False)
    assert [jcls[i]["text"] for i in range(3)] == ["", "", ""]
    assert [jcls[i]["label"] for i in range(3)] == [-1, -1, -1]
    assert [tcls[i]["text"] for i in range(3)] == ["标题0", "标题1", "标题2"]
    assert [tcls[i]["label"] for i in range(N_CLIPS)] == [0, 1, 2, 0, 1, 2]
    np.testing.assert_array_equal(tcls[4]["video"], jcls[4]["video"])


@pytest.mark.parametrize("name", ["pretrain.csv", "numeric.csv",
                                  "pretrain.json", "caption.jsonl",
                                  "retrieval.jsonl"])
def test_other_annotation_files_read_as_in_jax(files, name):
    """Two-column CSVs (numeric ids too: pandas parses them as integers,
    kept as they come and joined to the root as text), JSON and jsonl:
    the rows are JAX's."""
    path = str(files / name)
    for kw in ({}, {"id_key": "clip_name"}):
        assert tds._read_annotations(path, **kw) == \
            jds._read_annotations(path, **kw)


def test_numeric_csv_ids_find_their_files(files):
    port = tds.PretrainVideoDataset(str(files / "numeric.csv"), str(files),
                                    num_frames=2)
    jax_ = jds.PretrainVideoDataset(str(files / "numeric.csv"), str(files),
                                    num_frames=2)
    for i in range(3):
        _same_sample(port[i], jax_[i])
        assert port[i]["index"] == i


def test_remote_video_root_raises_naming_the_roadmap(monkeypatch, tmp_path):
    """A remote root is read now (``data/remote_io``, held against JAX's
    in tests/test_torch_image_data.py): the dataset names each video by
    its URI, and an oss:// read without the ``oss2`` package raises an
    ImportError naming it, before any network access.  The name is the
    one it had when a remote root raised NotImplementedError."""
    import sys

    from youku_mplug_tpu_torch.data import remote_io

    monkeypatch.setitem(sys.modules, "oss2", None)
    remote_io._BUCKETS.clear()
    for root in ("oss://bucket/videos", "https://host/videos/"):
        ds = tds.VideoDataset([{"video_id": "a.mp4"}], root)
        assert ds._video_path(ds.ann[0]) == root.rstrip("/") + "/a.mp4"
    with pytest.raises(ImportError, match="oss2"):
        remote_io.fetch("oss://bucket/videos/a.mp4", cache_dir=str(tmp_path))


@pytest.mark.parametrize("train", [True, False])
def test_instruct_jsonl_dataset_bitwise(files, train):
    kw = dict(video_root=str(files), num_frames=3, train=train, seed=4)
    port = tinstruct.InstructJsonlDataset(
        str(files / "instruct.jsonl"), transform=ttf.train_transform(32),
        **kw)
    jax_ = jinstruct.InstructJsonlDataset(
        str(files / "instruct.jsonl"), transform=jtf.train_transform(32),
        **kw)
    for epoch in (0, 1):
        port.set_epoch(epoch)
        jax_.set_epoch(epoch)
        for i in range(len(jax_)):
            _same_sample(port[i], jax_[i])


# ------------------------------------------------------------------ loaders


def _batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same_sample(g, w)


@pytest.mark.parametrize("workers", [(1, "thread"), (4, "thread"),
                                     (2, "process")], ids=str)
@pytest.mark.parametrize("shuffle,drop_last", [(True, True),
                                               (False, False)])
def test_loader_batches_equal_sharded_loader(files, workers, shuffle,
                                             drop_last):
    num_workers, impl = workers
    port = tds.PretrainVideoDataset(str(files / "pretrain.json"),
                                    str(files), ttf.train_transform(32),
                                    num_frames=2, seed=1)
    jax_ = jds.PretrainVideoDataset(str(files / "pretrain.json"),
                                    str(files), jtf.train_transform(32),
                                    num_frames=2, seed=1)
    tl = tloader.Loader(port, 3, seed=6, shuffle=shuffle,
                        drop_last=drop_last, num_workers=num_workers,
                        workers_impl=impl, prefetch=1)
    # JAX's on threads: its forked workers can hang in a process that
    # runs threads (the port spawns its own)
    jl = jloader.ShardedLoader(jax_, 3, seed=6, shuffle=shuffle,
                               drop_last=drop_last, num_workers=num_workers,
                               process_index=0, process_count=1)
    inline = tloader.Loader(port, 3, seed=6, shuffle=shuffle,
                            drop_last=drop_last)
    for epoch in (0, 1):
        for ld in (tl, jl, inline):
            ld.set_epoch(epoch)
        want = list(jl)
        assert len(tl) == len(jl) == len(want)
        _batches_equal(list(tl), want)
        _batches_equal(list(inline), want)


def test_loader_under_thread_stress_gives_the_inline_batches(files):
    """More decode threads than cores, a short switch interval: the
    batches are the inline pass's, every index once."""
    import sys

    ds = tds.PretrainVideoDataset(str(files / "pretrain.json"), str(files),
                                  ttf.train_transform(24), num_frames=2,
                                  seed=8)
    want = list(tloader.Loader(ds, 2, seed=1, drop_last=False))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = list(tloader.Loader(ds, 2, seed=1, drop_last=False,
                                  num_workers=4 * (os.cpu_count() or 1),
                                  prefetch=1))
    finally:
        sys.setswitchinterval(interval)
    _batches_equal(got, want)
    assert sorted(i for b in got for i in b["index"]) == list(range(len(ds)))


def _loader_threads():
    return [t for t in threading.enumerate()
            if t is not threading.current_thread() and t.daemon]


def test_loader_early_exit_leaves_no_thread(files):
    ds = tds.CaptionVideoDataset(str(files / "caption.jsonl"), str(files),
                                 ttf.test_transform(32), num_frames=2)
    before = len(_loader_threads())
    for workers in (1, 3):
        ld = tloader.Loader(ds, 1, num_workers=workers, prefetch=1)
        it = iter(ld)
        first = next(it)
        assert first["video"].shape == (1, 2, 32, 32, 3)
        it.close()
        assert len(_loader_threads()) == before
        for i, batch in enumerate(ld):
            if i == 1:
                break
        del batch
        import gc

        gc.collect()
        assert len(_loader_threads()) == before


def test_loader_raises_a_worker_error(files):
    class Failing:
        def __len__(self):
            return 6

        def __getitem__(self, i):
            if i == 4:
                raise KeyError("sample 4")
            return {"x": np.zeros(2), "index": i}

    with pytest.raises(KeyError, match="sample 4"):
        list(tloader.Loader(Failing(), 2, shuffle=False, num_workers=2))
    with pytest.raises(ValueError, match="workers_impl"):
        tloader.Loader(Failing(), 2, workers_impl="fiber")


def test_meta_loader_order_equals_jax(files):
    def make(mod_ds, mod_loader, tf, **kw):
        loaders = [mod_loader(mod_ds.PretrainVideoDataset(
            str(files / f), str(files), tf.train_transform(32),
            num_frames=2, seed=3), bs, seed=3, **kw)
            for f, bs in (("pretrain.csv", 2), ("pretrain.json", 3))]
        return loaders

    port = tloader.MetaLoader(make(tds, tloader.Loader, ttf, num_workers=2),
                              seed=3)
    jax_ = jloader.MetaLoader(make(
        jds, jloader.ShardedLoader, jtf, num_workers=2, process_index=0,
        process_count=1), seed=3)
    for epoch in (0, 1, 2):
        port.set_epoch(epoch)
        jax_.set_epoch(epoch)
        got, want = list(port), list(jax_)
        assert len(port) == len(jax_) == len(got) == 5
        assert [s for s, _ in got] == [s for s, _ in want]
        _batches_equal([b for _, b in got], [b for _, b in want])
