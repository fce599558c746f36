"""Every runner of the port on video files the test writes: each runner's
loaders against the JAX runner's (``build_loaders`` / ``build_loader`` /
``build_datasets`` / ``build_train_loader`` / ``load_videos``, bitwise,
JAX held on its cv2 decoder), and each CLI for one step and its
evaluation on the files (tiny configs, ``--device cpu --fp32``), serve's
results carrying the caption text as the JAX CLI writes it."""

import argparse
import json

import cv2
import numpy as np
import pytest
import yaml

from tests.hf_tokenizer_files import write_tokenizer_dir
from tests.test_torch_caption import TINY_TEXT, TINY_VISION
from youku_mplug_tpu.data import native_decode

N_CLIPS = 8
CAPS = ["一只猫在睡觉", "a dog runs", "两个人在跑步", "the cat sleeps",
        "视频 标题", "kids play ball", "一辆车", "rain falls"]


@pytest.fixture(autouse=True)
def jax_on_cv2(monkeypatch):
    monkeypatch.setattr(native_decode, "available", lambda: False)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Clips vid0..7.mp4 (25 frames of 64 x 48, a band of grey 9 i in
    frame i) and one annotation file per format."""
    d = tmp_path_factory.mktemp("runner_files")
    yy, xx = np.mgrid[:48, :64]
    for k in range(N_CLIPS):
        w = cv2.VideoWriter(str(d / f"vid{k}.mp4"),
                            cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
        for i in range(25):
            frame = np.stack([(xx * 4 + k * 30) % 256, (yy * 5 + i) % 256,
                              (xx + yy + 9 * k) % 256], -1).astype(np.uint8)
            frame[:8] = i * 9
            w.write(frame)
        w.release()

    def jsonl(name, rows):
        (d / name).write_text("".join(json.dumps(r, ensure_ascii=False)
                                      + "\n" for r in rows))
    jsonl("caption_train.jsonl", [{"video_id": f"vid{k}.mp4",
                                   "caption": c} for k, c in enumerate(CAPS)])
    jsonl("caption_test.jsonl", [{"video_id": f"vid{k}.mp4",
                                  "golden_caption": [c, c + " 2"]}
                                 for k, c in enumerate(CAPS)])
    (d / "pretrain.csv").write_text("video_id:FILE,title\n" + "".join(
        f"vid{k}.mp4,{c}\n" for k, c in enumerate(CAPS)))
    (d / "pretrain_b.json").write_text(json.dumps(
        [{"video_id": f"vid{k}", "caption": CAPS[-k]} for k in range(6)]))
    (d / "cls.csv").write_text("video_id:FILE,video_title,category_id\n"
                               + "".join(f"vid{k}.mp4,{c},{k % 3}\n"
                                         for k, c in enumerate(CAPS)))
    jsonl("cls.jsonl", [{"video_id": f"vid{k}.mp4", "video_title": c,
                         "category_id": k % 3} for k, c in enumerate(CAPS)])
    jsonl("retrieval.jsonl", [{"clip_name": f"vid{k}.mp4", "caption": c}
                              for k, c in enumerate(CAPS)])
    jsonl("instruct.jsonl", [{"video": str(d / f"vid{k}.mp4"),
                              "question": f"what is in clip {k} ?",
                              "answer": f"a clip numbered {k}"}
                             for k in range(4)])
    (d / "classnames.json").write_text(json.dumps(
        {"体育": 0, "动物": 1, "汽车": 2}, ensure_ascii=False))
    return d


def gpt3_yaml(files, tmp_path, name, **extra):
    """A tiny GPT-3 video model (the caption tests') reading ``files``."""
    (tmp_path / "text.json").write_text(json.dumps(TINY_TEXT))
    (tmp_path / "vision.json").write_text(json.dumps(TINY_VISION))
    cfg = {"text_cfg": str(tmp_path / "text.json"),
           "visual_cfg": str(tmp_path / "vision.json"), "batch_size": 4,
           "num_workers": 2, "max_length": 12, "num_frames": 2,
           "image_res": 32, "num_learnable_token": 4, "embed_dim": 8,
           "freeze_text_decoder": True, "prompt": "", "max_new_tokens": 3,
           "beam_size": 2, "video_root": str(files),
           "train_video_root": str(files),
           "optimizer": {"lr": 1e-3, "opt": "AdamW", "weight_decay": 0.01},
           "schedular": {"epochs": 1, "min_lr": 1e-5, "warmup_steps": 1,
                         "lr_sched_type": "cosine"}}
    cfg.update(extra)
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg, allow_unicode=True))
    return str(path)


TASK_FILES = {
    "caption": dict(train_file="caption_train.jsonl",
                    val_file="caption_test.jsonl",
                    test_file="caption_test.jsonl"),
    "pretrain": dict(train_file="pretrain.csv"),
    "pretrain_groups": dict(train_file_groups=["pretrain.csv",
                                               "pretrain_b.json"]),
    "cls": dict(train_file="cls.jsonl", val_file="cls.jsonl",
                test_file="cls.jsonl"),
    "retrieval": dict(train_file="retrieval.jsonl",
                      val_file="retrieval.jsonl",
                      test_file="retrieval.jsonl"),
}


def task_yaml(files, tmp_path, task, **extra):
    paths = {k: ([str(files / f) for f in v] if isinstance(v, list)
                 else str(files / v)) for k, v in TASK_FILES[task].items()}
    return gpt3_yaml(files, tmp_path, task, **paths, **extra)


def _args(**kw):
    return argparse.Namespace(synthetic_data=False, seed=5, **kw)


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


def _both_epochs(pairs):
    for epoch in (0, 1):
        for port, jax_ in pairs:
            port.set_epoch(epoch)
            jax_.set_epoch(epoch)
            _same_batches(port, jax_)


@pytest.mark.parametrize("task", ["caption", "pretrain", "pretrain_groups",
                                  "cls", "retrieval"])
def test_runner_loaders_equal_jax(files, tmp_path, task):
    from youku_mplug_tpu.config import load_config as jload
    from youku_mplug_tpu_torch.config import load_config as tload

    path = task_yaml(files, tmp_path, task)
    tcfg, jcfg, args = tload(path), jload(path), _args()
    if task == "caption":
        from youku_mplug_tpu.cli import run_caption as j
        from youku_mplug_tpu_torch.cli import run_caption as t

        tl, jl = t.build_loaders(args, tcfg), j.build_loaders(args, jcfg)
        _both_epochs([(tl[0], jl[0]), (tl[1], jl[2])])
    elif task.startswith("pretrain"):
        from youku_mplug_tpu.cli import run_pretrain as j
        from youku_mplug_tpu_torch.cli import run_pretrain as t

        tl, jl = t.build_loader(args, tcfg), j.build_loader(args, jcfg)
        assert len(tl) == len(jl) == (3 if task == "pretrain_groups" else 2)
        _both_epochs([(tl, jl)])
    elif task == "cls":
        from youku_mplug_tpu.cli import run_cls as j
        from youku_mplug_tpu_torch.cli import run_cls as t

        _both_epochs(list(zip(t.build_loaders(args, tcfg),
                              j.build_loaders(args, jcfg))))
    else:
        from youku_mplug_tpu.cli import run_retrieval as j
        from youku_mplug_tpu_torch.cli import run_retrieval as t
        from youku_mplug_tpu_torch.data.loader import Loader

        for tds, jds in zip(t.build_datasets(args, tcfg),
                            j.build_datasets(args, jcfg)):
            for attr in ("text", "vid2txt", "txt2vid", "match_ids"):
                assert getattr(tds, attr) == getattr(jds, attr)
            _same_batches(Loader(tds, 3, shuffle=False, drop_last=False),
                          Loader(jds, 3, shuffle=False, drop_last=False))


def owl_yaml(files, tmp_path, **extra):
    raw = yaml.safe_load(open("configs/instruct/serve_owl_tiny.yaml"))
    raw.update(max_new_tokens=3, num_workers=2, **extra)
    path = tmp_path / "owl.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def test_instruct_loaders_and_clips_equal_jax(files, tmp_path):
    from youku_mplug_tpu.cli import run_instruct as j
    from youku_mplug_tpu_torch.cli import run_instruct as t
    from youku_mplug_tpu_torch.config import instruct_train_config

    path = owl_yaml(files, tmp_path, batch_size=2,
                    train_file=str(files / "instruct.jsonl"))
    tcfg, raw = t.load_owl_config(path)
    jcfg, _ = j.load_owl_config(path)
    args = _args(train_jsonl="")
    tl = t.build_train_loader(args, instruct_train_config(raw), raw,
                              tcfg.vision.img_size)
    _both_epochs([(tl, j.build_train_loader(args, jcfg, raw))])
    rows = [json.loads(line) for line in
            (files / "instruct.jsonl").read_text().splitlines()]
    np.testing.assert_array_equal(t.load_videos(args, raw, rows),
                                  j.load_videos(args, raw, rows))


# -------------------------------------------------------------- the CLIs


def _main(module, parser, argv):
    return module.main(getattr(module, parser)().parse_args(
        argv + ["--device", "cpu"]))


def _log(out):
    return [json.loads(line) for line in (out / "log.txt").read_text()
            .splitlines()]


def test_serve_cli_on_files_writes_captions(files, tmp_path):
    """serve reads the YAML's test split and writes JAX's result fields,
    the caption decoded as the JAX CLI decodes it; a model directory with
    a tokenizer.json decodes through JiebaBPE."""
    from youku_mplug_tpu.models.tokenizer import BatchTokenizer as JBT
    from youku_mplug_tpu.models.tokenizer import JiebaBPETokenizer as JBPE
    from youku_mplug_tpu.models.tokenizer import ToyTokenizer as JToy
    from youku_mplug_tpu_torch.cli import serve

    path = task_yaml(files, tmp_path, "caption")
    out = tmp_path / "out"
    stats = _main(serve, "serve_parser", [
        "--config", path, "--num_requests", "6", "--num_slots", "2",
        "--output_dir", str(out)])
    assert stats["requests"] == 6
    results = json.loads((out / "serve_results.json").read_text())
    assert [r["video_id"] for r in results] == [f"vid{k}.mp4"
                                                for k in range(6)]
    jtok = JBT(JToy(TINY_TEXT["vocab_size"]))
    for r in results:
        assert {"video_id", "caption", "n_tokens", "latency_s"} <= set(r)
        assert r["n_tokens"] == len(r["tokens"]) >= 1
        assert r["caption"] == jtok.decode(np.asarray(
            r["tokens"] + [2], np.int32)).replace(" ", "").strip()

    from tests.test_torch_tokenizer import CORPUS
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers
    from tokenizers import trainers

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(CORPUS, trainers.BpeTrainer(
        vocab_size=TINY_TEXT["vocab_size"] + 200,
        special_tokens=["<|endoftext|>", "<sep>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    (tmp_path / "gpt3").mkdir()
    tok.save(str(tmp_path / "gpt3" / "tokenizer.json"))
    path = task_yaml(files, tmp_path, "caption",
                     text_decoder=str(tmp_path / "gpt3"))
    _main(serve, "serve_parser", [
        "--config", path, "--num_requests", "4", "--output_dir", str(out)])
    jbpe = JBPE(str(tmp_path / "gpt3" / "tokenizer.json"))
    for r in json.loads((out / "serve_results.json").read_text()):
        assert r["caption"] == jbpe.detokenize(
            r["tokens"] + [0]).replace(" ", "").strip()


def test_run_pretrain_cli_on_files(files, tmp_path):
    from youku_mplug_tpu_torch.cli import run_pretrain

    for task in ("pretrain", "pretrain_groups"):
        out = tmp_path / task
        runner = _main(run_pretrain, "base_parser", [
            "--config", task_yaml(files, tmp_path, task), "--fp32",
            "--max_steps", "1", "--output_dir", str(out)])
        assert runner.state.step == 1
        assert np.isfinite(_log(out)[0]["loss"])


def test_run_caption_cli_on_files(files, tmp_path):
    from youku_mplug_tpu_torch.cli import run_caption

    out = tmp_path / "out"
    _main(run_caption, "parser", [
        "--config", task_yaml(files, tmp_path, "caption"), "--fp32",
        "--max_steps", "1", "--output_dir", str(out)])
    log = _log(out)
    assert np.isfinite(log[0]["loss"]) and "CIDEr" in log[-1]["test"]
    results = json.loads((out / "caption_results.json").read_text())
    assert [r["video_id"] for r in results] == [f"vid{k}.mp4"
                                                for k in range(4)]
    assert results[0]["gold_caption"] == [CAPS[0], CAPS[0] + " 2"]


def test_run_cls_cli_on_a_three_column_csv(files, tmp_path):
    """The cls CSV of the reference YAMLs (video_id:FILE, video_title,
    category_id): its titles and labels reach the training batches."""
    from youku_mplug_tpu_torch.cli import run_cls

    path = gpt3_yaml(files, tmp_path, "cls", use_cls=True, num_classes=3,
                     classname_file=str(files / "classnames.json"),
                     **{k: str(files / "cls.csv")
                        for k in ("train_file", "val_file", "test_file")})
    loaders = run_cls.build_loaders(_args(), run_cls.load_config(path))
    for ld in loaders:
        for batch in ld:
            assert [int(la) for la in batch["label"]] == [
                i % 3 for i in batch["index"]]
            assert batch["text"] == [CAPS[i] for i in batch["index"]]
    out = tmp_path / "out"
    _main(run_cls, "parser", ["--config", path, "--fp32", "--max_steps",
                              "1", "--output_dir", str(out)])
    log = _log(out)
    assert np.isfinite(log[0]["loss_cls"]) and "val_gen_top1_accuracy" in \
        log[0]
    assert 0 <= log[-1]["test"]["gen_top1_accuracy"] <= 100


@pytest.mark.parametrize("module", ["run_retrieval", "run_retrieval_itm"])
def test_retrieval_clis_on_files(files, tmp_path, module):
    import importlib

    mod = importlib.import_module(f"youku_mplug_tpu_torch.cli.{module}")
    extra = (dict(use_cls=True, num_classes=2, eval_video_batch=4)
             if module.endswith("itm") else {})
    out = tmp_path / "out"
    _main(mod, "parser", [
        "--config", task_yaml(files, tmp_path, "retrieval", **extra),
        "--fp32", "--max_steps", "1", "--output_dir", str(out)])
    test = _log(out)[-1]["test"]
    key = "gen_r_mean" if module.endswith("itm") else "r_mean"
    assert 0 <= test[key] <= 100


def test_run_instruct_serves_and_trains_on_files(files, tmp_path):
    from youku_mplug_tpu_torch.cli import run_instruct

    path = owl_yaml(files, tmp_path, batch_size=2, epochs=1,
                    text_overrides={**yaml.safe_load(open(
                        "configs/instruct/serve_owl_tiny.yaml"))[
                        "text_overrides"], "lora_rank": 2},
                    optimizer={"lr": 1e-3})
    results, stats = _main(run_instruct, "parser", [
        "--config", path, "--engine", "--num_slots", "2", "--input_jsonl",
        str(files / "instruct.jsonl"), "--output_dir", str(tmp_path / "s")])
    assert stats["requests"] == 4 and stats["nonfinite_logits"] == 0
    assert [r["video"] for r in results] == [
        str(files / f"vid{k}.mp4") for k in range(4)]
    # a built tokenizer.json takes the question: the whitespace
    # tokenizer's salted hash would make a first token of eos come and go
    one, _ = _main(run_instruct, "parser", [
        "--config", path, "--video", str(files / "vid5.mp4"), "--question",
        "what ?", "--output_dir", str(tmp_path / "one"), "--tokenizer",
        str(write_tokenizer_dir(tmp_path / "tok", 120, byte_level=False))])
    assert len(one) == 1 and one[0]["tokens"]
    out = tmp_path / "train"
    runner = _main(run_instruct, "parser", [
        "--config", path, "--train", "--train_jsonl",
        str(files / "instruct.jsonl"), "--max_steps", "1", "--output_dir",
        str(out)])
    assert len(runner.history) == 1
    assert np.isfinite(runner.history[0]["loss"])
