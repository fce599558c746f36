"""The BERT family's CLIs on the CPU: ``run_mplug_pretrain``,
``run_mplug_downstream`` (cls, caption, retrieval; cls once more on
clips written by cv2) and ``run_alpro`` (pretrain, cls, retrieval) each
train 2 steps and evaluate on the JAX e2e tests' tiny YAML;
``run_mplug_pretrain`` with ``mlm_probability: 0`` at batch 2 (no MLM
draw; the hard negatives forced; no dropout) against the JAX runner from
the same carried weights and queues: the logged losses, the parameters,
the EMA twin, both queues and the pointer; and each CLI refuses to start
without a card unless given ``--device cpu``."""

import json

import cv2
import jax
import numpy as np
import pytest
import torch
import yaml

from tests.torch_bert_family import PARAM_TOL, TOL, close, flat

torch.set_num_threads(1)
TINY_VISION = {"img_size": 32, "patch_size": 16, "embed_dim": 32,
               "depth": 1, "num_heads": 2, "num_frames": 2, "mlp_ratio": 2}
BERT_OVERRIDES = {"vocab_size": 256, "hidden_size": 32,
                  "num_hidden_layers": 2, "num_attention_heads": 4,
                  "intermediate_size": 64, "encoder_width": 32,
                  "fusion_layer": 1, "text_encoder_layers": 1,
                  "hidden_dropout_prob": 0.0,
                  "attention_probs_dropout_prob": 0.0}


def write_cfg(d, name, **extra):
    """The JAX e2e tests' tiny YAML with a BERT of hidden 32."""
    (d / "vision.json").write_text(json.dumps(TINY_VISION))
    cfg = {"visual_cfg": str(d / "vision.json"), "batch_size": 4,
           "num_workers": 2, "max_length": 12, "num_frames": 2, "image_res": 32, "embed_dim": 8,
           "synthetic_length": 8, "bert_overrides": BERT_OVERRIDES,
           "queue_size": 8, "alpha": 0.4, "num_classes": 3,
           "beam_size": 3, "max_new_tokens": 4,
           "optimizer": {"lr": 1e-3, "opt": "AdamW", "weight_decay": 0.01,
                         "clip_grad": 3.0},
           "schedular": {"epochs": 1, "min_lr": 1e-5, "warmup_steps": 1,
                         "lr_sched_type": "cosine"}}
    cfg.update(extra)
    path = d / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _run(module, cfg, out, *extra, device="cpu"):
    import importlib

    mod = importlib.import_module(f"youku_mplug_tpu_torch.cli.{module}")
    args = mod.parser().parse_args([
        "--config", cfg, "--output_dir", str(out), "--fp32",
        "--synthetic_data", "--max_steps", "2", "--seed", "0",
        "--device", device, *extra])
    return mod.main(args)


def _log(out):
    return [json.loads(line) for line in (out / "log.txt").read_text()
            .splitlines()]


@pytest.mark.parametrize("module,task", [
    ("run_mplug_pretrain", None), ("run_mplug_downstream", "cls"),
    ("run_mplug_downstream", "caption"),
    ("run_mplug_downstream", "retrieval"), ("run_alpro", "pretrain"),
    ("run_alpro", "cls"), ("run_alpro", "retrieval")])
def test_cli_trains_and_evaluates_on_cpu(tmp_path, module, task):
    cfg = write_cfg(tmp_path, "c")
    out = tmp_path / "out"
    extra = ("--task", task) if task else ()
    result = _run(module, cfg, out, *extra)
    log = _log(out)
    assert np.isfinite(log[0]["loss"]) and log[0]["skipped_nonfinite"] == 0
    assert (out / "checkpoints" / "2").is_dir()
    if task in (None, "pretrain"):
        assert log[0]["loss_ita"] > 0 and log[0]["loss_mlm"] > 0
    if module == "run_mplug_pretrain":
        assert result.mstate.ptr == 0  # 2 steps of 4 wrap the size-8 queue
        assert torch.isfinite(result.mstate.image_queue).all()
        return
    runner, res = result
    assert runner.state.step == 2
    if task == "cls":
        assert 0 <= res["top1"] <= 100 and 0 <= res["top5"] <= 100
    elif task == "caption":
        assert "CIDEr" in res
    elif task == "retrieval":
        assert "r_mean" in res
    if task != "pretrain":
        assert log[-1]["test"] == res


def test_downstream_cls_on_clips_written_by_cv2(tmp_path):
    """run_mplug_downstream --task cls without --synthetic_data: four mp4v
    clips and a three-column CSV (video_id:FILE, title, category)."""
    from youku_mplug_tpu_torch.cli import run_mplug_downstream

    for k in range(4):
        w = cv2.VideoWriter(str(tmp_path / f"v{k}.mp4"),
                            cv2.VideoWriter_fourcc(*"mp4v"), 10, (48, 40))
        for i in range(12):
            w.write(np.full((40, 48, 3), (k * 50 + i * 7) % 256, np.uint8))
        w.release()
    (tmp_path / "cls.csv").write_text(
        "video_id:FILE,video_title,category_id\n"
        + "".join(f"v{k}.mp4,title {k},{k % 3}\n" for k in range(4)))
    cfg = write_cfg(tmp_path, "files", train_file=str(tmp_path / "cls.csv"),
                    test_file=str(tmp_path / "cls.csv"),
                    video_root=str(tmp_path), batch_size=2)
    args = run_mplug_downstream.parser().parse_args([
        "--config", cfg, "--output_dir", str(tmp_path / "out"), "--fp32",
        "--max_steps", "2", "--device", "cpu", "--task", "cls"])
    runner, res = run_mplug_downstream.main(args)
    assert runner.state.step == 2 and 0 <= res["top1"] <= 100
    loader = runner.loader
    loader.set_epoch(0)
    batch = next(iter(loader))
    assert batch["video"].shape == (2, 2, 32, 32, 3)
    assert set(batch["text"]) <= {f"title {k}" for k in range(4)}


def test_pretrain_runner_matches_jax_without_mlm(tmp_path, monkeypatch):
    """``mlm_probability: 0`` at batch 2 over a size-8 queue: every draw
    is fixed, so the port's run from JAX's init and queues follows JAX's
    runner: the epoch's logged losses, every parameter, the twin, both
    queues and the pointer."""
    from youku_mplug_tpu.cli import common as jcommon
    from youku_mplug_tpu.cli import run_mplug_pretrain as jrun
    from youku_mplug_tpu_torch import bridge
    from youku_mplug_tpu_torch.cli import common as tcommon
    from youku_mplug_tpu_torch.cli import run_mplug_pretrain as trun

    cfg = write_cfg(tmp_path, "p", mlm_probability=0.0, batch_size=2)
    jout, tout = tmp_path / "jax", tmp_path / "port"
    # the JAX runner's init (model.init with its seeds) and its queues,
    # as it hands them to init_momentum_state
    seen = {}
    real_jinit = jrun.init_momentum_state

    def spy(params, *a, **kw):
        seen["params"] = params
        seen["mstate"] = real_jinit(params, *a, **kw)
        return seen["mstate"]
    monkeypatch.setattr(jrun, "init_momentum_state", spy)
    jargs = jcommon.base_parser("t").parse_args([
        "--config", cfg, "--output_dir", str(jout), "--fp32",
        "--synthetic_data", "--max_steps", "2", "--seed", "0"])
    jstate, jms = jrun.main(jargs)
    params, jms0 = seen["params"], seen["mstate"]
    monkeypatch.setattr(tcommon, "jax_init",
                        lambda model, seed: bridge.load_jax_params(
                            model, jax.device_get(params)))
    real_init = trun.init_momentum_state

    def carried(model, embed_dim, queue_size):
        return bridge.load_momentum_state(
            real_init(model, embed_dim, queue_size),
            jax.device_get(jms0))
    monkeypatch.setattr(trun, "init_momentum_state", carried)
    pt = _run("run_mplug_pretrain", cfg, tout)

    jlog, tlog = _log(jout)[0], _log(tout)[0]
    for k in ("loss", "loss_ita", "loss_itm", "loss_mlm", "grad_norm"):
        close(tlog[k], jlog[k])
    assert tlog["loss_mlm"] == 0.0
    jflat = flat(jax.device_get(jstate.trainable))
    for path, p in pt.runner.state.trainable.items():
        close(p, jflat[path], PARAM_TOL)
    jema = flat(jax.device_get(jms.ema_params))
    for path, p in pt.mstate.ema_params.items():
        close(p, jema[path], PARAM_TOL)
    for name in ("image_queue", "text_queue"):
        close(getattr(pt.mstate, name), getattr(jms, name), TOL)
    assert pt.mstate.ptr == int(jms.ptr) == 4


@pytest.mark.parametrize("module,task", [
    ("run_mplug_pretrain", None), ("run_mplug_downstream", "cls"),
    ("run_alpro", "pretrain")])
def test_clis_need_the_card_by_default(tmp_path, module, task, monkeypatch):
    import importlib

    mod = importlib.import_module(f"youku_mplug_tpu_torch.cli.{module}")
    cfg = write_cfg(tmp_path, "c")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--config", cfg, "--synthetic_data", "--output_dir",
            str(tmp_path / "o")] + (["--task", task] if task else [])
    assert mod.parser().parse_args(argv).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(mod.parser().parse_args(argv))


@pytest.mark.parametrize("path,module", [
    ("configs/mplug/mplug_vitb16_zh.yaml", "run_mplug_pretrain"),
    ("configs/alpro/alpro_vitb16_zh.yaml", "run_alpro")])
def test_full_width_yamls_build_the_jax_runners_model(path, module):
    """The card's YAMLs: the port's runner builds the model config the JAX
    runner builds (BERT, vision tower, embed, queue, momentum, MLM rate,
    classes), at the flagship tower's 12 heads of 64."""
    import dataclasses
    import importlib

    from youku_mplug_tpu import config as jconfig
    from youku_mplug_tpu_torch.config import load_config

    jmod = importlib.import_module(f"youku_mplug_tpu.cli.{module}")
    tmod = importlib.import_module(f"youku_mplug_tpu_torch.cli.{module}")
    want = jmod.build_model_cfg(jconfig.load_config(path))
    got = tmod.build_model_cfg(load_config(path))
    assert dataclasses.asdict(got.bert) == dataclasses.asdict(want.bert)
    for f in dataclasses.fields(got.vision):
        assert getattr(got.vision, f.name) == getattr(want.vision, f.name)
    for f in dataclasses.fields(got):
        if f.name not in ("vision", "bert"):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert (got.vision.num_heads, got.vision.embed_dim, got.vision.depth,
            got.vision.num_frames) == (12, 768, 12, 8)
    assert got.bert.vocab_size == 21128 and got.bert.hidden_size == 768
