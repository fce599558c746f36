"""The port's caption slice against the JAX package at fp32 on the tiny
flagship model with the same weights (redrawn at std 0.2 through the
bridge): the prefix-LM targets with prompt lengths, ``caption_loss`` and
every trainable gradient (1e-4: fp32 sums in another order),
``generate_captions`` (sequences equal, beam scores within 1e-4), the
(prompt, text) pair tokenizer, the caption YAML read by both loaders;
then the ``run_caption`` CLI on the CPU: train, save, resume,
``--evaluate_only``, and what it refuses.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from __graft_entry__ import _flagship_cfg
from youku_mplug_tpu.models import generation as jgen
from youku_mplug_tpu.models import tasks as jtasks
from youku_mplug_tpu.runtime.precision import FP32_POLICY as J_FP32
from youku_mplug_tpu_torch import bridge
from youku_mplug_tpu_torch.config import flagship_config, load_config
from youku_mplug_tpu_torch.models import generation as tgen
from youku_mplug_tpu_torch.models import tasks as ttasks
from youku_mplug_tpu_torch.optim.factory import OptimizerConfig
from youku_mplug_tpu_torch.runtime.precision import FP32_POLICY
from youku_mplug_tpu_torch.train.state import create_train_state

torch.set_num_threads(1)
TOL = 1e-4
CAPTION_FLAGSHIP = "configs/caption/caption_gpt3_1.3B_flagship.yaml"
PRETRAIN_FLAGSHIP = "configs/pretrain/pretrain_gpt3_1.3B_flagship.yaml"


def redraw(tree, rng, std=0.2):
    def leaf(path, x):
        z = rng.normal(size=x.shape).astype(np.float32)
        if str(path[-1].key) == "temp":
            return np.float32(0.07)
        return 1.0 + 0.1 * z if str(path[-1].key).endswith("scale") \
            else std * z
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _inputs(rng, b=3, s=10):
    v = _flagship_cfg(tiny=True).vision
    video = rng.normal(size=(b, 3, v.num_frames, v.img_size,
                             v.img_size)).astype(np.float32)
    ids = rng.integers(3, 256, size=(b, s)).astype(np.int32)
    lengths = np.array([s, 6, 4][:b])
    mask = (np.arange(s)[None] < lengths[:, None]).astype(np.int32)
    ids = np.where(mask == 1, ids, 2).astype(np.int32)
    plens = np.array([3, 0, 2][:b], np.int32)
    return video, ids, mask, plens


def _models(rng, video, ids, mask):
    jm = jtasks.MPLUGVideo(_flagship_cfg(tiny=True), policy=J_FP32)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.asarray(video), jnp.asarray(ids),
        jnp.asarray(mask)))["params"]
    params = redraw(shapes, rng)
    tm = bridge.load_jax_params(
        ttasks.MPLUGVideo(flagship_config(tiny=True), FP32_POLICY), params)
    return jm, params, tm


def test_prefix_lm_targets_with_prompt_lengths_match_jax():
    rng = np.random.default_rng(0)
    _, ids, mask, plens = _inputs(rng)
    for vocab in (None, 50):
        jl, jmask = jtasks.prefix_lm_targets(
            jnp.asarray(ids), jnp.asarray(mask), 4,
            prompt_lengths=jnp.asarray(plens), vocab_size=vocab)
        tl, tmask = ttasks.prefix_lm_targets(
            torch.from_numpy(ids), torch.from_numpy(mask), 4,
            prompt_lengths=torch.from_numpy(plens), vocab_size=vocab)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert tmask[0, 4:7].sum() == 0 and tmask[0, 7] == 1  # prompt of 3


def test_caption_loss_and_grads_match_jax():
    rng = np.random.default_rng(1)
    video, ids, mask, plens = _inputs(rng)
    jm, params, tm = _models(rng, video, ids, mask)

    def jloss(p):
        return jm.apply({"params": p}, jnp.asarray(video), jnp.asarray(ids),
                        jnp.asarray(mask), jnp.asarray(plens),
                        method=jtasks.MPLUGVideo.caption_loss)["loss"]
    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    state, _, _ = create_train_state(tm, OptimizerConfig())
    out = tm.caption_loss(torch.from_numpy(video),
                          torch.from_numpy(ids).long(),
                          torch.from_numpy(mask), torch.from_numpy(plens))
    out["loss"].backward()
    np.testing.assert_allclose(float(out["loss"].detach()), float(jl),
                               rtol=TOL, atol=TOL)
    jflat = _flat(jgrads)
    for path, p in state.trainable.items():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(got.numpy(), np.asarray(jflat[path]),
                                   rtol=TOL, atol=TOL, err_msg=path)
    # the prompt's positions leave the loss: another loss than without
    plain = tm.caption_loss(torch.from_numpy(video),
                            torch.from_numpy(ids).long(),
                            torch.from_numpy(mask),
                            torch.zeros(3, dtype=torch.int32))["loss"]
    assert abs(plain.item() - out["loss"].item()) > 1e-3


@pytest.mark.parametrize("beam", [1, 2])
def test_generate_captions_matches_jax(beam):
    rng = np.random.default_rng(2 + beam)
    video, _, _, _ = _inputs(rng)
    ids = np.array([[1, 17, 33, 2, 2], [1, 2, 2, 2, 2], [1, 90, 2, 2, 2]],
                   np.int32)
    mask = (np.arange(5)[None] < np.array([[4], [2], [3]])).astype(np.int32)
    jm, params, tm = _models(rng, video, ids, mask)
    cfg = jgen.GenerationConfig(max_new_tokens=5, eos_id=2, pad_id=2,
                                beam_size=beam)
    want = jtasks.generate_captions(jm, params, jnp.asarray(video),
                                    jnp.asarray(ids), jnp.asarray(mask), cfg)
    got = ttasks.generate_captions(tm.eval(), torch.from_numpy(video),
                                   torch.from_numpy(ids).long(),
                                   torch.from_numpy(mask), cfg)
    np.testing.assert_array_equal(got["sequences"].numpy(),
                                  np.asarray(want["sequences"]))
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), rtol=TOL,
                               atol=TOL)


def test_pair_tokenizer_matches_jax():
    from youku_mplug_tpu.models.tokenizer import BatchTokenizer as JBT
    from youku_mplug_tpu.models.tokenizer import ToyTokenizer as JToy
    from youku_mplug_tpu_torch.models.tokenizer import (
        BatchTokenizer,
        ToyTokenizer,
    )

    jt, tt = JBT(JToy(512), 12), BatchTokenizer(ToyTokenizer(512), 12)
    pairs = [("", "synthetic clip 3"), ("描述视频", "一段视频"),
             ("a long prompt here", "text"), ("p", "一段很长的视频描述" * 2)]
    for kw in ({}, {"max_length": 20}, {"max_length": 6}):
        want, got = jt(pairs, **kw), tt(pairs, **kw)
        assert set(got) == set(want) == {"input_ids", "attention_mask",
                                         "prompt_lengths"}
        for key in want:
            assert got[key].dtype == want[key].dtype == np.int32
            np.testing.assert_array_equal(got[key], want[key])
    texts = ["synthetic clip 3 class 3", "a", "一段很长的视频描述" * 3]
    for kw in ({"padding": "longest"}, {"max_length": 20},
               {"padding": "longest", "max_length": 5}):
        want, got = jt(texts, **kw), tt(texts, **kw)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
    seq = np.array([1, 40, 41, 2, 2])
    assert tt.decode(seq) == jt.decode(seq) == "40 41"


def test_caption_flagship_yaml_matches_jax_and_pretrain_model():
    """Both loaders read the caption YAML to the same model, optimizer and
    decode keys; its model is the pretrain flagship's, so a checkpoint of
    that run restores exactly."""
    from youku_mplug_tpu.config import load_config as j_load_config

    t, j = load_config(CAPTION_FLAGSHIP), j_load_config(CAPTION_FLAGSHIP)
    assert t.model == flagship_config() == load_config(PRETRAIN_FLAGSHIP
                                                       ).model
    for part in ("vision", "text"):
        tp, jp = getattr(t.model, part), getattr(j.model, part)
        for f in dataclasses.fields(tp):
            assert getattr(tp, f.name) == getattr(jp, f.name), (part, f)
    for f in dataclasses.fields(t.model):
        if f.name not in ("vision", "text"):
            assert getattr(t.model, f.name) == getattr(j.model, f.name), f
    for f in dataclasses.fields(t.optimizer):
        assert getattr(t.optimizer, f.name) == getattr(j.optimizer,
                                                       f.name), f
    for key in ("batch_size", "max_length", "num_frames", "epochs",
                "update_freq", "prompt"):
        assert getattr(t, key) == getattr(j, key), key
    for key in ("beam_size", "max_new_tokens", "synthetic_length",
                "async_checkpointing"):
        assert t.get(key) == j.get(key), key
    assert (t.batch_size, t.get("beam_size"), t.get("max_new_tokens"),
            t.optimizer.lr, t.optimizer.warmup_steps) == (24, 5, 32, 2e-5,
                                                          100)
    assert not j.model.use_cls


TINY_TEXT = {
    "vocab_size": 128, "hidden_size": 32, "num_hidden_layers": 1,
    "num_attention_heads": 4, "max_position_embeddings": 128,
    "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0,
    "layernorm_epsilon": 1e-5,
}
TINY_VISION = {
    "img_size": 32, "patch_size": 16, "embed_dim": 32, "depth": 1,
    "num_heads": 2, "num_frames": 2, "mlp_ratio": 2,
}


def tiny_caption_yaml(d, name="cap", **extra):
    """The JAX downstream e2e test's tiny caption config, one process."""
    (d / "text.json").write_text(json.dumps(TINY_TEXT))
    (d / "vision.json").write_text(json.dumps(TINY_VISION))
    cfg = {"text_cfg": str(d / "text.json"),
           "visual_cfg": str(d / "vision.json"), "batch_size": 4,
           "max_length": 12, "num_frames": 2, "image_res": 32,
           "num_learnable_token": 4, "embed_dim": 8,
           "freeze_text_decoder": True, "synthetic_length": 8, "prompt": "",
           "max_new_tokens": 4, "beam_size": 2,
           "optimizer": {"lr": 1e-3, "opt": "AdamW", "weight_decay": 0.01,
                         "clip_grad": 3.0},
           "schedular": {"epochs": 1, "min_lr": 1e-5, "warmup_steps": 1,
                         "lr_sched_type": "cosine"}}
    cfg.update(extra)
    path = d / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _run(cfg, out, *extra):
    from youku_mplug_tpu_torch.cli import run_caption

    return run_caption.main(run_caption.parser().parse_args([
        "--config", cfg, "--output_dir", str(out), "--fp32",
        "--synthetic_data", "--max_steps", "2", "--seed", "0", "--device",
        "cpu", *extra]))


def test_run_caption_trains_saves_resumes_and_evaluates(tmp_path, capsys):
    cfg = tiny_caption_yaml(tmp_path)
    out = tmp_path / "out"
    runner = _run(cfg, out)
    assert runner.state.step == 2 and runner.state.optimizer.count == 2
    log = [json.loads(line) for line in (out / "log.txt").read_text()
           .splitlines()]
    assert log[0]["epoch"] == 0 and np.isfinite(log[0]["loss"])
    assert "CIDEr" in log[-1]["test"] and np.isfinite(log[-1]["test"]
                                                      ["CIDEr"])
    results = json.loads((out / "caption_results.json").read_text())
    # --max_steps 2 caps the evaluation too: 2 batches of 4 clips
    assert len(results) == 8 and "pred_caption" in results[0]
    assert all(len(r["tokens"]) == 4 and np.isfinite(r["score"])
               for r in results)
    assert sorted(int(p.name) for p in (out / "checkpoints").iterdir()) \
        == [2]
    # a second run on the same directory resumes and trains no more
    capsys.readouterr()
    again = _run(cfg, out)
    assert "resumed from step 2 (epoch 1)" in capsys.readouterr().out
    assert again.state.step == 2 and again.start_epoch == 1
    for k, p in again.state.trainable.items():
        assert torch.equal(p, runner.state.trainable[k]), k
    again_results = json.loads((out / "caption_results.json").read_text())
    assert again_results == results
    # --evaluate_only from another directory's checkpoints
    ev = tmp_path / "eval"
    _run(cfg, ev, "--evaluate_only", "--resume", str(out))
    ev_log = [json.loads(line) for line in (ev / "log.txt").read_text()
              .splitlines()]
    assert len(ev_log) == 1 and ev_log[0]["test"] == log[-1]["test"]
    assert not (ev / "checkpoints").exists()


def test_run_caption_refuses_what_is_not_ported(tmp_path):
    from youku_mplug_tpu_torch.cli import run_caption

    cfg = tiny_caption_yaml(tmp_path)
    args = run_caption.parser().parse_args([
        "--config", cfg, "--output_dir", str(tmp_path / "o"), "--device",
        "cpu"])
    # files are ported: a YAML that names none raises
    with pytest.raises(ValueError, match="no annotation file"):
        run_caption.prepare(args)
    args.synthetic_data = True
    args.evaluate_only = True
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        run_caption.prepare(args)
    # use_cls is ported: the heads are built, and caption_loss ignores
    # them (test_run_caption_on_the_reference_recipe_keys)
    assert load_config(tiny_caption_yaml(tmp_path, "cls", use_cls=True)
                       ).model.use_cls
    # async_checkpointing is ported: the manager writes in the background
    args.evaluate_only = False
    args.config = tiny_caption_yaml(tmp_path, "async",
                                    async_checkpointing=True)
    assert run_caption.prepare(args)[0].ckpt.async_save
    # a named tokenizer.json is read (JiebaBPE is ported): a broken one
    # raises, never toy ids in its place
    (tmp_path / "tok").mkdir()
    (tmp_path / "tok" / "tokenizer.json").write_text("{}")
    args.config = tiny_caption_yaml(tmp_path, "tok",
                                    text_decoder=str(tmp_path / "tok"))
    with pytest.raises(Exception, match="Model missing"):
        run_caption.prepare(args)


def test_run_caption_on_the_reference_recipe_keys(tmp_path):
    """A tiny copy of caption_gpt3_1.3B_youku_v0.yaml's keys: a clip_model
    tower (norm_pre, heads of 96), the decoder's 0.1 dropouts drawn in
    training, and use_cls.  The cls heads are built and left out of
    caption_loss, as in JAX: they take no gradient and do not move."""
    (tmp_path / "clip.json").write_text(json.dumps(dict(
        TINY_VISION, embed_dim=192, num_heads=2, clip_model=True)))
    (tmp_path / "drop.json").write_text(json.dumps(dict(
        TINY_TEXT, hidden_dropout_prob=0.1,
        attention_probs_dropout_prob=0.1)))
    cfg = tiny_caption_yaml(tmp_path, "ref", use_cls=True,
                            visual_cfg=str(tmp_path / "clip.json"),
                            text_cfg=str(tmp_path / "drop.json"))
    model = load_config(cfg).model
    assert model.use_cls and model.vision.clip_model
    assert model.text.hidden_dropout == model.text.attention_dropout == 0.1
    out = tmp_path / "out"
    runner = _run(cfg, out)
    tm = runner.model
    assert tm.visual_encoder.norm_pre is not None
    assert tm.cls_fc2.kernel.shape[1] == 1  # max(num_classes, 1)
    log = [json.loads(line) for line in (out / "log.txt").read_text()
           .splitlines()]
    assert np.isfinite(log[0]["loss"]) and "CIDEr" in log[-1]["test"]
    assert runner.state.optimizer.config.visual_backbone_scale
    again = tmp_path / "again"
    _run(cfg, again)  # the same seed: the same dropout masks
    log2 = [json.loads(line) for line in (again / "log.txt").read_text()
            .splitlines()]
    assert log2[0]["loss"] == log[0]["loss"]


def test_generation_config_reads_the_yaml(tmp_path):
    from youku_mplug_tpu_torch.cli import run_caption

    args = run_caption.parser().parse_args([
        "--config", tiny_caption_yaml(tmp_path, beam_size=3,
                                      max_new_tokens=7),
        "--output_dir", str(tmp_path / "o"), "--synthetic_data",
        "--device", "cpu", "--fp32"])
    runner, test_loader = run_caption.prepare(args)
    cfg = run_caption.generation_config(runner)
    assert (cfg.beam_size, cfg.max_new_tokens, cfg.eos_id, cfg.pad_id,
            cfg.do_sample) == (3, 7, 2, 2, False)
    assert not test_loader.shuffle and runner.loader.shuffle
    default = tiny_caption_yaml(tmp_path, "default")
    raw = yaml.safe_load(open(default))
    del raw["beam_size"], raw["max_new_tokens"]
    (tmp_path / "default.yaml").write_text(yaml.safe_dump(raw))
    args.config = default
    args.output_dir = str(tmp_path / "o2")
    cfg = run_caption.generation_config(run_caption.prepare(args)[0])
    assert (cfg.beam_size, cfg.max_new_tokens) == (5, 100)
    assert isinstance(cfg, tgen.GenerationConfig)
