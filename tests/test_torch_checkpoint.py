"""Checkpoints, resume and the non-finite rollback of the port's training
CLIs (youku_mplug_tpu_torch.train.checkpoint, cli/common.py) on the CPU
at the tiny pretrain config: a bitwise round trip of the whole train
state (fp32 trainable leaves, bf16 frozen ones, AdamW moments by path,
the update count and the step), retention and an interrupted save, the
resume rules of the JAX package's ``cli/common.resume_state``, the
vision-embedding resize against the JAX package's (1e-6: float64
interpolation cast to fp32 in both), the rollback after 3 non-finite
steps, and ``run_pretrain`` saving and resuming.  Also: an asynchronous
save racing the next step (its write held back until the step has
changed every trainable leaf in place) restores the state of its own
step bitwise; a zoo optimizer's state (lookahead slow weights, nadam's
momentum schedule) round-trips; a ``state.pt`` in the form written
before the zoo (AdamW moments under ``adam``) still restores.
"""

import json
import os
import threading
import types
import unittest.mock as mock

import numpy as np
import pytest
import torch
import yaml

from youku_mplug_tpu_torch.cli import common, run_pretrain
from youku_mplug_tpu_torch.train import checkpoint as ckpt_mod
from youku_mplug_tpu_torch.train.checkpoint import (
    CheckpointManager,
    state_dict,
)

torch.set_num_threads(1)
TINY_YAML = "configs/pretrain/pretrain_tiny_no_dropout.yaml"


def _yaml(tmp_path, name="tiny", **over):
    raw = yaml.safe_load(open(TINY_YAML))
    raw.update(over)
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def _args(config, out, *extra):
    return run_pretrain.base_parser().parse_args([
        "--config", config, "--output_dir", str(out), "--synthetic_data",
        "--device", "cpu", *extra])


def _train(runner, steps):
    step = run_pretrain.build_train_step(runner)
    runner.args.max_steps = steps
    return common.train_one_epoch(runner, step, runner.state.step,
                                  run_pretrain.make_batch)


def _equal_states(a, b):
    for part in ("trainable", "frozen"):
        da, db = getattr(a, part), getattr(b, part)
        assert set(da) == set(db)
        for k in da:
            assert da[k].dtype == db[k].dtype and torch.equal(da[k], db[k]), k
    sa, sb = a.optimizer.leaf_state(), b.optimizer.leaf_state()
    assert set(sa) == set(sb)
    for k in sa:
        ma, mb = sa[k], sb[k]
        assert set(ma) == set(mb), k
        for key in ma:
            assert torch.equal(ma[key], mb[key].to(ma[key].device)), (k, key)
    assert a.optimizer.scalars() == b.optimizer.scalars()
    assert a.optimizer.count == b.optimizer.count
    assert a.step == b.step


def test_round_trip_is_bitwise_and_training_continues(tmp_path):
    runner = run_pretrain.setup(_args(TINY_YAML, tmp_path / "a", "--seed",
                                      "1"))
    _train(runner, 2)
    state = runner.state
    assert any(p.dtype == torch.bfloat16 for p in state.frozen.values())
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    assert ckpt.save(state.step, state, metadata={"epoch": 1})
    raw = torch.load(tmp_path / "ckpt" / "2" / "state.pt",
                     weights_only=True)
    assert set(raw) == {"trainable", "frozen", "optim", "optim_scalars",
                        "opt", "count", "step"}
    assert set(raw["optim"]) == set(state.trainable)
    assert raw["opt"] == "adamw" and raw["optim_scalars"] == {}
    assert ckpt.restore_metadata(2) == {"epoch": 1}
    other = run_pretrain.setup(_args(TINY_YAML, tmp_path / "b", "--seed",
                                     "2"))
    ckpt.restore(2, other.state)
    _equal_states(state, other.state)
    assert other.schedule(other.state.optimizer.count) == \
        runner.schedule(state.optimizer.count)
    # one more step from each: the same update, bit for bit
    runner.loader.set_epoch(0)
    batch = run_pretrain.make_batch(runner, next(iter(runner.loader)))
    for r in (runner, other):
        run_pretrain.build_train_step(r)(r.state, batch)
    _equal_states(state, other.state)


def _clone_state(state):
    """A deep copy of what a checkpoint holds, for bitwise comparison."""
    return {"trainable": {k: p.detach().clone()
                          for k, p in state.trainable.items()},
            "frozen": {k: p.detach().clone() for k, p in state.frozen.items()},
            "optim": {k: {n: v.clone() for n, v in leaf.items()}
                      for k, leaf in state.optimizer.leaf_state().items()},
            "count": state.optimizer.count, "step": state.step}


def _assert_state_is(state, want):
    for part in ("trainable", "frozen"):
        got = getattr(state, part)
        assert set(got) == set(want[part])
        for k, p in got.items():
            assert torch.equal(p.detach(), want[part][k]), k
    got = state.optimizer.leaf_state()
    assert set(got) == set(want["optim"])
    for k, leaf in got.items():
        for n, v in leaf.items():
            assert torch.equal(v, want["optim"][k][n]), (k, n)
    assert (state.optimizer.count, state.step) == (want["count"],
                                                   want["step"])


@pytest.mark.parametrize("opt", ["adamw", "lookahead_nadam"])
def test_async_save_racing_a_step_resumes_bitwise(tmp_path, opt):
    """The step-2 save is asynchronous and its write waits until step 3
    has updated the parameters and moments in place: the checkpoint holds
    step 2's state bitwise (the host snapshot), reads wait for the write,
    and a resumed run's next step equals the unbroken run's."""
    cfg = _yaml(tmp_path, optimizer={"opt": opt, "lr": 1e-3,
                                     "weight_decay": 0.01, "clip_grad": 3.0},
                async_checkpointing=True)
    runner = run_pretrain.setup(_args(cfg, tmp_path / "a", "--seed", "3"))
    assert runner.ckpt.async_save
    _train(runner, 2)
    before = _clone_state(runner.state)
    stepped = threading.Event()
    real_save = torch.save

    def held_save(obj, path):
        assert stepped.wait(60)  # the write starts after step 3
        real_save(obj, path)

    with mock.patch.object(ckpt_mod.torch, "save", side_effect=held_save):
        assert runner.ckpt.save(2, runner.state, metadata={"epoch": 1})
        runner.loader.set_epoch(0)
        batch = run_pretrain.make_batch(runner, next(iter(runner.loader)))
        run_pretrain.build_train_step(runner)(runner.state, batch)
        stepped.set()
        assert runner.ckpt.latest_step() == 2  # waits for the write
    moved = [k for k, p in runner.state.trainable.items()
             if not torch.equal(p.detach(), before["trainable"][k])]
    assert moved, "step 3 changed nothing: the race is not exercised"
    other = run_pretrain.setup(_args(cfg, tmp_path / "b", "--seed", "4"))
    runner.ckpt.restore(2, other.state)
    _assert_state_is(other.state, before)
    run_pretrain.build_train_step(other)(other.state, batch)
    _assert_state_is(other.state, _clone_state(runner.state))
    runner.ckpt.close()


def test_zoo_state_round_trips_and_refuses_another_optimizer(tmp_path):
    cfg = _yaml(tmp_path, optimizer={"opt": "lookahead_nadam", "lr": 1e-3})
    runner = run_pretrain.setup(_args(cfg, tmp_path / "a"))
    _train(runner, 2)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save(2, runner.state)
    raw = ckpt.restore_raw(2)
    assert raw["opt"] == "lookahead_nadam"
    assert set(raw["optim_scalars"]) == {"m_schedule"}
    assert all(set(v) == {"mu", "nu", "slow"} for v in raw["optim"].values())
    other = run_pretrain.setup(_args(cfg, tmp_path / "b", "--seed", "5"))
    ckpt.restore(2, other.state)
    _equal_states(runner.state, other.state)
    adamw = run_pretrain.setup(_args(TINY_YAML, tmp_path / "c"))
    with pytest.raises(ValueError, match="optimizer state of"):
        ckpt.restore(2, adamw.state)


def test_a_pre_zoo_adam_checkpoint_still_restores(tmp_path):
    """The form written before the zoo: AdamW's moments under ``adam``, no
    ``optim_scalars`` or ``opt``."""
    runner = run_pretrain.setup(_args(TINY_YAML, tmp_path / "a"))
    _train(runner, 2)
    old = state_dict(runner.state)
    old["adam"] = old.pop("optim")
    del old["optim_scalars"], old["opt"]
    os.makedirs(tmp_path / "ckpt" / "2")
    torch.save(old, tmp_path / "ckpt" / "2" / "state.pt")
    other = run_pretrain.setup(_args(TINY_YAML, tmp_path / "b", "--seed",
                                     "2"))
    CheckpointManager(str(tmp_path / "ckpt")).restore(2, other.state)
    _equal_states(runner.state, other.state)


def test_retention_rollback_and_interrupted_save(tmp_path):
    runner = run_pretrain.setup(_args(TINY_YAML, tmp_path / "a"))
    ckpt = CheckpointManager(str(tmp_path / "ckpt"), keep=3)
    assert ckpt.all_steps() == [] and ckpt.latest_step() is None
    assert ckpt.rollback_step() is None
    assert ckpt.save(1, runner.state)
    assert ckpt.rollback_step() == 1
    for step in (2, 3, 4, 5):
        assert ckpt.save(step, runner.state)
    assert ckpt.all_steps() == [3, 4, 5] and ckpt.rollback_step() == 4
    assert not ckpt.save(5, runner.state) and not ckpt.save(4, runner.state)
    assert ckpt.restore_metadata(5) is None
    # a save killed before its rename, and a step directory without state
    (tmp_path / "ckpt" / ".tmp-9-123").mkdir()
    torch.save({}, tmp_path / "ckpt" / ".tmp-9-123" / "state.pt")
    (tmp_path / "ckpt" / "8").mkdir()
    assert ckpt.latest_step() == 5
    ckpt.wait_until_finished()
    ckpt.close()


def test_restore_refuses_another_trainable_set(tmp_path):
    runner = run_pretrain.setup(_args(TINY_YAML, tmp_path / "a"))
    _train(runner, 1)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save(runner.state.step, runner.state)
    other = run_pretrain.setup(_args(_yaml(tmp_path, freeze_vit=True),
                                     tmp_path / "b"))
    before = {k: p.clone() for k, p in other.state.trainable.items()}
    with pytest.raises(ValueError, match="leaves differ"):
        ckpt.restore(runner.state.step, other.state)
    for k, p in other.state.trainable.items():
        assert torch.equal(p, before[k])
    assert other.state.optimizer.count == 0 and other.state.step == 0


def _resume_args(tmp_path, **kw):
    d = dict(resume="", evaluate_only=False,
             output_dir=str(tmp_path / "out"))
    d.update(kw)
    return types.SimpleNamespace(**d)


@pytest.mark.parametrize("case", ["missing_resume", "missing_evaluate_only",
                                  "fresh_run"])
def test_resume_state_rules_as_jax(tmp_path, case):
    """JAX tests/test_resume_state.py: a --resume or --evaluate_only with
    no checkpoint raises; a fresh run starts at epoch 0 with its state."""
    ckpt = CheckpointManager(str(tmp_path / "out" / "checkpoints"))
    if case == "fresh_run":
        assert common.resume_state(_resume_args(tmp_path), ckpt,
                                   state="s") == ("s", 0)
        return
    empty = tmp_path / "elsewhere"
    empty.mkdir()
    args = (_resume_args(tmp_path, resume=str(empty))
            if case == "missing_resume"
            else _resume_args(tmp_path, evaluate_only=True))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        common.resume_state(args, ckpt, state=None)


@pytest.mark.parametrize("what", ["frames", "resolution"])
def test_resume_resizes_vision_embeds_and_resets_the_optimizer(tmp_path,
                                                               what):
    """A checkpoint at 2 frames (32 px) resumed at 4 frames (or 48 px):
    the temporal (or position) embedding interpolated as the JAX package
    does, every other leaf as saved, the optimizer and step fresh."""
    from youku_mplug_tpu.models.importers import (
        resize_pos_embed as j_pos,
        resize_temporal_embed as j_temp,
    )

    src = run_pretrain.setup(_args(TINY_YAML, tmp_path / "src"))
    _train(src, 1)
    common.save_epoch(src, 0)
    over = ({"num_frames": 4} if what == "frames" else
            {"image_res": 48, "visual_overrides": {
                **yaml.safe_load(open(TINY_YAML))["visual_overrides"],
                "img_size": 48}})
    dst = run_pretrain.setup(_args(_yaml(tmp_path, **over), tmp_path / "dst",
                                   "--resume", str(tmp_path / "src")))
    leaf = ("visual_encoder/temporal_embed" if what == "frames"
            else "visual_encoder/pos_embed")
    saved = src.state.trainable[leaf].detach().numpy()
    want = (j_temp(saved, 4) if what == "frames"
            else j_pos(saved, 9))
    got = dst.state.trainable[leaf].detach().numpy()
    assert got.shape == want.shape != saved.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    for part in ("trainable", "frozen"):
        for k, p in getattr(dst.state, part).items():
            if k != leaf:
                assert torch.equal(p, getattr(src.state, part)[k]), k
    assert dst.state.optimizer.count == 0 and dst.state.step == 0
    assert not dst.state.optimizer.torch_optimizer.state
    assert dst.start_epoch == 1
    # a mismatch the resize cannot mend raises the exact restore's error
    bad = _yaml(tmp_path, "bad", num_learnable_token=4)
    with pytest.raises(ValueError, match="shapes differ"):
        run_pretrain.setup(_args(bad, tmp_path / "bad", "--resume",
                                 str(tmp_path / "src")))


@pytest.mark.parametrize("shape,new", [((1, 5, 6), 8), ((1, 4, 3), 3),
                                       ((1, 3, 16), 2)])
def test_resize_temporal_embed_matches_jax(shape, new):
    from youku_mplug_tpu.models.importers import resize_temporal_embed as j
    from youku_mplug_tpu_torch.models.importers import resize_temporal_embed

    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    np.testing.assert_allclose(resize_temporal_embed(x, new), j(x, new),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("grid,new", [(4, 9), (3, 25), (5, 4), (4, 16)])
def test_resize_pos_embed_matches_jax(grid, new):
    from youku_mplug_tpu.models.importers import resize_pos_embed as j
    from youku_mplug_tpu_torch.models.importers import resize_pos_embed

    x = np.random.default_rng(grid).normal(
        size=(1, 1 + grid * grid, 8)).astype(np.float32)
    got = resize_pos_embed(x, new)
    assert got.shape == (1, 1 + new, 8)
    np.testing.assert_allclose(got, j(x, new), rtol=1e-6, atol=1e-6)


def test_rollback_after_three_non_finite_steps(tmp_path, capsys):
    """Checkpoints at steps 2 and 3; then 3 steps on clips with a NaN: the
    third restores the second-latest checkpoint (step 2) in place."""
    runner = run_pretrain.setup(_args(_yaml(tmp_path, synthetic_length=12),
                                      tmp_path / "run"))
    _train(runner, 2)
    common.save_epoch(runner, 0)
    at2 = {k: p.clone() for k, p in runner.state.trainable.items()}
    _train(runner, 1)
    common.save_epoch(runner, 1)
    assert runner.ckpt.all_steps() == [2, 3]

    def poisoned(r, raw):
        batch = run_pretrain.make_batch(r, raw)
        batch["video"] = batch["video"].float()
        batch["video"][0, 0, 0, 0, 0] = float("nan")
        return batch

    step = run_pretrain.build_train_step(runner)
    runner.args.max_steps = 3
    capsys.readouterr()
    history = common.train_one_epoch(runner, step, 2, poisoned)
    printed = capsys.readouterr().out
    assert [h["skipped_nonfinite"] for h in history] == [1.0] * 3
    assert "(streak 3)" in printed
    assert "rolling back to checkpoint step 2" in printed
    assert runner.state.step == 2 and runner.state.optimizer.count == 2
    for k, p in runner.state.trainable.items():
        assert torch.equal(p, at2[k]), k
    # two non-finite steps in a row are not enough
    runner.args.max_steps = 2
    common.train_one_epoch(runner, step, 3, poisoned)
    assert runner.state.step == 4


def test_run_pretrain_saves_each_epoch_and_resumes(tmp_path, capsys):
    cfg = _yaml(tmp_path, schedular={"epochs": 2, "min_lr": 1e-5,
                                     "warmup_steps": 0,
                                     "lr_sched_type": "cosine"})
    out = tmp_path / "out"
    runner = run_pretrain.main(_args(cfg, out, "--max_steps", "1"))
    assert runner.ckpt.all_steps() == [1, 2]
    assert runner.ckpt.restore_metadata(2) == {"epoch": 2}
    assert os.path.exists(out / "config.yaml")
    log = [json.loads(x) for x in (out / "log.txt").read_text().splitlines()]
    assert [entry["epoch"] for entry in log] == [0, 1]
    capsys.readouterr()
    again = run_pretrain.main(_args(cfg, out, "--max_steps", "1"))
    assert "resumed from step 2 (epoch 2)" in capsys.readouterr().out
    _equal_states(runner.state, again.state)
    assert len((out / "log.txt").read_text().splitlines()) == 2
    # --save_ckpt_freq 2 saves every second epoch only
    other = run_pretrain.main(_args(cfg, tmp_path / "o2", "--max_steps", "1",
                                    "--save_ckpt_freq", "2"))
    assert other.ckpt.all_steps() == [2]
