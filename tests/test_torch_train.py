"""The port's pretrain slice against the JAX package, at fp32 on the tiny
flagship config with weights carried over by the bridge: the pretrain
loss and every trainable leaf's gradient (with and without the
contrastive branch), a four-step AdamW trajectory through
``make_train_step`` (warmup from lr 0, a skipped non-finite batch,
``update_freq=2``, active clipping), the host-side pieces (targets,
synthetic captions, loader order, tokenizer, config) and the CLI.

Parameters are redrawn from numpy (std 0.2, LayerNorm scales near one,
``temp`` 0.07) so that no weight is zero.  Tolerances: 1e-4 on losses
and gradients (fp32, sums in another order, the fp32 attention backward
rebuilt from lse), 2e-5 on parameters after Adam steps of lr 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from youku_mplug_tpu.models import tasks as jtasks
from youku_mplug_tpu.optim.factory import OptimizerConfig as JOptConfig
from youku_mplug_tpu.runtime.precision import FP32_POLICY as J_FP32
from youku_mplug_tpu.train.state import create_train_state as j_state
from youku_mplug_tpu.train.trainer import make_train_step as j_step
from youku_mplug_tpu_torch import bridge
from youku_mplug_tpu_torch.config import flagship_config, load_config
from youku_mplug_tpu_torch.models import tasks as ttasks
from youku_mplug_tpu_torch.optim.factory import OptimizerConfig
from youku_mplug_tpu_torch.runtime.precision import FP32_POLICY
from youku_mplug_tpu_torch.train.state import create_train_state
from youku_mplug_tpu_torch.train.trainer import make_train_step

torch.set_num_threads(1)
TOL = 1e-4
FLAGSHIP_PRETRAIN = "configs/pretrain/pretrain_gpt3_1.3B_flagship.yaml"


def redraw(tree, rng, std=0.2):
    def leaf(path, x):
        name = str(path[-1].key)
        z = rng.normal(size=x.shape).astype(np.float32)
        if name == "temp":
            return np.float32(0.07)
        return 1.0 + 0.1 * z if name.endswith("scale") else std * z
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def _inputs(rng, b=4, s=12):
    v = _flagship_cfg(tiny=True).vision
    video = rng.normal(size=(b, 3, v.num_frames, v.img_size,
                             v.img_size)).astype(np.float32)
    ids = rng.integers(3, 256, size=(b, s)).astype(np.int32)
    lengths = rng.integers(3, s + 1, size=(b,))
    lengths[0] = s
    mask = (np.arange(s)[None] < lengths[:, None]).astype(np.int32)
    ids = np.where(mask == 1, ids, 2).astype(np.int32)  # padded text
    return video, ids, mask


def _models(contrastive, rng, video, ids, mask):
    cfg = dataclasses.replace(_flagship_cfg(tiny=True),
                              use_contrastive=contrastive)
    jm = jtasks.MPLUGVideo(cfg, policy=J_FP32)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.asarray(video), jnp.asarray(ids),
        jnp.asarray(mask)))["params"]
    params = redraw(shapes, rng)
    tcfg = dataclasses.replace(flagship_config(tiny=True),
                               use_contrastive=contrastive)
    tm = bridge.load_jax_params(ttasks.MPLUGVideo(tcfg, FP32_POLICY), params)
    return jm, params, tm


def _jloss(jm):
    def loss_fn(p, batch, rng=None, step=None):
        return jm.apply({"params": p}, batch["video"], batch["input_ids"],
                        batch["attention_mask"],
                        method=jtasks.MPLUGVideo.pretrain_loss)
    return loss_fn


def _tloss(tm):
    def loss_fn(batch):
        return tm.pretrain_loss(torch.from_numpy(np.asarray(batch["video"])),
                                torch.from_numpy(
                                    np.asarray(batch["input_ids"])).long(),
                                torch.from_numpy(
                                    np.asarray(batch["attention_mask"])))
    return loss_fn


@pytest.mark.parametrize("contrastive", [False, True])
def test_pretrain_loss_and_grads_match_jax(contrastive):
    rng = np.random.default_rng(int(contrastive))
    video, ids, mask = _inputs(rng)
    jm, params, tm = _models(contrastive, rng, video, ids, mask)
    batch = {"video": video, "input_ids": ids, "attention_mask": mask}

    def jfn(p):
        out = _jloss(jm)(p, jax.tree.map(jnp.asarray, batch))
        return out["loss"], out
    (_, jout), jgrads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        params)
    state, _, _ = create_train_state(tm, OptimizerConfig())
    out = _tloss(tm)(batch)
    out["loss"].backward()
    for key in ("loss", "loss_caption", "loss_contrastive"):
        _close(out[key].detach(), jout[key])
    if contrastive:
        assert float(out["loss_contrastive"].detach()) > 0
    jflat = _flat(jgrads)
    assert not any(k.startswith("text_decoder") for k in state.trainable)
    assert set(state.frozen) == {k for k in jflat
                                 if k.startswith("text_decoder")}
    for path, p in state.trainable.items():
        # an unused leaf (temp without the contrastive branch) has no grad
        # in torch and a zero one in JAX
        assert p.grad is not None or path == "temp", path
        _close(torch.zeros_like(p) if p.grad is None else p.grad,
               jflat[path])
    assert all(p.grad is None for p in state.frozen.values())


def test_grads_reach_both_factors_of_the_temporal_fc_fold():
    """The fp32 fold proj @ temporal_fc is differentiable: both factors
    of every block get a nonzero gradient."""
    rng = np.random.default_rng(2)
    video, ids, mask = _inputs(rng)
    _, _, tm = _models(False, rng, video, ids, mask)
    create_train_state(tm, OptimizerConfig())
    _tloss(tm)({"video": video, "input_ids": ids,
                "attention_mask": mask})["loss"].backward()
    for blk in tm.visual_encoder.blocks:
        assert blk.temporal_attn.proj_kernel.grad.abs().sum() > 0
        assert blk.temporal_fc_kernel.grad.abs().sum() > 0


def _opt_kwargs():
    return dict(lr=1e-3, min_lr=1e-5, weight_decay=0.05,
                opt_betas=(0.9, 0.999), opt_eps=1e-6, clip_grad=0.3,
                warmup_steps=2, epochs=1, niter_per_ep=10)


def test_adamw_trajectory_matches_jax():
    """Four steps at update_freq 2: step 1 has lr schedule(0) = 0 (the
    parameters do not move), step 2 is non-finite and skipped (the
    optimizer count stays, so step 3 runs at schedule(1)), steps 3 and 4
    move; clipping at 0.3 is active.  Losses, grad norms and trainable
    parameters after every step against JAX's create_train_state +
    make_train_step; the frozen decoder stays bitwise."""
    rng = np.random.default_rng(3)
    video, ids, mask = _inputs(rng)
    jm, params, tm = _models(True, rng, video, ids, mask)
    batches = []
    for i in range(4):
        v, t, m = _inputs(np.random.default_rng(10 + i))
        if i == 1:
            v[1, 0, 0, 0, 0] = np.nan
        batches.append({"video": v, "input_ids": t, "attention_mask": m})

    jst, tx, _ = j_state(params, JOptConfig(**_opt_kwargs()))
    jtrain = jax.jit(j_step(_jloss(jm), tx, update_freq=2))
    state, opt, _ = create_train_state(tm, OptimizerConfig(**_opt_kwargs()))
    ttrain = make_train_step(_tloss(tm), update_freq=2)
    frozen0 = {k: p.detach().clone() for k, p in state.frozen.items()}
    start = {k: p.detach().clone() for k, p in state.trainable.items()}
    for i, batch in enumerate(batches):
        jst, jmet = jtrain(jst, jax.tree.map(jnp.asarray, batch),
                           jax.random.key(0))
        met = ttrain(state, batch)
        assert met["skipped_nonfinite"] == float(jmet["skipped_nonfinite"]) \
            == (1.0 if i == 1 else 0.0)
        if i != 1:
            _close(met["loss"], jmet["loss"])
            _close(met["grad_norm"], jmet["grad_norm"])
            assert met["grad_norm"] > 0.3  # clipping is active
        jtrain_flat = _flat(jax.device_get(jst.trainable))
        for path, p in state.trainable.items():
            _close(p.detach(), jtrain_flat[path], 2e-5)
            if i <= 1:  # lr 0, then a skipped step
                assert torch.equal(p.detach(), start[path]), path
        assert opt.count == int(jst.opt_state[1][0].count) \
            == [1, 1, 2, 3][i]
        assert state.step == i + 1
    assert any(not torch.equal(p.detach(), start[k])
               for k, p in state.trainable.items())
    for k, p in state.frozen.items():
        assert torch.equal(p.detach(), frozen0[k]), k
    # the whole model back as a JAX tree equals JAX's merged parameters
    got = _flat(bridge.to_jax_tree(tm))
    want = _flat(jax.device_get(jst.params))
    assert set(got) == set(want)
    for path, value in want.items():
        _close(got[path], value, 2e-5)


def test_prefix_lm_targets_match_jax():
    """Labels shift left with column 0 wrapping to the end; query slots
    hold min(100, V - 1); the mask is [0 x nq ; mask[:, 1:]]."""
    rng = np.random.default_rng(4)
    ids = rng.integers(3, 90, size=(3, 7)).astype(np.int32)
    mask = np.array([[1] * 7, [1] * 4 + [0] * 3, [1] * 2 + [0] * 5],
                    np.int32)
    for vocab in (None, 50, 512):
        jl, jmask = jtasks.prefix_lm_targets(
            jnp.asarray(ids), jnp.asarray(mask), 5, vocab_size=vocab)
        tl, tmask = ttasks.prefix_lm_targets(
            torch.from_numpy(ids), torch.from_numpy(mask), 5,
            vocab_size=vocab)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert tl[0, -1] == ids[0, 0] and tl[0, 0] == 100
    assert ttasks.prefix_lm_targets(torch.from_numpy(ids),
                                    torch.from_numpy(mask), 2,
                                    vocab_size=50)[0][0, 0] == 49


def test_synthetic_dataset_yields_the_jax_samples():
    """Every field of the JAX dataset, captions included (the pretrain
    loop tokenizes ``text``)."""
    from youku_mplug_tpu.data.datasets import SyntheticVideoDataset as JDs
    from youku_mplug_tpu_torch.data.datasets import SyntheticVideoDataset

    jds, tds = JDs(8, 2, 16), SyntheticVideoDataset(8, 2, 16)
    for i in (0, 3, 7):
        want, got = jds[i], tds[i]
        assert set(got) == set(want)
        np.testing.assert_array_equal(got.pop("video"), want.pop("video"))
        assert got == want


def test_loader_order_matches_sharded_loader():
    from youku_mplug_tpu.data.loader import ShardedLoader
    from youku_mplug_tpu_torch.data.datasets import SyntheticVideoDataset
    from youku_mplug_tpu_torch.data.loader import Loader

    ds = SyntheticVideoDataset(11, 2, 8)
    tl = Loader(ds, 3, seed=5)
    jl = ShardedLoader(ds, 3, seed=5, num_workers=1, process_index=0,
                       process_count=1)
    assert len(tl) == len(jl) == 3
    for epoch in (0, 1):
        tl.set_epoch(epoch)
        jl.set_epoch(epoch)
        got = [b["index"].tolist() for b in tl]
        want = [b["index"].tolist() for b in jl]
        assert got == want
        assert all(len(b) == 3 for b in got)  # drop_last


def test_batch_tokenizer_matches_jax():
    from youku_mplug_tpu.models.tokenizer import BatchTokenizer as JBT
    from youku_mplug_tpu.models.tokenizer import ToyTokenizer as JToy
    from youku_mplug_tpu_torch.models.tokenizer import (
        BatchTokenizer,
        ToyTokenizer,
    )

    texts = ["synthetic clip 3 class 3", "a", "一段很长的视频描述" * 3]
    want = JBT(JToy(512), 12)(texts, padding="max_length")
    got = BatchTokenizer(ToyTokenizer(512), 12)(texts)
    for key in ("input_ids", "attention_mask"):
        assert got[key].dtype == want[key].dtype == np.int32
        np.testing.assert_array_equal(got[key], want[key])


def test_flagship_pretrain_yaml_matches_jax_and_flagship():
    """Both loaders read the new YAML to the same model and optimizer;
    the model is _flagship_cfg()."""
    from youku_mplug_tpu.config import load_config as j_load_config

    t, j = load_config(FLAGSHIP_PRETRAIN), j_load_config(FLAGSHIP_PRETRAIN)
    assert t.model == flagship_config()
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
                "update_freq"):
        assert getattr(t, key) == getattr(j, key), key
    assert (t.batch_size, t.max_length, t.model.text.ce_chunk) == (16, 80, 32)


TINY_YAML = "configs/pretrain/pretrain_tiny_no_dropout.yaml"


def test_run_pretrain_cli_two_steps_on_cpu(tmp_path, capsys):
    import json

    from youku_mplug_tpu_torch.cli import run_pretrain

    out = tmp_path / "out"
    args = run_pretrain.base_parser().parse_args([
        "--config", TINY_YAML, "--output_dir", str(out), "--synthetic_data",
        "--max_steps", "2", "--seed", "1", "--device", "cpu"])
    runner = run_pretrain.main(args)
    assert len(runner.history) == 2
    for step, h in enumerate(runner.history, start=1):
        assert np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
        assert h["skipped_nonfinite"] == 0 and h["loss_contrastive"] > 0
        # the logged lr is the schedule at the step counter, as in JAX
        assert h["step_time"] > 0 and h["lr"] == runner.schedule(step)
    assert runner.state.optimizer.count == runner.state.step == 2
    log = [json.loads(line) for line in (out / "log.txt").read_text()
           .splitlines()]
    assert log[0]["epoch"] == 0 and np.isfinite(log[0]["loss"])
    printed = capsys.readouterr().out
    assert "step 2:" in printed
    # the epoch's checkpoint (tests/test_torch_checkpoint.py holds its
    # contents) and the merged config beside the log
    assert sorted(p.name for p in out.iterdir()
                  if p.name != "tb") == ["checkpoints", "config.yaml",
                                         "log.txt"]
    assert runner.ckpt.all_steps() == [2]


def test_run_pretrain_refuses_cuda_without_a_card(tmp_path):
    from youku_mplug_tpu_torch.cli import run_pretrain

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = run_pretrain.base_parser().parse_args([
        "--config", TINY_YAML, "--synthetic_data", "--device", "cuda",
        "--output_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_pretrain.setup(args)
