"""``run_instruct --train`` (rank-2 LoRA on Bloom and the ViT) under
(data, model) splits on CPU processes over gloo, against the unsharded
port and the JAX package, and the dp == tp check of ``__graft_entry__``.

Two worlds run at once (2 ranks: (2,1), (1,2), then a (1,2) run resumed
from the (2,1) run's checkpoint; 4 ranks: (2,2) and (1,4)); each run
trains the tiny Owl of ``tests/torch_owl_mesh_worker.py`` in fp32 (its
weights redrawn from a seed, every ``lora_*_b`` non-zero) one step an
epoch on batches of 4 synthetic clips; the unsharded (1,1) run, three
epochs, runs in this process.  At fp32:

- (1,1)'s first step: its loss within rtol 1e-4 of JAX's
  ``instruct_loss`` under JAX's ``make_train_step``, and every trainable
  leaf after it (the abstractor, ``visual_fc``, ``vit_eos``, every
  adapter) within 1e-5 of JAX's;
- every split's losses and grad norms at each step within 1e-4 of
  (1,1)'s, and its unsharded checkpoint's trainable leaves (the split
  abstractor and the adapters on split products included) within 1e-5
  of (1,1)'s and of JAX's after the first step;
- the resumed run restarts at (1,1)'s third step, with its loss and its
  leaves after it;
- the dp == tp check: the check's Owl (``__graft_entry__.py``'s config)
  gives JAX's loss, computed here, at (1,1) and at every split.

Every process group has an explicit timeout; a world that outlives its
deadline is terminated and the test fails.
"""

import dataclasses
import json
import os
import sys
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from youku_mplug_tpu.models import owl as jowl
from youku_mplug_tpu.models.bloom import BloomConfig as JBloomConfig
from youku_mplug_tpu.models.vision import VisionConfig as JVisionConfig
from youku_mplug_tpu.ops.preprocess import normalize_clip as jnorm
from youku_mplug_tpu.optim.factory import OptimizerConfig as JOpt
from youku_mplug_tpu.runtime.precision import FP32_POLICY as J_FP32
from youku_mplug_tpu.train.state import create_train_state as j_state
from youku_mplug_tpu.train.trainer import make_train_step as j_step
from youku_mplug_tpu_torch import bridge
from youku_mplug_tpu_torch.cli import run_instruct
from youku_mplug_tpu_torch.train.checkpoint import CheckpointManager

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_owl_mesh as serve_tests  # noqa: E402
import torch_owl_mesh_worker as worker  # noqa: E402

torch.set_num_threads(1)
LOSS_TOL = 1e-4
LEAF_TOL = 1e-5
WORLDS = {2: [{"tag": "2x1", "epochs": 2}, {"tag": "1x2", "epochs": 2},
              {"tag": "1x2", "epochs": 3, "resume": "train_2x1",
               "name": "1x2_resumed"}],
          4: [{"tag": "2x2", "epochs": 2}, {"tag": "1x4", "epochs": 2}]}
SPLITS = ["2x1", "1x2", "2x2", "1x4"]
DPTP = {2: ["2x1", "1x2"], 4: ["2x2", "1x4", "4x1"]}


def _history(d, name):
    """{rank: history file} of one run."""
    out = {}
    for f in sorted(os.listdir(os.path.join(d, f"train_{name}"))):
        if f.startswith("history_rank"):
            with open(os.path.join(d, f"train_{name}", f)) as fh:
                out[int(f[len("history_rank"):-5])] = json.load(fh)
    return out


def _leaves(d, name, step):
    raw = CheckpointManager(os.path.join(d, f"train_{name}", "checkpoints")
                            ).restore_raw(step, map_location="cpu")
    return {k: v.float().numpy() for k, v in raw["trainable"].items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("owl_train_mesh"))
    worker.write_inputs(d)
    for run in WORLDS[2]:
        if "resume" in run:
            run["resume"] = os.path.join(d, run["resume"])
    worlds = [serve_tests.start("train", world, d, {"runs": runs})
              for world, runs in WORLDS.items()]
    batches = []
    make = run_instruct.make_instruct_batch

    def recording(runner, raw):
        out = make(runner, raw)
        batches.append({k: v.cpu().numpy() for k, v in out.items()})
        return out
    with mock.patch.object(run_instruct, "make_instruct_batch", recording):
        base = worker.train_split("1x1", d, 3)
    for procs in worlds:
        serve_tests.finish(procs)
    return {"dir": d, "base": base, "batches": batches}


@pytest.fixture(scope="module")
def jax_step(runs):
    """JAX's first step from the runs' initial weights on (1,1)'s first
    batch: (metrics, trainable leaves after it)."""
    base = runs["base"]
    jm = jowl.MPLUGOwlVideo(serve_tests._jax_cfg(os.path.join(
        runs["dir"], "train_1x1", "train.yaml")), policy=J_FP32)
    fresh = run_instruct.MPLUGOwlVideo(base.model.cfg, worker.FP32_POLICY)
    params = worker.redraw(bridge.to_jax_tree(fresh),
                           np.random.default_rng(worker.SEED))
    opt = JOpt(**dataclasses.asdict(base.cfg.optimizer))
    state, tx, _ = j_state(jax.tree.map(jnp.asarray, params), opt)

    def loss_fn(p, b, rng=None, step=None):
        return jm.apply({"params": p}, jnorm(b["video"], dtype=jnp.float32),
                        b["input_ids"],
                        b["attention_mask"], b["media_mask"],
                        b["prompt_mask"],
                        method=jowl.MPLUGOwlVideo.instruct_loss)
    b = {k: jnp.asarray(v) for k, v in runs["batches"][0].items()}
    state, met = jax.jit(j_step(loss_fn, tx))(state, b, jax.random.key(0))
    flat = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, path)
            else:
                flat[path] = np.asarray(v)
    walk(jax.device_get(state.trainable))
    return {k: float(v) for k, v in met.items()}, flat


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def test_unsharded_first_step_matches_jax(runs, jax_step):
    met, leaves = jax_step
    h = runs["base"].history[0]
    _close(h["loss"], met["loss"], LOSS_TOL, "loss")
    _close(h["grad_norm"], met["grad_norm"], LOSS_TOL, "grad_norm")
    got = _leaves(runs["dir"], "1x1", 1)
    assert set(got) == set(leaves)
    assert sum("lora_" in k for k in got) == 16  # Bloom's 8, the ViT's 8
    for k, v in leaves.items():
        _close(got[k], v, LEAF_TOL, k)


@pytest.mark.parametrize("tag", SPLITS)
def test_split_steps_equal_unsharded(runs, tag):
    base = runs["base"].history
    hist = _history(runs["dir"], tag)
    assert len(hist) == int(tag[0]) * int(tag[2])
    for rec in hist.values():
        assert len(rec["history"]) == 2
        for got, want in zip(rec["history"], base):
            assert got["skipped_nonfinite"] == 0
            _close(got["loss"], want["loss"], LOSS_TOL, "loss")
        # the first step's: later ones hang on the abstractor's keys,
        # whose gradients nearly cancel (a 1e-5 move there shifts them
        # by a percent), as JAX's own do against (1,1)'s
        _close(rec["history"][0]["grad_norm"], base[0]["grad_norm"],
               LOSS_TOL, "grad_norm")
        # the adapters on split products are the leaves summed over
        # the model group; the abstractor's q/k/v/out/w1-3/ffn_ln split
        assert bool(rec["partial"]) == (int(tag[2]) > 1)
        assert all("lora_" in k for k in rec["partial"])
        assert bool(rec["split"]) == (int(tag[2]) > 1)


@pytest.mark.parametrize("step", [1, 2])
@pytest.mark.parametrize("tag", SPLITS)
def test_split_checkpoint_leaves_equal_unsharded(runs, tag, step):
    want = _leaves(runs["dir"], "1x1", step)
    got = _leaves(runs["dir"], tag, step)
    assert set(got) == set(want)
    for k, v in want.items():
        _close(got[k], v, LEAF_TOL, k)


@pytest.mark.parametrize("tag", SPLITS)
def test_split_first_step_leaves_match_jax(runs, jax_step, tag):
    got = _leaves(runs["dir"], tag, 1)
    for k, v in jax_step[1].items():
        _close(got[k], v, LEAF_TOL, k)


def test_a_run_resumes_at_another_split(runs):
    """(1,2) resumes (2,1)'s checkpoint at step 2 and takes (1,1)'s third
    step: its loss and its leaves after it."""
    hist = _history(runs["dir"], "1x2_resumed")
    for rec in hist.values():
        assert rec["start_epoch"] == 2 and len(rec["history"]) == 1
        _close(rec["history"][0]["loss"], runs["base"].history[2]["loss"],
               LOSS_TOL, "loss")
    want = _leaves(runs["dir"], "1x1", 3)
    got = _leaves(runs["dir"], "1x2_resumed", 3)
    for k, v in want.items():
        _close(got[k], v, LEAF_TOL, k)


# ----- the dp == tp check of __graft_entry__ -----

@pytest.fixture(scope="module")
def dptp(tmp_path_factory):
    """JAX's loss of the check's Owl (its tiny config, the check's batch
    layout at batch 8, ``init`` seed 7) and the port's at each split."""
    d = str(tmp_path_factory.mktemp("owl_dptp"))
    jcfg = jowl.MPLUGOwlVideoConfig(
        vision=JVisionConfig(img_size=16, patch_size=8, embed_dim=32,
                             depth=1, num_heads=4, num_frames=2,
                             attn_impl="xla", clip_model=True),
        abstractor=jowl.OwlAbstractorConfig(
            hidden_size=32, num_layers=1, num_heads=4, intermediate_size=64,
            num_queries=4),
        text=JBloomConfig(vocab_size=256, hidden_size=32,
                          num_hidden_layers=2, num_attention_heads=4,
                          attn_impl="xla", decode_attn_impl="gather"))
    owl = jowl.MPLUGOwlVideo(jcfg, policy=J_FP32)
    batch, s_len = 8, 12
    rng = np.random.default_rng(0)
    inputs = {"video": rng.normal(size=(batch, 3, 2, 16, 16)).astype(
        np.float32), "input_ids": np.ones((batch, s_len), np.int32) * 7}
    media = np.zeros((batch, s_len), np.int32)
    media[:, 1:1 + jcfg.num_media_tokens] = 1
    prompt = np.zeros((batch, s_len), np.int32)
    prompt[:, :6] = 1
    inputs.update(attention_mask=np.ones((batch, s_len), np.int32),
                  media_mask=media, prompt_mask=prompt)
    args = [jnp.asarray(inputs[k]) for k in (
        "video", "input_ids", "attention_mask", "media_mask", "prompt_mask")]
    params = owl.init(jax.random.key(7), *args)["params"]
    want = float(jax.jit(lambda p: owl.apply({"params": p}, *args)["loss"])(
        params))
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}/{k}")
            else:
                flat[f"{prefix}/{k}"] = np.asarray(v)
    walk(jax.device_get(params), "params")
    path = os.path.join(d, "inputs.npz")
    np.savez(path, **flat, **inputs)
    worlds = [serve_tests.start("units", world, d,
                                {"dptp": tags, "inputs": path})
              for world, tags in DPTP.items()]
    got = {"1x1": worker.dptp_loss("1x1", path)}
    for procs in worlds:
        serve_tests.finish(procs)
    for tags in DPTP.values():
        for tag in tags:
            n = int(tag[0]) * int(tag[2])
            got[tag] = []
            for r in range(n):
                with open(os.path.join(d, f"dptp_{tag}_rank{r}.json")) as f:
                    got[tag].append(json.load(f)["loss"])
    return want, got, d


@pytest.mark.parametrize("tag", ["1x1"] + [t for ts in DPTP.values()
                                           for t in ts])
def test_dp_equals_tp_on_the_owl_as_jax(dptp, tag):
    want, got, _ = dptp
    losses = got[tag] if isinstance(got[tag], list) else [got[tag]]
    assert np.isfinite(want) and want > 0
    for loss in losses:
        np.testing.assert_allclose(loss, want, rtol=1e-4)
