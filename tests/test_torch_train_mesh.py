"""Training under a (data, model) split on CPU processes over gloo,
against the JAX package's train step and the port's own unsplit runs.

- One train step of the tiny dryrun model of
  ``__graft_entry__._flagship_cfg(tiny=True)`` (vocab 256, fp32) at (8,1),
  (4,2) and (1,8), as JAX's ``dryrun_multichip`` runs it, against JAX's
  step on one device on the same numpy-drawn weights and global batch:
  the loss within rtol 1e-4 (JAX's own gate), ``grad_norm`` within 1e-4
  and every updated trainable leaf within 1e-5.  Then the same at (2,1),
  (1,2), (2,2) and (1,4) with the contrastive loss on and the vision
  tower at 4 heads of 64, so that the temporal attention takes the packed
  kernel's route and, at model = 4, the head-major one with the period
  mask on the local head (its backward included).  Every batch's masks
  have unequal lengths across the data ranks (a mean of per-rank means
  would show).  ``u2_2x1`` takes that step at (2,1) with ``update_freq``
  2: each data rank's micro-batch is its block of JAX's (a micro-batch's
  masked mean and contrastive max over JAX's rows).
- A non-finite batch on one rank makes every rank skip the step.

The collectives, the CLIs and the refusals are in
``tests/test_torch_train_mesh_cli.py``.

Every world is a set of ``tests/torch_train_mesh_worker.py`` processes
with an explicit timeout on every collective and a deadline on the
world.
"""

import dataclasses
import json
import os
import sys

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

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_train_mesh_worker as worker  # noqa: E402
from test_torch_train import _flat, redraw  # noqa: E402

torch.set_num_threads(1)
LOSS_RTOL = 1e-4     # JAX's dryrun gate across splits
NORM_TOL = 1e-4
LEAF_TOL = 1e-5
# the dryrun's optimizer with the flagship pretrain YAML's eps, weight
# decay and clip: Adam's first update is g / (|g| + eps), and at the
# YAML's eps fp32 sums in another order move it far below LEAF_TOL
OPT = dict(lr=1e-4, epochs=1, niter_per_ep=10, warmup_steps=0,
           opt_eps=1e-6, weight_decay=0.05, clip_grad=3.0)
# the weights' std: 0.2 (test_torch_train's) at the dryrun's width 64,
# scaled by sqrt(64 / 256) at the 4 heads of 64, so that both towers
# keep the dryrun's gain a layer (fp32 noise in another summation order
# grows with it, and Adam's first update g / (|g| + eps) carries it)
CASES = {"dryrun": {"std": 0.2},
         "heads64": {"contrastive": True, "std": 0.1,
                     "vision": {"embed_dim": 256, "num_heads": 4}},
         "heads64_u2": {"contrastive": True, "std": 0.1, "update_freq": 2,
                        "vision": {"embed_dim": 256, "num_heads": 4}}}
WORLDS = {8: [("8x1", "dryrun"), ("4x2", "dryrun"), ("1x8", "dryrun")],
          4: [("2x2", "heads64"), ("1x4", "heads64")],
          2: [("2x1", "heads64"), ("1x2", "heads64"),
              ("u2_2x1", "heads64_u2")]}
SPLITS = [(tag, case) for w in WORLDS.values() for tag, case in w]


def _jax_cfg(meta):
    base = _flagship_cfg(tiny=True)
    return dataclasses.replace(
        base, use_contrastive=bool(meta.get("contrastive", False)),
        vision=dataclasses.replace(base.vision, **meta.get("vision", {})))


def _batch(cfg, seed, b=8, s=24):
    """A global batch of ``b`` rows whose masks differ in length across
    every block of rows (lengths 3..s, padded with id 2)."""
    rng = np.random.default_rng(seed)
    v = cfg.vision
    video = rng.normal(size=(b, 3, v.num_frames, v.img_size,
                             v.img_size)).astype(np.float32)
    ids = rng.integers(3, 256, size=(b, s)).astype(np.int32)
    lengths = np.linspace(3, s, b).round().astype(int)[rng.permutation(b)]
    mask = (np.arange(s)[None] < lengths[:, None]).astype(np.int32)
    ids = np.where(mask == 1, ids, 2).astype(np.int32)
    return {"video": video, "input_ids": ids, "attention_mask": mask}


def _jax_step(name, meta, d):
    """JAX's step on one device; writes the case file the workers read.
    Returns (metrics, {path: updated trainable leaf}, the case path)."""
    cfg = _jax_cfg(meta)
    batch = _batch(cfg, seed=len(name))
    jm = jtasks.MPLUGVideo(cfg, policy=J_FP32)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), *(jnp.asarray(batch[k]) for k in
                             ("video", "input_ids", "attention_mask"))))
    params = redraw(shapes["params"], np.random.default_rng(7),
                    std=meta["std"])

    def loss_fn(p, b, rng=None, step=None):
        return jm.apply({"params": p}, b["video"], b["input_ids"],
                        b["attention_mask"],
                        method=jtasks.MPLUGVideo.pretrain_loss)
    st, tx, _ = j_state(params, JOptConfig(**OPT))
    st, met = jax.jit(j_step(loss_fn, tx,
                             update_freq=meta.get("update_freq", 1)))(
        st, jax.tree.map(jnp.asarray, batch), jax.random.key(1))
    path = os.path.join(d, f"case_{name}.npz")
    np.savez(path, meta=json.dumps({**meta, "opt": OPT}), **batch,
             **{f"p:{k}": np.asarray(v) for k, v in _flat(params).items()})
    return ({k: float(v) for k, v in met.items()},
            _flat(jax.device_get(st.trainable)), path)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """{tag: (JAX metrics, JAX leaves, the split's record)} for every
    split, and the skip runs' per-rank metrics under "nan"."""
    d = str(tmp_path_factory.mktemp("train_mesh"))
    ref = {name: _jax_step(name, meta, d) for name, meta in CASES.items()}
    for world, splits in WORLDS.items():
        spec = [{"tag": t, "data": int(t[-3]), "model": int(t[-1]),
                 "case": ref[c][2]} for t, c in splits]
        if world == 2:
            spec += [{"tag": f"nan_{t}", "data": int(t[0]),
                      "model": int(t[2]), "case": ref[c][2], "nan_rank": 1}
                     for t, c in splits if c == "heads64"]
        worker.spawn("step", world, d, spec)
    out = {}
    for tag, case in SPLITS + [("nan_2x1", "heads64"),
                               ("nan_1x2", "heads64")]:
        rec = dict(np.load(os.path.join(d, f"{tag}.npz")))
        world = int(tag[-3]) * int(tag[-1])
        ranks = []
        for r in range(world):
            with open(os.path.join(d, f"{tag}_rank{r}.json")) as f:
                ranks.append(json.load(f))
        out[tag] = (ref[case][0], ref[case][1], rec, ranks)
    out["cases"] = {name: r[2] for name, r in ref.items()}
    return out


@pytest.mark.parametrize("tag,case", SPLITS, ids=[t for t, _ in SPLITS])
def test_split_step_loss_and_grad_norm_match_jax(steps, tag, case):
    jmet, _, rec, ranks = steps[tag]
    met = json.loads(str(rec["metrics"]))
    np.testing.assert_allclose(met["loss"], jmet["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(met["grad_norm"], jmet["grad_norm"],
                               rtol=NORM_TOL)
    assert met["skipped_nonfinite"] == 0.0
    if CASES[case].get("contrastive"):
        assert met["loss_contrastive"] > 0
        np.testing.assert_allclose(met["loss_contrastive"],
                                   jmet["loss_contrastive"], rtol=LOSS_RTOL)
    # every rank reports the same global metrics and decision
    for r in ranks:
        np.testing.assert_allclose(r["loss"], met["loss"], rtol=1e-6)
        assert r["grad_norm"] == met["grad_norm"]


@pytest.mark.parametrize("tag,case", SPLITS, ids=[t for t, _ in SPLITS])
def test_split_step_updates_every_trainable_leaf_as_jax(steps, tag, case):
    _, jleaves, rec, _ = steps[tag]
    got = {k[2:]: v for k, v in rec.items() if k.startswith("p:")}
    assert set(got) == set(jleaves)
    for path, want in jleaves.items():
        np.testing.assert_allclose(got[path], want, rtol=LEAF_TOL,
                                   atol=LEAF_TOL, err_msg=path)


@pytest.mark.parametrize("tag", ["4x2", "1x8", "1x2", "2x2", "1x4"])
def test_model_splits_cut_the_leaves_jax_rules_cut(steps, tag):
    """The trainable leaves split over the model ranks are those JAX's
    rules split: the vision tower's heads and MLP columns (at model = 8
    the 4 heads stay whole and only the MLPs split, as JAX drops an axis
    that does not divide)."""
    _, _, rec, _ = steps[tag]
    split = json.loads(str(rec["split"]))
    model = int(tag[2])
    heads = any("attn/qkv_kernel" in k and "visual_encoder" in k
                for k in split)
    assert heads == (model <= 4)
    assert any("mlp/fc1_kernel" in k and "visual_encoder" in k
               for k in split)
    assert any("attn_pool/mlp/fc2_kernel" in k for k in split)


@pytest.mark.parametrize("tag", ["nan_2x1", "nan_1x2"])
def test_a_non_finite_rank_makes_every_rank_skip(steps, tag):
    """A NaN in one rank's clip: every rank skips, nothing moves."""
    _, _, rec, ranks = steps[tag]
    assert [r["skipped_nonfinite"] for r in ranks] == [1.0] * len(ranks)
    case = dict(np.load(steps["cases"]["heads64"]))
    got = {k[2:]: v for k, v in rec.items() if k.startswith("p:")}
    assert got
    for path, v in got.items():
        np.testing.assert_array_equal(v, case[f"p:{path}"], err_msg=path)
