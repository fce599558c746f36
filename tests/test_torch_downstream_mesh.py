"""``run_cls``, ``run_retrieval`` and ``run_retrieval_itm`` under a
(data, model) split on CPU processes over gloo, against the JAX
package's step and the port's unsplit runs.

- One train step of each task's loss (``cls_train_loss``,
  ``retrieval_loss``, ``itm_train_loss``) on the tiny downstream model
  (clip-b16's form at 2 heads of 96 and 2 blocks; a 2-layer decoder of 4
  heads of 8), fp32, with every dropout rate at 0, at (2,1), (1,2) and
  (2,2), against JAX's step on one device on the same numpy-drawn
  weights and global batch of 8 clips: the loss within rtol 1e-4 and
  every trainable leaf within 1e-5; and against the port's own (1,1)
  step: the loss within 1e-5, the leaves within 1e-6.  The retrieval
  batch's clip ids repeat across the data ranks' blocks (ids 0 and 2),
  so its soft targets reach positives on the other rank; the ITM batch's
  2B negatives index clips of the whole batch.
- The CLIs (2 steps an epoch of 4 synthetic clips, then the evaluation)
  with the decoder's hidden and attention dropout and the vision
  tower's ``drop_rate``, ``attn_drop_rate`` and ``drop_path`` at 0.1, at
  (2,1), (1,2) and (2,2) against (1,1) in this process: the step losses
  within rtol 1e-5; the evaluations equal to (1,1)'s (the cls top-k
  accuracies, the retrieval recalls, the retrieval and ITM score
  matrices within 1e-5); ``run_cls`` saved at (1,2) after its first
  epoch resumes at (2,1) with (1,1)'s second epoch; ``run_retrieval_itm
  --evaluate_only --resume`` of the (1,2) run at (2,1) scores (1,1)'s
  matrices; ``run_cls`` at head dim 80 (the 2.7B decoder's) at (1,2).

The dropout masks themselves: ``tests/test_torch_dropout_mesh.py``; the
workers: ``tests/torch_downstream_mesh_worker.py``.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from youku_mplug_tpu.models import gpt3 as jgpt3
from youku_mplug_tpu.models import tasks as jtasks
from youku_mplug_tpu.models import vision as jvision
from youku_mplug_tpu.optim.factory import OptimizerConfig as JOptConfig
from youku_mplug_tpu.runtime.precision import FP32_POLICY as J_FP32
from youku_mplug_tpu.train.state import create_train_state as j_state
from youku_mplug_tpu.train.trainer import make_train_step as j_step
from youku_mplug_tpu_torch.runtime.mesh import Mesh

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_downstream as down  # noqa: E402
import torch_downstream_mesh_worker as worker  # noqa: E402

torch.set_num_threads(1)
JAX_RTOL, JAX_LEAF = 1e-4, 1e-5
SPLIT_RTOL, SPLIT_LEAF = 1e-5, 1e-6
MATRIX_TOL = 1e-5
TEXT = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=192,
            layernorm_epsilon=1e-5, hidden_dropout=0.0,
            attention_dropout=0.0, remat=True)
VISION = dict(img_size=32, patch_size=16, embed_dim=192, depth=2,
              num_heads=2, num_frames=2, mlp_ratio=2, clip_model=True,
              grad_ckpt=True)
# Adam's eps at 1e-3: see tests/test_torch_dropout_mesh.py
OPT = dict(lr=1e-4, epochs=1, niter_per_ep=10, warmup_steps=0,
           opt_eps=1e-3, weight_decay=0.05, clip_grad=3.0)
CLASSES = {"cls": 3, "retrieval": 2, "itm": 2}
WORLDS = {2: ["2x1", "1x2"], 4: ["2x2"]}
SPLIT_TAGS = [t for tags in WORLDS.values() for t in tags]
STEPS = [(tag, kind) for tag in SPLIT_TAGS for kind in CLASSES]


def _meta(kind):
    return dict(text=TEXT, vision=VISION, queries=8, embed=8,
                num_classes=CLASSES[kind], loss=kind, opt=OPT,
                dropout_seed=None if kind == "retrieval" else 5)


def _jax_step(kind, d):
    """JAX's step on one device on the case's redrawn full_init tree;
    writes the case file.  Returns (metrics, leaves, the case path)."""
    meta = _meta(kind)
    batch = worker.global_batch(meta, 2)
    jcfg = jtasks.MPLUGVideoConfig(
        vision=jvision.VisionConfig(**VISION),
        text=jgpt3.GPT3Config(**TEXT), num_learnable_token=8,
        contrastive_embed_dim=8, use_cls=True,
        num_classes=CLASSES[kind])
    jm = jtasks.MPLUGVideo(jcfg, policy=J_FP32)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.asarray(batch["video"]),
        jnp.asarray(batch["input_ids"][:8]),
        jnp.asarray(batch["attention_mask"][:8]),
        method=jtasks.MPLUGVideo.full_init))["params"]
    params = down.redraw(shapes, np.random.default_rng(1))

    def loss_fn(p, b, rng=None, step=None):
        args = {"cls": ("video", "input_ids", "attention_mask",
                        "prompt_lengths"),
                "retrieval": ("video", "input_ids", "attention_mask",
                              "idx"),
                "itm": ("video", "input_ids", "attention_mask",
                        "prompt_lengths", "negative_indices")}[kind]
        kw = {} if kind == "retrieval" else {
            k: b[k] for k in ("prompt_ids", "prompt_mask", "labels")}
        return jm.apply({"params": p}, *(b[k] for k in args), **kw,
                        method={"cls": jtasks.MPLUGVideo.cls_train_loss,
                                "retrieval":
                                jtasks.MPLUGVideo.retrieval_loss,
                                "itm": jtasks.MPLUGVideo.itm_train_loss
                                }[kind])
    st, tx, _ = j_state(params, JOptConfig(**OPT))
    st, met = jax.jit(j_step(loss_fn, tx))(
        st, jax.tree.map(jnp.asarray, batch), jax.random.key(1))
    path = worker.write_case(d, kind, meta, down._flat(params), batch)
    return ({k: float(v) for k, v in met.items()},
            down._flat(jax.device_get(st.trainable)), path)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """{kind: (JAX metrics, JAX leaves, (1,1)'s metrics, (1,1)'s
    leaves)}, {(tag, kind): rank 0's file}."""
    d = str(tmp_path_factory.mktemp("downstream_mesh_steps"))
    jax_ref = {kind: _jax_step(kind, d) for kind in CLASSES}
    worlds = [worker.start("step", world, d, [
        {"tag": f"{t}_{k}", "data": int(t[0]), "model": int(t[2]),
         "case": jax_ref[k][2]} for t in tags for k in CLASSES])
        for world, tags in WORLDS.items()]
    ref = {}
    for kind, (jmet, jleaves, path) in jax_ref.items():
        met, leaves, _ = worker.one_step(path, Mesh())
        ref[kind] = (jmet, jleaves, met, leaves, path)
    for procs in worlds:
        worker.finish(procs)
    return ref, {(t, k): dict(np.load(os.path.join(d, f"{t}_{k}.npz")))
                 for t, k in STEPS}


def _leaves(rec):
    return {k[2:]: v for k, v in rec.items() if k.startswith("p:")}


def _metric_keys(kind):
    return ("loss", "grad_norm") + (() if kind == "retrieval" else
                                    ("loss_caption", "loss_cls"))


@pytest.mark.parametrize("kind", list(CLASSES))
def test_unsplit_step_matches_jax(steps, kind):
    jmet, jleaves, met, leaves, _ = steps[0][kind]
    for k in _metric_keys(kind):
        np.testing.assert_allclose(met[k], jmet[k], rtol=JAX_RTOL,
                                   err_msg=k)
    assert set(leaves) == set(jleaves)
    for path, want in jleaves.items():
        np.testing.assert_allclose(leaves[path], want, rtol=JAX_LEAF,
                                   atol=JAX_LEAF, err_msg=path)


@pytest.mark.parametrize("tag,kind", STEPS)
def test_split_step_matches_jax_and_the_unsplit_step(steps, tag, kind):
    jmet, jleaves, met, leaves, _ = steps[0][kind]
    rec = steps[1][tag, kind]
    got_met = json.loads(str(rec["metrics"]))
    got = _leaves(rec)
    assert set(got) == set(jleaves)
    for k in _metric_keys(kind):
        np.testing.assert_allclose(got_met[k], jmet[k], rtol=JAX_RTOL,
                                   err_msg=k)
        np.testing.assert_allclose(got_met[k], met[k], rtol=SPLIT_RTOL,
                                   err_msg=k)
    for path, want in jleaves.items():
        np.testing.assert_allclose(got[path], want, rtol=JAX_LEAF,
                                   atol=JAX_LEAF, err_msg=path)
        np.testing.assert_allclose(got[path], leaves[path],
                                   rtol=SPLIT_LEAF, atol=SPLIT_LEAF,
                                   err_msg=path)


def test_retrieval_batch_has_positives_across_the_data_ranks(steps):
    """The case's ids repeat across the halves: at data = 2 a rank's
    soft targets hold the other rank's pairs (the loss would differ from
    JAX's, above, were they taken from the rank's own ids alone)."""
    idx = np.load(steps[0]["retrieval"][4])["idx"]
    assert set(idx[:4]) & set(idx[4:]) == {0, 2}


# ----- the CLIs -----

CLI_TEXT = dict(down.TINY_TEXT, num_hidden_layers=2,
                hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
CLI_VISION = dict(down.TINY_VISION, drop_rate=0.1, attn_drop_rate=0.1,
                  drop_path=0.1, grad_ckpt=True)
# the 2.7B decoder's head dim: 2 heads of 80
CLI_TEXT_80 = dict(CLI_TEXT, hidden_size=160, num_attention_heads=2)
RUNS = {"cls": ("run_cls", dict(use_cls=True, num_classes=3)),
        "retrieval": ("run_retrieval", {}),
        "itm": ("run_retrieval_itm", dict(use_cls=True, num_classes=2)),
        "cls80": ("run_cls", dict(use_cls=True, num_classes=3))}
CLI_SPLITS = {"cls": SPLIT_TAGS, "retrieval": SPLIT_TAGS,
              "itm": SPLIT_TAGS, "cls80": ["1x2"]}
EPOCHS = {"cls": 2}


def _cfg(d, name, tag):
    """The CLI's tiny YAML at split ``tag``: 2 decoder layers and 2 clip
    blocks with every dropout at 0.1, batch 4 of 8 synthetic clips."""
    text = CLI_TEXT_80 if name == "cls80" else CLI_TEXT
    data, model = map(int, tag.split("x"))
    sub = os.path.join(d, f"{name}_{tag}")
    os.makedirs(sub, exist_ok=True)
    for f, content in (("text.json", text), ("vision.json", CLI_VISION)):
        with open(os.path.join(sub, f), "w") as fh:
            json.dump(content, fh)
    cfg = {"text_cfg": os.path.join(sub, "text.json"),
           "visual_cfg": os.path.join(sub, "vision.json"),
           "batch_size": 4, "max_length": 12, "num_frames": 2,
           "image_res": 32, "num_learnable_token": 4, "embed_dim": 8,
           "freeze_text_decoder": True, "synthetic_length": 8,
           "mesh": {"data": data, "model": model},
           "optimizer": {"lr": 1e-3, "opt": "AdamW", "weight_decay": 0.01,
                         "clip_grad": 3.0, "opt_eps": 1e-3},
           "schedular": {"epochs": EPOCHS.get(name, 1), "min_lr": 1e-5,
                         "warmup_steps": 1, "lr_sched_type": "cosine"},
           **RUNS[name][1]}
    path = os.path.join(sub, "cfg.yaml")
    with open(path, "w") as fh:
        yaml.safe_dump(cfg, fh)
    return path


def _argv(cfg, out, *extra):
    return ["--config", cfg, "--output_dir", out, "--fp32",
            "--synthetic_data", "--seed", "0", "--device", "cpu",
            "--max_steps", "2", *extra]


def _spec(d, name, tag, out=None, *extra):
    return {"cli": RUNS[name][0], "argv": _argv(
        _cfg(d, name, tag), os.path.join(d, out or f"run_{name}_{tag}"),
        *extra)}


@pytest.fixture(scope="module")
def clis(tmp_path_factory):
    """Every run's directory: (1,1) here, the splits in a 2-rank and a
    4-rank world; then (1,2)'s cls run cut back to its first epoch
    resumes at (2,1), and (1,2)'s ITM run is evaluated at (2,1)."""
    d = str(tmp_path_factory.mktemp("downstream_mesh_clis"))
    two = [_spec(d, name, t) for name, tags in CLI_SPLITS.items()
           for t in tags if t in WORLDS[2]]
    two += [{"prune": os.path.join(d, "run_cls_1x2", "checkpoints"),
             "keep": 2},
            _spec(d, "cls", "2x1", "resumed_cls_2x1", "--resume",
                  os.path.join(d, "run_cls_1x2")),
            _spec(d, "itm", "2x1", "eval_itm_2x1", "--evaluate_only",
                  "--resume", os.path.join(d, "run_itm_1x2"))]
    four = [_spec(d, name, "2x2") for name, tags in CLI_SPLITS.items()
            if "2x2" in tags]
    worlds = [worker.start("runner", 2, d, two),
              worker.start("runner", 4, d, four)]
    for name in RUNS:
        spec = _spec(d, name, "1x1")
        worker.run_cli(spec["cli"], spec["argv"])
    for procs in worlds:
        worker.finish(procs)
    return d


def _history(d, run):
    with open(os.path.join(d, run, "history.json")) as f:
        return json.load(f)


def _log(d, run):
    with open(os.path.join(d, run, "log.txt")) as f:
        return [json.loads(line) for line in f]


def _sims(d, run):
    files = sorted((f for f in os.listdir(os.path.join(d, run))
                    if f.startswith("sims_")),
                   key=lambda f: int(f[5:-4]))
    return [np.load(os.path.join(d, run, f)) for f in files]


CLI_CASES = [(name, tag) for name, tags in CLI_SPLITS.items()
             for tag in tags]


@pytest.mark.parametrize("name,tag", CLI_CASES)
def test_cli_split_takes_the_unsplit_steps(clis, name, tag):
    want = _history(clis, f"run_{name}_1x1")
    got = _history(clis, f"run_{name}_{tag}")
    assert len(got) == len(want) == 2 * EPOCHS.get(name, 1)
    keys = ("loss", "grad_norm") + (() if name == "retrieval" else
                                    ("loss_caption", "loss_cls"))
    for k in keys:
        np.testing.assert_allclose([h[k] for h in got],
                                   [h[k] for h in want], rtol=SPLIT_RTOL,
                                   err_msg=k)
    assert all(h["skipped_nonfinite"] == 0.0 for h in got)


@pytest.mark.parametrize("name,tag", CLI_CASES)
def test_cli_split_evaluates_as_the_unsplit_run(clis, name, tag):
    """The log's evaluation entries (the cls accuracies of each epoch's
    validation and of the test split, the recalls) equal (1,1)'s, and
    the retrieval and ITM matrices agree within 1e-5."""
    want = _log(clis, f"run_{name}_1x1")
    got = _log(clis, f"run_{name}_{tag}")
    assert len(got) == len(want)
    evals = 0
    for g, w in zip(got, want):
        want_evals = {k: v for k, v in w.items()
                      if k.startswith("val_") or k == "test"}
        assert {k: g[k] for k in want_evals} == want_evals
        evals += len(want_evals)
    assert evals
    want_m, got_m = (_sims(clis, f"run_{name}_{t}") for t in ("1x1", tag))
    # retrieval: each epoch's validation and the test; ITM: the test's
    # generative and head matrices
    assert len(got_m) == len(want_m) == {"retrieval": 2, "itm": 2}.get(
        name, 0)
    for g, w in zip(got_m, want_m):
        assert g.shape == w.shape == (8, 8)
        np.testing.assert_allclose(g, w, rtol=MATRIX_TOL, atol=MATRIX_TOL)


def test_cls_checkpoint_of_a_split_resumes_at_another(clis):
    """(1,2)'s checkpoint after epoch 0 (step 2), resumed at (2,1): its
    two steps are (1,1)'s epoch 1, and its test accuracies (1,1)'s."""
    got = _history(clis, "resumed_cls_2x1")
    want = _history(clis, "run_cls_1x1")[2:]
    assert len(got) == len(want) == 2
    for k in ("loss", "grad_norm", "loss_cls"):
        np.testing.assert_allclose([h[k] for h in got],
                                   [h[k] for h in want], rtol=SPLIT_RTOL,
                                   err_msg=k)
    assert _log(clis, "resumed_cls_2x1")[-1] == _log(
        clis, "run_cls_1x1")[-1]


def test_itm_evaluate_only_at_another_split(clis):
    """``--evaluate_only --resume`` of the (1,2) ITM run at (2,1): no
    step, the test matrices and recalls of (1,1)'s run."""
    assert _history(clis, "eval_itm_2x1") == []
    got, want = (_sims(clis, r) for r in ("eval_itm_2x1", "run_itm_1x1"))
    assert len(got) == len(want) == 2  # the generative and head matrices
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=MATRIX_TOL, atol=MATRIX_TOL)
    assert _log(clis, "eval_itm_2x1") == [_log(clis, "run_itm_1x1")[-1]]
