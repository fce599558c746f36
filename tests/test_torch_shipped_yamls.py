"""The four shipped mPLUG-Video YAMLs that chip_smoke.py drives at full
width on the card (the reference pretrain recipe at GPT-3 1.3B and 2.7B,
dual-encoder retrieval and ITM rerank at 2.7B), against the JAX package
on the CPU:

- each loads under the port's ``load_config`` to JAX's values: every
  field of the vision, text and task configs and of the optimizer, and
  the run keys;
- at a cut depth (2 decoder layers, 1 vision block, batch 2; the widths,
  frames, queries and text length are the YAML's; ITM with a 2-way match
  head, as the port requires), one train step of the port's runner (its
  ``prepare`` / ``setup``, loader, ``make_batch`` and ``make_loss_fn``
  under ``make_train_step``) gives JAX's loss and grad norm on the same
  weights (JAX's ``full_init`` tree redrawn, the port's init replaced by
  it) and the same batch, within ``TOL`` (1e-4 relative and absolute,
  fp32, as tests/test_torch_train.py and tests/test_torch_downstream.py
  state).  Both run without dropout (JAX ``deterministic=True``, the
  port's loss without a generator): the two frameworks draw different
  masks, and tests/test_torch_dropout.py holds the port's dropout.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from youku_mplug_tpu.config import load_config as j_load_config
from youku_mplug_tpu.models import tasks as jtasks
from youku_mplug_tpu.runtime.precision import FP32_POLICY as J_FP32
from youku_mplug_tpu.train.state import create_train_state as j_state
from youku_mplug_tpu.train.trainer import make_train_step as j_step
from youku_mplug_tpu_torch import bridge
from youku_mplug_tpu_torch.cli import common
from youku_mplug_tpu_torch.cli import run_pretrain, run_retrieval
from youku_mplug_tpu_torch.cli import run_retrieval_itm
from youku_mplug_tpu_torch.config import load_config
from youku_mplug_tpu_torch.train.trainer import make_train_step
from tests.test_torch_downstream import redraw

torch.set_num_threads(1)
TOL = 1e-4
SHIPPED = {
    "pretrain_1.3B":
        "configs/pretrain/gpt3_1.3B/pretrain_gpt3_freezeGPT_youku_v0.yaml",
    "pretrain_2.7B":
        "configs/pretrain/gpt3_2.7B/pretrain_gpt3_freezeGPT_youku_v0.yaml",
    "retrieval_2.7B": "configs/retrieval/retrieval_gpt3_2.7B_youku_v0.yaml",
    "itm_2.7B": "configs/retrieval/retrieval_itm_gpt3_2.7B_youku_v0.yaml",
}
# (decoder width, layers, batch) of each recipe
GEOMETRY = {"pretrain_1.3B": (2048, 24, 48), "pretrain_2.7B": (2560, 32, 48),
            "retrieval_2.7B": (2560, 32, 96), "itm_2.7B": (2560, 32, 96)}
CUT = {"text_overrides": {"num_hidden_layers": 2},
       "visual_overrides": {"depth": 1}, "batch_size": 2,
       "synthetic_length": 2}


def _fields_equal(got, want, where):
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), (where, f.name)


@pytest.mark.parametrize("name", sorted(SHIPPED))
def test_shipped_yaml_loads_as_jax(name):
    """Every field both loaders read, and the recipe's geometry: clip-b16
    (8 heads of 96, 4 frames at 224 px), the decoder's width, depth and
    0.1 dropouts, the batch, 80 text tokens, 128 queries."""
    t, j = load_config(SHIPPED[name]), j_load_config(SHIPPED[name])
    for part in ("vision", "text"):
        _fields_equal(getattr(t.model, part), getattr(j.model, part), part)
    for f in dataclasses.fields(t.model):
        if f.name not in ("vision", "text"):
            assert getattr(t.model, f.name) == getattr(j.model, f.name), f
    _fields_equal(t.optimizer, j.optimizer, "optimizer")
    for key in ("batch_size", "max_length", "num_frames", "epochs",
                "update_freq", "image_res"):
        assert getattr(t, key) == getattr(j, key), key
    m = t.model
    assert (m.text.hidden_size, m.text.num_hidden_layers,
            t.batch_size) == GEOMETRY[name]
    assert m.vision.clip_model and (m.vision.embed_dim,
                                    m.vision.num_heads) == (768, 8)
    assert (t.num_frames, t.image_res, t.max_length,
            m.num_learnable_token) == (4, 224, 80, 128)
    assert (m.text.hidden_dropout, m.text.attention_dropout) == (0.1, 0.1)
    assert m.use_cls == (name == "itm_2.7B") and m.num_classes == 0
    assert t.optimizer.visual_backbone_scale


def _cut_yaml(path, tmp_path, **extra):
    """A copy of a shipped YAML with CUT (and ``extra``) and its model
    JSONs by absolute path."""
    with open(path) as f:
        raw = yaml.safe_load(f)
    for key in ("text_cfg", "visual_cfg"):
        raw[key] = os.path.abspath(raw[key])
    raw.update(CUT, **extra)
    dst = tmp_path / os.path.basename(path)
    dst.write_text(yaml.safe_dump(raw))
    return str(dst)


def _jax_loss(kind, jm):
    """The JAX runner's loss for ``kind``, deterministic."""
    def loss(p, b, rng=None, step=None):
        from youku_mplug_tpu.ops.preprocess import normalize_clip

        video = normalize_clip(b["video"], dtype=jnp.float32)
        args = ({"params": p}, video, b["input_ids"], b["attention_mask"])
        if kind == "pretrain":
            return jm.apply(*args, method=jtasks.MPLUGVideo.pretrain_loss)
        if kind == "retrieval":
            return jm.apply(*args, b["idx"],
                            method=jtasks.MPLUGVideo.retrieval_loss)
        return jm.apply(*args, b["prompt_lengths"], b["negative_indices"],
                        prompt_ids=b["prompt_ids"],
                        prompt_mask=b["prompt_mask"], labels=b["labels"],
                        method=jtasks.MPLUGVideo.itm_train_loss)
    return loss


@pytest.mark.parametrize("name", sorted(SHIPPED))
def test_shipped_yaml_train_step_matches_jax(name, tmp_path, monkeypatch):
    kind = name.split("_")[0]
    module = {"pretrain": run_pretrain, "retrieval": run_retrieval,
              "itm": run_retrieval_itm}[kind]
    cfg_path = _cut_yaml(SHIPPED[name], tmp_path,
                         **({"num_classes": 2} if kind == "itm" else {}))
    j = j_load_config(cfg_path)
    jm = jtasks.MPLUGVideo(j.model, policy=J_FP32)
    v = j.model.vision
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, 3, j.num_frames, v.img_size,
                                      v.img_size)),
        jnp.ones((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32),
        method=jtasks.MPLUGVideo.full_init))["params"]
    params = redraw(shapes, np.random.default_rng(len(name)))
    # the port builds the projection heads only where the runner uses
    # them (JAX's full_init builds every head)
    monkeypatch.setattr(common, "jax_init", lambda model, seed:
                        bridge.load_jax_params(model, {
                            k: v for k, v in params.items()
                            if hasattr(model, k)}))
    parser = (module.base_parser if kind == "pretrain" else module.parser)
    args = parser().parse_args([
        "--config", cfg_path, "--synthetic_data", "--fp32", "--max_steps",
        "1", "--device", "cpu", "--output_dir", str(tmp_path / "out")])
    runner = (module.setup(args) if kind == "pretrain"
              else module.prepare(args)[0])
    assert runner.cfg.model.text.num_hidden_layers == 2
    assert runner.cfg.model.text.hidden_size == GEOMETRY[name][0]
    raw = next(iter(runner.loader))
    batch = module.make_batch(runner, raw)
    met = make_train_step(module.make_loss_fn(runner.model))(runner.state,
                                                             batch)

    jst, tx, _ = j_state(params, dataclasses.replace(j.optimizer,
                                                     niter_per_ep=1))
    jbatch = {k: jnp.asarray(t.numpy()) for k, t in batch.items()}
    _, jmet = jax.jit(j_step(_jax_loss(kind, jm), tx))(
        jst, jbatch, jax.random.key(0))
    keys = [k for k in jmet if k.startswith("loss")] + ["grad_norm"]
    assert "loss" in keys and np.isfinite(float(jmet["loss"]))
    for k in keys:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)


@pytest.mark.parametrize("name", sorted(SHIPPED))
def test_decoder_routes_of_the_shipped_recipes(name):
    """The decoder attention each recipe's chip_smoke launch counts rest
    on, by the JAX package's rule (tests/test_torch_dispatch.py holds the
    port's route to it): training passes (128 queries + 80 tokens) under
    the decoder's 0.1 attention dropout run plain attention, no kernel;
    the retrieval text tower (80 tokens, no dropout) runs plain attention
    at 32 heads of 80; ITM's evaluation passes (208 positions, no
    dropout) run the head-major flash kernel (K4) at head dim 80."""
    from tests.test_torch_dispatch import jax_route

    text = load_config(SHIPPED[name]).model.text
    n, d = text.num_attention_heads, text.head_dim
    assert text.attention_dropout > 0
    assert jax_route(n, d, 208, True, None) == "reference+dropout"
    if name == "retrieval_2.7B":
        assert (n, d) == (32, 80)
        assert jax_route(n, d, 80, False, None) == "reference"
    if name == "itm_2.7B":
        assert jax_route(n, d, 208, False, None) == "flash"
