"""The port's optimizer (youku_mplug_tpu_torch.optim, train.state) against
the JAX package's optax chain: the decay, freeze and lr-scale masks on
the tiny flagship tree (by JAX path), the schedule, and AdamW updates on
given gradients (masked decay, warmup from lr 0).
Tolerance 1e-6 relative on updates (fp32 on both sides)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from youku_mplug_tpu.config import load_config as j_load_config
from youku_mplug_tpu.models import tasks as jtasks
from youku_mplug_tpu.optim import factory as jf
from youku_mplug_tpu_torch import bridge
from youku_mplug_tpu_torch.config import flagship_config
from youku_mplug_tpu_torch.models.tasks import MPLUGVideo
from youku_mplug_tpu_torch.optim import factory as tf
from youku_mplug_tpu_torch.runtime.precision import FP32_POLICY
from youku_mplug_tpu_torch.train.state import create_train_state

torch.set_num_threads(1)
FLAGSHIP_PRETRAIN = "configs/pretrain/pretrain_gpt3_1.3B_flagship.yaml"


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


@pytest.fixture(scope="module")
def trees():
    """(JAX shapes tree, port parameters by JAX path) of the tiny
    contrastive flagship."""
    cfg = dataclasses.replace(_flagship_cfg(tiny=True), use_contrastive=True)
    v = cfg.vision
    shapes = jax.eval_shape(lambda: jtasks.MPLUGVideo(cfg).init(
        jax.random.key(0),
        jnp.zeros((2, 3, v.num_frames, v.img_size, v.img_size)),
        jnp.zeros((2, 6), jnp.int32), jnp.ones((2, 6), jnp.int32)))["params"]
    tm = MPLUGVideo(dataclasses.replace(flagship_config(tiny=True),
                                        use_contrastive=True), FP32_POLICY)
    named = {bridge.jax_path(n): p for n, p in tm.named_parameters()}
    assert set(named) == set(_flat(shapes))
    return shapes, named


@pytest.mark.parametrize("kind", ["decay", "freeze", "freeze_vit",
                                  "lr_scale"])
def test_masks_match_jax_on_the_tiny_tree(trees, kind):
    shapes, named = trees
    if kind == "decay":
        want, got = jf.decay_mask(shapes), tf.decay_mask(named)
    elif kind == "freeze":
        want, got = jf.freeze_mask(shapes), tf.freeze_mask(named)
    elif kind == "freeze_vit":
        want = jf.freeze_mask(shapes, False, True)
        got = tf.freeze_mask(named, False, True)
    else:
        # the port applies no per-leaf lr scale: JAX's scales are all 1
        # under the optimizer config both loaders read from a port config
        jcfg = j_load_config(FLAGSHIP_PRETRAIN).optimizer
        want = jf.lr_scale_tree(shapes, jcfg.visual_backbone_scale,
                                jcfg.lr_scale_rules)
        got = dict.fromkeys(named, 1.0)
    assert got == _flat(want)


@pytest.mark.parametrize("freeze_text_decoder,freeze_vit",
                         [(True, True), (True, False), (False, True)])
def test_freeze_mask_trains_lora_like_jax_on_an_owl_tree(
        freeze_text_decoder, freeze_vit):
    """The tiny Owl with rank-2 LoRA: path by path the port's freeze and
    decay masks equal JAX's; the adapters train inside the frozen
    decoder."""
    from youku_mplug_tpu.models import owl as jowl
    from youku_mplug_tpu.models.bloom import BloomConfig as JBloomConfig
    from youku_mplug_tpu.models.vision import VisionConfig as JVisionConfig
    from youku_mplug_tpu_torch.models import owl as towl
    from youku_mplug_tpu_torch.models.bloom import BloomConfig
    from youku_mplug_tpu_torch.models.vision import VisionConfig

    v = dict(img_size=16, patch_size=8, embed_dim=32, depth=1, num_heads=4,
             clip_model=True, gelu="quick")
    a = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
             num_queries=4, max_frames=8)
    t = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=4, lora_rank=2)
    jm = jowl.MPLUGOwlVideo(jowl.MPLUGOwlVideoConfig(
        vision=JVisionConfig(**v), abstractor=jowl.OwlAbstractorConfig(**a),
        text=JBloomConfig(**t)))
    ids = jnp.zeros((1, 8), jnp.int32)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, 3, 2, 16, 16)), ids, ids, ids,
        ids))["params"]
    tm = towl.MPLUGOwlVideo(towl.MPLUGOwlVideoConfig(
        vision=VisionConfig(**v), abstractor=towl.OwlAbstractorConfig(**a),
        text=BloomConfig(**t)), FP32_POLICY)
    named = {bridge.jax_path(n): p for n, p in tm.named_parameters()}
    assert set(named) == set(_flat(shapes))
    got = tf.freeze_mask(named, freeze_text_decoder, freeze_vit)
    assert got == _flat(jf.freeze_mask(shapes, freeze_text_decoder,
                                       freeze_vit))
    assert tf.decay_mask(named) == _flat(jf.decay_mask(shapes))
    lora = [k for k in named if "lora_" in k]
    assert len(lora) == 8 and not any(got[k] for k in lora)
    assert got["text_decoder/decoder/layers/attn/qkv_kernel"] == \
        freeze_text_decoder


def test_decay_exclusions(trees):
    """No decay for rank <= 1 leaves or for pos_embed / cls_token /
    temporal_embed / *bias* names, AttentionPool's rank-3 bias_k and
    bias_v included; matrices decay."""
    _, named = trees
    mask = tf.decay_mask(named)
    for path in ("attn_pool/bias_k", "attn_pool/bias_v",
                 "visual_encoder/pos_embed", "visual_encoder/cls_token",
                 "visual_encoder/temporal_embed", "temp",
                 "visual_encoder/blocks_0/attn/q_bias"):
        assert not mask[path], path
    assert named["attn_pool/bias_k"].dim() == 3
    for path in ("attn_pool/q_kernel", "visual_fc/kernel",
                 "visual_encoder/blocks_1/temporal_fc_kernel",
                 "learnable_queries"):
        assert mask[path], path


@pytest.mark.parametrize("kw", [
    dict(warmup_steps=3, sched_type="cos"),
    dict(warmup_epochs=0.5, sched_type="linear"),
    dict(warmup_steps=-1, sched_type="cos")])
def test_schedule_matches_jax(kw):
    args = (1e-3, 1e-5, 2, 5)
    want, got = jf.cosine_schedule(*args, **kw), tf.cosine_schedule(
        *args, **kw)
    for step in range(12):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-12)
    if kw.get("warmup_steps", -1) > 0:
        assert got(0) == 0.0  # the first applied update moves nothing


def test_adamw_updates_match_optax_chain():
    """Three updates from fixed gradients: masked decoupled decay, warmup
    from lr 0 and the Adam moments."""
    rng = np.random.default_rng(0)
    params = {"visual_encoder/blocks_0/attn/qkv_kernel":
              rng.normal(size=(4, 6)).astype(np.float32),
              "visual_encoder/blocks_0/attn/q_bias":
              rng.normal(size=(6,)).astype(np.float32),
              "attn_pool/bias_k": rng.normal(size=(1, 1, 4)).astype(
                  np.float32),
              "visual_fc/kernel": rng.normal(size=(4, 3)).astype(
                  np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    cfg = dict(lr=1e-2, min_lr=1e-4, weight_decay=0.1, opt_betas=(0.9, 0.99),
               opt_eps=1e-6, clip_grad=None, warmup_steps=2, epochs=1,
               niter_per_ep=6)
    jtx, _ = jf.create_optimizer(params, jf.OptimizerConfig(**cfg))
    jstate, jp = jtx.init(params), dict(params)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = tf.AdamW(tp, tf.OptimizerConfig(**cfg))
    lrs = []
    for g in grads:
        upd, jstate = jtx.update(g, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        lrs.append(opt.step())
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7)
    assert lrs == [0.0, pytest.approx(1e-2), opt.schedule(2)]
    assert opt.count == 3


def test_train_state_splits_and_casts(trees):
    """The decoder is frozen, cast to bf16 and holds no optimizer state;
    everything else is fp32 and trainable."""
    tm = MPLUGVideo(dataclasses.replace(flagship_config(tiny=True),
                                        use_contrastive=True), FP32_POLICY)
    bridge.seeded_init(tm, 0)
    state, opt, _ = create_train_state(tm, tf.OptimizerConfig(),
                                       frozen_dtype=torch.bfloat16)
    assert state.frozen and all(k.startswith("text_decoder")
                                for k in state.frozen)
    for p in state.frozen.values():
        assert p.dtype == torch.bfloat16 and not p.requires_grad
    for p in state.trainable.values():
        assert p.dtype == torch.float32 and p.requires_grad
    in_opt = {id(p) for g in opt.torch_optimizer.param_groups
              for p in g["params"]}
    assert in_opt == {id(p) for p in state.trainable.values()}
    assert float(tm.temp.detach()) == pytest.approx(0.07)
