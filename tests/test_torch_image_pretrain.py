"""The port's image pretrain path against the JAX package, at fp32 on the
CPU: ``MPLUGVideo.image_pretrain_loss`` (a plain image ViT, the learnable
queries pooled over its tokens, the prefix LM over a GPT-3 decoder) on
two scaled geometries, each carried over by the bridge:

- EVA-ViT-g's (176 wide, 2 heads of 88, 2 blocks, 28 px, patch 14, MLP
  ratio 4.3637, drop-path 0.4, every block checkpointed), which keeps the
  head dim 88 of ``EVA_VIT_G``: the blocks run einsum attention (no packed
  kernel takes 88) and AttentionPool's 128 queries the head-major flash
  route (its plain version here);
- the flagship's (the tiny flagship tower of 4 heads of 64, 32 px).

Then one AdamW step through ``make_train_step`` against JAX's, the
tower that an image model builds, the bridge's coverage of its tree, the
preset, and the drop-path masks a checkpointed block replays.

Parameters are redrawn from numpy (std 0.2, LayerNorm scales near one).
Tolerances: 1e-4 on the loss and gradients (fp32, sums in another
order), 2e-5 on parameters after an Adam step of lr 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from youku_mplug_tpu.models import tasks as jtasks
from youku_mplug_tpu.models import vision as jvision
from youku_mplug_tpu.optim.factory import OptimizerConfig as JOptConfig
from youku_mplug_tpu.runtime.precision import FP32_POLICY as J_FP32
from youku_mplug_tpu.train.state import create_train_state as j_state
from youku_mplug_tpu.train.trainer import make_train_step as j_step
from youku_mplug_tpu_torch import bridge
from youku_mplug_tpu_torch.config import flagship_config
from youku_mplug_tpu_torch.models import tasks as ttasks
from youku_mplug_tpu_torch.models import vision as tvision
from youku_mplug_tpu_torch.ops import flash_attention as fa
from youku_mplug_tpu_torch.optim.factory import OptimizerConfig
from youku_mplug_tpu_torch.runtime.precision import FP32_POLICY
from youku_mplug_tpu_torch.train.state import create_train_state
from youku_mplug_tpu_torch.train.trainer import make_train_step

torch.set_num_threads(1)
TOL = 1e-4

# (image size, patch, width, heads, depth, MLP ratio, drop-path,
# grad_ckpt, learnable queries)
GEOMETRIES = {
    "eva": (28, 14, 176, 2, 2, 4.3637, 0.4, True, 128),
    "flagship": (32, 16, 64, 4, 2, 2.0, 0.0, False, 8),
}


def _cfgs(name):
    img, patch, width, heads, depth, ratio, dp, ckpt, queries = \
        GEOMETRIES[name]
    vkw = dict(img_size=img, patch_size=patch, embed_dim=width,
               depth=depth, num_heads=heads, mlp_ratio=ratio, drop_path=dp,
               grad_ckpt=ckpt, num_frames=1)
    jcfg = dataclasses.replace(
        _flagship_cfg(tiny=True), vision=jvision.VisionConfig(**vkw),
        num_learnable_token=queries)
    tcfg = dataclasses.replace(
        flagship_config(tiny=True), vision=tvision.VisionConfig(**vkw),
        num_learnable_token=queries)
    return jcfg, tcfg


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


def _inputs(rng, img, b=2, s=10):
    images = rng.normal(size=(b, 3, img, img)).astype(np.float32)
    ids = rng.integers(3, 256, size=(b, s)).astype(np.int32)
    lengths = rng.integers(3, s + 1, size=(b,))
    lengths[0] = s
    mask = (np.arange(s)[None] < lengths[:, None]).astype(np.int32)
    ids = np.where(mask == 1, ids, 2).astype(np.int32)
    return {"images": images, "input_ids": ids, "attention_mask": mask}


def _models(name, rng, batch):
    jcfg, tcfg = _cfgs(name)
    jm = jtasks.MPLUGVideo(jcfg, policy=J_FP32)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), *(jnp.asarray(batch[k]) for k in (
            "images", "input_ids", "attention_mask")),
        method=jtasks.MPLUGVideo.image_pretrain_loss))["params"]
    params = redraw(shapes, rng)
    tm = bridge.load_jax_params(
        ttasks.MPLUGVideo(tcfg, FP32_POLICY, image=True), params)
    return jm, params, tm


def _jloss(jm):
    def loss_fn(p, batch, rng=None, step=None):
        return jm.apply({"params": p}, batch["images"], batch["input_ids"],
                        batch["attention_mask"],
                        method=jtasks.MPLUGVideo.image_pretrain_loss)
    return loss_fn


def _tloss(tm):
    def loss_fn(batch, generator=None):
        return tm.image_pretrain_loss(
            torch.from_numpy(np.asarray(batch["images"])),
            torch.from_numpy(np.asarray(batch["input_ids"])).long(),
            torch.from_numpy(np.asarray(batch["attention_mask"])),
            generator=generator)
    return loss_fn


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_image_pretrain_loss_and_grads_match_jax(name):
    """The loss and every trainable leaf's gradient (the image tower, the
    queries, AttentionPool, visual_fc; the decoder frozen) against
    jax.value_and_grad of the JAX method on the same weights."""
    rng = np.random.default_rng(len(name))
    batch = _inputs(rng, GEOMETRIES[name][0])
    jm, params, tm = _models(name, rng, batch)

    def jfn(p):
        out = _jloss(jm)(p, jax.tree.map(jnp.asarray, batch))
        return out["loss"], out
    (_, jout), jgrads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        params)
    state, _, _ = create_train_state(tm, OptimizerConfig())
    out = _tloss(tm)(batch)
    out["loss"].backward()
    _close(out["loss"].detach(), jout["loss"])
    _close(out["loss_caption"].detach(), jout["loss_caption"])
    jflat = _flat(jgrads)
    assert set(state.frozen) == {k for k in jflat
                                 if k.startswith("text_decoder")}
    for path, p in state.trainable.items():
        # temp is in the tree and in no loss of this path
        assert p.grad is not None or path == "temp", path
        _close(torch.zeros_like(p) if p.grad is None else p.grad,
               jflat[path])


def test_image_pretrain_adamw_step_matches_jax():
    """One AdamW step at the EVA geometry through make_train_step against
    JAX's create_train_state + make_train_step: loss, grad norm and every
    trainable leaf after the step; the frozen decoder bitwise."""
    rng = np.random.default_rng(7)
    batch = _inputs(rng, GEOMETRIES["eva"][0])
    jm, params, tm = _models("eva", rng, batch)
    # opt_eps 1e-4: Adam's first step moves a leaf by lr x g / (|g| +
    # eps), so at eps 1e-6 a gradient entry within fp32 summation noise of
    # zero (a few of the patch embedding's 1e5) turns an agreement of
    # 1e-4 on g into a step difference of up to lr
    kw = dict(lr=1e-3, min_lr=1e-5, weight_decay=0.05,
              opt_betas=(0.9, 0.999), opt_eps=1e-4, clip_grad=5.0,
              warmup_steps=0, epochs=1, niter_per_ep=10)
    jst, tx, _ = j_state(params, JOptConfig(**kw))
    jst, jmet = jax.jit(j_step(_jloss(jm), tx))(
        jst, jax.tree.map(jnp.asarray, batch), jax.random.key(0))
    state, _, _ = create_train_state(tm, OptimizerConfig(**kw))
    frozen0 = {k: p.detach().clone() for k, p in state.frozen.items()}
    start = {k: p.detach().clone() for k, p in state.trainable.items()}
    met = make_train_step(_tloss(tm))(state, batch)
    _close(met["loss"], jmet["loss"])
    _close(met["grad_norm"], jmet["grad_norm"])
    jflat = _flat(jax.device_get(jst.trainable))
    moved = 0
    for path, p in state.trainable.items():
        _close(p.detach(), jflat[path], 2e-5)
        moved += not torch.equal(p.detach(), start[path])
    assert moved >= len(state.trainable) - 1  # all but temp
    assert all(torch.equal(p, frozen0[k]) for k, p in state.frozen.items())


def test_image_model_builds_only_the_image_tower_and_loads_jax_tree():
    """An image model holds ``image_encoder`` and no TimeSformer, as the
    JAX image-pretrain tree has no ``visual_encoder``; the bridge loads
    that tree with no leftover and nothing missing (load_jax_params
    raises on either), ``jax_init`` has a rule for every leaf, and
    ``to_jax_tree`` gives back the JAX paths."""
    rng = np.random.default_rng(3)
    batch = _inputs(rng, GEOMETRIES["eva"][0])
    _, params, tm = _models("eva", rng, batch)
    jpaths = set(_flat(params))
    assert not any(p.startswith("visual_encoder") for p in jpaths)
    assert any(p.startswith("image_encoder/blocks_1") for p in jpaths)
    assert not hasattr(tm, "visual_encoder")
    assert isinstance(tm.image_encoder, tvision.VisionTransformer)
    assert set(_flat(bridge.to_jax_tree(tm))) == jpaths
    bridge.jax_init(tm, 0)
    video_model = ttasks.MPLUGVideo(_cfgs("eva")[1], FP32_POLICY)
    assert not hasattr(video_model, "image_encoder")


def test_eva_preset_matches_jax():
    """EVA_VIT_G carries JAX's geometry: 1408 wide, 40 blocks of 16 heads
    of 88, patch 14 at 224 px (257 tokens), MLP 6144 wide, drop-path 0.4,
    every block checkpointed; no packed kernel takes its heads, so its
    blocks run einsum attention, and its head dim is one the flash
    kernels are built for (AttentionPool)."""
    t, j = tvision.EVA_VIT_G, jvision.EVA_VIT_G
    for f in ("img_size", "patch_size", "embed_dim", "depth", "num_heads",
              "mlp_ratio", "drop_path", "grad_ckpt"):
        assert getattr(t, f) == getattr(j, f), f
    d = t.embed_dim // t.num_heads
    assert (d, t.num_patches + 1, int(t.embed_dim * t.mlp_ratio)) == (
        88, 257, 6144)
    assert not fa.packed_supported(t.num_heads, d)
    assert d in fa.HEAD_DIMS and fa.FWD_BLOCKS_PER_SM[d] == 3


def test_checkpointed_blocks_replay_their_drop_path_masks():
    """With a dropout generator in training mode, the checkpointed tower
    (grad_ckpt) gives the loss and gradients of the same tower without
    checkpoints, bitwise: each recomputed block draws the drop-path masks
    of its forward again; and the masks do act (another seed, another
    loss)."""
    rng = np.random.default_rng(9)
    batch = _inputs(rng, GEOMETRIES["eva"][0], b=4)
    _, params, tm = _models("eva", rng, batch)
    plain = bridge.load_jax_params(ttasks.MPLUGVideo(
        dataclasses.replace(tm.cfg, vision=dataclasses.replace(
            tm.cfg.vision, grad_ckpt=False)), FP32_POLICY, image=True),
        params)
    results = []
    for model, seed in ((tm, 0), (plain, 0), (tm, 1)):
        model.train()
        for p in model.parameters():
            p.requires_grad_(True)
            p.grad = None
        out = _tloss(model)(batch, torch.Generator().manual_seed(seed))
        out["loss"].backward()
        results.append((out["loss"].item(),
                        model.image_encoder.blocks[1].mlp.fc1_kernel.grad))
    assert results[0][0] == results[1][0]
    assert torch.equal(results[0][1], results[1][1])
    assert results[2][0] != results[0][0]
