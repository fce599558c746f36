"""The port's GPT-2 multimodal decoder and MPLUG-COCA against the JAX
package (``models/gpt2_multimodal.py``), at fp32 on the CPU, at the
config of JAX's ``tests/test_bert_mplug.py::test_gpt2_coca`` (a one-block
16 px ViT of width 24 under two GPT-2 decoders of width 32, so the
``visual_fc`` / ``visual_norm`` projection is built), weights carried by
the bridge and the same patch mask and targets handed to both: the
losses and every gradient at 1e-4; ``mixed_causal_bias`` exactly; the
parameter sets flax creates; ``blockwise_mask``'s count."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from youku_mplug_tpu.models import gpt2_multimodal as jg
from youku_mplug_tpu.models.vision import VisionConfig as JVisionConfig
from youku_mplug_tpu.runtime.precision import FP32_POLICY as J_FP32
from youku_mplug_tpu_torch import bridge
from youku_mplug_tpu_torch.models import gpt2_multimodal as tg
from youku_mplug_tpu_torch.models.vision import VisionConfig
from youku_mplug_tpu_torch.runtime.precision import FP32_POLICY

torch.set_num_threads(1)
TOL = 1e-4
VKW = dict(img_size=16, patch_size=8, embed_dim=24, depth=1, num_heads=2,
           mlp_ratio=2.0)
GKW = dict(vocab_size=120, n_positions=64, n_embd=32, n_layer=2, n_head=4)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _redraw(tree, rng):
    def leaf(path, x):
        z = rng.normal(size=x.shape).astype(np.float32)
        return 1.0 + 0.1 * z if str(path[-1].key) == "scale" else 0.2 * z
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _inputs(rng, padded):
    images = rng.normal(size=(2, 3, 16, 16)).astype(np.float32)
    ids = rng.integers(0, 120, (2, 6)).astype(np.int32)
    mask = np.ones((2, 6), np.int32)
    if padded:
        mask[1, 4:] = 0
    bmask = np.zeros((2, 4), bool)
    bmask[0, [1, 2]] = bmask[1, [0, 3]] = True
    target = rng.normal(size=(2, 4, 8)).astype(np.float32)
    return images, ids, mask, bmask, target


def _models(rng, inputs):
    jcfg = jg.COCAConfig(vision=JVisionConfig(**VKW),
                         gpt2=jg.GPT2Config(**GKW), predict_feature_dim=8)
    jm = jg.MPLUGCOCA(jcfg, policy=J_FP32)
    images, ids, mask, bmask, target = inputs
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.asarray(images), jnp.asarray(ids),
        jnp.asarray(mask), bool_masked_pos=jnp.asarray(bmask),
        image_target=jnp.asarray(target)))["params"]
    params = _redraw(shapes, rng)
    tcfg = tg.COCAConfig(vision=VisionConfig(**VKW),
                         gpt2=tg.GPT2Config(**GKW), predict_feature_dim=8)
    tm = bridge.load_jax_params(tg.MPLUGCOCA(tcfg, FP32_POLICY), params)
    return jm, params, tm


@pytest.mark.parametrize("padded", [False, True])
def test_coca_losses_and_grads_match_jax(padded):
    rng = np.random.default_rng(int(padded))
    inputs = _inputs(rng, padded)
    jm, params, tm = _models(rng, inputs)
    images, ids, mask, bmask, target = inputs

    def jfn(p):
        out = jm.apply({"params": p}, jnp.asarray(images), jnp.asarray(ids),
                       jnp.asarray(mask), bool_masked_pos=jnp.asarray(bmask),
                       image_target=jnp.asarray(target))
        return out["loss"], out
    (_, jout), jgrads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        params)
    for p in tm.parameters():
        p.requires_grad_(True)
    out = tm(torch.from_numpy(images), torch.from_numpy(ids).long(),
             torch.from_numpy(mask), bool_masked_pos=torch.from_numpy(bmask),
             image_target=torch.from_numpy(target))
    out["loss"].backward()
    for k in ("loss", "loss_caption", "loss_mim"):
        _close(out[k].detach(), jout[k])
    assert 0 < float(out["loss_mim"].detach()) < 2.1
    jflat = _flat(jgrads)
    unused = []
    for name, p in tm.named_parameters():
        # the text decoder's lm_head feeds no loss: no gradient in torch,
        # zeros in JAX
        if p.grad is None:
            unused.append(name)
        _close(torch.zeros_like(p) if p.grad is None else p.grad,
               jflat[bridge.jax_path(name)])
    assert unused == ["text_decoder.lm_head.kernel"]


def test_coca_without_mim_inputs_gives_the_caption_loss_alone():
    rng = np.random.default_rng(3)
    inputs = _inputs(rng, False)
    jm, params, tm = _models(rng, inputs)
    images, ids, mask, _, _ = inputs
    jout = jax.jit(lambda p: jm.apply({"params": p}, jnp.asarray(images),
                                      jnp.asarray(ids), jnp.asarray(mask)))(
        params)
    out = tm(torch.from_numpy(images), torch.from_numpy(ids).long(),
             torch.from_numpy(mask))
    assert float(out["loss_mim"]) == 0.0
    _close(out["loss"], jout["loss"])


def test_coca_builds_the_parameters_flax_creates():
    """The multimodal decoder has no ``wte`` and both FFN branches; the
    text decoder ``wte`` and the text branch alone; no cross-attention;
    the bridge's rename covers the tree both ways."""
    rng = np.random.default_rng(4)
    _, params, tm = _models(rng, _inputs(rng, False))
    jpaths = set(_flat(params))
    assert set(_flat(bridge.to_jax_tree(tm))) == jpaths
    assert "text_decoder/wte/embedding" in jpaths
    assert not any(p.startswith("multimodal_decoder/wte") for p in jpaths)
    assert "multimodal_decoder/h_1/mlp_vision/c_fc/kernel" in jpaths
    assert not any("mlp_vision" in p for p in jpaths
                   if p.startswith("text_decoder"))
    assert not any("cross" in p for p in jpaths)
    assert "visual_fc/kernel" in jpaths and "visual_norm/scale" in jpaths


@pytest.mark.parametrize("visual,text,full,v2t", [
    (3, 4, False, True), (3, 4, True, True), (3, 4, False, False),
    (0, 5, False, True)])
def test_mixed_causal_bias_matches_jax_exactly(visual, text, full, v2t):
    rng = np.random.default_rng(visual + text)
    mask = (rng.random((2, visual + text)) > 0.3).astype(np.int32)
    want = np.asarray(jg.mixed_causal_bias(visual, text, jnp.asarray(mask),
                                           mask_v2t=v2t, full=full))
    got = tg.mixed_causal_bias(visual, text, torch.from_numpy(mask),
                               mask_v2t=v2t, full=full).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_mixed_causal_bias_semantics():
    bias = tg.mixed_causal_bias(3, 4, torch.ones(1, 7)).numpy()
    assert bias[0, 0, 3, 0] == 0.0       # text -> visual allowed
    assert bias[0, 0, 0, 3] < -1e3       # visual -> text blocked
    assert bias[0, 0, 4, 5] < -1e3       # text future blocked
    assert bias[0, 0, 0, 2] == 0.0       # visual <-> visual allowed


@pytest.mark.parametrize("batch,grid,num", [(2, 2, 2), (16, 14, 75)])
def test_blockwise_mask_count(batch, grid, num):
    m = tg.blockwise_mask(torch.Generator().manual_seed(1), batch, grid,
                          num)
    assert m.shape == (batch, grid * grid) and m.dtype == torch.bool
    assert m.sum(1).tolist() == [num] * batch
    j = np.asarray(jg.blockwise_mask(jax.random.key(1), batch, grid, num))
    assert j.sum(1).tolist() == [num] * batch


def test_gpt2_cross_attention_block_matches_jax():
    """A GPT2MultiModalModel with ``add_cross_attention`` over an encoder
    state (the block's ``crossattention``, which COCA never reaches)."""
    cfg = dict(GKW, add_cross_attention=True)
    jm = jg.GPT2MultiModalModel(jg.GPT2Config(**cfg), policy=J_FP32)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 120, (2, 5)).astype(np.int32)
    enc = rng.normal(size=(2, 3, 32)).astype(np.float32)
    params = _redraw(jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.asarray(ids), enc=jnp.asarray(enc)))[
        "params"], rng)
    jh, jl = jm.apply({"params": params}, jnp.asarray(ids),
                      enc=jnp.asarray(enc))
    tm = bridge.load_jax_params(tg.GPT2MultiModalModel(
        tg.GPT2Config(**cfg), FP32_POLICY), params)
    th, tl = tm(torch.from_numpy(ids), enc=torch.from_numpy(enc))
    _close(th.detach(), jh)
    _close(tl.detach(), jl)
