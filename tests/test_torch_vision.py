"""The port's video encoder (youku_mplug_tpu_torch.models.vision/tasks)
against the JAX package at fp32 on the tiny flagship config, with weights
carried over by the bridge.

Parameters are redrawn from numpy (std 0.2, LayerNorm scales near one)
so no weight is zero: the JAX init zeroes ``temporal_fc`` past block 1,
``bias_k``/``bias_v`` and the biases, which would hide a broken period
mask, fold or extra key.  Tolerance 1e-4 (fp32, sums in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from youku_mplug_tpu.models import tasks as jtasks
from youku_mplug_tpu.models.gpt3 import GPT3LM
from youku_mplug_tpu.models import vision as jvision
from youku_mplug_tpu.runtime.precision import FP32_POLICY as J_FP32
from youku_mplug_tpu_torch import bridge
from youku_mplug_tpu_torch.config import flagship_config
from youku_mplug_tpu_torch.models import vision as tvision
from youku_mplug_tpu_torch.models.tasks import MPLUGVideo
from youku_mplug_tpu_torch.runtime.precision import FP32_POLICY

torch.set_num_threads(1)
TOL = 1e-4


def redraw(tree, rng, std=0.2):
    """Same tree of shapes, every leaf drawn: LayerNorm scales 1 + N(0, 0.1),
    everything else N(0, std)."""
    def leaf(path, x):
        name = str(path[-1].key)
        z = rng.normal(size=x.shape).astype(np.float32)
        return 1.0 + 0.1 * z if name.endswith("scale") else std * z
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def _init(module, *args, method=None):
    """The module's parameter shapes (no values: they are redrawn)."""
    return jax.eval_shape(lambda: module.init(jax.random.key(0), *args,
                                              method=method))["params"]


def test_encode_video_matches_jax_through_bridge():
    cfg = _flagship_cfg(tiny=True)
    v = cfg.vision
    rng = np.random.default_rng(0)
    video = rng.normal(size=(2, 3, v.num_frames, v.img_size,
                             v.img_size)).astype(np.float32)
    jm = jtasks.MPLUGVideo(cfg, policy=J_FP32)
    enc = _init(jm, jnp.asarray(video),
                method=jtasks.MPLUGVideo.encode_queries)
    dec = _init(GPT3LM(cfg.text, policy=J_FP32), jnp.zeros((1, 4), jnp.int32))
    params = redraw(dict(enc, text_decoder=dec), rng)
    want = jax.jit(lambda p, x: jm.apply(
        {"params": p}, x, method=jtasks.MPLUGVideo.encode_video))(
            params, jnp.asarray(video))
    tm = bridge.load_jax_params(
        MPLUGVideo(flagship_config(tiny=True), FP32_POLICY), params)
    got = tm.encode_video(_t(video))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)


@pytest.mark.parametrize("period,fold", [(0, False), (2, True)])
def test_vision_attention_matches_jax(period, fold):
    """Spatial (no mask) and temporal (period mask + fp32 temporal_fc
    fold) attention; q and v carry biases, k none."""
    rng = np.random.default_rng(1)
    c, n, s = 32, 4, 8
    x = rng.normal(size=(3, s, c)).astype(np.float32)
    jmod = jvision.VisionAttention(c, n, block_period=period,
                                   attn_impl="xla")
    params = redraw(_init(jmod, jnp.asarray(x)), rng)
    post = rng.normal(size=(c, c)).astype(np.float32) * 0.2
    pb = rng.normal(size=(c,)).astype(np.float32) * 0.2
    kw = {"post_kernel": post, "post_bias": pb} if fold else {}
    want = jmod.apply({"params": params}, jnp.asarray(x),
                      **{k: jnp.asarray(v) for k, v in kw.items()})
    tmod = bridge.load_jax_params(tvision.VisionAttention(c, n), params)
    got = tmod(_t(x), period=period, **{k: _t(v) for k, v in kw.items()})
    _close(got, want)
    assert "k_bias" not in dict(tmod.named_parameters())


@pytest.mark.parametrize("n,d,s,period,packed", [
    (2, 64, 197, 0, True),    # a ViT-B/16 frame: 197 tokens
    (2, 64, 50, 0, False),    # a 112 px image: 50 tokens, under 128
    (2, 64, 112, 8, True),    # 14 patches x 8 frames, period 8
    (2, 64, 12, 3, False),    # 4 patches x 3 frames: not a multiple of 8
    (2, 64, 16, 8, True),     # one group of 2 x 8
    (4, 88, 257, 0, False),   # EVA-ViT-g's heads: no packed geometry
])
def test_vision_attention_route_follows_jax(n, d, s, period, packed):
    """VisionAttention takes the packed flash kernel exactly where JAX's
    rule does (``vision.py:243-247``: the head geometry, and 128 tokens or
    more, or a multiple of 8 under a period mask), else einsum attention;
    the two routes give the same output."""
    import unittest.mock as mock

    from youku_mplug_tpu_torch.ops import flash_attention as fa

    assert tvision.packed_kernel_takes(n, d, s, period) == packed
    torch.manual_seed(0)
    attn = tvision.VisionAttention(n * d, n, FP32_POLICY.param_dtype)
    bridge.seeded_init(attn, 0, std=0.05)
    x = torch.randn(2, s, n * d)
    with mock.patch.object(tvision, "flash_attention_packed",
                           wraps=fa.flash_attention_packed) as flash, \
            mock.patch.object(tvision, "_einsum_attention",
                              wraps=tvision._einsum_attention) as einsum:
        got = attn(x, period=period)
    assert (flash.call_count, einsum.call_count) == (int(packed),
                                                    int(not packed))
    # the other route on the same call
    other = (tvision._einsum_attention if packed else
             lambda q_, k_, v_, n_, p_: fa.flash_attention_packed(
                 q_, k_, v_, n_, period=p_))
    with mock.patch.object(tvision, "flash_attention_packed",
                           lambda q_, k_, v_, n_, period=0: other(
                               q_, k_, v_, n_, period)), \
            mock.patch.object(tvision, "_einsum_attention", other):
        want = attn(x, period=period)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_space_time_block_matches_jax():
    """Shared cls updated as the mean over frames; n-major tokens; g=4
    patches x 2 frames per temporal call (period 2)."""
    cfg = _flagship_cfg(tiny=True).vision
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 4, cfg.num_frames, cfg.embed_dim)).astype(
        np.float32)
    cls = rng.normal(size=(2, cfg.embed_dim)).astype(np.float32)
    jmod = jvision.SpaceTimeBlock(cfg, layer_id=2)
    params = redraw(_init(jmod, jnp.asarray(x), jnp.asarray(cls)), rng)
    wx, wcls = jmod.apply({"params": params}, jnp.asarray(x),
                          jnp.asarray(cls))
    tcfg = flagship_config(tiny=True).vision
    tmod = bridge.load_jax_params(tvision.SpaceTimeBlock(tcfg), params)
    gx, gcls = tmod(_t(x), _t(cls))
    _close(gx, wx)
    _close(gcls, wcls)


def test_attention_pool_matches_jax():
    """bias_k/bias_v add one key; the residual base is the normed
    queries."""
    rng = np.random.default_rng(3)
    d, n = 32, 4
    qs = rng.normal(size=(2, 5, d)).astype(np.float32)
    ks = rng.normal(size=(2, 9, d)).astype(np.float32)
    jmod = jvision.AttentionPool(d, n, mlp_ratio=2.0)
    params = redraw(_init(jmod, jnp.asarray(qs), jnp.asarray(ks)), rng)
    want = jax.jit(jmod.apply)({"params": params}, jnp.asarray(qs),
                               jnp.asarray(ks))
    tmod = bridge.load_jax_params(
        tvision.AttentionPool(d, n, mlp_ratio=2.0), params)
    _close(tmod(_t(qs), _t(ks)), want)


def test_attention_pool_gradients_match_jax():
    """Every leaf's gradient against jax.grad, k_bias's included: the
    port applies k_bias as -k_bias on the appended bias key alone (the
    softmax ignores a shift of every score of a query), the same function
    as JAX's k_bias on every key."""
    rng = np.random.default_rng(4)
    d, n = 32, 4
    qs = rng.normal(size=(2, 5, d)).astype(np.float32)
    ks = rng.normal(size=(2, 9, d)).astype(np.float32)
    w = rng.normal(size=(2, 5, d)).astype(np.float32)
    jmod = jvision.AttentionPool(d, n, mlp_ratio=2.0)
    params = redraw(_init(jmod, jnp.asarray(qs), jnp.asarray(ks)), rng)
    want = bridge.flatten(jax.grad(lambda p: jnp.sum(jmod.apply(
        {"params": p}, jnp.asarray(qs), jnp.asarray(ks)) * w))(params))
    tmod = bridge.load_jax_params(
        tvision.AttentionPool(d, n, mlp_ratio=2.0), params)
    tmod.requires_grad_(True)
    (tmod(_t(qs), _t(ks)) * _t(w)).sum().backward()
    got = {bridge.jax_path(k): p.grad for k, p in tmod.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], 1e-5)


def test_attention_pool_k_bias_gradient_holds_in_bf16():
    """k_bias's gradient in bf16 compute over 1569 keys within 2^-7 of the
    fp32 one: it is one key's dk.  As the sum of every other key's bf16
    dk rows (JAX's k_bias on every key), which nearly cancel, it read
    0.020 at this shape."""
    torch.manual_seed(0)
    d, n, b, q, k = 128, 4, 8, 32, 1569
    pool = tvision.AttentionPool(d, n)
    for p in pool.parameters():
        p.data.normal_(0, 0.05)
    pool.requires_grad_(True)
    qs, ks, w = torch.randn(b, q, d), torch.randn(b, k, d), torch.randn(
        b, q, d)

    def grad(dtype):
        pool.zero_grad()
        (pool(qs.to(dtype), ks.to(dtype)).float() * w).sum().backward()
        return pool.k_bias.grad.clone()
    want = grad(torch.float32)
    err = (grad(torch.bfloat16) - want).norm() / want.norm()
    assert err <= 2.0 ** -7, err


def test_temporal_group_matches_jax_geometry():
    # flagship: 196 patches x 8 frames -> 14 patches per call, S = 112
    assert tvision.temporal_group(196, 8) == 14
    assert tvision.temporal_group(4, 2) == 4
    assert tvision.temporal_group(7, 128) == 1


def test_bridge_rejects_leftovers_missing_and_bad_shapes():
    mod = tvision.Mlp(4, 8)
    good = {"fc1_kernel": np.zeros((4, 8)), "fc1_bias": np.zeros(8),
            "fc2_kernel": np.zeros((8, 4)), "fc2_bias": np.zeros(4)}
    bridge.load_jax_params(mod, good)
    with pytest.raises(KeyError, match="no port parameter"):
        bridge.load_jax_params(mod, dict(good, extra=np.zeros(1)))
    with pytest.raises(KeyError, match="not in the JAX tree"):
        bridge.load_jax_params(mod, {k: v for k, v in good.items()
                                     if k != "fc2_bias"})
    with pytest.raises(ValueError, match="shape"):
        bridge.load_jax_params(mod, dict(good, fc2_bias=np.zeros(5)))
    assert bridge.port_name("visual_encoder/blocks_11/attn/q_bias") == \
        "visual_encoder.blocks.11.attn.q_bias"


def test_seeded_init_is_deterministic_and_nonzero():
    cfg = flagship_config(tiny=True)
    a = bridge.seeded_init(MPLUGVideo(cfg, FP32_POLICY), 3)
    b = bridge.seeded_init(MPLUGVideo(cfg, FP32_POLICY), 3)
    names = dict(a.named_parameters())
    for (name, pa), (_, pb) in zip(a.named_parameters(),
                                   b.named_parameters()):
        assert torch.equal(pa, pb), name
        if name.endswith("scale"):  # LayerNorm scales
            assert torch.all(pa == 1), name
        elif name.endswith("bias") and name[:-4] + "scale" in names:
            assert torch.all(pa == 0), name  # LayerNorm biases
        else:
            assert torch.all(pa != 0), name
    blk = a.visual_encoder.blocks[1]
    assert blk.temporal_fc_kernel.abs().mean() > 0.01  # not zero-init


def test_vision_config_rejects_clip_towers():
    """A CLIP tower builds both ways: the clip_model TimeSformer (clip-b16)
    and the plain VisionTransformer carry ``norm_pre`` and a bias-free
    patch embedding (tests/test_torch_downstream.py holds the TimeSformer
    against JAX); vision LoRA builds the adapters of every block's
    attentions and MLP (tests/test_torch_train_knobs.py holds them against
    JAX)."""
    cfg = dataclasses.replace(flagship_config(tiny=True).vision,
                              clip_model=True)
    tower = tvision.TimeSformer(cfg, FP32_POLICY)
    assert tower.norm_pre is not None and tower.patch_embed.bias is None
    lora = tvision.TimeSformer(dataclasses.replace(cfg, lora_rank=4),
                               FP32_POLICY)
    names = {n.rsplit(".", 1)[-1] for n, _ in lora.named_parameters()
             if "lora_" in n}
    assert names == {f"lora_{t}_{ab}" for t in ("qkv", "proj", "fc1", "fc2")
                     for ab in "ab"}
    assert tvision.VisionTransformer(cfg, FP32_POLICY).norm_pre is not None


@pytest.mark.parametrize("clip,gelu", [(True, "quick"), (False, "tanh")])
def test_vision_transformer_matches_jax(clip, gelu):
    """The per-frame ViT of mPLUG-Owl: the CLIP form (bias-free patch
    embedding, norm_pre over [cls; patches], quick GELU), and the plain
    form; 1 + 4 tokens per image through two pre-LN blocks."""
    rng = np.random.default_rng(6)
    kw = dict(img_size=16, patch_size=8, embed_dim=32, depth=2, num_heads=4,
              clip_model=clip, gelu=gelu)
    images = rng.normal(size=(3, 3, 16, 16)).astype(np.float32)
    jmod = jvision.VisionTransformer(jvision.VisionConfig(**kw,
                                                          attn_impl="xla"),
                                     policy=J_FP32)
    params = redraw(_init(jmod, jnp.asarray(images)), rng)
    want_cls, want = jmod.apply({"params": params}, jnp.asarray(images))
    tmod = bridge.load_jax_params(tvision.VisionTransformer(
        tvision.VisionConfig(**kw), FP32_POLICY), params)
    got_cls, got = tmod(_t(images))
    assert tuple(got.shape) == want.shape == (3, 5, 32)
    _close(got, want)
    _close(got_cls, want_cls)
    assert ("bias" in params["patch_embed"]) == (not clip)


@pytest.mark.parametrize("gelu", ["tanh", "erf", "quick"])
def test_mlp_gelu_flavour_matches_jax(gelu):
    """The GELU flavour per config: tanh (the flagship), erf, and CLIP's
    quick GELU x * sigmoid(1.702 x) (the Owl tower).  Inputs (std 2) and
    weights (std 0.5) are wide enough that the tolerance tells each
    flavour from the others (tanh and erf differ by at most 5e-4 before
    the second matmul, which carries that to about 6x the tolerance)."""
    rng = np.random.default_rng(7)
    x = 2 * rng.normal(size=(4, 16)).astype(np.float32)
    jmod = jvision.Mlp(16, 32, gelu=gelu)
    params = redraw(_init(jmod, jnp.asarray(x)), rng, std=0.5)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    got = bridge.load_jax_params(tvision.Mlp(16, 32, gelu=gelu),
                                 params)(_t(x))
    _close(got, want)
    others = [jvision.Mlp(16, 32, gelu=g).apply({"params": params},
                                                jnp.asarray(x))
              for g in ("tanh", "erf", "quick") if g != gelu]
    assert not any(np.allclose(np.asarray(o), np.asarray(want), rtol=TOL,
                               atol=TOL) for o in others)


def test_fold_runs_in_fp32_before_the_cast():
    """fp32 weights, bf16 activations: the temporal_fc fold P @ T is taken
    in fp32 and only then cast.  With T = inv(P) the fp32 fold is the
    identity; folding bf16-rounded factors is off by ~2^-8 * cond(P),
    which the tolerance below would catch."""
    rng = np.random.default_rng(4)
    c, n = 32, 4
    x = rng.normal(size=(3, 8, c)).astype(np.float32)
    jmod = jvision.VisionAttention(c, n, block_period=2, attn_impl="xla")
    params = redraw(_init(jmod, jnp.asarray(x)), rng)
    inv = np.linalg.inv(params["proj_kernel"].reshape(c, c).astype(
        np.float64)).astype(np.float32)
    pb = rng.normal(size=(c,)).astype(np.float32) * 0.2
    want = jmod.apply({"params": params}, jnp.asarray(x, jnp.bfloat16),
                      post_kernel=jnp.asarray(inv),
                      post_bias=jnp.asarray(pb))
    tmod = bridge.load_jax_params(tvision.VisionAttention(c, n), params)
    got = tmod(_t(x).to(torch.bfloat16), period=2, post_kernel=_t(inv),
               post_bias=_t(pb))
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), 1e-2)


@pytest.mark.parametrize("policy,stride", [("sixth", 6), ("half", 2),
                                           ("third:names", 3),
                                           ("nothing", 1)])
def test_grad_ckpt_stride_and_same_gradients(policy, stride):
    """Blocks i % stride == 0 run under checkpoint (the JAX package's
    stride rule); the gradients do not change."""
    import unittest.mock as mock

    cfg = dataclasses.replace(flagship_config(tiny=True).vision, depth=3)
    assert dataclasses.replace(cfg, remat_policy=policy).remat_stride == \
        stride
    rng = np.random.default_rng(5)
    video = _t(rng.normal(size=(2, 3, cfg.num_frames, cfg.img_size,
                                cfg.img_size)).astype(np.float32))
    grads = []
    for ckpt in (False, True):
        enc = bridge.seeded_init(tvision.TimeSformer(dataclasses.replace(
            cfg, grad_ckpt=ckpt, remat_policy=policy), FP32_POLICY), 1)
        for p in enc.parameters():
            p.requires_grad_(True)
        with mock.patch.object(tvision, "checkpoint",
                               wraps=tvision.checkpoint) as spy:
            enc(video)[1].square().sum().backward()
        assert spy.call_count == (len(range(0, 3, stride)) if ckpt else 0)
        grads.append([p.grad for p in enc.parameters()])
    for g0, g1 in zip(*grads):
        _close(g1, g0, 1e-5)


def test_vision_dropout_raises_in_training_only():
    """Vision drop-path is ported: it draws only in training mode and
    with a generator (the law: tests/test_torch_train_knobs.py)."""
    cfg = dataclasses.replace(flagship_config(tiny=True).vision,
                              drop_path=0.5)
    enc = bridge.seeded_init(tvision.TimeSformer(cfg, FP32_POLICY), 0)
    video = torch.randn(4, 3, cfg.num_frames, cfg.img_size, cfg.img_size,
                        generator=torch.Generator().manual_seed(1))
    plain = enc.eval()(video)[1]
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(enc.eval()(video, gen)[1], plain)
    assert torch.equal(enc.train()(video)[1], plain)
    assert not torch.equal(enc.train()(video, gen)[1], plain)
