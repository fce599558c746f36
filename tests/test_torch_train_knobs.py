"""The training knobs of the port against the JAX package on the CPU.

- GPT-3 LoRA, vision LoRA and ``connect_ln`` (``visual_norm``): the
  pretrain loss and every trainable leaf's gradient against JAX at fp32
  on the tiny flagship config with every adapter's ``b`` nonzero
  (parameters redrawn, tolerance 1e-4, as tests/test_torch_train.py);
  the vision attention with adapters in each of its routes (the packed
  kernel's, einsum attention, and the period mask) against JAX's; the
  LoRA decoder's prefill and decode steps against JAX's ``decode_step``.
- Dropout in the video towers and Bloom, held to its law (JAX's bits
  cannot be drawn from a torch.Generator, tests/test_torch_dropout.py):
  rate 0 with a generator equals the deterministic forward, drop-path
  zeroes whole samples at its share and scales the rest by 1 / (1 -
  rate), the same seed gives the same masks, attention dropout leaves
  the flash kernels for the plain path (JAX's rule) with the temporal
  period mask kept, and a checkpointed block or layer replays its masks.
- Bloom's remat policies and ``ce_chunk`` equal the plain forward and
  gradients; "names" and "narrow" run each layer's attention once.
- The bridge carries each new leaf both ways and stays strict.
- A GPT-3 LoRA pretrain run, exported merged by ``cli/export_serving.py``,
  serves the same tokens as the run served unmerged by ``serve
  --resume``, and the two models' teacher-forced logits agree.
"""

import dataclasses
import os
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from __graft_entry__ import _flagship_cfg
from youku_mplug_tpu.models import gpt3 as jgpt3
from youku_mplug_tpu.models import tasks as jtasks
from youku_mplug_tpu.models import vision as jvision
from youku_mplug_tpu.runtime.precision import FP32_POLICY as J_FP32
from youku_mplug_tpu_torch import bridge
from youku_mplug_tpu_torch.config import flagship_config
from youku_mplug_tpu_torch.models import bloom as tbloom
from youku_mplug_tpu_torch.models import gpt3 as tgpt3
from youku_mplug_tpu_torch.models import tasks as ttasks
from youku_mplug_tpu_torch.models import vision as tvision
from youku_mplug_tpu_torch.ops import attention as tattn
from youku_mplug_tpu_torch.ops.attention import drop_path
from youku_mplug_tpu_torch.optim.factory import OptimizerConfig
from youku_mplug_tpu_torch.runtime.precision import FP32_POLICY
from youku_mplug_tpu_torch.train.state import create_train_state

torch.set_num_threads(1)
TOL = 1e-4
SIGMAS = 6.0


def redraw(tree, rng, std=0.2):
    """Every leaf redrawn from numpy (LoRA ``b`` included: nonzero)."""
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


def _t(a):
    return torch.from_numpy(np.array(a))


def _share_ok(zeroed, n, rate):
    return abs(zeroed / n - rate) <= SIGMAS * (rate * (1 - rate) / n) ** 0.5


KNOBS = {"gpt3_lora": dict(text=2), "vision_lora": dict(vision=2),
         "connect_ln": dict(connect_ln=True),
         "all": dict(text=2, vision=3, connect_ln=True)}


def _knob_cfgs(text=0, vision=0, connect_ln=False):
    jcfg, tcfg = _flagship_cfg(tiny=True), flagship_config(tiny=True)
    out = []
    for cfg in (jcfg, tcfg):
        out.append(dataclasses.replace(
            cfg, connect_ln=connect_ln, freeze_vit=True,
            text=dataclasses.replace(cfg.text, lora_rank=text,
                                     lora_alpha=8.0),
            vision=dataclasses.replace(cfg.vision, lora_rank=vision,
                                       lora_alpha=4.0)))
    return out


def _inputs(rng, b=3, s=10):
    v = _flagship_cfg(tiny=True).vision
    video = rng.normal(size=(b, 3, v.num_frames, v.img_size,
                             v.img_size)).astype(np.float32)
    ids = rng.integers(3, 256, size=(b, s)).astype(np.int32)
    lengths = np.array([s] + list(rng.integers(3, s + 1, size=b - 1)))
    mask = (np.arange(s)[None] < lengths[:, None]).astype(np.int32)
    return video, np.where(mask == 1, ids, 2).astype(np.int32), mask


def _task_models(rng, knobs, video, ids, mask):
    jcfg, tcfg = _knob_cfgs(**knobs)
    jm = jtasks.MPLUGVideo(jcfg, policy=J_FP32)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.asarray(video), jnp.asarray(ids),
        jnp.asarray(mask)))["params"]
    params = redraw(shapes, rng)
    tm = bridge.load_jax_params(ttasks.MPLUGVideo(tcfg, FP32_POLICY), params)
    return jm, params, tm


@pytest.mark.parametrize("knob", list(KNOBS))
def test_lora_and_connect_ln_loss_and_grads_match_jax(knob):
    rng = np.random.default_rng(len(knob))
    video, ids, mask = _inputs(rng)
    jm, params, tm = _task_models(rng, KNOBS[knob], video, ids, mask)
    flat = _flat(params)
    lora = [k for k in flat if "lora_" in k]
    assert ("text_decoder/decoder/layers/attn/lora_qkv_b" in flat) == \
        bool(KNOBS[knob].get("text"))
    assert ("visual_norm/scale" in flat) == bool(
        KNOBS[knob].get("connect_ln"))
    assert all(np.abs(flat[k]).max() > 0 for k in lora)

    def jfn(p):
        out = jm.apply({"params": p}, jnp.asarray(video), jnp.asarray(ids),
                       jnp.asarray(mask),
                       method=jtasks.MPLUGVideo.pretrain_loss)
        return out["loss"], out
    (_, jout), jgrads = jax.value_and_grad(jfn, has_aux=True)(params)
    state, _, _ = create_train_state(tm, OptimizerConfig(freeze_vit=True))
    assert set(lora) <= set(state.trainable)
    out = tm.pretrain_loss(_t(video), _t(ids).long(), _t(mask))
    out["loss"].backward()
    _close(out["loss"].detach(), jout["loss"])
    jflat = _flat(jgrads)
    for path, p in state.trainable.items():
        _close(torch.zeros_like(p) if p.grad is None else p.grad,
               jflat[path])


def test_connect_ln_normalizes_the_serving_encode():
    rng = np.random.default_rng(3)
    video, ids, mask = _inputs(rng)
    jm, params, tm = _task_models(rng, KNOBS["connect_ln"], video, ids, mask)
    want = jm.apply({"params": params}, jnp.asarray(video),
                    method=jtasks.MPLUGVideo.encode_video)[1]
    with torch.inference_mode():
        got = tm.eval().encode_queries(_t(video))
    _close(got, want)


@pytest.mark.parametrize("heads,dim,period,s", [
    (4, 64, 0, 9),     # packed kernel's geometry (its plain version here)
    (2, 192, 0, 9),    # d 96: einsum attention
    (4, 64, 3, 12),    # the temporal period mask
])
def test_vision_attention_lora_matches_jax_in_every_route(heads, dim,
                                                          period, s):
    from youku_mplug_tpu.ops.flash_attention import packed_supported as jps
    from youku_mplug_tpu_torch.ops.flash_attention import packed_supported

    assert packed_supported(heads, dim // heads) == jps(heads, dim // heads)
    rng = np.random.default_rng(heads + dim + period)
    jmod = jvision.VisionAttention(dim, heads, lora_rank=2, lora_alpha=4.0,
                                   block_period=period)
    x = rng.normal(size=(2, s, dim)).astype(np.float32)
    params = redraw(jax.eval_shape(lambda: jmod.init(
        jax.random.key(0), jnp.asarray(x)))["params"], rng)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = bridge.load_jax_params(tvision.VisionAttention(
        dim, heads, lora_rank=2, lora_alpha=4.0), params)
    _close(tmod(_t(x), period=period), want)


def _gpt3_lora_models(rng):
    jcfg = dataclasses.replace(_flagship_cfg(tiny=True).text, lora_rank=3,
                               lora_alpha=6.0)
    tcfg = dataclasses.replace(flagship_config(tiny=True).text, lora_rank=3,
                               lora_alpha=6.0)
    jlm = jgpt3.GPT3LM(jcfg, policy=J_FP32)
    params = redraw(jax.eval_shape(lambda: jlm.init(
        jax.random.key(0), jnp.zeros((1, 4), jnp.int32)))["params"], rng)
    tlm = bridge.load_jax_params(tgpt3.GPT3LM(tcfg, FP32_POLICY), params)
    return jlm, params, tlm


def test_gpt3_lora_forward_and_decode_steps_match_jax():
    rng = np.random.default_rng(4)
    jlm, params, tlm = _gpt3_lora_models(rng)
    layers = _flat(params)
    assert layers["decoder/layers/attn/lora_qkv_a"].shape == (2, 64, 3)
    assert layers["decoder/layers/mlp/lora_fc2_b"].shape == (2, 3, 64)
    b, s = 3, 9
    tokens = rng.integers(3, 256, size=(b, s)).astype(np.int32)
    want = jlm.apply({"params": params}, jnp.asarray(tokens))
    got = tlm(_t(tokens).long())
    _close(got["last_hidden_state"].detach(), want["last_hidden_state"])

    jparams = jax.tree.map(jnp.asarray, params)
    step = jax.jit(lambda e, c, cl: jlm.apply(
        {"params": jparams}, e, c, cl, jnp.zeros((b,), jnp.int32),
        jnp.zeros((b,), jnp.int32), method=jgpt3.GPT3LM.decode_step))
    jcache = jlm.apply({"params": params}, b, 16,
                       method=jgpt3.GPT3LM.init_cache)
    tcache = tlm.init_cache(b, 16)
    emb = jlm.apply({"params": params}, jnp.asarray(tokens),
                    method=jgpt3.GPT3LM.embed)
    jl, jcache = step(emb, jcache, jnp.int32(0))
    with torch.inference_mode():
        tl, tcache = tlm.decode_step(tlm.embed(_t(tokens).long()), tcache, 0,
                                     torch.zeros(b, dtype=torch.int32),
                                     torch.zeros(b, dtype=torch.int32))
    _close(tl, jl)
    cache_len = np.full((b,), s, np.int32)
    for _ in range(3):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        emb = jlm.apply({"params": params}, jnp.asarray(tok),
                        method=jgpt3.GPT3LM.embed)
        jl, jcache = step(emb, jcache, jnp.asarray(cache_len))
        with torch.inference_mode():
            tl, tcache = tlm.decode_step(tlm.embed(_t(tok).long()), tcache,
                                         _t(cache_len),
                                         torch.zeros(b, dtype=torch.int32),
                                         torch.zeros(b, dtype=torch.int32))
        _close(tl, jl)
        _close(tcache, jcache)
        cache_len += 1


# --- dropout, drop-path ---------------------------------------------------


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_drop_path_zeroes_whole_samples_and_scales_the_rest(rate):
    x = torch.randn(4000, 3, 5) + 3.0
    y = drop_path(x, rate, torch.Generator().manual_seed(0))
    zero = (y == 0).all(-1).all(-1)
    kept = ~zero
    assert _share_ok(int(zero.sum()), x.shape[0], rate)
    torch.testing.assert_close(y[kept], x[kept] / (1 - rate), rtol=0,
                               atol=0)
    assert ((y == 0) == zero[:, None, None]).all()  # whole samples only
    assert torch.equal(drop_path(x, 0.0, None), x)


def _tower(kind, **kw):
    base = flagship_config(tiny=True).vision
    cfg = dataclasses.replace(base, depth=3, **kw)
    cls = tvision.TimeSformer if kind == "timesformer" else \
        tvision.VisionTransformer
    if kind == "vit":
        cfg = dataclasses.replace(cfg, clip_model=True, gelu="quick")
    return bridge.seeded_init(cls(cfg, FP32_POLICY), 0), cfg


def _tower_input(kind, cfg, b=4):
    g = torch.Generator().manual_seed(9)
    if kind == "timesformer":
        return torch.randn(b, 3, cfg.num_frames, cfg.img_size, cfg.img_size,
                           generator=g)
    return torch.randn(b, 3, cfg.img_size, cfg.img_size, generator=g)


@pytest.mark.parametrize("kind", ["timesformer", "vit"])
def test_vision_rate_zero_equals_jax_and_the_deterministic_forward(kind):
    """Rates 0 in training with a generator: the deterministic forward,
    and JAX's (deterministic=False at rate 0)."""
    rng = np.random.default_rng(5)
    enc, cfg = _tower(kind)
    x = _tower_input(kind, cfg)
    jcls = jvision.TimeSformer if kind == "timesformer" else \
        jvision.VisionTransformer
    jcfg = jvision.VisionConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
        if f.name in {g.name for g in dataclasses.fields(
            jvision.VisionConfig)}})
    jm = jcls(jcfg, policy=J_FP32)
    params = redraw(jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.asarray(x.numpy())))["params"], rng)
    bridge.load_jax_params(enc, params)
    want = jm.apply({"params": params}, jnp.asarray(x.numpy()),
                    deterministic=False, rngs={"dropout": jax.random.key(1)})
    got = enc.train()(x, torch.Generator().manual_seed(0))
    _close(got[1].detach(), want[1])
    assert torch.equal(got[1], enc.eval()(x)[1])


@pytest.mark.parametrize("kind", ["timesformer", "vit"])
def test_vision_attention_dropout_takes_the_plain_path(kind):
    """JAX's rule: attention dropout leaves the flash kernel (every
    attention call goes to mha_reference with the rate); without it the
    packed kernel runs (at 192 px: 145 spatial tokens, temporal groups of
    48 patches x 2 frames, each a sequence the packed kernel takes); the
    same seed gives the same output."""
    from youku_mplug_tpu_torch.ops import flash_attention as fa

    enc, cfg = _tower(kind, attn_drop_rate=0.2, embed_dim=128, num_heads=2,
                      img_size=192)
    x = _tower_input(kind, cfg)
    # two attentions a space-time block (temporal, spatial), one a plain
    calls = 2 * cfg.depth if kind == "timesformer" else cfg.depth
    assert fa.packed_supported(2, 64)
    with mock.patch.object(tvision, "flash_attention_packed",
                           wraps=fa.flash_attention_packed) as flash, \
            mock.patch.object(tvision, "mha_reference",
                              wraps=tattn.mha_reference) as plain:
        a = enc.train()(x, torch.Generator().manual_seed(3))[1]
        assert flash.call_count == 0 and plain.call_count == calls
        assert all(c.kwargs["dropout_rate"] == 0.2
                   for c in plain.call_args_list)
        b = enc.train()(x, torch.Generator().manual_seed(3))[1]
        enc.eval()(x)
        assert flash.call_count == calls
        assert plain.call_count == 2 * calls
    assert torch.equal(a, b)
    assert not torch.equal(a, enc.eval()(x)[1])


def test_temporal_attention_keeps_its_period_mask_under_dropout():
    """The packed temporal attention (g patches x T frames, period T)
    under attention dropout: the port's plain path masks across groups,
    so a rate near 0 gives the dropout-free output; JAX's dropout path
    drops the mask (ROADMAP Queue 3), so its output moves far."""
    rng = np.random.default_rng(8)
    c, n, t, s = 32, 4, 3, 12
    x = rng.normal(size=(2, s, c)).astype(np.float32)
    jmod = jvision.VisionAttention(c, n, block_period=t, attn_drop=1e-7)
    params = redraw(jax.eval_shape(lambda: jmod.init(
        jax.random.key(0), jnp.asarray(x)))["params"], rng)
    ref = jmod.apply({"params": params}, jnp.asarray(x))
    jdrop = jmod.apply({"params": params}, jnp.asarray(x),
                       deterministic=False,
                       rngs={"dropout": jax.random.key(0)})
    tmod = bridge.load_jax_params(tvision.VisionAttention(c, n), params)
    got = tmod(_t(x), period=t, drop=tattn.Dropout(
        torch.Generator().manual_seed(0), attention=1e-7))
    _close(got, ref)
    assert np.abs(np.asarray(jdrop) - np.asarray(ref)).max() > 1e-2


@pytest.mark.parametrize("kind", ["timesformer", "vit"])
def test_vision_drop_path_and_drop_rate_follow_their_rates(kind):
    """Drop-path at linspace(0, rate, depth) per block (the first block's
    0), on each block's two residual branches; drop_rate on the
    TimeSformer's tokens (the ViT has none, as in JAX)."""
    enc, cfg = _tower(kind, drop_path=0.3, drop_rate=0.25)
    assert [b.drop_path for b in enc.blocks] == pytest.approx(
        [0.0, 0.15, 0.3])
    x = _tower_input(kind, cfg)
    with mock.patch.object(tvision, "drop_path",
                           wraps=tvision.drop_path) as dp, \
            mock.patch.object(tvision, "dropout",
                              wraps=tvision.dropout) as do:
        enc.train()(x, torch.Generator().manual_seed(2))
    assert [c.args[1] for c in dp.call_args_list] == pytest.approx(
        [0.0, 0.0, 0.15, 0.15, 0.3, 0.3])
    assert [c.args[1] for c in do.call_args_list] == (
        [0.25] if kind == "timesformer" else [])


def test_checkpointed_vision_blocks_replay_their_masks():
    """grad_ckpt with drop-path and attention dropout: the same loss and
    gradients as the unchecked tower on the same generator seed."""
    outs = []
    for ckpt in (False, True):
        enc, cfg = _tower("timesformer", drop_path=0.4, attn_drop_rate=0.3,
                          grad_ckpt=ckpt)
        for p in enc.parameters():
            p.requires_grad_(True)
        x = _tower_input("timesformer", cfg)
        loss = enc.train()(x, torch.Generator().manual_seed(4))[1].square()
        loss.sum().backward()
        outs.append((loss.detach(), [p.grad for p in enc.parameters()]))
    assert torch.equal(outs[0][0], outs[1][0])
    for g0, g1 in zip(outs[0][1], outs[1][1]):
        torch.testing.assert_close(g1, g0, rtol=1e-6, atol=1e-7)


def _bloom(**kw):
    cfg = tbloom.BloomConfig(vocab_size=64, hidden_size=32,
                             num_hidden_layers=3, num_attention_heads=4,
                             **kw)
    return bridge.seeded_init(tbloom.BloomLM(cfg, FP32_POLICY), 0)


def _bloom_batch(b=3, s=12):
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(4, 64, (b, s), generator=g)
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.ones(b, s - 1, dtype=torch.int32)
    mask[1, 6:] = 0
    return tokens, labels, mask


def test_bloom_dropout_law():
    """Rate 0 with a generator equals the deterministic forward; hidden
    dropout draws once on the embeddings and twice a layer at its rate;
    attention dropout takes mha_reference with the ALiBi bias, never the
    flash kernel; the same seed gives the same loss."""
    tokens, labels, mask = _bloom_batch()
    lm0 = _bloom()
    det = lm0.eval()(tokens, labels=labels, loss_mask=mask)["loss"]
    assert torch.equal(lm0.train()(
        tokens, labels=labels, loss_mask=mask,
        generator=torch.Generator().manual_seed(0))["loss"], det)
    lm = _bloom(hidden_dropout=0.2, attention_dropout=0.3)
    with mock.patch.object(tbloom, "dropout", wraps=tbloom.dropout) as do, \
            mock.patch.object(tbloom, "flash_attention_packed") as flash, \
            mock.patch.object(tbloom, "mha_reference",
                              wraps=tbloom.mha_reference) as plain:
        a = lm.train()(tokens, labels=labels, loss_mask=mask,
                       generator=torch.Generator().manual_seed(5))["loss"]
    assert [c.args[1] for c in do.call_args_list] == [0.2] * 7
    assert flash.call_count == 0 and plain.call_count == 3
    call = plain.call_args_list[0]
    assert call.kwargs["dropout_rate"] == 0.3 and call.kwargs["causal"]
    slopes = torch.tensor(tbloom.alibi_slopes(4))
    torch.testing.assert_close(call.kwargs["bias"][0, :, 0, 5],
                               slopes * 5)
    b = lm.train()(tokens, labels=labels, loss_mask=mask,
                   generator=torch.Generator().manual_seed(5))["loss"]
    assert torch.equal(a, b) and not torch.equal(a, det)
    # the hidden dropout's zeroed share on the embeddings
    x = torch.randn(64, 50, 32)
    y = tattn.dropout(x, 0.2, torch.Generator().manual_seed(0))
    assert _share_ok(int((y == 0).sum()), x.numel(), 0.2)


def _bloom_loss_and_grads(lm, batch, seed):
    tokens, labels, mask = batch
    params = [p for n, p in lm.named_parameters()]
    for p in params:
        p.requires_grad_(True)
        p.grad = None
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    loss = lm.train()(tokens, labels=labels, loss_mask=mask,
                      generator=gen)["loss"]
    loss.backward()
    return loss.detach(), [p.grad.clone() for p in params]


@pytest.mark.parametrize("policy", ["nothing", "names", "narrow"])
@pytest.mark.parametrize("dropout_on", [False, True])
def test_bloom_remat_equals_the_plain_forward(policy, dropout_on):
    """Each policy's loss and gradients against the layer without remat
    (dropout on: the same generator seed, so the replayed masks must be
    the forward's); the flash forward runs twice a layer under "nothing"
    (its recompute) and once under "names" / "narrow"."""
    from youku_mplug_tpu_torch.ops import flash_attention as fa

    rates = dict(hidden_dropout=0.2) if dropout_on else {}
    batch = _bloom_batch()
    seed = 6 if dropout_on else None
    want = _bloom_loss_and_grads(_bloom(lora_rank=2, **rates), batch, seed)
    lm = _bloom(lora_rank=2, remat=True, remat_policy=policy, **rates)
    with mock.patch.object(tbloom, "flash_attention_packed",
                           wraps=fa.flash_attention_packed) as flash:
        got = _bloom_loss_and_grads(lm, batch, seed)
    assert flash.call_count == 3 * (2 if policy == "nothing" else 1)
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-6)
    for g1, g0 in zip(got[1], want[1]):
        torch.testing.assert_close(g1, g0, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("chunk", [3, 4, 5])
def test_bloom_ce_chunk_equals_the_dense_loss(chunk):
    """ce_chunk streams the LM loss over sequence chunks (a chunk that
    does not divide S runs dense); loss and gradients as the dense one."""
    batch = _bloom_batch(s=12)
    want = _bloom_loss_and_grads(_bloom(), batch, None)
    got = _bloom_loss_and_grads(_bloom(ce_chunk=chunk), batch, None)
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=0)
    for g1, g0 in zip(got[1], want[1]):
        torch.testing.assert_close(g1, g0, rtol=1e-5, atol=1e-7)


# --- the bridge -------------------------------------------------------------


def test_bridge_carries_the_new_leaves_and_stays_strict():
    rng = np.random.default_rng(10)
    video, ids, mask = _inputs(rng)
    _, params, tm = _task_models(rng, KNOBS["all"], video, ids, mask)
    flat = _flat(params)
    new = sorted(k for k in flat if "lora_" in k or "visual_norm" in k)
    assert {k.rsplit("/", 1)[-1] for k in new} >= {
        "scale", "bias", "lora_qkv_a", "lora_out_b", "lora_proj_a",
        "lora_fc1_b", "lora_fc2_a"}
    back = _flat(bridge.to_jax_tree(tm))
    assert set(back) == set(flat)
    for k in new:
        np.testing.assert_array_equal(back[k], flat[k])
    _, tcfg = _knob_cfgs(**KNOBS["all"])
    fresh = ttasks.MPLUGVideo(tcfg, FP32_POLICY)
    missing = dict(flat)
    missing.pop(new[0])
    with pytest.raises(KeyError, match="not in the JAX tree"):
        bridge.load_jax_params(fresh, _unflat(missing))
    extra = dict(flat, **{"visual_norm/extra": np.zeros(1, np.float32)})
    with pytest.raises(KeyError, match="no port parameter"):
        bridge.load_jax_params(fresh, _unflat(extra))
    bad = dict(flat)
    bad[new[0]] = np.zeros((1,) + flat[new[0]].shape, np.float32)
    with pytest.raises(ValueError, match="shape"):
        bridge.load_jax_params(fresh, _unflat(bad))
    # jax_init fills every new leaf by JAX's rules: b zero, a normal
    bridge.jax_init(fresh, 0)
    for name, p in fresh.named_parameters():
        if "lora_" in name and name.endswith("_b"):
            assert not p.any(), name
        elif "lora_" in name:
            assert p.std() > 0, name
        elif "visual_norm" in name:
            assert torch.equal(p, torch.ones_like(p) if name.endswith(
                "scale") else torch.zeros_like(p)), name


def _unflat(flat):
    return bridge.unflatten(flat)


# --- LoRA export ----------------------------------------------------------


def _lora_yaml(tmp_path):
    with open("configs/pretrain/pretrain_tiny_no_dropout.yaml") as f:
        raw = yaml.safe_load(f)
    raw.update(lora_rank=2, lora_alpha=8, connect_ln=True,
               max_new_tokens=5, prompt="", optimizer=dict(
                   raw["optimizer"], opt="adamp", lr=5e-2))
    raw["visual_overrides"] = dict(raw["visual_overrides"], lora_rank=2)
    path = tmp_path / "lora.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def test_gpt3_lora_run_exports_merged_and_serves_the_same(tmp_path):
    """2 pretrain steps of GPT-3 and vision LoRA (adamp, connect_ln) at
    fp32; ``serve --resume`` serves the run with its adapters unmerged;
    ``export_serving`` folds them into the kernels (each tower with its
    own rank and alpha) and a rank-0 model loaded with the merged tree
    serves the same tokens; teacher-forced logits agree to 1e-4."""
    from youku_mplug_tpu_torch.cli import common, export_serving, \
        run_pretrain, serve
    from youku_mplug_tpu_torch.config import load_config
    from youku_mplug_tpu_torch.train.checkpoint import CheckpointManager

    cfg_path = _lora_yaml(tmp_path)
    run = tmp_path / "run"
    args = run_pretrain.base_parser().parse_args([
        "--config", cfg_path, "--output_dir", str(run), "--synthetic_data",
        "--max_steps", "2", "--fp32", "--device", "cpu"])
    runner = run_pretrain.setup(args)
    common.train_epochs(runner, run_pretrain.build_train_step(runner),
                        run_pretrain.make_batch)
    raw = CheckpointManager(str(run / "checkpoints")).restore_raw(2)
    assert raw["opt"] == "adamp"
    moved = [k for k in raw["trainable"] if "lora_" in k and k.endswith(
        "_b")]
    assert moved and all(raw["trainable"][k].abs().max() > 0 for k in moved)

    sargs = serve.serve_parser().parse_args([
        "--config", cfg_path, "--output_dir", str(run), "--resume", str(run),
        "--synthetic_data", "--num_requests", "4", "--num_slots", "2",
        "--device", "cpu"])
    cfg, lora_model, device = serve.build(sargs)
    assert lora_model.cfg.text.lora_rank == 2
    _, unmerged, _ = serve.run(sargs, cfg, lora_model, device)

    dest = tmp_path / "serving"
    export_serving.main(["--run_dir", str(run), "--config", cfg_path,
                         "--dest", str(dest), "--device", "cpu"])
    merged = CheckpointManager(str(dest)).restore_raw(2)["params"]
    assert not any("lora_" in k for k in _flat(merged))
    rank0 = load_config(cfg_path).model
    rank0 = dataclasses.replace(
        rank0, text=dataclasses.replace(rank0.text, lora_rank=0),
        vision=dataclasses.replace(rank0.vision, lora_rank=0))
    model = bridge.load_jax_params(
        ttasks.MPLUGVideo(rank0, lora_model.policy), merged).eval()
    _, got, _ = serve.run(sargs, cfg, model, device)
    assert [r["tokens"] for r in got] == [r["tokens"] for r in unmerged]

    # teacher-forced at fp32: the run restored unmerged (adapters) and
    # the merged tree, the same clips and tokens through both
    lora_model = ttasks.MPLUGVideo(load_config(cfg_path).model,
                                   FP32_POLICY)
    bridge.seeded_init(lora_model, 0)
    state, _, _ = create_train_state(lora_model, cfg.optimizer)
    CheckpointManager(str(run / "checkpoints")).restore(2, state)
    model = bridge.load_jax_params(
        ttasks.MPLUGVideo(rank0, FP32_POLICY), merged).eval()
    lora_model.eval()
    v = cfg.model.vision
    video = torch.randn(2, 3, v.num_frames, v.img_size, v.img_size,
                        generator=torch.Generator().manual_seed(0))
    tokens = torch.randint(3, 500, (2, 7),
                           generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        logits = []
        for m in (lora_model, model):
            qf = m.encode_queries(video)
            emb = torch.cat([qf.to(m.text_decoder.policy.compute_dtype),
                             m.text_decoder.embed(tokens)], dim=1)
            hid = m.text_decoder(input_embeds=emb)["last_hidden_state"]
            logits.append(m.text_decoder.logits(hid))
    torch.testing.assert_close(logits[1], logits[0], rtol=1e-4, atol=1e-4)
    assert os.path.exists(dest / "2" / "metadata.json")


# --- the YAML surface -------------------------------------------------------


OPT_BLOCK = {"opt": "lookahead_lamb", "lr": 2e-3, "momentum": 0.8,
             "weight_decay": 0.02, "opt_betas": [0.9, 0.99],
             "layer_decay": 0.9, "layer_decay_num_layers": 3,
             "lr_scale_rules": [["abstractor", 0.5], ["vit_eos", 2.0]],
             "clip_grad": 1.0}


def test_instruct_optimizer_block_builds_as_in_jax(tmp_path):
    """run_instruct passes its whole optimizer block into OptimizerConfig
    (JAX cli/run_instruct.py:188-196): every field reaches the same
    config; the runners' loader reads ``opt`` as JAX's does."""
    from youku_mplug_tpu.config import load_config as j_load_config
    from youku_mplug_tpu.optim.factory import OptimizerConfig as JOpt
    from youku_mplug_tpu_torch.config import (
        instruct_train_config,
        load_config,
    )

    got = instruct_train_config({"optimizer": dict(OPT_BLOCK),
                                 "epochs": 2}).optimizer
    kw = dict(OPT_BLOCK, opt_betas=tuple(OPT_BLOCK["opt_betas"]))
    want = JOpt(**kw, epochs=2, freeze_text_decoder=True, freeze_vit=True)
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    path = "configs/pretrain/pretrain_tiny_no_dropout.yaml"
    raw = yaml.safe_load(open(path))
    raw["optimizer"]["opt"] = "RAdam"
    tmp = str(tmp_path / "radam.yaml")
    with open(tmp, "w") as f:
        yaml.safe_dump(raw, f)
    assert load_config(tmp).optimizer == OptimizerConfig(**{
        f.name: getattr(j_load_config(tmp).optimizer, f.name)
        for f in dataclasses.fields(OptimizerConfig)})
    assert load_config(tmp).optimizer.opt == "radam"


def test_run_instruct_trains_with_every_knob_on_cpu(tmp_path, capsys):
    """run_instruct --train at the tiny Owl size with Bloom's hidden and
    attention dropout, remat "names" and ce_chunk, vision LoRA and
    drop-path, the lookahead_lamb block above and async checkpoints: two
    finite steps, the adapters of both towers trained, the frozen bases
    unchanged, the checkpoint written in the background and resumed."""
    from youku_mplug_tpu_torch.cli import run_instruct as tcli
    from youku_mplug_tpu_torch.config import load_owl_config

    raw = yaml.safe_load(open("configs/instruct/serve_owl_tiny.yaml"))
    raw.update(
        text_overrides=dict(raw["text_overrides"], lora_rank=2,
                            hidden_dropout=0.1, attention_dropout=0.1,
                            remat=True, remat_policy="names", ce_chunk=4),
        vision_overrides=dict(raw["vision_overrides"], lora_rank=2,
                              drop_path=0.1, attn_drop_rate=0.1),
        batch_size=2, epochs=1, synthetic_length=4, max_length=40,
        optimizer=dict(OPT_BLOCK), async_checkpointing=True)
    path = tmp_path / "train.yaml"
    path.write_text(yaml.safe_dump(raw))
    cfg = load_owl_config(str(path))[0]
    assert (cfg.text.remat_policy, cfg.text.ce_chunk, cfg.vision.lora_rank,
            cfg.vision.drop_path) == ("names", 4, 2, 0.1)
    out = tmp_path / "out"
    argv = ["--config", str(path), "--train", "--synthetic_data",
            "--device", "cpu", "--seed", "3", "--output_dir", str(out)]
    runner = tcli.main(tcli.parser().parse_args(argv))
    assert runner.ckpt.async_save
    assert type(runner.state.optimizer).__name__ == "ZooOptimizer"
    assert len(runner.history) == 2
    for h in runner.history:
        assert np.isfinite(h["loss"]) and h["skipped_nonfinite"] == 0
    lora = [k for k in runner.state.trainable if "lora_" in k]
    assert any(k.startswith("visual_encoder") for k in lora)
    assert any(k.startswith("text_decoder") for k in lora)
    runner.ckpt.close()
    assert sorted(p.name for p in (out / "checkpoints").iterdir()) == ["2"]
    again = tcli.main(tcli.parser().parse_args(argv))
    assert "resumed from step 2 (epoch 1)" in capsys.readouterr().out
    assert again.history == []
    for k, p in runner.state.trainable.items():
        assert torch.equal(p.detach(), again.state.trainable[k].detach()), k
