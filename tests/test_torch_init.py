"""The port's fresh training weights and its config loader against the
JAX package.

``bridge.jax_init`` (what ``run_pretrain`` and ``run_instruct --train``
start from) against JAX ``model.init`` of the same tiny configs (the
tiny flagship with the contrastive heads, the tiny Owl with rank-2 LoRA):
the same leaves, and each leaf of both draws held to the rule
``bridge._jax_rule`` gives it.  Constant leaves (LayerNorm scales, every
bias, ``cls_token``, ``temporal_embed``, ``temporal_fc`` past block 1,
``bias_k`` / ``bias_v``, ``lora_*_b``, ``temp``) are exact on both
sides.  A random leaf of n values: its sample std within 6 / sqrt(2n) of
the rule's (six standard errors of a sample std), its mean within
6 std / sqrt(n), and a truncated or uniform leaf inside its bound
(2 stddev for flax's truncated normal, sqrt(6 / (fan_in + fan_out)) for
xavier_uniform).  The draws are not JAX's bits, only their law.

``load_config`` raises on the YAML keys that make the JAX loader build or
load another model (a top-level ``lora_rank``, ``import_torch_weights``)
and still loads every port YAML of the repo.  The downstream case is the
cls / retrieval / ITM tree (clip_model tower, ``use_cls`` heads and the
projections, from ``full_init``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from __graft_entry__ import _flagship_cfg
from youku_mplug_tpu.models import owl as jowl
from youku_mplug_tpu.models import tasks as jtasks
from youku_mplug_tpu.runtime.precision import FP32_POLICY as J_FP32
from youku_mplug_tpu_torch import bridge
from youku_mplug_tpu_torch.config import flagship_config, load_config
from youku_mplug_tpu_torch.models import owl as towl
from youku_mplug_tpu_torch.models import tasks as ttasks
from youku_mplug_tpu_torch.runtime.precision import FP32_POLICY

torch.set_num_threads(1)
SIGMAS = 6.0
TRUNC_STD = 0.87962566103423978  # std of a standard normal cut at +-2


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _pretrain_models():
    jcfg = dataclasses.replace(_flagship_cfg(tiny=True), use_contrastive=True)
    jm = jtasks.MPLUGVideo(jcfg, policy=J_FP32)
    v = jcfg.vision
    video = jnp.zeros((2, 3, v.num_frames, v.img_size, v.img_size))
    ids = jnp.zeros((2, 8), jnp.int32)
    want = jm.init(jax.random.key(0), video, ids, jnp.ones_like(ids),
                   method=jtasks.MPLUGVideo.full_init)["params"]
    tm = ttasks.MPLUGVideo(dataclasses.replace(flagship_config(tiny=True),
                                               use_contrastive=True),
                           FP32_POLICY)
    return want, tm


def _downstream_models():
    """The cls / retrieval / ITM tree: the tiny flagship with clip-b16's
    tower form (clip_model, heads of 96) and the use_cls heads, from
    full_init (with vision_proj and text_proj)."""
    j0, t0 = _flagship_cfg(tiny=True), flagship_config(tiny=True)
    vis = dict(embed_dim=192, num_heads=2, clip_model=True)
    jcfg = dataclasses.replace(j0, vision=dataclasses.replace(
        j0.vision, **vis), use_cls=True, num_classes=3)
    tcfg = dataclasses.replace(t0, vision=dataclasses.replace(
        t0.vision, **vis), use_cls=True, num_classes=3)
    jm = jtasks.MPLUGVideo(jcfg, policy=J_FP32)
    v = jcfg.vision
    ids = jnp.zeros((2, 8), jnp.int32)
    want = jm.init(jax.random.key(0), jnp.zeros(
        (2, 3, v.num_frames, v.img_size, v.img_size)), ids,
        jnp.ones_like(ids), method=jtasks.MPLUGVideo.full_init)["params"]
    return want, ttasks.MPLUGVideo(tcfg, FP32_POLICY, proj_heads=True)


def _owl_models():
    from test_torch_owl import tiny_cfgs

    jcfg, tcfg = tiny_cfgs(lora_rank=2)
    jm = jowl.MPLUGOwlVideo(jcfg, policy=J_FP32)
    ids = jnp.zeros((2, 12), jnp.int32)
    media = jnp.zeros((2, 12), jnp.int32).at[:, 1:6].set(1)
    want = jm.init(jax.random.key(0), jnp.zeros((2, 3, 2, 16, 16)), ids,
                   jnp.ones_like(ids), media, jnp.zeros_like(ids))["params"]
    return want, towl.MPLUGOwlVideo(tcfg, FP32_POLICY)


def _law(kind, arg, shape):
    """(std, bound or None) of a rule's draws."""
    if kind == "lecun":
        kind, arg = "trunc", shape[-2] ** -0.5 / TRUNC_STD
    if kind == "normal":
        return arg, None
    if kind == "trunc":
        return TRUNC_STD * arg, 2.0 * arg
    bound = (6.0 / (shape[-2] + shape[-1])) ** 0.5  # xavier
    return bound / 3 ** 0.5, bound


def _check_leaf(name, x, kind, arg):
    if kind == "const":  # in the leaf's own fp32
        assert (np.asarray(x) == np.float32(arg)).all(), (name, arg)
        return
    x = np.asarray(x, np.float64)
    std, bound = _law(kind, arg, x.shape)
    n = x.size
    assert abs(x.std() / std - 1) <= SIGMAS / (2 * n) ** 0.5, \
        (name, kind, x.std(), std)
    assert abs(x.mean()) <= SIGMAS * std / n ** 0.5, (name, x.mean())
    if bound is not None:
        assert np.abs(x).max() <= bound * (1 + 1e-6), (name, bound)


@pytest.mark.parametrize("which", ["pretrain", "owl", "downstream"])
def test_jax_init_follows_jax_model_init(which):
    want, tm = {"pretrain": _pretrain_models, "owl": _owl_models,
                "downstream": _downstream_models}[which]()
    bridge.jax_init(tm, 0)
    want = {k: np.asarray(v) for k, v in _flat(jax.device_get(want)).items()}
    got = {bridge.jax_path(k): p.detach().numpy()
           for k, p in tm.named_parameters()}
    assert set(got) == set(want)
    lora_stds = bridge._lora_stds(tm)
    kinds = set()
    for name, p in tm.named_parameters():
        kind, arg = bridge._jax_rule(tm, name, lora_stds)
        kinds.add(kind)
        for side, x in (("jax", want[bridge.jax_path(name)]),
                        ("port", got[bridge.jax_path(name)])):
            _check_leaf(f"{side} {name}", x, kind, arg)
    # every kind of draw the two models use is exercised
    assert kinds == ({"const", "trunc", "normal"} if which == "owl" else
                     {"const", "trunc", "normal", "xavier", "lecun"})
    if which == "downstream":
        assert "visual_encoder/norm_pre/scale" in got
        assert bridge._jax_rule(tm, "cls_fc2.kernel", {}) == ("lecun", None)


def test_jax_init_zero_leaves_and_scaled_projections():
    """The leaves JAX zeroes are exactly zero and the rest are not; the
    rescaled vision projections and GPT-3 out / fc2 draw at their own
    std."""
    _, tm = _pretrain_models()
    bridge.jax_init(tm, 1)
    params = dict(tm.named_parameters())
    zero = {k for k, p in params.items() if not p.detach().any()}
    assert "visual_encoder.blocks.1.temporal_fc_kernel" in zero
    assert "visual_encoder.blocks.0.temporal_fc_kernel" not in zero
    for k in ("visual_encoder.cls_token", "visual_encoder.temporal_embed",
              "attn_pool.bias_k", "attn_pool.bias_v", "visual_fc.bias",
              "text_decoder.decoder.layers.attn.qkv_bias"):
        assert k in zero, k
    assert all(k.endswith(("bias", "bias_k", "bias_v", "cls_token",
                           "temporal_embed", "temporal_fc_kernel"))
               for k in zero), sorted(zero)
    rule = bridge._jax_rule
    assert rule(tm, "visual_encoder.blocks.1.attn.proj_kernel", {}) == \
        ("trunc", 0.015 / 2.0)
    assert rule(tm, "visual_encoder.blocks.1.temporal_attn.proj_kernel",
                {}) == ("trunc", 0.015)
    assert rule(tm, "text_decoder.decoder.layers.mlp.fc2_kernel", {}) == \
        ("normal", 0.02 / 2.0)


def test_jax_init_is_seeded_and_refuses_int8():
    _, a = _owl_models()
    _, b = _owl_models()
    bridge.jax_init(a, 5)
    bridge.jax_init(b, 5)
    for (k, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), k
    from youku_mplug_tpu_torch.ops import quant

    quant.quantize_decoder_(a.text_decoder)
    with pytest.raises(TypeError, match="quantize after"):
        bridge.jax_init(a, 5)


@pytest.mark.parametrize("key,value", [
    ("lora_rank", 8), ("import_torch_weights", "ckpt/gpt3.pt")])
def test_load_config_raises_on_keys_that_change_the_model(tmp_path, key,
                                                         value):
    """A top-level lora_rank (GPT-3 adapters) raises; import_torch_weights
    is ported and reaches the runners as given (models/importers.py)."""
    with open("configs/pretrain_tiny.yaml") as f:
        raw = yaml.safe_load(f)
    path = tmp_path / "x.yaml"
    path.write_text(yaml.safe_dump(dict(raw, **{key: value},
                                        lora_alpha=32)))
    if key == "import_torch_weights":
        assert load_config(str(path)).get(key) == value
    else:
        with pytest.raises(NotImplementedError, match=key):
            load_config(str(path))
    # a rank of 0 (or lora_alpha alone) builds no adapter in JAX either
    path.write_text(yaml.safe_dump(dict(raw, lora_rank=0, lora_alpha=32)))
    assert load_config(str(path)).model == load_config(
        "configs/pretrain_tiny.yaml").model


@pytest.mark.parametrize("path", [
    "configs/pretrain_tiny.yaml",
    "configs/pretrain/pretrain_tiny_no_dropout.yaml",
    "configs/pretrain/pretrain_gpt3_1.3B_flagship.yaml",
    "configs/caption/serve_gpt3_1.3B_flagship.yaml",
    "configs/caption/serve_gpt3_1.3B_int8kv.yaml"])
def test_port_yamls_still_load(path):
    assert load_config(path).model.text.num_hidden_layers > 0
