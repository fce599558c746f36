"""The GPT-3 13B decoder in the port: its config, its train state built
without an fp32 copy of the frozen decoder, and its geometry (heads of
128 without ALiBi) against the JAX package at a small size.

- ``configs/models/config_gpt3_13B.json`` loads to hidden 5120, 40
  layers, 40 heads (of 128) and a 51200-token vocab, as JAX reads it, in
  a pretrain YAML too;
- on ``meta``: ``common.build_train_model`` and ``create_train_state`` of
  JAX's compile configuration (``tools/compile_13b.py``: the frozen 13B
  decoder, ViT-B/16) hold the frozen decoder in bf16 (~25.7 GB by shapes)
  and no fp32 leaf of it, the trainable side in fp32;
- ``build_train_model`` gives the values of the fp32 build cast to bf16,
  bitwise, on a small model, and without a frozen dtype the fp32
  build's;
- a decoder of 2 heads of 128, 2 layers, at fp32 on the same weights as
  JAX's: ``pretrain_loss`` and every trainable gradient (1e-4), its
  attention through the packed route (K1, the kernels' d128 build on the
  card), and the serving engine's greedy tokens, which are JAX's engine's.
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
from youku_mplug_tpu.models.generation import GenerationConfig as JGen
from youku_mplug_tpu.ops import flash_attention as jfa
from youku_mplug_tpu.runtime.precision import FP32_POLICY as J_FP32
from youku_mplug_tpu.serving.engine import ServingEngine as JEngine
from youku_mplug_tpu_torch import bridge
from youku_mplug_tpu_torch.cli import common
from youku_mplug_tpu_torch.config import flagship_config, load_config
from youku_mplug_tpu_torch.models import gpt3 as tgpt3
from youku_mplug_tpu_torch.models import tasks as ttasks
from youku_mplug_tpu_torch.models.generation import GenerationConfig
from youku_mplug_tpu_torch.ops import flash_attention as tfa
from youku_mplug_tpu_torch.optim.factory import OptimizerConfig
from youku_mplug_tpu_torch.runtime.precision import (
    DEFAULT_POLICY,
    FP32_POLICY,
)
from youku_mplug_tpu_torch.serving.engine import ServingEngine
from youku_mplug_tpu_torch.train.state import create_train_state

torch.set_num_threads(1)
TOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_13B = os.path.join(REPO, "configs", "models", "config_gpt3_13B.json")
FLAGSHIP_PRETRAIN = os.path.join(REPO, "configs", "pretrain",
                                 "pretrain_gpt3_1.3B_flagship.yaml")
# the 13B's head width at a small size: 2 heads of 128, 2 layers
D128 = dict(vocab_size=256, hidden_size=256, num_hidden_layers=2,
            num_attention_heads=2, max_position_embeddings=256,
            hidden_dropout=0.0, attention_dropout=0.0)


def test_13b_config_loads_as_jax_reads_it():
    cfg = tgpt3.GPT3Config.from_json_file(CONFIG_13B)
    got = (cfg.hidden_size, cfg.num_hidden_layers, cfg.num_attention_heads,
           cfg.vocab_size)
    assert got == (5120, 40, 40, 51200) and cfg.head_dim == 128
    jcfg = jgpt3.GPT3Config.from_json_file(CONFIG_13B)
    assert got == (jcfg.hidden_size, jcfg.num_hidden_layers,
                   jcfg.num_attention_heads, jcfg.vocab_size)
    assert cfg.layernorm_epsilon == jcfg.layernorm_epsilon == 1e-5
    assert tfa.packed_supported(40, 128) and jfa.packed_supported(40, 128)


def _13b_yaml(tmp_path):
    """The flagship pretrain YAML with the 13B decoder, batch 4: JAX's
    compile configuration (tools/compile_13b.py:54-140)."""
    with open(FLAGSHIP_PRETRAIN) as f:
        raw = yaml.safe_load(f)
    raw.update(text_cfg=CONFIG_13B, batch_size=4)
    path = tmp_path / "pretrain_13b.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return str(path)


def test_13b_yaml_reads_the_13b_decoder_at_compile_settings(tmp_path):
    text = load_config(_13b_yaml(tmp_path)).model.text
    assert (text.hidden_size, text.num_hidden_layers,
            text.num_attention_heads, text.vocab_size) == (5120, 40, 40,
                                                           51200)
    assert (text.hidden_dropout, text.attention_dropout, text.remat,
            text.ce_chunk) == (0.0, 0.0, True, 32)


def test_13b_train_state_on_meta_holds_the_frozen_decoder_in_bf16(tmp_path):
    cfg = load_config(_13b_yaml(tmp_path))
    model = common.build_train_model(cfg, DEFAULT_POLICY,
                                     torch.device("meta"),
                                     frozen_dtype=torch.bfloat16)
    # materialized in its final dtype: no fp32 leaf of the decoder
    dec = dict(model.text_decoder.named_parameters())
    assert {p.dtype for p in dec.values()} == {torch.bfloat16}
    state, _, _ = create_train_state(model, cfg.optimizer,
                                     frozen_dtype=torch.bfloat16)
    frozen_gb = sum(p.numel() * p.element_size()
                    for p in state.frozen.values()) / 1e9
    assert set(state.frozen) == {k for k in state.frozen
                                 if k.startswith("text_decoder")}
    assert {p.dtype for p in state.frozen.values()} == {torch.bfloat16}
    assert 25.5 < frozen_gb < 26.0, frozen_gb
    assert all(p.dtype == torch.float32 for p in state.trainable.values())
    # every parameter of the model is a leaf of the state: no fp32 twin
    assert len(list(model.parameters())) == len(state.frozen) + len(
        state.trainable)


def _cast_build(run, frozen_dtype):
    """The reference ``build_train_model`` stands for: ``MPLUGVideo``
    built on the CPU in the policy's fp32, drawn by ``jax_init`` and its
    frozen leaves cast by ``create_train_state``."""
    with torch.device("cpu"):
        model = ttasks.MPLUGVideo(run.model, DEFAULT_POLICY)
    bridge.jax_init(model, 7)
    create_train_state(model, run.optimizer, frozen_dtype=frozen_dtype)
    return model


def _assert_same_leaves(got, want):
    want = dict(want.named_parameters())
    assert set(want) == {name for name, _ in got.named_parameters()}
    for name, p in got.named_parameters():
        assert p.dtype == want[name].dtype and torch.equal(p, want[name]), \
            name


def test_build_train_model_gives_the_cast_fp32_build_bitwise():
    cfg = flagship_config(tiny=True)
    run = type("Run", (), {"model": cfg, "optimizer": OptimizerConfig()})()
    direct = common.build_train_model(run, DEFAULT_POLICY,
                                      torch.device("cpu"),
                                      frozen_dtype=torch.bfloat16)
    assert {p.dtype for p in direct.text_decoder.parameters()} == {
        torch.bfloat16}
    bridge.jax_init(direct, 7)
    _assert_same_leaves(direct, _cast_build(run, torch.bfloat16))


def test_build_train_model_without_frozen_dtype_is_the_fp32_build():
    """``--fp32``: no frozen dtype, every leaf in the policy's fp32, the
    same values as the model built on the device directly."""
    cfg = flagship_config(tiny=True)
    run = type("Run", (), {"model": cfg, "optimizer": OptimizerConfig()})()
    model = common.build_train_model(run, DEFAULT_POLICY, torch.device("cpu"))
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    bridge.jax_init(model, 7)
    _assert_same_leaves(model, _cast_build(run, None))


def _redraw(tree, rng, std=0.2):
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


def test_d128_pretrain_loss_and_grads_match_jax():
    """The pretrain step's loss and gradients with the decoder at the
    13B's head width (remat and ce_chunk as compiled), against JAX; the
    port's decoder attention takes the packed route at d 128."""
    rng = np.random.default_rng(0)
    jtiny = _flagship_cfg(tiny=True)
    jcfg = dataclasses.replace(jtiny, text=dataclasses.replace(
        jtiny.text, **D128, remat=True, ce_chunk=4))
    ttiny = flagship_config(tiny=True)
    tcfg = dataclasses.replace(ttiny, text=dataclasses.replace(
        ttiny.text, **D128, remat=True, ce_chunk=4))
    v = jcfg.vision
    b, s = 3, 12
    video = rng.normal(size=(b, 3, v.num_frames, v.img_size,
                             v.img_size)).astype(np.float32)
    ids = rng.integers(3, 256, size=(b, s)).astype(np.int32)
    mask = (np.arange(s)[None] < np.array([[s], [7], [4]])).astype(np.int32)
    ids = np.where(mask == 1, ids, 2).astype(np.int32)
    jm = jtasks.MPLUGVideo(jcfg, policy=J_FP32)
    params = _redraw(jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.asarray(video), jnp.asarray(ids),
        jnp.asarray(mask)))["params"], rng)
    tm = bridge.load_jax_params(ttasks.MPLUGVideo(tcfg, FP32_POLICY), params)

    def jfn(p):
        out = jm.apply({"params": p}, jnp.asarray(video), jnp.asarray(ids),
                       jnp.asarray(mask),
                       method=jtasks.MPLUGVideo.pretrain_loss)
        return out["loss"], out
    (_, jout), jgrads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        params)
    state, _, _ = create_train_state(tm, OptimizerConfig())
    calls = []
    packed = tgpt3.flash_attention_packed

    def spy(q, k, v_, n, **kw):
        calls.append((n, q.shape[-1] // n, kw.get("causal")))
        return packed(q, k, v_, n, **kw)
    with mock.patch.object(tgpt3, "flash_attention_packed", spy):
        out = tm.pretrain_loss(torch.from_numpy(video),
                               torch.from_numpy(ids).long(),
                               torch.from_numpy(mask))
        out["loss"].backward()
    # each decoder layer forward, then again under remat in the backward
    assert calls == [(2, 128, True)] * 4
    np.testing.assert_allclose(out["loss"].detach().numpy(),
                               np.asarray(jout["loss"]), rtol=TOL, atol=TOL)
    jflat = _flat(jgrads)
    assert set(state.frozen) == {k for k in jflat
                                 if k.startswith("text_decoder")}
    for path, p in state.trainable.items():
        assert p.grad is not None or path == "temp", path
        got = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(got.numpy(), np.asarray(jflat[path]),
                                   rtol=TOL, atol=TOL, err_msg=path)


def test_d128_engine_tokens_match_jax():
    """The serving engine's greedy tokens on a decoder of 2 heads of 128
    (its decode steps through the decode kernel's d128 route, the plain
    version here) equal JAX's engine's on the same weights."""
    jlm = jgpt3.GPT3LM(jgpt3.GPT3Config(**D128), policy=J_FP32)
    params = jax.tree.map(np.asarray, _redraw(jax.eval_shape(
        lambda: jlm.init(jax.random.key(0), jnp.zeros((1, 4), jnp.int32)))[
        "params"], np.random.default_rng(1)))
    tlm = bridge.load_jax_params(
        tgpt3.GPT3LM(tgpt3.GPT3Config(**D128), FP32_POLICY), params).eval()
    prompts = [[5, 9, 17], [3, 3, 40, 7, 1], [200], [11, 12, 13, 14]]
    kw = dict(num_slots=2, max_len=32, prefill_buckets=(8,))
    jeng = JEngine(jlm, jax.tree.map(jnp.asarray, params), **kw,
                   config=JGen(max_new_tokens=8, eos_id=2, pad_id=0))
    teng = ServingEngine(tlm, **kw, config=GenerationConfig(
        max_new_tokens=8, eos_id=2, pad_id=0))
    for p in prompts:
        jeng.submit(p)
        teng.submit(p)
    routes = []
    dec = tgpt3.write_decode_attention

    def spy(q, *a, **k):
        routes.append(q.shape[-1] // a[3])
        return dec(q, *a, **k)
    with mock.patch.object(tgpt3, "write_decode_attention", spy):
        got = sorted((f.rid, f.tokens) for f in teng.run_to_completion())
    want = sorted((f.rid, f.tokens) for f in jeng.run_to_completion())
    assert got == want
    assert len({tuple(t) for _, t in want}) > 1
    assert routes and set(routes) == {128}
