"""The port's mPLUG-Owl checkpoint import against the JAX package's on
the same seeded state dicts (numpy, fp32 and fp16): the HF Bloom mapper
(with and without the ``transformer.`` prefix, vocab padding), the
abstractor mapper (the published naming, the naming-drift fallback, the
temporal resize, a layer past ``num_layers``), the external vision
tower's mapper (at the tiny and the ViT-L/14 geometry, the position
resize), and ``import_owl`` end to end from two by-key ``.bin`` shards
on the tiny Owl model: every leaf bitwise equal to JAX's import, and the
fail-loud raises both ways (an unconsumed tensor, an uncovered
parameter, a missing ``vit_eos``).  Also the port's safetensors reader
against the ``safetensors`` package for F32, F16 and BF16, and
``load_hf_torch_state`` reading the same tensors from ``.bin`` shards
and from ``.safetensors`` files.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from youku_mplug_tpu.models import importers as jimp
from youku_mplug_tpu.models import owl as jowl
from youku_mplug_tpu.models.bloom import BloomConfig as JBloomConfig
from youku_mplug_tpu.models.vision import VisionConfig as JVisionConfig
from youku_mplug_tpu.runtime.precision import FP32_POLICY as J_FP32
from youku_mplug_tpu_torch import bridge
from youku_mplug_tpu_torch.models import importers as timp
from youku_mplug_tpu_torch.models import owl as towl
from youku_mplug_tpu_torch.models.bloom import BloomConfig
from youku_mplug_tpu_torch.models.vision import VisionConfig
from youku_mplug_tpu_torch.runtime.precision import FP32_POLICY

from tests.test_torch_importers import assert_trees_equal

torch.set_num_threads(1)
DTYPES = {"fp32": np.float32, "fp16": np.float16}
with open("configs/instruct/serve_owl_tiny.yaml") as _f:
    TINY = yaml.safe_load(_f)


def tiny_cfgs():
    """(JAX config, port config) of the tiny Owl model."""
    v, a, t = (TINY["vision_overrides"], TINY["abstractor"],
               TINY["text_overrides"])
    j = jowl.MPLUGOwlVideoConfig(
        vision=JVisionConfig(**v, gelu="quick", attn_impl="xla"),
        abstractor=jowl.OwlAbstractorConfig(**a),
        text=JBloomConfig(**t, attn_impl="xla", decode_attn_impl="gather"))
    p = towl.MPLUGOwlVideoConfig(
        vision=VisionConfig(**v, gelu="quick"),
        abstractor=towl.OwlAbstractorConfig(**a), text=BloomConfig(**t))
    return j, p


def _r(rng, dtype):
    return lambda *s: rng.normal(size=s).astype(dtype)  # noqa: E731


def bloom_sd(rng, cfg, dtype, vocab=None):
    """HF BloomModel naming, numpy."""
    h, r = cfg.hidden_size, _r(rng, dtype)
    sd = {"word_embeddings.weight": r(vocab or cfg.vocab_size, h),
          "word_embeddings_layernorm.weight": r(h),
          "word_embeddings_layernorm.bias": r(h),
          "ln_f.weight": r(h), "ln_f.bias": r(h)}
    for i in range(cfg.num_hidden_layers):
        t = f"h.{i}."
        for name, shape in (
                ("input_layernorm.weight", (h,)),
                ("input_layernorm.bias", (h,)),
                ("post_attention_layernorm.weight", (h,)),
                ("post_attention_layernorm.bias", (h,)),
                ("self_attention.query_key_value.weight", (3 * h, h)),
                ("self_attention.query_key_value.bias", (3 * h,)),
                ("self_attention.dense.weight", (h, h)),
                ("self_attention.dense.bias", (h,)),
                ("mlp.dense_h_to_4h.weight", (4 * h, h)),
                ("mlp.dense_h_to_4h.bias", (4 * h,)),
                ("mlp.dense_4h_to_h.weight", (h, 4 * h)),
                ("mlp.dense_4h_to_h.bias", (h,))):
            sd[t + name] = r(*shape)
    return sd


def abstractor_sd(rng, a, text_hidden, dtype, frames=None):
    """The published MplugOwlVisualAbstractor naming (no ``abstractor.``
    prefix), numpy; ``frames`` rows of temporal embedding (default
    ``max_frames``)."""
    d, f, r = a["hidden_size"], a["intermediate_size"], _r(rng, dtype)
    sd = {"query_tokens": r(1, a["num_queries"], d),
          "visual_fc.weight": r(text_hidden, d),
          "visual_fc.bias": r(text_hidden), "vit_eos": r(1, 1, text_hidden),
          "temporal_position_embeddings": r(frames or a["max_frames"], d)}
    for i in range(a["num_layers"]):
        p = f"encoder.layers.{i}.crossattention."
        for nrm in ("norm1", "normk"):
            sd[p + nrm + ".weight"] = r(d)
            sd[p + nrm + ".bias"] = r(d)
        for proj in ("query", "key", "value"):
            sd[p + "attention." + proj + ".weight"] = r(d, d)
            sd[p + "attention." + proj + ".bias"] = r(d)
        sd[p + "output.out_proj.weight"] = r(d, d)
        sd[p + "output.out_proj.bias"] = r(d)
        sd[p + "output.norm2.weight"] = r(d)
        sd[p + "output.norm2.bias"] = r(d)
        for w, shape in (("w1", (f, d)), ("w2", (d, f)), ("w3", (f, d))):
            sd[p + "output.mlp." + w + ".weight"] = r(*shape)
            sd[p + "output.mlp." + w + ".bias"] = r(shape[0])
        sd[p + "output.mlp.ffn_ln.weight"] = r(f)
        sd[p + "output.mlp.ffn_ln.bias"] = r(f)
    return sd


def vision_sd(rng, dtype, depth=1, dim=32, patch=8, patches=4):
    """MplugOwlVisionModel (Megatron-style) naming, numpy."""
    r = _r(rng, dtype)
    sd = {"embeddings.cls_token": r(1, 1, dim),
          "embeddings.position_embedding": r(1, patches + 1, dim),
          "embeddings.patch_embed.weight": r(dim, 3, patch, patch),
          "embeddings.pre_layernorm.weight": r(dim),
          "embeddings.pre_layernorm.bias": r(dim),
          "post_layernorm.weight": r(dim), "post_layernorm.bias": r(dim)}
    for i in range(depth):
        p = f"encoder.layers.{i}."
        for name, shape in (
                ("input_layernorm.weight", (dim,)),
                ("input_layernorm.bias", (dim,)),
                ("post_attention_layernorm.weight", (dim,)),
                ("post_attention_layernorm.bias", (dim,)),
                ("self_attn.query_key_value.weight", (3 * dim, dim)),
                ("self_attn.query_key_value.bias", (3 * dim,)),
                ("self_attn.dense.weight", (dim, dim)),
                ("self_attn.dense.bias", (dim,)),
                ("mlp.fc1.weight", (4 * dim, dim)),
                ("mlp.fc1.bias", (4 * dim,)),
                ("mlp.fc2.weight", (dim, 4 * dim)),
                ("mlp.fc2.bias", (dim,))):
            sd[p + name] = r(*shape)
    return sd


def _both(sd):
    """(torch tensors in the file's dtype, fp32 numpy as the JAX loader
    gives them)."""
    return ({k: torch.from_numpy(v) for k, v in sd.items()},
            {k: v.astype(np.float32) for k, v in sd.items()})


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("prefix,vocab", [("", None), ("transformer.", 100)])
def test_bloom_mapper_matches_jax(prefix, vocab, dtype):
    jcfg, tcfg = tiny_cfgs()
    sd = bloom_sd(np.random.default_rng(1), tcfg.text, DTYPES[dtype], vocab)
    port, jx = _both({prefix + k: v for k, v in sd.items()})
    got = timp.bloom_params_from_torch(port, tcfg.text)
    assert_trees_equal(got, jimp.bloom_params_from_torch(jx, jcfg.text))
    if vocab:
        assert not got["word_embeddings"]["embedding"][vocab:].any()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("frames", [8, 4])
def test_abstractor_mapper_matches_jax(frames, dtype):
    """The published naming; a 4-frame temporal embedding resized to 8."""
    jcfg, tcfg = tiny_cfgs()
    sd = abstractor_sd(np.random.default_rng(2), TINY["abstractor"],
                       tcfg.text.hidden_size, DTYPES[dtype], frames)
    port, jx = _both(sd)
    got = timp.owl_abstractor_params_from_torch(port, tcfg.abstractor)
    assert_trees_equal(got, jimp.owl_abstractor_params_from_torch(
        jx, jcfg.abstractor))
    assert got["abstractor"]["temporal_embed"].shape == (8, 32)


def test_abstractor_fallback_naming_and_raises_match_jax():
    """Names that drifted (q_proj, fc1, o_proj, norm_k) map as JAX maps
    them; an unknown tensor, an unknown top-level name and a layer past
    ``num_layers`` raise in both."""
    jcfg, tcfg = tiny_cfgs()
    rng = np.random.default_rng(3)
    r = _r(rng, np.float32)
    p = "encoder.layers.1.crossattention."
    sd = {p + "attention.q_proj.weight": r(32, 32),
          p + "output.mlp.fc1.weight": r(64, 32),
          p + "output.mlp.fc2.bias": r(32),
          p + "output.o_proj.weight": r(32, 32),
          p + "norm_k.bias": r(32), "query_embeds": r(4, 32)}
    port, jx = _both(sd)
    got = timp.owl_abstractor_params_from_torch(port, tcfg.abstractor)
    assert_trees_equal(got, jimp.owl_abstractor_params_from_torch(
        jx, jcfg.abstractor))
    assert torch.equal(got["abstractor"]["layers_1"]["q_kernel"],
                       port[p + "attention.q_proj.weight"].t())
    for bad, match in (
            ({p + "mystery_block.weight": r(3, 3)}, "no mapping"),
            ({"totally_unknown.weight": r(3, 3)}, "no mapping"),
            ({"encoder.layers.2.crossattention.norm1.weight": r(32)},
             "num_layers"),
            ({"query_tokens": r(1, 5, 32)}, "query tokens shape")):
        port, jx = _both(bad)
        with pytest.raises(ValueError, match=match):
            jimp.owl_abstractor_params_from_torch(jx, jcfg.abstractor)
        with pytest.raises(ValueError, match=match):
            timp.owl_abstractor_params_from_torch(port, tcfg.abstractor)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_owl_vision_mapper_matches_jax(dtype):
    jcfg, tcfg = tiny_cfgs()
    sd = vision_sd(np.random.default_rng(4), DTYPES[dtype])
    port, jx = _both(sd)
    got = timp.owl_vision_params_from_torch(port, tcfg.vision)
    assert_trees_equal(got, jimp.owl_vision_params_from_torch(
        jx, jcfg.vision))
    for bad, match in (({"encoder.layers.0.mystery.weight": np.zeros(
            2, np.float32)}, "no mapping"), ({
                "encoder.layers.1.input_layernorm.weight": np.zeros(
                    32, np.float32)}, "depth")):
        with pytest.raises(ValueError, match=match):
            timp.owl_vision_params_from_torch(_both(bad)[0], tcfg.vision)


@pytest.mark.parametrize("grid", [16, 14])
def test_owl_vision_mapper_at_vit_l_geometry_matches_jax(grid):
    """ViT-L/14 (1024 wide, 16 heads, 2 of its 24 layers): 3 x 1024
    fused rows de-interleaved at n = 16; a 14 x 14 checkpoint grid
    resized to 16 x 16."""
    kw = dict(img_size=224, patch_size=14, embed_dim=1024, depth=2,
              num_heads=16, clip_model=True)
    jv, tv = JVisionConfig(**kw, attn_impl="xla"), VisionConfig(**kw)
    sd = vision_sd(np.random.default_rng(grid), np.float16, depth=2,
                   dim=1024, patch=14, patches=grid * grid)
    port, jx = _both(sd)
    got = timp.owl_vision_params_from_torch(port, tv)
    assert_trees_equal(got, jimp.owl_vision_params_from_torch(jx, jv))
    assert got["pos_embed"].shape == (1, 257, 1024)
    assert got["blocks_1"]["attn"]["qkv_kernel"].shape == (1024, 3, 16, 64)


def _jax_params(jcfg, seed=0):
    model = jowl.MPLUGOwlVideo(jcfg, policy=J_FP32)
    v = jcfg.vision
    video = jnp.zeros((1, 3, v.num_frames, v.img_size, v.img_size))
    n = jcfg.num_media_tokens
    ids = jnp.ones((1, n + 3), jnp.int32)
    media = jnp.zeros_like(ids).at[:, 1:1 + n].set(1)
    params = model.init(jax.random.key(seed), video, ids, jnp.ones_like(ids),
                        media, jnp.zeros_like(ids))["params"]
    return jax.tree.map(np.asarray, params)


def owl_checkpoint(rng, tcfg, dtype):
    """The full external naming: ``language_model.transformer.*``,
    ``vision_model.*``, ``abstractor.*`` and ``query_tokens``, with a tied
    ``lm_head`` copy outside the known prefixes."""
    sd = {("abstractor." + k if k != "query_tokens" else k): v
          for k, v in abstractor_sd(rng, TINY["abstractor"],
                                    tcfg.text.hidden_size, dtype).items()}
    sd.update({"vision_model." + k: v
               for k, v in vision_sd(rng, dtype).items()})
    sd.update({"language_model.transformer." + k: v
               for k, v in bloom_sd(rng, tcfg.text, dtype).items()})
    sd["lm_head.weight"] = sd[
        "language_model.transformer.word_embeddings.weight"]
    return sd


def save_by_key(sd, directory, shards=2):
    """HF's by-key shards: the names dealt round-robin into
    ``pytorch_model-0000i-of-0000n.bin``."""
    directory.mkdir(exist_ok=True)
    for f in directory.glob("pytorch_model*.bin"):
        f.unlink()
    names = sorted(sd)
    for i in range(shards):
        torch.save({k: torch.from_numpy(np.asarray(sd[k]))
                    for k in names[i::shards]},
                   directory / f"pytorch_model-{i + 1:05d}-of-"
                               f"{shards:05d}.bin")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_import_owl_from_by_key_shards_matches_jax(tmp_path, dtype,
                                                   capsys):
    jcfg, tcfg = tiny_cfgs()
    params = _jax_params(jcfg)
    sd = owl_checkpoint(np.random.default_rng(5), tcfg, DTYPES[dtype])
    save_by_key(sd, tmp_path / "hf")
    want = jimp.import_owl(copy.deepcopy(params), jcfg, str(tmp_path / "hf"))
    model = bridge.load_jax_params(towl.MPLUGOwlVideo(tcfg, FP32_POLICY),
                                   params)
    assert timp.import_owl(model, tcfg, str(tmp_path / "hf")) is model
    got = bridge.flatten(bridge.to_jax_tree(model))
    flat_want = bridge.flatten(want)
    assert set(got) == set(flat_want)
    for k, w in flat_want.items():
        np.testing.assert_array_equal(got[k], np.asarray(w, np.float32),
                                      err_msg=k)
    np.testing.assert_array_equal(
        got["abstractor/query_embeds"], sd["query_tokens"].astype(
            np.float32))
    printed = capsys.readouterr().out
    assert "WARNING: 1 checkpoint tensor(s)" in printed
    assert "['lm_head.weight']" in printed


def test_import_owl_fails_loud_both_ways(tmp_path):
    """An unconsumed abstractor tensor, a missing abstractor or vision
    tensor and a missing ``vit_eos`` raise in the port as in JAX; an
    absent temporal embedding imports."""
    jcfg, tcfg = tiny_cfgs()
    params = _jax_params(jcfg)
    base = owl_checkpoint(np.random.default_rng(6), tcfg, np.float32)
    q0 = "abstractor.encoder.layers.1.crossattention.attention.query.weight"
    cases = (
        (dict(base, **{"abstractor.rogue.weight": np.zeros(
            (2, 2), np.float32)}), "no mapping"),
        ({k: v for k, v in base.items() if k != q0}, "partial import"),
        ({k: v for k, v in base.items() if k != "abstractor.vit_eos"},
         "partial import"),
        ({k: v for k, v in base.items()
          if k != "vision_model.encoder.layers.0.mlp.fc2.weight"},
         "partial import"))
    for sd, match in cases:
        save_by_key(sd, tmp_path / "hf")
        with pytest.raises(ValueError, match=match):
            jimp.import_owl(copy.deepcopy(params), jcfg,
                            str(tmp_path / "hf"))
        with pytest.raises(ValueError, match=match):
            timp.import_owl(towl.MPLUGOwlVideo(tcfg, FP32_POLICY), tcfg,
                            str(tmp_path / "hf"))
    save_by_key({k: v for k, v in base.items()
                 if "temporal" not in k}, tmp_path / "hf")
    model = bridge.load_jax_params(towl.MPLUGOwlVideo(tcfg, FP32_POLICY),
                                   params)
    timp.import_owl(model, tcfg, str(tmp_path / "hf"))
    np.testing.assert_array_equal(
        model.abstractor.temporal_embed.detach().numpy(),
        params["abstractor"]["temporal_embed"])


def _st_tensors(rng):
    return {"a.f32": torch.from_numpy(rng.normal(size=(3, 5)).astype(
                np.float32)),
            "b.f16": torch.from_numpy(rng.normal(size=(7,)).astype(
                np.float16)),
            "c.bf16": torch.from_numpy(rng.normal(size=(2, 3, 4)).astype(
                np.float32)).bfloat16(),
            "d.scalar": torch.tensor(3.5, dtype=torch.bfloat16),
            "e.empty": torch.zeros((0, 4), dtype=torch.float16)}


def test_safetensors_reader_matches_the_package(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    tensors = _st_tensors(np.random.default_rng(7))
    path = str(tmp_path / "model.safetensors")
    st.save_file(tensors, path, metadata={"format": "pt"})
    got = timp.read_safetensors(path)
    want = st.load_file(path)
    assert set(got) == set(want) == set(tensors)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert torch.equal(got[k], w), k
        assert torch.equal(got[k], tensors[k]), k


def test_hf_loader_reads_bin_shards_and_safetensors_alike(tmp_path):
    """The same tensors from by-key ``.bin`` shards and from two
    ``.safetensors`` files load bitwise equal; ``.bin`` files win where
    both are present, as in JAX; an empty directory raises."""
    st = pytest.importorskip("safetensors.torch")
    tensors = _st_tensors(np.random.default_rng(8))
    names = sorted(tensors)
    bins, sts = tmp_path / "bin", tmp_path / "st"
    bins.mkdir()
    sts.mkdir()
    for i in range(2):
        part = {k: tensors[k] for k in names[i::2]}
        torch.save(part, bins / f"pytorch_model-{i + 1:05d}-of-00002.bin")
        st.save_file(part, str(sts / f"model-{i + 1:05d}-of-00002"
                                     ".safetensors"))
    a = timp.load_hf_torch_state(str(bins))
    b = timp.load_hf_torch_state(str(sts))
    assert set(a) == set(b) == set(tensors)
    for k in tensors:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    jx = jimp.load_hf_torch_state(str(sts))  # the package, fp32 numpy
    for k in tensors:
        np.testing.assert_array_equal(b[k].float().numpy(), jx[k])
    torch.save({"x": torch.ones(2)}, sts / "pytorch_model.bin")
    assert set(timp.load_hf_torch_state(str(sts))) == {"x"}
    stripped = timp.load_hf_torch_state(str(bins), prefix_strip="a.")
    assert "f32" in stripped and "b.f16" in stripped
    (tmp_path / "none").mkdir()
    with pytest.raises(FileNotFoundError):
        timp.load_hf_torch_state(str(tmp_path / "none"))
