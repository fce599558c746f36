"""The port's checkpoint importers against the JAX package's on the same
seeded state dicts (numpy, saved as torch files in fp32 and fp16):
the Megatron loader (one file, two ``mp_rank`` shards, the
``module`` / ``model.language_model`` nesting), the GPT-3 mapper in the
Megatron and twin QKV layouts with both key variants and vocab padding,
the timm / TimeSformer vision mapper (the q / v bias split, the position
and temporal resizes), the partial merge of an image-only ViT, and
``import_all`` end to end on the tiny flagship model.  Every mapped and
merged leaf is held bitwise (the port keeps the file's dtype until the
copy into a parameter; fp16 widens to fp32 exactly); the bridged model's
logits and query features within 1e-4 of the JAX model's (fp32 sums in
another order).
"""

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from __graft_entry__ import _flagship_cfg
from youku_mplug_tpu.models import gpt3 as jgpt3
from youku_mplug_tpu.models import importers as jimp
from youku_mplug_tpu.models import tasks as jtasks
from youku_mplug_tpu.runtime.precision import FP32_POLICY as J_FP32
from youku_mplug_tpu_torch import bridge
from youku_mplug_tpu_torch.config import flagship_config
from youku_mplug_tpu_torch.models import importers as timp
from youku_mplug_tpu_torch.models import tasks as ttasks
from youku_mplug_tpu_torch.runtime.precision import FP32_POLICY

torch.set_num_threads(1)
TOL = 1e-4
DTYPES = {"fp32": np.float32, "fp16": np.float16}


def assert_trees_equal(port_tree, jax_tree):
    """The same paths, and every port leaf (a tensor in the file's dtype,
    or fp64 where a resize computed it) bitwise equal in value to the
    JAX leaf."""
    got, want = bridge.flatten(port_tree), bridge.flatten(jax_tree)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        g = g.double().numpy() if isinstance(g, torch.Tensor) else g
        w = np.asarray(w)
        assert g.shape == w.shape, k
        np.testing.assert_array_equal(g, w.astype(np.float64), err_msg=k)


def megatron_sd(rng, cfg, dtype, vocab=None, variant=0):
    """A GPT-3 state dict in ModelScope's Megatron naming, numpy.
    ``variant`` 1 names the embeddings without ``embedding.``."""
    h, f, L = cfg.hidden_size, cfg.ffn_dim, cfg.num_hidden_layers
    lm = "language_model."

    def r(*s):
        return rng.normal(size=s).astype(dtype)

    emb = "" if variant else "embedding."
    sd = {lm + emb + "word_embeddings.weight": r(vocab or cfg.vocab_size, h),
          lm + emb + "position_embeddings.weight":
          r(cfg.max_position_embeddings, h),
          lm + "transformer.final_layernorm.weight": r(h),
          lm + "transformer.final_layernorm.bias": r(h)}
    for i in range(L):
        p = lm + f"transformer.layers.{i}."
        for name, shape in (
                ("input_layernorm.weight", (h,)),
                ("input_layernorm.bias", (h,)),
                ("post_attention_layernorm.weight", (h,)),
                ("post_attention_layernorm.bias", (h,)),
                ("attention.query_key_value.weight", (3 * h, h)),
                ("attention.query_key_value.bias", (3 * h,)),
                ("attention.dense.weight", (h, h)),
                ("attention.dense.bias", (h,)),
                ("mlp.dense_h_to_4h.weight", (f, h)),
                ("mlp.dense_h_to_4h.bias", (f,)),
                ("mlp.dense_4h_to_h.weight", (h, f)),
                ("mlp.dense_4h_to_h.bias", (h,))):
            sd[p + name] = r(*shape)
    return sd


def save_megatron(sd, root, shards):
    """``pytorch_model.bin`` under ``{"module": ...}`` (one shard), else
    ``model/mp_rank_0X_model_states.pt`` split along each name's
    partition dim, named ``model.language_model.*`` under ``{"model":
    ...}`` beside a non-tensor entry."""
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    if shards == 1:
        torch.save({"module": tensors}, root / "pytorch_model.bin")
        return
    (root / "model").mkdir()
    parts = [{} for _ in range(shards)]
    for name, t in tensors.items():
        dim = jimp._partition_dim(name)
        pieces = [t] * shards if dim is None else torch.chunk(t, shards, dim)
        for part, piece in zip(parts, pieces):
            part["model." + name] = piece.clone()
    for r, part in enumerate(parts):
        part["checkpoint_version"] = 3.0
        torch.save({"model": part, "iteration": 7},
                   root / "model" / f"mp_rank_0{r}_model_states.pt")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shards", [1, 2])
def test_megatron_loader_matches_jax(tmp_path, shards, dtype):
    cfg = flagship_config(tiny=True).text
    sd = megatron_sd(np.random.default_rng(shards), cfg, DTYPES[dtype])
    save_megatron(sd, tmp_path, shards)
    got = timp.load_torch_gpt3_state(str(tmp_path))
    want = jimp.load_torch_gpt3_state(str(tmp_path))
    assert set(got) == set(want) == set(sd)
    for k, w in want.items():
        assert got[k].dtype == torch.from_numpy(sd[k]).dtype, k
        np.testing.assert_array_equal(got[k].float().numpy(), w, err_msg=k)
        np.testing.assert_array_equal(got[k].numpy(), sd[k], err_msg=k)
    with pytest.raises(FileNotFoundError):
        timp.load_torch_gpt3_state(str(tmp_path / "model" / "none"))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("megatron_qkv", [True, False])
@pytest.mark.parametrize("variant", [0, 1])
def test_gpt3_mapper_matches_jax(variant, megatron_qkv, dtype):
    """Both QKV layouts, both embedding key variants; the word embedding
    padded (a 200-row checkpoint for the 256 vocab) in variant 1 and cut
    (300 rows) in variant 0."""
    tcfg = flagship_config(tiny=True).text
    jcfg = _flagship_cfg(tiny=True).text
    vocab = 200 if variant else 300
    sd = megatron_sd(np.random.default_rng(variant), tcfg, DTYPES[dtype],
                     vocab=vocab, variant=variant)
    got = timp.gpt3_params_from_torch(
        {k: torch.from_numpy(v) for k, v in sd.items()}, tcfg,
        megatron_qkv=megatron_qkv)
    want = jimp.gpt3_params_from_torch(
        {k: v.astype(np.float32) for k, v in sd.items()}, jcfg,
        megatron_qkv=megatron_qkv)
    assert_trees_equal(got, want)
    emb = got["word_embeddings"]["embedding"]
    assert emb.shape == (tcfg.vocab_size, tcfg.hidden_size)
    assert emb.dtype == torch.from_numpy(sd[next(iter(sd))]).dtype
    if variant:
        assert not emb[vocab:].any()  # the padding rows are zero
    assert got["decoder"]["layers"]["attn"]["qkv_kernel"].shape == (
        tcfg.num_hidden_layers, tcfg.hidden_size, 3,
        tcfg.num_attention_heads, tcfg.head_dim)


def test_megatron_qkv_is_head_major():
    """Twin rows (3, n, d) reordered to Megatron's (n, 3, d) map to the
    same kernel: the transpose the two layouts differ by."""
    cfg = flagship_config(tiny=True).text
    h, n, d = cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim
    sd = {k: torch.from_numpy(v) for k, v in megatron_sd(
        np.random.default_rng(9), cfg, np.float32).items()}
    mega = dict(sd)
    for i in range(cfg.num_hidden_layers):
        key = f"language_model.transformer.layers.{i}.attention." \
              "query_key_value."
        mega[key + "weight"] = sd[key + "weight"].reshape(
            3, n, d, h).transpose(0, 1).reshape(3 * h, h)
        mega[key + "bias"] = sd[key + "bias"].reshape(3, n, d).transpose(
            0, 1).reshape(-1)
    twin = timp.gpt3_params_from_torch(sd, cfg, megatron_qkv=False)
    got = timp.gpt3_params_from_torch(mega, cfg, megatron_qkv=True)
    for leaf in ("qkv_kernel", "qkv_bias"):
        assert torch.equal(got["decoder"]["layers"]["attn"][leaf],
                           twin["decoder"]["layers"]["attn"][leaf])


def timesformer_sd(rng, dtype, dim=64, depth=2, grid=3, frames=4,
                   temporal=True, bias="fused"):
    """A TimeSformer state dict in timm naming, numpy: a ``grid`` x
    ``grid`` position embedding and ``frames`` temporal rows (the tiny
    model has 2 x 2 and 2); ``bias``: "fused" (``qkv.bias``), "split"
    (``q_bias`` / ``v_bias``) or "none"; a classifier head."""
    def r(*s):
        return rng.normal(size=s).astype(dtype)

    sd = {"patch_embed.proj.weight": r(dim, 3, 16, 16),
          "patch_embed.proj.bias": r(dim), "cls_token": r(1, 1, dim),
          "pos_embed": r(1, 1 + grid * grid, dim),
          "norm.weight": r(dim), "norm.bias": r(dim),
          "head.weight": r(10, dim), "head.bias": r(10)}
    if temporal:
        sd["temporal_embed"] = r(1, frames, dim)
    subs = ("attn", "temporal_attn") if temporal else ("attn",)
    for i in range(depth):
        b = f"blocks.{i}."
        norms = ("norm1", "norm2") + (("temporal_ln",) if temporal else ())
        for nrm in norms:
            sd[b + nrm + ".weight"] = r(dim)
            sd[b + nrm + ".bias"] = r(dim)
        for a in subs:
            sd[b + a + ".qkv.weight"] = r(3 * dim, dim)
            if bias == "fused":
                sd[b + a + ".qkv.bias"] = r(3 * dim)
            elif bias == "split":
                sd[b + a + ".q_bias"] = r(dim)
                sd[b + a + ".v_bias"] = r(dim)
            sd[b + a + ".proj.weight"] = r(dim, dim)
            sd[b + a + ".proj.bias"] = r(dim)
        if temporal:
            sd[b + "temporal_fc.weight"] = r(dim, dim)
            sd[b + "temporal_fc.bias"] = r(dim)
        sd[b + "mlp.fc1.weight"] = r(2 * dim, dim)
        sd[b + "mlp.fc1.bias"] = r(2 * dim)
        sd[b + "mlp.fc2.weight"] = r(dim, 2 * dim)
        sd[b + "mlp.fc2.bias"] = r(dim)
    return sd


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("bias", ["fused", "split", "none"])
@pytest.mark.parametrize("grid,frames", [(2, 2), (3, 4)])
def test_vision_mapper_matches_jax(grid, frames, bias, dtype):
    """The q / v bias split and, at another grid and frame count, the
    position and temporal resizes, bitwise against JAX."""
    tcfg = flagship_config(tiny=True).vision
    jcfg = _flagship_cfg(tiny=True).vision
    sd = timesformer_sd(np.random.default_rng(grid), DTYPES[dtype],
                        grid=grid, frames=frames, bias=bias)
    got = timp.vision_params_from_torch(
        {k: torch.from_numpy(v) for k, v in sd.items()}, tcfg)
    want = jimp.vision_params_from_torch(
        {k: v.astype(np.float32) for k, v in sd.items()}, jcfg)
    assert_trees_equal(got, want)
    assert got["pos_embed"].shape == (1, 1 + tcfg.num_patches,
                                      tcfg.embed_dim)
    assert got["temporal_embed"].shape == (1, tcfg.num_frames,
                                           tcfg.embed_dim)
    if bias != "none":
        q = sd["blocks.0.attn.qkv.bias"][:64] if bias == "fused" \
            else sd["blocks.0.attn.q_bias"]
        np.testing.assert_array_equal(
            got["blocks_0"]["attn"]["q_bias"].numpy(), q.reshape(4, 16))
    else:
        assert not got["blocks_0"]["attn"]["q_bias"].any()


def _jax_params(seed=0):
    """The tiny flagship's JAX params (model.init) and its JAX model."""
    jm = jtasks.MPLUGVideo(_flagship_cfg(tiny=True), policy=J_FP32)
    v = _flagship_cfg(tiny=True).vision
    video = jnp.zeros((2, 3, v.num_frames, v.img_size, v.img_size))
    ids = jnp.zeros((2, 6), jnp.int32)
    params = jm.init(jax.random.key(seed), video, ids, jnp.ones_like(ids),
                     method=jtasks.MPLUGVideo.full_init)["params"]
    return jm, jax.tree.map(np.asarray, params)


def _port_model(params):
    return bridge.load_jax_params(
        ttasks.MPLUGVideo(flagship_config(tiny=True), FP32_POLICY,
                          proj_heads=True), params)


def test_partial_merge_of_an_image_vit_matches_jax():
    """An image ViT (no temporal parts) merges partially: its leaves
    bitwise as JAX's merge places them, the temporal leaves and the rest
    of the model at their values, and the count JAX's."""
    _, params = _jax_params(1)
    tm = _port_model(params)
    sd = timesformer_sd(np.random.default_rng(4), np.float16, grid=3,
                        temporal=False)
    want_tree = copy.deepcopy(params)
    want_n = jimp.merge_into(want_tree["visual_encoder"],
                             jimp.vision_params_from_torch(
                                 {k: v.astype(np.float32)
                                  for k, v in sd.items()},
                                 _flagship_cfg(tiny=True).vision))
    got_n = timp.merge_into(timp.param_tree(tm)["visual_encoder"],
                            timp.vision_params_from_torch(
                                {k: torch.from_numpy(v)
                                 for k, v in sd.items()},
                                flagship_config(tiny=True).vision))
    assert got_n == want_n
    got = bridge.flatten(bridge.to_jax_tree(tm))
    for k, w in bridge.flatten(want_tree).items():
        np.testing.assert_array_equal(got[k], np.asarray(w, np.float32),
                                      err_msg=k)
    old = bridge.flatten(params)
    for k in ("visual_encoder/temporal_embed",
              "visual_encoder/blocks_0/temporal_fc_kernel",
              "visual_encoder/blocks_1/temporal_attn/qkv_kernel",
              "attn_pool/q_kernel"):
        np.testing.assert_array_equal(got[k], old[k], err_msg=k)
    assert not np.array_equal(got["visual_encoder/cls_token"],
                              old["visual_encoder/cls_token"])


def test_merges_shape_check_and_exact_refuses_unknown_names():
    tm = _port_model(_jax_params()[1])
    params = timp.param_tree(tm)
    bad = {"visual_encoder": {"cls_token": torch.zeros(1, 1, 5)}}
    with pytest.raises(ValueError, match="shape mismatch at "
                       "visual_encoder/cls_token"):
        timp.merge_into(params, bad)
    assert timp.merge_into(params, {"nowhere": torch.zeros(3)}) == 0
    with pytest.raises(ValueError, match="no target param at nowhere"):
        timp.merge_exact(params, {"nowhere": torch.zeros(3)})
    with pytest.raises(ValueError, match="Missing: attn_pool/q_bias"):
        timp.check_covered({"attn_pool": params["attn_pool"]},
                           {"attn_pool": {k: v for k, v in
                                          params["attn_pool"].items()
                                          if k != "q_bias"}}, "x")


@pytest.mark.parametrize("shards", [1, 2])
def test_import_all_matches_jax_and_the_bridged_model_runs_as_jax(
        tmp_path, shards):
    """import_torch_weights end to end, ``{"gpt3": dir, "vision":
    file}``: the port's whole tree bitwise equal to JAX's import on the
    same init, then decoder logits and query features within 1e-4."""
    rng = np.random.default_rng(10 + shards)
    jm, params = _jax_params(shards)
    tm = _port_model(params)
    tcfg = flagship_config(tiny=True)
    jcfg = _flagship_cfg(tiny=True)
    gdir = tmp_path / "gpt3"
    gdir.mkdir()
    save_megatron(megatron_sd(rng, tcfg.text, np.float16, vocab=250),
                  gdir, shards)
    vfile = tmp_path / "timesformer.pth"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in
                               timesformer_sd(rng, np.float16).items()},
                "epoch": 3}, vfile)
    spec = {"gpt3": str(gdir), "vision": str(vfile)}
    want = jimp.import_all(copy.deepcopy(params),
                           types.SimpleNamespace(model=jcfg), spec)
    assert timp.import_all(tm, types.SimpleNamespace(model=tcfg),
                           spec) is tm
    got = bridge.flatten(bridge.to_jax_tree(tm))
    flat_want = bridge.flatten(want)
    assert set(got) == set(flat_want)
    for k, w in flat_want.items():
        np.testing.assert_array_equal(got[k], np.asarray(w, np.float32),
                                      err_msg=k)
    # a bare string is the GPT-3 directory
    tm2 = _port_model(params)
    timp.import_all(tm2, types.SimpleNamespace(model=tcfg), str(gdir))
    assert torch.equal(tm2.text_decoder.word_embeddings.embedding,
                       tm.text_decoder.word_embeddings.embedding)

    tokens = rng.integers(0, 256, size=(2, 7))
    jlm = jgpt3.GPT3LM(jcfg.text, policy=J_FP32)
    jl = jlm.apply({"params": want["text_decoder"]}, jnp.asarray(tokens),
                   return_logits=True)["logits"]
    with torch.no_grad():
        hidden = tm.text_decoder(tokens=torch.from_numpy(tokens))[
            "last_hidden_state"]
        tl = tm.text_decoder.logits(hidden)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    v = jcfg.vision
    video = rng.normal(size=(2, 3, v.num_frames, v.img_size,
                             v.img_size)).astype(np.float32)
    jq = jm.apply({"params": want}, jnp.asarray(video),
                  method=jtasks.MPLUGVideo.encode_video)[1]
    with torch.no_grad():
        tq = tm.encode_queries(torch.from_numpy(video))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=TOL,
                               atol=TOL)


def test_load_config_keeps_import_torch_weights(tmp_path):
    """The config key reaches the runners as the JAX loader leaves it."""
    from youku_mplug_tpu_torch.config import load_config

    with open("configs/pretrain_tiny.yaml") as f:
        raw = yaml.safe_load(f)
    spec = {"gpt3": "ckpt/gpt3", "vision": "ckpt/vit.pth"}
    path = tmp_path / "x.yaml"
    path.write_text(yaml.safe_dump(dict(raw, import_torch_weights=spec)))
    assert load_config(str(path)).get("import_torch_weights") == spec
