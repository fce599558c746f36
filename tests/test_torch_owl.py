"""The port's mPLUG-Owl video-instruct serving path against the JAX
package at fp32 on the CPU, weights carried over by the bridge: the
visual abstractor, ``encode_video`` and the media splice, the prompt
batch (ids and masks), greedy tokens of ``serve_instruct``, the synthetic
clips, the config loaders, a CPU run of the port's ``run_instruct`` CLI,
and a bridge round trip of the whole Owl tree.

Geometry of tests/test_owl.py (ViT 32 wide, abstractor 2 layers of 4
heads, 4 queries, Bloom 2 layers); parameters redrawn from numpy (std
0.2, LayerNorm scales near one).  Tolerance 1e-4 (fp32, sums taken in
another order).
"""

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from youku_mplug_tpu.cli import run_instruct as jcli
from youku_mplug_tpu.data import instruct as jinstruct
from youku_mplug_tpu.models import owl as jowl
from youku_mplug_tpu.models.bloom import BloomConfig as JBloomConfig
from youku_mplug_tpu.models.generation import GenerationConfig as JGen
from youku_mplug_tpu.models.vision import VisionConfig as JVisionConfig
from youku_mplug_tpu.runtime.precision import FP32_POLICY as J_FP32
from youku_mplug_tpu_torch import bridge
from youku_mplug_tpu_torch.cli import run_instruct as tcli
from youku_mplug_tpu_torch.config import load_owl_config
from youku_mplug_tpu_torch.data import instruct as tinstruct
from youku_mplug_tpu_torch.models import owl as towl
from youku_mplug_tpu_torch.models.bloom import BloomConfig
from youku_mplug_tpu_torch.models.generation import GenerationConfig
from youku_mplug_tpu_torch.models.vision import VisionConfig
from youku_mplug_tpu_torch.runtime.precision import FP32_POLICY

torch.set_num_threads(1)
TOL = 1e-4
V, NQ = 128, 4
NM = NQ + 1  # media tokens: the queries and vit_eos
FLAGSHIP_YAML = "configs/instruct/serve_bloomz_7b_flagship.yaml"
TINY_YAML = "configs/instruct/serve_owl_tiny.yaml"
with open(TINY_YAML) as _f:
    TINY = yaml.safe_load(_f)
assert TINY["text_overrides"]["vocab_size"] == V
assert TINY["abstractor"]["num_queries"] == NQ


def redraw(tree, rng, std=0.2):
    def leaf(path, x):
        z = rng.normal(size=x.shape).astype(np.float32)
        return 1.0 + 0.1 * z if str(path[-1].key).endswith("scale") \
            else std * z
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def tiny_cfgs():
    """(JAX config, port config) of the same tiny model."""
    v = TINY["vision_overrides"]
    a = TINY["abstractor"]
    t = TINY["text_overrides"]
    j = jowl.MPLUGOwlVideoConfig(
        vision=JVisionConfig(**v, gelu="quick", attn_impl="xla"),
        abstractor=jowl.OwlAbstractorConfig(**a),
        text=JBloomConfig(**t, attn_impl="xla", decode_attn_impl="gather"))
    p = towl.MPLUGOwlVideoConfig(
        vision=VisionConfig(**v, gelu="quick"),
        abstractor=towl.OwlAbstractorConfig(**a), text=BloomConfig(**t))
    return j, p


@pytest.fixture(scope="module")
def owl():
    """(JAX model, redrawn params, port model, a batch, clips)."""
    jcfg, tcfg = tiny_cfgs()
    rng = np.random.default_rng(0)
    jm = jowl.MPLUGOwlVideo(jcfg, policy=J_FP32)
    tk = jinstruct.WhitespaceTokenizer(V)
    # pre-formatted prompts that end in different words beside one in
    # the template: the greedy tokens then differ between requests
    batch = jinstruct.build_instruct_batch(
        [jinstruct.format_prompt("what is this ?"),
         "Human: <|video|> describe the longer video please",
         "<|video|> who"], tk, NM, pad_id=3)
    video = rng.normal(size=(3, 3, 2, 16, 16)).astype(np.float32)
    ids = jnp.asarray(batch["input_ids"])
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.asarray(video), ids, jnp.ones_like(ids),
        jnp.asarray(batch["media_mask"]), jnp.zeros_like(ids)))["params"]
    params = redraw(shapes, rng)
    tm = bridge.load_jax_params(towl.MPLUGOwlVideo(tcfg, FP32_POLICY),
                                params)
    return jm, params, tm, batch, video


@pytest.mark.parametrize("vision_dim", [32, 24])
def test_abstractor_matches_jax(vision_dim):
    """Temporal embedding before the flatten; keys [normed queries ;
    normed frames]; residual on the normed queries; the gated MLP's
    LayerNorm on the intermediate width; ``in_proj`` when the widths
    differ."""
    rng = np.random.default_rng(vision_dim)
    acfg = jowl.OwlAbstractorConfig(**TINY["abstractor"])
    feats = rng.normal(size=(2, 3, 5, vision_dim)).astype(np.float32)
    jmod = jowl.OwlVisualAbstractor(acfg, vision_dim=vision_dim)
    params = redraw(jax.eval_shape(lambda: jmod.init(
        jax.random.key(0), jnp.asarray(feats)))["params"], rng)
    want = jmod.apply({"params": params}, jnp.asarray(feats))
    tmod = bridge.load_jax_params(towl.OwlVisualAbstractor(
        towl.OwlAbstractorConfig(**TINY["abstractor"]), vision_dim,
        torch.float32), params)
    _close(tmod(_t(feats)), want)


def test_encode_video_and_splice_match_jax(owl):
    jm, params, tm, batch, video = owl
    want = jm.apply({"params": params}, jnp.asarray(video),
                    method=jowl.MPLUGOwlVideo.encode_video)
    got = tm.encode_video(_t(video))
    assert tuple(got.shape) == want.shape == (3, NM, 32)
    _close(got, want)
    want_e = jm.apply({"params": params}, jnp.asarray(batch["input_ids"]),
                      jnp.asarray(batch["media_mask"]), want,
                      method=jowl.MPLUGOwlVideo.spliced_embeds)
    got_e = tm.spliced_embeds(_t(batch["input_ids"]).long(),
                              _t(batch["media_mask"]), got)
    _close(got_e, want_e)


def test_splice_media_matches_jax():
    rng = np.random.default_rng(3)
    tok = rng.normal(size=(2, 9, 6)).astype(np.float32)
    qf = rng.normal(size=(2, 3, 6)).astype(np.float32)
    media = np.zeros((2, 9), np.int32)
    media[0, 2:5] = 1
    media[1, 0:3] = 1
    want = jowl.splice_media(jnp.asarray(tok), jnp.asarray(qf),
                             jnp.asarray(media))
    got = towl.splice_media(_t(tok), _t(qf), _t(media))
    _close(got, want, 0)
    np.testing.assert_array_equal(got[0, 2:5].numpy(), qf[0])


def test_instruct_batch_ids_and_masks_match_jax():
    prompts = [tinstruct.format_prompt("what is this ?"),
               "Human: <|video|> one more", "<|video|>"]
    assert prompts[0] == jinstruct.format_prompt("what is this ?")
    assert tinstruct.CONVERSATION_TEMPLATE == jinstruct.CONVERSATION_TEMPLATE
    got = tinstruct.build_instruct_batch(
        prompts, tinstruct.WhitespaceTokenizer(V), NM, pad_id=3,
        max_length=40)
    want = jinstruct.build_instruct_batch(
        prompts, jinstruct.WhitespaceTokenizer(V), NM, pad_id=3,
        max_length=40)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
        assert got[key].dtype == want[key].dtype
    with pytest.raises(ValueError, match="exactly one"):
        tinstruct.build_instruct_batch(["no video"],
                                       tinstruct.WhitespaceTokenizer(V), NM,
                                       pad_id=3)


def test_serve_instruct_tokens_match_jax(owl):
    """Three requests through two slots (the third admitted when one
    finishes): the same greedy tokens as the JAX runner's
    serve_instruct."""
    jm, params, tm, batch, video = owl
    jgen = JGen(max_new_tokens=6, eos_id=2, pad_id=3, beam_size=1)
    want = jcli.serve_instruct(jm, jax.tree.map(jnp.asarray, params),
                               jnp.asarray(video), batch, jgen,
                               num_slots=2)
    got, stats, engine = tcli.serve_instruct(
        tm, _t(video), batch,
        GenerationConfig(max_new_tokens=6, eos_id=2, pad_id=3), num_slots=2)
    np.testing.assert_array_equal(got, want)
    assert len({tuple(r) for r in got}) > 1  # not degenerate
    assert stats["requests"] == 3 and stats["nonfinite_logits"] == 0
    assert engine.num_slots == 2


def test_synthetic_clips_match_jax():
    args = argparse.Namespace(synthetic_data=True, seed=5)
    raw = {"num_frames": 2, "image_res": 16}
    rows = [{"video": ""}] * 3
    np.testing.assert_array_equal(tcli.load_videos(args, raw, rows),
                                  jcli.load_videos(args, raw, rows))


def _same_fields(got, want, part):
    for f in dataclasses.fields(got):
        if hasattr(want, f.name):
            assert getattr(got, f.name) == getattr(want, f.name), \
                (part, f.name)


def test_loaders_agree_on_the_flagship_yaml():
    got, raw = load_owl_config(FLAGSHIP_YAML)
    want, jraw = jcli.load_owl_config(FLAGSHIP_YAML)
    assert raw == jraw
    for part in ("vision", "abstractor", "text"):
        _same_fields(getattr(got, part), getattr(want, part), part)
    assert got.num_media_tokens == want.num_media_tokens == 65
    # full width: ViT-L/14 at 224 px, BloomZ-7B1 with 32 heads of 128
    assert (got.vision.embed_dim, got.vision.depth, got.vision.patch_size,
            got.vision.num_patches) == (1024, 24, 14, 256)
    assert (got.text.hidden_size, got.text.num_hidden_layers,
            got.text.num_attention_heads, got.text.head_dim,
            got.text.vocab_size) == (4096, 30, 32, 128, 250880)
    assert got.text.lora_rank == 0
    assert (raw["do_sample"], raw["beam_size"], raw["max_new_tokens"],
            raw["num_frames"]) == (False, 1, 64, 8)


def test_owl_config_resolves_to_quick_gelu(tmp_path):
    """The Owl tower is CLIP-lineage: quick GELU from the loader and from
    the config's default; a YAML may still override it."""
    assert load_owl_config(FLAGSHIP_YAML)[0].vision.gelu == "quick"
    assert towl.MPLUGOwlVideoConfig().vision.gelu == "quick"
    path = tmp_path / "owl.yaml"
    path.write_text(yaml.safe_dump(
        {"vision_overrides": {"gelu": "erf", "clip_model": True}}))
    assert load_owl_config(str(path))[0].vision.gelu == \
        jcli.load_owl_config(str(path))[0].vision.gelu == "erf"


def test_run_instruct_cli_runs_on_cpu(tmp_path):
    path = tmp_path / "owl.yaml"
    path.write_text(yaml.safe_dump(dict(TINY, max_new_tokens=3)))
    rows = [{"video": "a.mp4", "question": "what happens ?"},
            {"video": "b.mp4", "question": "and then what ?"}]
    jsonl = tmp_path / "qa.jsonl"
    jsonl.write_text("".join(json.dumps(r) + "\n" for r in rows))
    args = tcli.parser().parse_args([
        "--config", str(path), "--output_dir", str(tmp_path / "out"),
        "--synthetic_data", "--input_jsonl", str(jsonl), "--engine",
        "--num_slots", "2"])
    results, stats = tcli.main(args)
    assert [r["video"] for r in results] == ["a.mp4", "b.mp4"]
    assert all(1 <= len(r["tokens"]) <= 3 for r in results)
    saved = json.loads((tmp_path / "out" / "instruct_results.json")
                       .read_text())
    assert saved == results
    assert stats["requests"] == 2 and stats["nonfinite_logits"] == 0
    for flag in (["--train"], ["--serving_ckpt", "x"]):
        with pytest.raises(NotImplementedError, match="not ported"):
            tcli.build(tcli.parser().parse_args(
                ["--config", str(path), "--synthetic_data"] + flag))
    path.write_text(yaml.safe_dump(dict(TINY, do_sample=True)))
    with pytest.raises(NotImplementedError, match="sampling"):
        tcli.build(tcli.parser().parse_args(["--config", str(path)]))


def test_bridge_round_trip_of_the_owl_tree(owl):
    """JAX tree -> port modules -> JAX tree gives back every leaf: the
    ViT's ``blocks_<i>``, the abstractor's ``layers_<i>``, the scanned
    decoder ``layers`` with their leading [L]."""
    _, params, tm, _, _ = owl
    back = bridge.to_jax_tree(tm)
    flat = dict(jax.tree_util.tree_leaves_with_path(params))
    back_flat = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(map(jax.tree_util.keystr, flat)) == \
        set(map(jax.tree_util.keystr, back_flat))
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        got = back_flat[path]
        np.testing.assert_array_equal(got, np.asarray(leaf))
    names = dict(tm.named_parameters())
    assert "abstractor.layers.1.mlp.ffn_ln.scale" in names
    assert "visual_encoder.blocks.0.attn.q_bias" in names
    assert "visual_encoder.patch_embed.bias" not in names  # CLIP conv1
    assert names["text_decoder.decoder.layers.attn.qkv_kernel"].shape == \
        (2, 32, 4, 3, 8)
