"""The port's mPLUG-Owl video-instruct paths against the JAX package at
fp32 on the CPU, weights carried over by the bridge.  Serving: the
visual abstractor, ``encode_video`` and the media splice, the prompt
batch (ids and masks), greedy tokens of ``serve_instruct``, the synthetic
clips, the config loaders, a CPU run of the port's ``run_instruct`` CLI,
and a bridge round trip of the whole Owl tree.  Training: the targets,
the (question, answer) batch with truncation, ``instruct_loss`` and the
gradient of every trainable leaf with rank-2 LoRA (``lora_*_b``
non-zero, so ``lora_*_a`` gets a gradient), a three-step AdamW
trajectory, the training YAML, and ``run_instruct --train`` on the CPU.

Geometry of tests/test_owl.py (ViT 32 wide, abstractor 2 layers of 4
heads, 4 queries, Bloom 2 layers); parameters redrawn from numpy (std
0.2, LayerNorm scales near one).  Tolerance 1e-4 (fp32, sums taken in
another order); 2e-5 on parameters after Adam steps of lr 1e-3.
"""

import argparse
import dataclasses
import json
import zlib

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
from youku_mplug_tpu.models.bloom import BloomLM as JBloomLM
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
from tests.hf_tokenizer_files import write_tokenizer_dir

torch.set_num_threads(1)
TOL = 1e-4
# a served greedy token is held to JAX's only where JAX's top-2 logit gap
# at that step exceeds this (ten times TOL): below it the two frameworks'
# fp32 sums, taken in other orders, may pick either token, and the logits
# are held within TOL instead
MARGIN = 1e-3
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


def tiny_cfgs(lora_rank=0, kv_cache_dtype="auto"):
    """(JAX config, port config) of the same tiny model."""
    v = TINY["vision_overrides"]
    a = TINY["abstractor"]
    t = dict(TINY["text_overrides"], lora_rank=lora_rank,
             kv_cache_dtype=kv_cache_dtype)
    j = jowl.MPLUGOwlVideoConfig(
        vision=JVisionConfig(**v, gelu="quick", attn_impl="xla"),
        abstractor=jowl.OwlAbstractorConfig(**a),
        text=JBloomConfig(**t, attn_impl="xla", decode_attn_impl="gather"))
    p = towl.MPLUGOwlVideoConfig(
        vision=VisionConfig(**v, gelu="quick"),
        abstractor=towl.OwlAbstractorConfig(**a), text=BloomConfig(**t))
    return j, p


class StableTokenizer(jinstruct.WhitespaceTokenizer):
    """The whitespace tokenizer with a word -> id map that is the same in
    every process (crc32, not Python's per-process string hash), so the
    prompts of the token tests do not change with PYTHONHASHSEED."""

    def encode(self, text, add_special_tokens=False):
        span = self.vocab_size - self._reserved
        return [self._reserved + zlib.crc32(w.encode()) % span
                for w in text.split()]


@pytest.fixture(scope="module")
def owl():
    """(JAX model, redrawn params, port model, a batch, clips)."""
    jcfg, tcfg = tiny_cfgs()
    rng = np.random.default_rng(0)
    jm = jowl.MPLUGOwlVideo(jcfg, policy=J_FP32)
    tk = StableTokenizer(V)
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


def _forced_logits(jm, params, tm, video, batch, want, qscales=None):
    """Each request's decoder logits at the steps JAX generated, teacher
    forced on JAX's tokens through both models' full causal forward (the
    spliced prompt, then the generated tokens): (JAX's, the port's), a
    list of [steps, V] per request."""
    task_vars = {"params": params}
    dec_vars = {"params": params["text_decoder"]}
    if qscales is not None:
        task_vars["qscales"] = {"text_decoder": qscales}
        dec_vars["qscales"] = qscales
    ids, media = (jnp.asarray(batch[k]) for k in ("input_ids", "media_mask"))
    jemb = jm.apply(task_vars, ids, media,
                    jm.apply(task_vars, jnp.asarray(video),
                             method=jowl.MPLUGOwlVideo.encode_video),
                    method=jowl.MPLUGOwlVideo.spliced_embeds)
    temb = tm.spliced_embeds(_t(batch["input_ids"]).long(),
                             _t(batch["media_mask"]),
                             tm.encode_video(_t(video)))
    jdec = JBloomLM(jm.cfg.text, policy=jm.policy)
    out = []
    for i, row in enumerate(np.asarray(want)):
        n = int(batch["prompt_len"][i])
        steps = int(np.argmax(row == 2)) + 1 if (row == 2).any() else len(row)
        fed = row[:steps - 1]
        je = jnp.concatenate([jemb[i, :n], jdec.apply(
            dec_vars, jnp.asarray(fed, jnp.int32),
            method=JBloomLM.embed)])[None]
        jl = jdec.apply(dec_vars, input_embeds=je,
                        return_logits=True)["logits"][0, n - 1:]
        te = torch.cat([temb[i, :n], tm.text_decoder.embed(
            torch.as_tensor(fed).long())])[None]
        tl = tm.text_decoder.logits(
            tm.text_decoder(input_embeds=te)["last_hidden_state"])[0, n - 1:]
        out.append((np.asarray(jl), tl.detach().numpy()))
    return out


def _check_served(got, want, forced):
    """The port's logits within TOL of JAX's at every step JAX generated;
    the port's greedy tokens equal to JAX's up to the first step whose JAX
    top-2 logit gap is MARGIN or less (JAX's own token its argmax there),
    the whole row where there is none."""
    ties = 0
    for g, w, (jl, tl) in zip(np.asarray(got), np.asarray(want), forced):
        _close(tl, jl)
        for j, row in enumerate(jl):
            top2 = np.sort(row)[-2:]
            if top2[1] - top2[0] <= MARGIN:
                ties += 1
                break
            assert w[j] == np.argmax(row) and g[j] == w[j], (j, g, w)
        else:
            np.testing.assert_array_equal(g, w)
    return ties


def test_serve_instruct_tokens_match_jax(owl):
    """Three requests through two slots (the third admitted when one
    finishes): the same greedy tokens as the JAX runner's serve_instruct
    wherever JAX's choice is clear of a near-tie (MARGIN), and the same
    teacher-forced logits within TOL."""
    jm, params, tm, batch, video = owl
    jgen = JGen(max_new_tokens=6, eos_id=2, pad_id=3, beam_size=1)
    want = jcli.serve_instruct(jm, jax.tree.map(jnp.asarray, params),
                               jnp.asarray(video), batch, jgen,
                               num_slots=2)
    got, stats, engine = tcli.serve_instruct(
        tm, _t(video), batch,
        GenerationConfig(max_new_tokens=6, eos_id=2, pad_id=3,
                         beam_size=1), num_slots=2)
    forced = _forced_logits(jm, jax.tree.map(jnp.asarray, params), tm,
                            video, batch, want)
    assert _check_served(got, want, forced) == 0  # no near-tie at this seed
    assert len({tuple(r) for r in got}) > 1  # not degenerate
    assert stats["requests"] == 3 and stats["nonfinite_logits"] == 0
    assert engine.num_slots == 2


def test_int8_serve_instruct_tokens_match_jax(owl):
    """int8 Bloom kernels, an int8 tied embedding (the splice looks its
    rows up dequantized) and an int8 cache: the same greedy tokens as the
    JAX runner's serve_instruct(..., qscales=) (clear of near-ties, as
    above) and the same teacher-forced logits, with the port model
    loaded from the JAX int8 tree and again quantized in place from the
    float one (the --int8 path)."""
    from youku_mplug_tpu.ops.quant import quantize_gpt3_decoder
    from youku_mplug_tpu_torch.ops import quant

    _, params, _, batch, video = owl
    jcfg, tcfg = tiny_cfgs(kv_cache_dtype="int8")
    jm = jowl.MPLUGOwlVideo(jcfg, policy=J_FP32)
    qdec, scales = jax.device_get(quantize_gpt3_decoder(
        params["text_decoder"], include_embedding=True))
    qparams = dict(params, text_decoder=qdec)
    want = jcli.serve_instruct(
        jm, jax.tree.map(jnp.asarray, qparams), jnp.asarray(video), batch,
        JGen(max_new_tokens=6, eos_id=2, pad_id=3, beam_size=1),
        num_slots=2, qscales=jax.tree.map(jnp.asarray, scales))
    loaded = bridge.load_jax_params(towl.MPLUGOwlVideo(tcfg, FP32_POLICY),
                                    qparams,
                                    qscales={"text_decoder": scales})
    quantized = bridge.load_jax_params(
        towl.MPLUGOwlVideo(tcfg, FP32_POLICY), params)
    quant.quantize_decoder_(quantized.text_decoder, include_embedding=True)
    for tm in (loaded, quantized):
        got, stats, engine = tcli.serve_instruct(
            tm, _t(video), batch,
            GenerationConfig(max_new_tokens=6, eos_id=2, pad_id=3,
                         beam_size=1),
            num_slots=2)
        forced = _forced_logits(jm, jax.tree.map(jnp.asarray, qparams), tm,
                                video, batch, want,
                                qscales=jax.tree.map(jnp.asarray, scales))
        assert _check_served(got, want, forced) == 0
        assert stats["kv_cache_dtype"] == "int8"
        assert stats["decoder_weight_bytes"] == quant.decoder_bytes(
            tm.text_decoder)
        assert stats["cache_bytes"] == 2 * 2 * 128 * (64 + 8 * 4)
    assert len({tuple(r) for r in got}) > 1  # not degenerate


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


def test_loaders_agree_on_the_int8_yaml():
    """The int8 YAML is the flagship with kv_cache_dtype int8, as both
    loaders read it."""
    got, raw = load_owl_config("configs/instruct/serve_bloomz_7b_int8.yaml")
    want, jraw = jcli.load_owl_config(
        "configs/instruct/serve_bloomz_7b_int8.yaml")
    assert raw == jraw
    for part in ("vision", "abstractor", "text"):
        _same_fields(getattr(got, part), getattr(want, part), part)
    flag, flag_raw = load_owl_config(FLAGSHIP_YAML)
    assert got.text.kv_cache_dtype == want.text.kv_cache_dtype == "int8"
    assert got == dataclasses.replace(flag, text=dataclasses.replace(
        flag.text, kv_cache_dtype="int8"))
    assert {k: v for k, v in raw.items() if k != "text_overrides"} == \
        {k: v for k, v in flag_raw.items() if k != "text_overrides"}


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
    # the prompts go through a tokenizer.json built here: with the
    # whitespace tokenizer their ids follow Python's salted string hash,
    # and a first greedy token of eos (no kept token) would come and go
    # with PYTHONHASHSEED
    tok = str(write_tokenizer_dir(tmp_path / "tok", 120, byte_level=False))
    path = tmp_path / "owl.yaml"
    path.write_text(yaml.safe_dump(dict(TINY, max_new_tokens=3)))
    rows = [{"video": "a.mp4", "question": "what happens ?"},
            {"video": "b.mp4", "question": "and then what ?"}]
    jsonl = tmp_path / "qa.jsonl"
    jsonl.write_text("".join(json.dumps(r) + "\n" for r in rows))
    args = tcli.parser().parse_args([
        "--config", str(path), "--output_dir", str(tmp_path / "out"),
        "--synthetic_data", "--input_jsonl", str(jsonl), "--engine",
        "--num_slots", "2", "--device", "cpu", "--tokenizer", tok])
    results, stats = tcli.main(args)
    assert [r["video"] for r in results] == ["a.mp4", "b.mp4"]
    assert all(1 <= len(r["tokens"]) <= 3 for r in results)
    saved = json.loads((tmp_path / "out" / "instruct_results.json")
                       .read_text())
    assert saved == results
    assert stats["requests"] == 2 and stats["nonfinite_logits"] == 0
    # the checkpoint flags are ported (tests/test_torch_owl_import.py,
    # tests/test_torch_export.py): a directory without one raises
    for flag, err in ((["--hf_checkpoint", str(tmp_path)],
                       FileNotFoundError),
                      (["--serving_ckpt", str(tmp_path)], SystemExit)):
        with pytest.raises(err, match="no (HF|serving) checkpoint"):
            tcli.build(tcli.parser().parse_args(
                ["--config", str(path), "--synthetic_data", "--device",
                 "cpu"] + flag))
    # int8 weights (--int8) and an int8 cache (the YAML)
    path.write_text(yaml.safe_dump(dict(
        TINY, max_new_tokens=3, text_overrides=dict(
            TINY["text_overrides"], kv_cache_dtype="int8"))))
    results, stats = tcli.main(tcli.parser().parse_args([
        "--config", str(path), "--output_dir", str(tmp_path / "int8"),
        "--synthetic_data", "--input_jsonl", str(jsonl), "--int8",
        "--num_slots", "2", "--device", "cpu", "--tokenizer", tok]))
    assert stats["kv_cache_dtype"] == "int8" and stats["requests"] == 2
    assert stats["nonfinite_logits"] == 0
    assert all(1 <= len(r["tokens"]) <= 3 for r in results)
    # sampling is served (the new-token budget is the YAML's); beam
    # search runs on the batched path (no --engine) and the engine
    # refuses it, as in the JAX runner
    path.write_text(yaml.safe_dump(dict(TINY, do_sample=True,
                                        max_new_tokens=3)))
    results, stats = tcli.main(tcli.parser().parse_args([
        "--config", str(path), "--output_dir", str(tmp_path / "sample"),
        "--synthetic_data", "--input_jsonl", str(jsonl), "--num_slots",
        "2", "--device", "cpu", "--tokenizer", tok]))
    assert stats["requests"] == 2 and stats["nonfinite_logits"] == 0
    assert all(1 <= len(r["tokens"]) <= 3 for r in results)
    path.write_text(yaml.safe_dump(dict(TINY, beam_size=2,
                                        max_new_tokens=3)))
    beam_args = ["--config", str(path), "--output_dir",
                 str(tmp_path / "beam"), "--synthetic_data", "--input_jsonl",
                 str(jsonl), "--device", "cpu", "--tokenizer", tok]
    results, stats = tcli.main(tcli.parser().parse_args(beam_args))
    assert stats["beam_size"] == 2 and stats["nonfinite_logits"] == 0
    assert all(1 <= len(r["tokens"]) <= 3 for r in results)
    with pytest.raises(ValueError, match="beam"):
        tcli.main(tcli.parser().parse_args(beam_args + ["--engine"]))


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


# ---------------------------------------------------------------------------
# instruct training
# ---------------------------------------------------------------------------

TRAIN_YAML = "configs/instruct/train_bloomz_7b_flagship.yaml"
PAIRS = [("what is this ?", "a small cat sits on a mat"),
         ("Human: <|video|> describe it", "dog"),
         ("who is there", "two people walk by the river at night")]


def _lora_models(seed):
    """(JAX model, redrawn params, port model, train batch, clips) of the
    tiny Owl with rank-2 LoRA; every lora_*_b is non-zero.  The ids come
    from StableTokenizer: with the hash tokenizer they change with the
    process's PYTHONHASHSEED, and some draws make the grad norm after two
    AdamW steps sensitive enough to leave 1e-4 (3 of 60 hash seeds)."""
    jcfg, tcfg = tiny_cfgs(lora_rank=2)
    rng = np.random.default_rng(seed)
    jm = jowl.MPLUGOwlVideo(jcfg, policy=J_FP32)
    batch = tinstruct.build_instruct_train_batch(
        PAIRS, StableTokenizer(V), NM, pad_id=3, eos_id=2)
    video = rng.normal(size=(3, 3, 2, 16, 16)).astype(np.float32)
    ids = jnp.asarray(batch["input_ids"])
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.asarray(video), ids, jnp.ones_like(ids),
        jnp.asarray(batch["media_mask"]), jnp.zeros_like(ids)))["params"]
    params = redraw(shapes, rng)
    tm = bridge.load_jax_params(towl.MPLUGOwlVideo(tcfg, FP32_POLICY),
                                params)
    return jm, params, tm, dict(batch, video=video)


def _jloss(jm):
    def loss_fn(p, b, rng=None, step=None):
        return jm.apply({"params": p}, b["video"], b["input_ids"],
                        b["attention_mask"], b["media_mask"],
                        b["prompt_mask"],
                        method=jowl.MPLUGOwlVideo.instruct_loss)
    return loss_fn


def _tloss(tm):
    def loss_fn(b):
        return tm.instruct_loss(*(_t(b[k]) for k in (
            "video", "input_ids", "attention_mask", "media_mask",
            "prompt_mask")))
    return loss_fn


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def test_instruct_targets_match_jax():
    rng = np.random.default_rng(8)
    ids = rng.integers(4, V, size=(3, 9)).astype(np.int32)
    attn = (np.arange(9)[None] < np.array([[9], [6], [3]])).astype(np.int32)
    media = np.zeros((3, 9), np.int32)
    media[:, 1:3] = 1
    prompt = (np.arange(9)[None] < np.array([[5], [4], [3]])).astype(
        np.int32)
    want = jowl.instruct_targets(*map(jnp.asarray, (ids, attn, media,
                                                    prompt)))
    got = towl.instruct_targets(*map(_t, (ids, attn, media, prompt)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].shape == (3, 8) and got[1][0].tolist() == [0] * 4 + [1] * 4


def test_instruct_train_batch_matches_jax():
    """Every field, with and without the max_length truncation (answers
    cut to fit, eos kept), the error of a prompt that leaves no room, and
    the runner's make_instruct_batch over synthetic captions."""
    tok = tinstruct.WhitespaceTokenizer(V)
    for max_length in (0, 41, 38):  # the prompts hold 36 and 8 tokens
        got = tinstruct.build_instruct_train_batch(
            PAIRS, tok, NM, pad_id=3, eos_id=2, max_length=max_length)
        want = jinstruct.build_instruct_train_batch(
            PAIRS, jinstruct.WhitespaceTokenizer(V), NM, pad_id=3, eos_id=2,
            max_length=max_length)
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype == np.int32
            np.testing.assert_array_equal(got[key], want[key])
        assert got["input_ids"].shape[1] == (max_length or 44)
    cut = tinstruct.build_instruct_train_batch(
        PAIRS[:1], tok, NM, pad_id=3, eos_id=2, max_length=40)
    assert cut["attention_mask"].sum() == 40 and cut["input_ids"][0, 39] == 2
    for mod in (tinstruct, jinstruct):
        with pytest.raises(ValueError, match="no room"):
            mod.build_instruct_train_batch(
                PAIRS[:1], mod.WhitespaceTokenizer(V), NM, pad_id=3,
                eos_id=2, max_length=10)
    raw = {"text": ["synthetic clip 3 class 3", "a"],
           "video": np.zeros((2, 2, 16, 16, 3), np.uint8)}
    _, tcfg = tiny_cfgs()
    runner = argparse.Namespace(
        model=argparse.Namespace(cfg=tcfg), tokenizer=tok,
        cfg=argparse.Namespace(max_length=40), device=torch.device("cpu"))
    got = tcli.make_instruct_batch(runner, raw)
    jrunner = argparse.Namespace(model=argparse.Namespace(cfg=tiny_cfgs()[0]),
                                 tokenizer=jinstruct.WhitespaceTokenizer(V),
                                 cfg={"max_length": 40})
    want = jcli.make_instruct_batch(jrunner, raw)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]))


def test_instruct_loss_and_grads_match_jax():
    """instruct_loss and the gradient of every trainable leaf (the
    abstractor, visual_fc, vit_eos, and the LoRA adapters inside the
    frozen decoder) against jax.value_and_grad at fp32; the frozen ViT
    builds no autograd graph."""
    from youku_mplug_tpu_torch.optim.factory import OptimizerConfig

    jm, params, tm, batch = _lora_models(11)
    jb = jax.tree.map(jnp.asarray, batch)
    (jloss, jgrads) = jax.jit(jax.value_and_grad(
        lambda p: _jloss(jm)(p, jb)["loss"]))(params)
    from youku_mplug_tpu_torch.train.state import create_train_state

    state, _, _ = create_train_state(tm, OptimizerConfig(freeze_vit=True))
    frames = _t(batch["video"]).transpose(1, 2).flatten(0, 1)
    assert tm.visual_encoder(frames)[1].grad_fn is None
    out = _tloss(tm)(batch)
    out["loss"].backward()
    _close(out["loss"].detach(), jloss)
    jflat = _flat(jgrads)
    lora = [k for k in state.trainable if "lora_" in k]
    assert len(lora) == 8 and all(k.startswith("text_decoder/") for k in lora)
    assert {k.split("/")[0] for k in state.trainable} == {
        "abstractor", "visual_fc", "vit_eos", "text_decoder"}
    assert {k.split("/")[0] for k in state.frozen} == {
        "visual_encoder", "text_decoder"}
    for path, p in state.trainable.items():
        assert p.grad is not None, path
        _close(p.grad, jflat[path])
        assert p.grad.abs().sum() > 0, path  # lora_*_a too: b is non-zero
    assert all(p.grad is None for p in state.frozen.values())


def _opt_kwargs():
    return dict(lr=1e-3, min_lr=1e-5, weight_decay=0.01,
                opt_betas=(0.9, 0.98), opt_eps=1e-6, clip_grad=0.05,
                warmup_steps=2, epochs=1, niter_per_ep=10, freeze_vit=True)


def test_instruct_adamw_trajectory_matches_jax():
    """Three steps: the first at lr schedule(0) = 0 (nothing moves), then
    two that move; clipping at 0.05 is active.  Losses, grad norms and
    every trainable leaf after each step against JAX's create_train_state
    + make_train_step; the frozen ViT and Bloom base stay bitwise."""
    from youku_mplug_tpu.optim.factory import OptimizerConfig as JOpt
    from youku_mplug_tpu.train.state import create_train_state as j_state
    from youku_mplug_tpu.train.trainer import make_train_step as j_step
    from youku_mplug_tpu_torch.optim.factory import OptimizerConfig
    from youku_mplug_tpu_torch.train.state import create_train_state
    from youku_mplug_tpu_torch.train.trainer import make_train_step

    jm, params, tm, batch = _lora_models(12)
    batches = []
    for i in range(3):
        b = dict(batch)
        b["video"] = np.random.default_rng(20 + i).normal(
            size=batch["video"].shape).astype(np.float32)
        batches.append(b)
    jst, tx, _ = j_state(params, JOpt(**_opt_kwargs()))
    jtrain = jax.jit(j_step(_jloss(jm), tx))
    state, opt, _ = create_train_state(tm, OptimizerConfig(**_opt_kwargs()))
    ttrain = make_train_step(_tloss(tm))
    frozen0 = {k: p.detach().clone() for k, p in state.frozen.items()}
    start = {k: p.detach().clone() for k, p in state.trainable.items()}
    for i, b in enumerate(batches):
        jst, jmet = jtrain(jst, jax.tree.map(jnp.asarray, b),
                           jax.random.key(0))
        met = ttrain(state, b)
        assert met["skipped_nonfinite"] == float(jmet["skipped_nonfinite"])\
            == 0.0
        _close(met["loss"], jmet["loss"])
        _close(met["grad_norm"], jmet["grad_norm"])
        assert met["grad_norm"] > 0.05  # clipping is active
        jflat = _flat(jax.device_get(jst.trainable))
        for path, p in state.trainable.items():
            _close(p.detach(), jflat[path], 2e-5)
            if i == 0:
                assert torch.equal(p.detach(), start[path]), path
    assert opt.count == 3 and state.step == 3
    moved = [k for k, p in state.trainable.items()
             if not torch.equal(p.detach(), start[k])]
    assert set(moved) == set(state.trainable)  # lora_*_a and *_b included
    for k, p in state.frozen.items():
        assert torch.equal(p.detach(), frozen0[k]), k


def test_train_yaml_loads_as_the_jax_runner_reads_it():
    """configs/instruct/train_bloomz_7b_flagship.yaml: the model and
    training blocks of configs/instruct_bloomz_7b.yaml plus
    synthetic_length 64; the optimizer the JAX train_main builds from it;
    and the original YAML's do_sample does not stop training."""
    from youku_mplug_tpu.optim.factory import OptimizerConfig as JOpt
    from youku_mplug_tpu_torch.config import instruct_train_config

    cfg, raw = load_owl_config(TRAIN_YAML)
    with open("configs/instruct_bloomz_7b.yaml") as f:
        ref = yaml.safe_load(f)
    for key in ("vision_overrides", "abstractor", "num_frames", "image_res",
                "text_overrides", "batch_size", "epochs", "max_length",
                "optimizer"):
        assert raw[key] == ref[key], key
    assert raw["synthetic_length"] == 64
    jcfg, _ = jcli.load_owl_config(TRAIN_YAML)
    for part in ("vision", "abstractor", "text"):
        _same_fields(getattr(cfg, part), getattr(jcfg, part), part)
    assert (cfg.text.lora_rank, cfg.text.lora_alpha, cfg.text.lora_targets,
            cfg.text.head_dim) == (8, 16.0, ("qkv", "out", "fc1", "fc2"),
                                   128)
    tcfg = instruct_train_config(raw)
    opt_kw = dict(raw["optimizer"])
    want = JOpt(**opt_kw, epochs=3, niter_per_ep=1000,
                freeze_text_decoder=True, freeze_vit=True)
    _same_fields(tcfg.optimizer, want, "optimizer")
    assert (tcfg.batch_size, tcfg.epochs, tcfg.max_length,
            tcfg.synthetic_length, tcfg.update_freq) == (8, 3, 768, 64, 1)
    assert (tcfg.optimizer.lr, tcfg.optimizer.weight_decay,
            tcfg.optimizer.clip_grad, tcfg.optimizer.warmup_steps) == \
        (1e-4, 0.01, 1.0, 50)
    _, ref_raw = load_owl_config("configs/instruct_bloomz_7b.yaml")
    assert ref_raw["do_sample"] and instruct_train_config(ref_raw) == \
        dataclasses.replace(tcfg, synthetic_length=16)


def test_run_instruct_train_cli_on_cpu(tmp_path, capsys):
    """run_instruct --train on the CPU at the tiny size, bf16 compute:
    two steps, finite losses, every adapter trained (the b's leave zero,
    the a's move from the second step on), the abstractor trained, the
    ViT and Bloom base frozen in bf16 and unchanged, log.txt written; a
    YAML with do_sample still trains."""
    from youku_mplug_tpu_torch.bridge import jax_init

    path = tmp_path / "train.yaml"
    path.write_text(yaml.safe_dump(dict(
        TINY, text_overrides=dict(TINY["text_overrides"], lora_rank=2),
        do_sample=True, batch_size=2, epochs=1, synthetic_length=4,
        max_length=40, optimizer={"lr": 1e-3, "clip_grad": 1.0})))
    out = tmp_path / "out"
    args = tcli.parser().parse_args([
        "--config", str(path), "--train", "--synthetic_data", "--device",
        "cpu", "--seed", "3", "--output_dir", str(out)])
    runner = tcli.main(args)
    assert len(runner.history) == 2
    for h in runner.history:
        assert np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
        assert h["skipped_nonfinite"] == 0 and h["step_time"] > 0
    state = runner.state
    fresh = towl.MPLUGOwlVideo(load_owl_config(str(path))[0])
    jax_init(fresh, 3)
    fresh = {bridge.jax_path(k): p for k, p in fresh.named_parameters()}
    for k, p in state.frozen.items():
        assert p.dtype == torch.bfloat16, k
        assert torch.equal(p.detach(), fresh[k].to(torch.bfloat16)), k
    lora = {k: p for k, p in state.trainable.items() if "lora_" in k}
    assert len(lora) == 8
    for k, p in state.trainable.items():
        assert p.dtype == torch.float32
        assert not torch.equal(p.detach(), fresh[k]), k
        if k.endswith("_b") and "lora_" in k:
            assert not fresh[k].any()  # zero at the start
    log = [json.loads(line) for line in (out / "log.txt").read_text()
           .splitlines()]
    assert len(log) == 1 and np.isfinite(log[0]["loss"])
    printed = capsys.readouterr().out
    assert "step 2:" in printed
    assert sorted(p.name for p in (out / "checkpoints").iterdir()) == ["2"]
