"""Weights in and out of the port's runners on the CPU, at tiny size:
``run_instruct --train`` saves, resumes bitwise from another directory
and exports (``cli/export_serving.py --owl --int8 --int8_embedding``),
the int8 tree bitwise equal to the JAX package's ``merge_lora`` +
``quantize_gpt3_decoder`` of the same checkpoint, then served through
``--serving_ckpt``; ``extract_adapters`` / ``inject_adapters`` files
exchanged with the JAX functions both ways; ``run_caption`` and
``serve`` with ``import_torch_weights`` (each imported leaf the file's
value rounded once into its parameter's dtype), and ``serve --resume``
holding a caption run's checkpoint bitwise.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from youku_mplug_tpu.models import owl as jowl
from youku_mplug_tpu.ops import lora as jlora
from youku_mplug_tpu.ops import quant as jquant
from youku_mplug_tpu.runtime.precision import FP32_POLICY as J_FP32
from youku_mplug_tpu_torch import bridge
from youku_mplug_tpu_torch.cli import export_serving, serve
from youku_mplug_tpu_torch.cli import run_caption
from youku_mplug_tpu_torch.cli import run_instruct as tcli
from youku_mplug_tpu_torch.config import load_config
from youku_mplug_tpu_torch.models import owl as towl
from youku_mplug_tpu_torch.ops import lora as tlora
from youku_mplug_tpu_torch.ops import quant
from youku_mplug_tpu_torch.runtime.precision import FP32_POLICY
from youku_mplug_tpu_torch.train.checkpoint import CheckpointManager

from tests.test_torch_caption import tiny_caption_yaml
from tests.test_torch_importers import (
    megatron_sd,
    save_megatron,
    timesformer_sd,
)
from tests.hf_tokenizer_files import write_tokenizer_dir
from tests.test_torch_owl_import import TINY, tiny_cfgs

torch.set_num_threads(1)


def _jax_leaf(t: torch.Tensor):
    """A checkpoint tensor as JAX holds it (bf16 stays bf16)."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _np(x):
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _train_yaml(tmp_path):
    path = tmp_path / "train.yaml"
    path.write_text(yaml.safe_dump(dict(
        TINY, text_overrides=dict(TINY["text_overrides"], lora_rank=2),
        batch_size=2, epochs=1, synthetic_length=4, max_length=40,
        optimizer={"lr": 1e-3, "clip_grad": 1.0})))
    return str(path)


def _train_args(path, out, *extra):
    return tcli.parser().parse_args([
        "--config", path, "--train", "--synthetic_data", "--device", "cpu",
        "--seed", "3", "--output_dir", str(out), *extra])


def test_instruct_train_saves_resumes_and_exports_int8_as_jax(tmp_path,
                                                               capsys):
    path = _train_yaml(tmp_path)
    out = tmp_path / "out"
    runner = tcli.main(_train_args(path, out))
    assert runner.state.step == 2
    ckpt = CheckpointManager(str(out / "checkpoints"))
    assert ckpt.all_steps() == [2]
    raw = ckpt.restore_raw(2, map_location="cpu")

    # resume from another directory: every leaf, moment, count, step
    capsys.readouterr()
    again = tcli.train_setup(_train_args(path, tmp_path / "again",
                                         "--resume", str(out)))
    assert "resumed from step 2 (epoch 1)" in capsys.readouterr().out
    st = again.state
    assert (st.step, st.optimizer.count, again.start_epoch) == (2, 2, 1)
    for part in ("trainable", "frozen"):
        got = getattr(st, part)
        assert set(got) == set(raw[part])
        for k, p in got.items():
            assert torch.equal(p.detach(), raw[part][k]), k
            assert torch.equal(p.detach(),
                               getattr(runner.state, part)[k].detach()), k
    moments = st.optimizer.torch_optimizer.state
    assert set(raw["optim"]) == set(st.trainable)
    for k, p in st.trainable.items():
        for m in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(moments[p][m], raw["optim"][k][m]), (k, m)

    # the export against JAX's merge + quantize of the same checkpoint
    dest = tmp_path / "serving"
    export_serving.main(["--owl", "--int8", "--int8_embedding", "--run_dir",
                         str(out), "--config", path, "--dest", str(dest),
                         "--device", "cpu"])
    sc = CheckpointManager(str(dest))
    saved = sc.restore_raw(2, map_location="cpu")
    assert sc.restore_metadata(2) == {"source_step": 2, "lora_merged": True,
                                      "int8": True}
    _, tcfg = tiny_cfgs()
    jtree = bridge.unflatten({k: _jax_leaf(v)
                              for part in ("trainable", "frozen")
                              for k, v in raw[part].items()})
    merged = jlora.merge_lora(jtree["text_decoder"], 2,
                              tcfg.text.lora_alpha)
    jq, js = jquant.quantize_gpt3_decoder(merged, include_embedding=True)
    got_q = bridge.flatten(saved["params"]["text_decoder"])
    want_q = bridge.flatten(jax.tree.map(np.asarray, jq))
    assert set(got_q) == set(want_q) and not any("lora_" in k for k in got_q)
    for k, w in want_q.items():
        assert got_q[k].dtype == {"int8": torch.int8,
                                  "bfloat16": torch.bfloat16}[w.dtype.name]
        np.testing.assert_array_equal(_np(got_q[k].float()), _np(w),
                                      err_msg=k)
    got_s = bridge.flatten(saved["qscales"]["text_decoder"])
    want_s = bridge.flatten(jax.tree.map(np.asarray, js))
    assert set(got_s) == set(want_s) and len(got_s) == 5
    for k, w in want_s.items():
        np.testing.assert_array_equal(got_s[k].numpy(), w, err_msg=k)
    for k, v in raw["trainable"].items():  # the other towers as saved
        if not k.startswith("text_decoder"):
            assert torch.equal(bridge.flatten(saved["params"])[k], v), k

    # served from the export: the int8 leaves and scales as saved
    args = tcli.parser().parse_args([
        "--config", path, "--synthetic_data", "--engine", "--device", "cpu",
        "--serving_ckpt", str(dest), "--output_dir", str(tmp_path / "srv")])
    _, _, model, _ = tcli.build(args)
    assert "loaded serving checkpoint step 2 (int8=True)" in \
        capsys.readouterr().out
    params = dict(model.named_parameters())
    for k, q in got_q.items():
        p = params[bridge.port_name("text_decoder/" + k)]
        assert p.dtype == q.dtype and torch.equal(p.detach(), q), k
    for k, s in got_s.items():
        owner, leaf = bridge.port_name("text_decoder/" + k).rsplit(".", 1)
        assert torch.equal(quant.qscale(model.get_submodule(owner), leaf), s)
    # a built tokenizer.json takes the prompt: the whitespace tokenizer's
    # salted hash would make a first greedy token of eos come and go
    args.tokenizer = str(write_tokenizer_dir(tmp_path / "tok", 120,
                                             byte_level=False))
    results, stats = tcli.main(args)
    assert stats["requests"] == 1 and stats["nonfinite_logits"] == 0
    assert results[0]["tokens"]
    args.int8 = True
    with pytest.raises(ValueError, match="--int8"):
        tcli.build(args)


def _owl_lora_params(rank=2):
    """(JAX params of the tiny Owl with rank-``rank`` text adapters, every
    adapter drawn non-zero; the port's config of that model)."""
    jcfg, tcfg = tiny_cfgs()
    jcfg = dataclasses.replace(jcfg, text=dataclasses.replace(
        jcfg.text, lora_rank=rank))
    tcfg = dataclasses.replace(tcfg, text=dataclasses.replace(
        tcfg.text, lora_rank=rank))
    model = jowl.MPLUGOwlVideo(jcfg, policy=J_FP32)
    v = jcfg.vision
    n = jcfg.num_media_tokens
    ids = jnp.ones((1, n + 3), jnp.int32)
    params = model.init(
        jax.random.key(0), jnp.zeros((1, 3, v.num_frames, v.img_size,
                                      v.img_size)), ids, jnp.ones_like(ids),
        jnp.zeros_like(ids).at[:, 1:1 + n].set(1),
        jnp.zeros_like(ids))["params"]
    rng = np.random.default_rng(11)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: rng.normal(size=x.shape).astype(np.float32)
        if "lora_" in jax.tree_util.keystr(p) else np.asarray(x), params)
    return params, tcfg


def test_adapter_files_exchange_with_jax_both_ways(tmp_path):
    params, tcfg = _owl_lora_params()
    port = bridge.load_jax_params(towl.MPLUGOwlVideo(tcfg, FP32_POLICY),
                                  params)
    got = tlora.extract_adapters(port)
    want = jlora.extract_adapters(params)
    assert set(got) == set(want) and len(got) == 8
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(w), err_msg=k)

    # port file -> JAX tree
    np.savez(tmp_path / "port.npz", **got)
    zeroed = jax.tree_util.tree_map_with_path(
        lambda p, x: np.zeros_like(x) if "lora_" in jax.tree_util.keystr(p)
        else x, params)
    back = jlora.inject_adapters(zeroed, dict(np.load(tmp_path /
                                                      "port.npz")))
    for k, w in jlora.extract_adapters(back).items():
        np.testing.assert_array_equal(np.asarray(w), got[k], err_msg=k)

    # JAX file -> port model
    np.savez(tmp_path / "jax.npz", **{k: np.asarray(v)
                                      for k, v in want.items()})
    fresh = bridge.load_jax_params(towl.MPLUGOwlVideo(tcfg, FP32_POLICY),
                                   zeroed)
    assert not any(v.any() for v in tlora.extract_adapters(fresh).values())
    assert tlora.inject_adapters(fresh, dict(np.load(tmp_path / "jax.npz"))
                                 ) is fresh
    for k, v in tlora.extract_adapters(fresh).items():
        np.testing.assert_array_equal(v, np.asarray(want[k]), err_msg=k)
    key = next(iter(want))
    with pytest.raises(ValueError, match="not in the param tree"):
        tlora.inject_adapters(fresh, {key.replace("lora_", "x_"): 0})
    with pytest.raises(ValueError, match="shape"):
        tlora.inject_adapters(fresh, {key: np.zeros((1, 1), np.float32)})


def _import_yaml(tmp_path, rng, name="cap"):
    """The tiny caption YAML with ``import_torch_weights`` naming two
    Megatron shards and a TimeSformer file of fp16 tensors; -> (YAML, the
    two state dicts)."""
    plain = load_config(tiny_caption_yaml(tmp_path, "plain")).model
    gsd = megatron_sd(rng, plain.text, np.float16)
    gdir = tmp_path / "gpt3"
    gdir.mkdir(exist_ok=True)
    save_megatron(gsd, gdir, 2)
    vsd = timesformer_sd(rng, np.float16, dim=32, depth=1, grid=2, frames=2)
    torch.save({"state_dict": {k: torch.from_numpy(v)
                               for k, v in vsd.items()}},
               tmp_path / "vit.pth")
    spec = {"gpt3": str(gdir), "vision": str(tmp_path / "vit.pth")}
    return tiny_caption_yaml(tmp_path, name, import_torch_weights=spec), \
        gsd, vsd


def _imported_leaves(model_or_state, gsd, vsd):
    """(port name, parameter, fp16 source) of a few imported leaves."""
    lm = "language_model."
    return [
        ("text_decoder.word_embeddings.embedding",
         gsd[lm + "embedding.word_embeddings.weight"]),
        ("text_decoder.decoder.ln_f_scale",
         gsd[lm + "transformer.final_layernorm.weight"]),
        ("text_decoder.decoder.layers.mlp.fc1_bias",
         gsd[lm + "transformer.layers.0.mlp.dense_h_to_4h.bias"][None]),
        ("visual_encoder.cls_token", vsd["cls_token"]),
        ("visual_encoder.blocks.0.mlp.fc2_bias", vsd["blocks.0.mlp.fc2.bias"]),
    ]


def test_run_caption_and_serve_import_torch_weights_and_serve_resumes(
        tmp_path, capsys):
    """run_caption (bf16: the frozen decoder rounded once from fp16 into
    bf16, the trainable tower widened exactly into fp32) and serve (bf16
    weights) take the imported values, the rest keeps its init; then
    serve --resume holds the caption run's checkpoint bitwise."""
    cfg, gsd, vsd = _import_yaml(tmp_path, np.random.default_rng(12))
    out = tmp_path / "cap"
    args = run_caption.parser().parse_args([
        "--config", cfg, "--output_dir", str(out), "--synthetic_data",
        "--max_steps", "2", "--seed", "0", "--device", "cpu"])
    runner, _ = run_caption.prepare(args)
    printed = capsys.readouterr().out
    assert "imported 16 decoder tensors" in printed
    assert "imported 29 vision tensors" in printed
    params = dict(runner.model.named_parameters())
    for name, src in _imported_leaves(runner.model, gsd, vsd):
        p = params[name]
        want = torch.from_numpy(src).to(p.dtype)
        assert p.dtype == (torch.bfloat16 if name.startswith("text")
                           else torch.float32), name
        assert torch.equal(p.detach(), want), name

    sargs = serve.serve_parser().parse_args([
        "--config", cfg, "--synthetic_data", "--num_requests", "2",
        "--num_slots", "2", "--device", "cpu", "--output_dir",
        str(tmp_path / "srv")])
    _, smodel, _ = serve.build(sargs)
    sparams = dict(smodel.named_parameters())
    for name, src in _imported_leaves(smodel, gsd, vsd):
        assert torch.equal(sparams[name].detach(),
                           torch.from_numpy(src).to(torch.bfloat16)), name
    seeded = serve.build(serve.serve_parser().parse_args([
        "--config", tiny_caption_yaml(tmp_path, "plain"), "--synthetic_data",
        "--device", "cpu"]))[1]
    assert torch.equal(sparams["attn_pool.q_kernel"],
                       seeded.attn_pool.q_kernel)  # not in the files

    run_caption.main(args)  # trains 2 steps and saves step 2
    raw = CheckpointManager(str(out / "checkpoints")).restore_raw(
        2, map_location="cpu")
    rargs = serve.serve_parser().parse_args([
        "--config", tiny_caption_yaml(tmp_path, "plain"), "--synthetic_data",
        "--num_requests", "3", "--num_slots", "2", "--device", "cpu",
        "--resume", str(out), "--output_dir", str(tmp_path / "resumed")])
    capsys.readouterr()
    _, rmodel, _ = serve.build(rargs)
    assert "resumed from step 2 (epoch 1)" in capsys.readouterr().out
    leaves = {**raw["trainable"], **raw["frozen"]}
    rparams = {bridge.jax_path(k): p for k, p in rmodel.named_parameters()}
    assert set(rparams) == set(leaves)
    for k, p in rparams.items():
        assert p.dtype == leaves[k].dtype and torch.equal(p.detach(),
                                                          leaves[k]), k
    stats = serve.main(rargs)
    assert stats["requests"] == 3
    results = json.loads((tmp_path / "resumed" / "serve_results.json")
                         .read_text())
    assert len(results) == 3 and all(r["tokens"] for r in results)
    rargs.resume = str(tmp_path / "none")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        serve.build(rargs)
