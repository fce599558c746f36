"""The port's serving slice against the JAX package: the continuous-
batching engine (same weights, staggered requests with visual query
prefixes -> identical greedy tokens), the serve CLI on the CPU, and the
host-side pieces it shares with the JAX CLI (config, prompt ids,
synthetic clips)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from youku_mplug_tpu.models import gpt3 as jgpt3
from youku_mplug_tpu.models.generation import GenerationConfig as JGen
from youku_mplug_tpu.runtime.precision import FP32_POLICY as J_FP32
from youku_mplug_tpu.serving.engine import ServingEngine as JEngine
from youku_mplug_tpu_torch import bridge
from youku_mplug_tpu_torch.cli import serve
from youku_mplug_tpu_torch.config import flagship_config, load_config
from youku_mplug_tpu_torch.data.datasets import SyntheticVideoDataset
from youku_mplug_tpu_torch.models import gpt3 as tgpt3
from youku_mplug_tpu_torch.models.generation import GenerationConfig
from youku_mplug_tpu_torch.models.tokenizer import ToyTokenizer
from youku_mplug_tpu_torch.runtime.precision import FP32_POLICY
from youku_mplug_tpu_torch.serving.engine import ServingEngine

torch.set_num_threads(1)
EOS = 2
FLAGSHIP_YAML = "configs/caption/serve_gpt3_1.3B_flagship.yaml"


def redraw(tree, rng, std=0.3):
    def leaf(path, x):
        z = rng.normal(size=x.shape).astype(np.float32)
        return 1.0 + 0.1 * z if str(path[-1].key).endswith("scale") \
            else std * z
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _drive(engine, requests):
    """Two requests, three steps, then the rest: later requests join a
    batch already in flight."""
    fin = []
    for ids, qe in requests[:2]:
        engine.submit(ids, query_embeds=qe)
    for _ in range(3):
        fin.extend(engine.step())
    for ids, qe in requests[2:]:
        engine.submit(ids, query_embeds=qe)
    fin.extend(engine.run_to_completion())
    return {f.rid: f.tokens for f in fin}


def test_engine_tokens_match_jax_engine():
    rng = np.random.default_rng(0)
    cfg = _flagship_cfg(tiny=True).text
    jlm = jgpt3.GPT3LM(cfg, policy=J_FP32)
    params = redraw(jax.eval_shape(lambda: jlm.init(
        jax.random.key(0), jnp.zeros((1, 4), jnp.int32)))["params"], rng)
    tlm = bridge.load_jax_params(
        tgpt3.GPT3LM(flagship_config(tiny=True).text, FP32_POLICY), params)
    nq, h = 4, cfg.hidden_size
    requests = [(list(rng.integers(3, cfg.vocab_size, size=n)),
                 rng.normal(size=(nq, h)).astype(np.float32))
                for n in (3, 8, 1, 5, 6)]
    kw = dict(num_slots=3, max_len=40, prefill_buckets=(8,))
    jeng = JEngine(jlm, jax.tree.map(jnp.asarray, params),
                   config=JGen(max_new_tokens=9, eos_id=EOS, pad_id=EOS),
                   **kw)
    teng = ServingEngine(tlm, config=GenerationConfig(
        max_new_tokens=9, eos_id=EOS, pad_id=EOS), **kw)
    want = _drive(jeng, requests)
    got = _drive(teng, requests)
    assert got == want
    assert len(got) == len(requests)
    assert len({tuple(t) for t in got.values()}) > 1  # not degenerate
    assert teng.nonfinite_logits == 0


def test_engine_prefill_bookkeeping():
    """After prefill a slot's cache_len is nq + bucket width (not the
    true prompt length) and valid_from = pos_offset = bucket - length."""
    lm = bridge.seeded_init(
        tgpt3.GPT3LM(flagship_config(tiny=True).text, FP32_POLICY), 0)
    eng = ServingEngine(lm, num_slots=2, max_len=40, prefill_buckets=(8,),
                        config=GenerationConfig(max_new_tokens=4,
                                                eos_id=EOS, pad_id=EOS))
    eng.submit([5, 6, 7], query_embeds=np.zeros((4, 64), np.float32))
    eng._admit()
    assert eng.cache_len[0] == 4 + 8
    assert eng.valid_from[0] == eng.pos_offset[0] == 5
    assert eng.cache.shape == (2, 2, 128, 128)


def test_serve_cli_runs_on_cpu(tmp_path):
    args = serve.serve_parser().parse_args([
        "--config", "configs/pretrain_tiny.yaml", "--synthetic_data",
        "--num_requests", "3", "--output_dir", str(tmp_path), "--device",
        "cpu"])
    stats = serve.main(args)
    assert set(stats) == {"requests", "wall_s", "tokens_per_sec",
                          "latency_p50_s", "latency_p95_s"}
    assert stats["requests"] == 3
    out = json.loads((tmp_path / "serve_results.json").read_text())
    assert [r["video_id"] for r in out] == ["0", "1", "2"]
    assert all(1 <= r["n_tokens"] <= 32 for r in out)


def test_flagship_config_matches_jax_and_yaml():
    from youku_mplug_tpu.config import load_config as j_load_config

    for tiny in (False, True):
        j, t = _flagship_cfg(tiny=tiny), flagship_config(tiny=tiny)
        assert t.num_learnable_token == j.num_learnable_token
        for part in ("vision", "text"):
            tp, jp = getattr(t, part), getattr(j, part)
            for f in dataclasses.fields(tp):
                assert getattr(tp, f.name) == getattr(jp, f.name), \
                    (part, f.name)
    # the serve YAML is the flagship in every setting serving reads; it
    # leaves the training-only ones (dropout, rematerialization, the CE
    # chunk) as the model JSONs have them
    flag, served = flagship_config(), load_config(FLAGSHIP_YAML).model
    train_only = {"text": ("hidden_dropout", "attention_dropout", "remat",
                           "ce_chunk"),
                  "vision": ("grad_ckpt", "remat_policy")}
    assert served == dataclasses.replace(flag, **{
        part: dataclasses.replace(getattr(flag, part), **{
            f: getattr(getattr(served, part), f) for f in fields})
        for part, fields in train_only.items()})
    jcfg = j_load_config(FLAGSHIP_YAML).model
    for part in ("vision", "text"):
        tp = getattr(served, part)
        for f in dataclasses.fields(tp):
            assert getattr(tp, f.name) == getattr(getattr(jcfg, part),
                                                  f.name), (part, f.name)


def test_prompt_ids_and_clips_match_jax():
    from youku_mplug_tpu.data.datasets import SyntheticVideoDataset as JDs
    from youku_mplug_tpu.models.tokenizer import ToyTokenizer as JTok

    for text in ("", "a cat", "视频"):
        assert ToyTokenizer(512).tokenize(text) == JTok(512).tokenize(text)
    ours, theirs = SyntheticVideoDataset(8, 4, 32), JDs(8, 4, 32)
    for i in (0, 5):
        np.testing.assert_array_equal(ours[i]["video"], theirs[i]["video"])
        assert ours[i]["video_id"] == theirs[i]["video_id"]


INT8KV_YAML = "configs/caption/serve_gpt3_1.3B_int8kv.yaml"


def test_int8_cache_engine_tokens_match_jax_engine():
    """The caption engine with kv_cache_dtype int8 (float weights): the
    prefill writes both leaves through a slot view, each decode step one
    quantized row per slot (the plain fused write) read by the plain
    int8 decode attention; JAX's engine gives the same greedy tokens."""
    rng = np.random.default_rng(1)
    cfg = dataclasses.replace(_flagship_cfg(tiny=True).text,
                              kv_cache_dtype="int8")
    jlm = jgpt3.GPT3LM(cfg, policy=J_FP32)
    params = redraw(jax.eval_shape(lambda: jlm.init(
        jax.random.key(0), jnp.zeros((1, 4), jnp.int32)))["params"], rng)
    tcfg = dataclasses.replace(flagship_config(tiny=True).text,
                               kv_cache_dtype="int8")
    tlm = bridge.load_jax_params(tgpt3.GPT3LM(tcfg, FP32_POLICY), params)
    nq, h = 4, cfg.hidden_size
    requests = [(list(rng.integers(3, cfg.vocab_size, size=n)),
                 rng.normal(size=(nq, h)).astype(np.float32))
                for n in (3, 8, 1, 5, 6)]
    kw = dict(num_slots=3, max_len=40, prefill_buckets=(8,))
    jeng = JEngine(jlm, jax.tree.map(jnp.asarray, params),
                   config=JGen(max_new_tokens=9, eos_id=EOS, pad_id=EOS),
                   **kw)
    teng = ServingEngine(tlm, config=GenerationConfig(
        max_new_tokens=9, eos_id=EOS, pad_id=EOS), **kw)
    assert teng.cache["kv"].dtype == torch.int8
    want = _drive(jeng, requests)
    got = _drive(teng, requests)
    assert got == want
    assert len({tuple(t) for t in got.values()}) > 1  # not degenerate
    assert teng.nonfinite_logits == 0


def test_int8kv_yaml_is_the_flagship_with_an_int8_cache():
    """Both loaders read the int8-KV YAML as the flagship serve YAML with
    kv_cache_dtype int8, and nothing else changed."""
    from youku_mplug_tpu.config import load_config as j_load_config

    got, flag = load_config(INT8KV_YAML), load_config(FLAGSHIP_YAML)
    assert got.model.text.kv_cache_dtype == "int8"
    assert got.model == dataclasses.replace(flag.model, text=(
        dataclasses.replace(flag.model.text, kv_cache_dtype="int8")))
    assert {k: v for k, v in got.raw.items() if k != "text_overrides"} == \
        {k: v for k, v in flag.raw.items()}
    jcfg = j_load_config(INT8KV_YAML).model
    for part in ("vision", "text"):
        tp = getattr(got.model, part)
        for f in dataclasses.fields(tp):
            assert getattr(tp, f.name) == getattr(getattr(jcfg, part),
                                                  f.name), (part, f.name)
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        tgpt3.GPT3Config(kv_cache_dtype="fp8")


def test_serve_cli_with_an_int8_cache_runs_on_cpu(tmp_path):
    import yaml

    raw = yaml.safe_load(open("configs/pretrain_tiny.yaml"))
    raw["text_overrides"]["kv_cache_dtype"] = "int8"
    path = tmp_path / "int8kv.yaml"
    path.write_text(yaml.safe_dump(raw))
    args = serve.serve_parser().parse_args([
        "--config", str(path), "--synthetic_data", "--num_requests", "3",
        "--output_dir", str(tmp_path), "--device", "cpu"])
    cfg, model, device = serve.build(args)
    stats, out, engine = serve.run(args, cfg, model, device)
    assert stats["requests"] == 3 and engine.cache["kv"].dtype == torch.int8
    assert all(1 <= r["n_tokens"] <= 32 for r in out)
    assert engine.nonfinite_logits == 0
