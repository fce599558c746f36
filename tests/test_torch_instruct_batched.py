"""The port's batched instruct path (``models/owl.generate_instruct`` and
``run_instruct`` without ``--engine``) against the JAX package at fp32 on
the CPU, weights carried over by the bridge, on the tiny Owl of
tests/test_torch_owl.py:

- greedy: the same tokens as JAX's ``generate_instruct`` wherever JAX's
  choice is clear of a near-tie (``MARGIN``), and the same teacher-forced
  logits within ``TOL``; fp32 and with an int8 decoder and cache (JAX's
  ``qscales``);
- beam 3: the same sequences and scores within ``TOL``, fp32 and int8;
  at fp32 each score is also the JAX decoder's teacher-forced sum of
  log-probabilities of its sequence (with the eos that closed it) within
  ``TOL`` (the int8 cache's rounding has no counterpart in that
  cacheless forward);
- the batched greedy tokens equal to the port's own engine's (as JAX's
  tests/test_owl.py holds its two paths);
- ``_build_prefix`` with prompt embeddings and no query prefix, as
  ``generate_instruct`` calls it;
- ``run_instruct`` without ``--engine`` against the JAX runner's
  ``instruct_results.json`` on one built ``tokenizer.json`` and one
  weight tree: the same answers, text for text, greedy and beam;
  sampled answers reproducible by seed.

Tolerance 1e-4 (fp32, sums taken in another order), as in
tests/test_torch_owl.py.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from youku_mplug_tpu.cli import run_instruct as jcli
from youku_mplug_tpu.models import generation as jgen
from youku_mplug_tpu.models import owl as jowl
from youku_mplug_tpu.models.bloom import BloomLM as JBloomLM
from youku_mplug_tpu.models.generation import GenerationConfig as JGen
from youku_mplug_tpu.ops.quant import quantize_gpt3_decoder
from youku_mplug_tpu.runtime.precision import FP32_POLICY as J_FP32
from youku_mplug_tpu_torch import bridge
from youku_mplug_tpu_torch.cli import run_instruct as tcli
from youku_mplug_tpu_torch.models import generation as tgen
from youku_mplug_tpu_torch.models import owl as towl
from youku_mplug_tpu_torch.models.generation import GenerationConfig
from youku_mplug_tpu_torch.runtime.precision import FP32_POLICY
from tests.hf_tokenizer_files import write_tokenizer_dir
from tests.test_torch_owl import (
    TINY,
    TOL,
    _check_served,
    _close,
    _forced_logits,
    _t,
    owl,  # noqa: F401  (the fixture)
    tiny_cfgs,
)

torch.set_num_threads(1)
EOS, PAD = 2, 3
NEW = 6


def _variant(owl, int8):
    """(JAX model, JAX params, JAX qscales or None, port model, batch,
    video): the fixture's float model, or its decoder quantized with its
    tied embedding and an int8 cache (the port loaded from JAX's int8
    tree)."""
    jm, params, tm, batch, video = owl
    if not int8:
        return jm, jax.tree.map(jnp.asarray, params), None, tm, batch, video
    jcfg, tcfg = tiny_cfgs(kv_cache_dtype="int8")
    qdec, scales = jax.device_get(quantize_gpt3_decoder(
        params["text_decoder"], include_embedding=True))
    qparams = dict(params, text_decoder=qdec)
    tm8 = bridge.load_jax_params(towl.MPLUGOwlVideo(tcfg, FP32_POLICY),
                                 qparams, qscales={"text_decoder": scales})
    return (jowl.MPLUGOwlVideo(jcfg, policy=J_FP32),
            jax.tree.map(jnp.asarray, qparams),
            jax.tree.map(jnp.asarray, scales), tm8, batch, video)


def _both(jm, jparams, qscales, tm, batch, video, beam):
    """JAX's and the port's generate_instruct on the same inputs:
    (JAX's sequences and scores, the port's output dict)."""
    keys = ("input_ids", "media_mask", "prompt_len")
    want = jowl.generate_instruct(
        jm, jparams, jnp.asarray(video),
        *(jnp.asarray(batch[k]) for k in keys),
        JGen(max_new_tokens=NEW, eos_id=EOS, pad_id=PAD, beam_size=beam),
        qscales=qscales)
    got = towl.generate_instruct(
        tm, _t(video), _t(batch["input_ids"]).long(),
        _t(batch["media_mask"]), _t(batch["prompt_len"]),
        GenerationConfig(max_new_tokens=NEW, eos_id=EOS, pad_id=PAD,
                         beam_size=beam))
    return (np.asarray(want["sequences"]), np.asarray(want["scores"])), got


@pytest.mark.parametrize("int8", [False, True])
def test_generate_instruct_greedy_matches_jax(owl, int8):
    jm, jparams, qscales, tm, batch, video = _variant(owl, int8)
    (want, _), got = _both(jm, jparams, qscales, tm, batch, video, 1)
    forced = _forced_logits(jm, jparams, tm, video, batch, want, qscales)
    assert _check_served(got["sequences"], want, forced) == 0
    assert got["nonfinite_logits"] == 0
    assert len({tuple(r) for r in want}) > 1  # not degenerate


def _jax_scores(jm, jparams, qscales, video, batch, seqs):
    """Each sequence's sum of log-probabilities under JAX's decoder,
    teacher-forced through its full causal forward: the tokens before
    the first pad, plus the eos that closed the hypothesis where pads
    follow (a finished beam's sequence holds no eos)."""
    task_vars = {"params": jparams}
    dec_vars = {"params": jparams["text_decoder"]}
    if qscales is not None:
        task_vars["qscales"] = {"text_decoder": qscales}
        dec_vars["qscales"] = qscales
    emb = jm.apply(task_vars, jnp.asarray(batch["input_ids"]),
                   jnp.asarray(batch["media_mask"]),
                   jm.apply(task_vars, jnp.asarray(video),
                            method=jowl.MPLUGOwlVideo.encode_video),
                   method=jowl.MPLUGOwlVideo.spliced_embeds)
    dec = JBloomLM(jm.cfg.text, policy=jm.policy)
    out = []
    for i, row in enumerate(seqs):
        n = int(batch["prompt_len"][i])
        kept = [int(t) for t in row[:int(np.argmax(row == PAD))]] \
            if (row == PAD).any() else [int(t) for t in row]
        targets = kept + ([EOS] if len(kept) < len(row) else [])
        fed = jnp.asarray(targets[:-1], jnp.int32)
        e = jnp.concatenate([emb[i, :n], dec.apply(
            dec_vars, fed, method=JBloomLM.embed)])[None]
        logits = dec.apply(dec_vars, input_embeds=e,
                           return_logits=True)["logits"][0, n - 1:]
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        out.append(float(sum(logp[j, t] for j, t in enumerate(targets))))
    return np.asarray(out)


@pytest.mark.parametrize("int8", [False, True])
def test_generate_instruct_beam_matches_jax(owl, int8):
    """Beam 3 over the Bloom decoder's cache (the float tensor or the int8
    dict, reordered past the prefill rows): JAX's sequences and its
    scores within TOL; at fp32 each score is its sequence's
    teacher-forced sum (an int8 cache rounds K and V, which the cacheless
    forward does not)."""
    jm, jparams, qscales, tm, batch, video = _variant(owl, int8)
    (want, want_scores), got = _both(jm, jparams, qscales, tm, batch,
                                     video, 3)
    np.testing.assert_array_equal(got["sequences"].numpy(), want)
    _close(got["scores"], want_scores)
    if not int8:
        _close(want_scores, _jax_scores(jm, jparams, qscales, video, batch,
                                        want))
    assert got["nonfinite_logits"] == 0 and got["decode_steps"] >= 1


@pytest.mark.parametrize("int8", [False, True])
def test_batched_greedy_matches_the_engine(owl, int8):
    """The lock-step batch and the continuous-batching engine (two slots
    for three requests) give the same greedy tokens."""
    _, _, _, tm, batch, video = _variant(owl, int8)
    cfg = GenerationConfig(max_new_tokens=NEW, eos_id=EOS, pad_id=PAD,
                           beam_size=1)
    batched, stats, out = tcli.generate_batched(tm, _t(video), batch, cfg)
    engine, _, _ = tcli.serve_instruct(tm, _t(video), batch, cfg,
                                       num_slots=2)
    np.testing.assert_array_equal(batched, engine)
    assert stats["kv_cache_dtype"] == ("int8" if int8 else "float32")
    assert stats["decode_steps"] == out["decode_steps"] >= 1
    assert stats["new_tokens"] == int((batched != PAD).sum())


def test_build_prefix_with_prompt_embeds_matches_jax():
    """Right-aligned prompt embeddings, no query prefix: the embeddings,
    ``valid_from`` and the position offset."""
    rng = np.random.default_rng(7)
    ids = rng.integers(4, 100, (3, 9)).astype(np.int32)
    plen = np.array([9, 4, 6], np.int32)
    emb = rng.normal(size=(3, 9, 5)).astype(np.float32)
    want = jgen._build_prefix(None, None, jnp.asarray(ids),
                              jnp.asarray(plen), None, PAD,
                              prompt_embeds=jnp.asarray(emb))
    got = tgen._build_prefix(None, _t(ids).long(), _t(plen), None, PAD,
                             prompt_embeds=_t(emb))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _runners(tmp_path, monkeypatch, params, **yaml_keys):
    """``run(module, extra)``: the JAX or the port runner's serving on a
    tiny YAML, three questions, a built tokenizer.json and the fixture's
    weights in both (each runner's own init replaced by them), fp32."""
    tok = write_tokenizer_dir(tmp_path / "tok", 120, byte_level=False)
    path = tmp_path / "owl.yaml"
    path.write_text(yaml.safe_dump(dict(TINY, max_new_tokens=NEW,
                                        **yaml_keys)))
    rows = [{"video": "a.mp4", "question": "What is in the video?"},
            {"video": "b.mp4", "question": "What happens next?"},
            {"video": "c.mp4", "question": "一只猫在公园里跑步吗？"}]
    jsonl = tmp_path / "qa.jsonl"
    jsonl.write_text("".join(json.dumps(r, ensure_ascii=False) + "\n"
                             for r in rows))
    monkeypatch.setattr(jowl.MPLUGOwlVideo, "init", lambda self, *a, **k: {
        "params": jax.tree.map(jnp.asarray, params)})
    monkeypatch.setattr(tcli, "seeded_init", lambda model, seed:
                        bridge.load_jax_params(model, params))

    def run(module, name, extra=()):
        out = tmp_path / name
        module.main(module.parser().parse_args([
            "--config", str(path), "--output_dir", str(out),
            "--synthetic_data", "--input_jsonl", str(jsonl), "--tokenizer",
            str(tok), "--fp32", *extra]))
        return json.loads((out / "instruct_results.json").read_text())
    return run


@pytest.mark.parametrize("beam", [1, 3])
def test_run_instruct_answers_match_the_jax_runner(owl, tmp_path,
                                                   monkeypatch, beam):
    """Text for text: the port's answers are the JAX runner's (its
    tokenizer is ``AutoTokenizer`` over the same files), and each is the
    decode of the port's kept tokens."""
    run = _runners(tmp_path, monkeypatch, owl[1], beam_size=beam)
    want = run(jcli, "jax")
    got = run(tcli, "port", ["--device", "cpu"])
    assert [r["answer"] for r in got] == [r["answer"] for r in want]
    assert [r["video"] for r in got] == ["a.mp4", "b.mp4", "c.mp4"]
    assert any(r["answer"] for r in got)
    tok = tcli.HFTokenizer(str(tmp_path / "tok"))
    for r in got:
        assert r["answer"] == tok.decode(r["tokens"]).strip()
        assert PAD not in r["tokens"] and EOS not in r["tokens"]


def test_run_instruct_sampled_answers_follow_the_seed(owl, tmp_path,
                                                      monkeypatch):
    """Sampling (top_k 5, top_p 0.9) on the batched path draws from the
    ``--seed + 1`` generator: the same seed gives the same answers.  (Its
    draws cannot be JAX's: ``jax.random`` against a torch generator; the
    filter is held to JAX's in tests/test_torch_decode_modes.py.)"""
    run = _runners(tmp_path, monkeypatch, owl[1], do_sample=True, top_k=5,
                   top_p=0.9)
    first = run(tcli, "a", ["--device", "cpu"])
    again = run(tcli, "b", ["--device", "cpu"])
    assert [r["tokens"] for r in first] == [r["tokens"] for r in again]
    assert [r["answer"] for r in first] == [r["answer"] for r in again]
    assert any(r["tokens"] for r in first)
