"""Speculative decoding on the port (``serving/speculative.py``) against
the JAX package at fp32 on the CPU, weights carried over by the bridge:
greedy ``speculative_generate`` with a twin draft (the target's first
layer, views of its weights) and ``ngram_speculative_generate`` give the
JAX functions' sequences, with and without a visual prefix; a perfect
draft accepts everything; ``_spec_accept``'s first committed token follows
the target distribution; ``_ngram_propose`` equals JAX's on drawn
histories; and the CLIs that expose speculation (``serve --speculative``,
``run_instruct --lookup_k``) and sampling finish on tiny configs."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from hypothesis import given, settings
from hypothesis import strategies as hs

from __graft_entry__ import _flagship_cfg
from youku_mplug_tpu.models import gpt3 as jgpt3
from youku_mplug_tpu.models.generation import GenerationConfig as JGen
from youku_mplug_tpu.runtime.precision import FP32_POLICY as J_FP32
from youku_mplug_tpu.serving import speculative as jspec
from youku_mplug_tpu_torch import bridge
from youku_mplug_tpu_torch.cli import run_instruct, serve
from youku_mplug_tpu_torch.config import flagship_config
from youku_mplug_tpu_torch.models import gpt3 as tgpt3
from youku_mplug_tpu_torch.models.generation import GenerationConfig
from youku_mplug_tpu_torch.runtime.precision import FP32_POLICY
from youku_mplug_tpu_torch.serving import speculative as tspec
from tests.hf_tokenizer_files import write_tokenizer_dir

torch.set_num_threads(1)
V = 256  # the tiny flagship's vocab


def redraw(tree, rng, std=0.3):
    def leaf(path, x):
        z = rng.normal(size=x.shape).astype(np.float32)
        return 1.0 + 0.1 * z if str(path[-1].key).endswith("scale") \
            else std * z
    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def models():
    """JAX and port tiny GPT-3 targets with the same redrawn weights, and
    JAX's one-layer twin parameters (``cli/serve.py``'s slicing)."""
    cfg = _flagship_cfg(tiny=True).text
    jlm = jgpt3.GPT3LM(cfg, policy=J_FP32)
    params = redraw(jax.eval_shape(lambda: jlm.init(
        jax.random.key(0), jnp.zeros((1, 4), jnp.int32)))["params"],
        np.random.default_rng(0))
    params = jax.tree.map(jnp.asarray, params)
    tlm = bridge.load_jax_params(
        tgpt3.GPT3LM(flagship_config(tiny=True).text, FP32_POLICY), params)
    depth = cfg.num_hidden_layers
    jdraft = jgpt3.GPT3LM(dataclasses.replace(cfg, num_hidden_layers=1),
                          policy=J_FP32)
    dparams = jax.tree.map(
        lambda x: x[:1] if x.ndim > 0 and x.shape[0] == depth else x, params)
    return jlm, params, jdraft, dparams, tlm


def _prompts(seed, b, p, lens):
    rng = np.random.default_rng(seed)
    return rng.integers(3, V, (b, p)).astype(np.int32), \
        np.asarray(lens, np.int32), rng


def _cfgs(max_new):
    return (JGen(max_new_tokens=max_new, eos_id=2, pad_id=0, beam_size=1),
            GenerationConfig(max_new_tokens=max_new, eos_id=2, pad_id=0))


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("k", [1, 3])
def test_twin_draft_speculation_matches_jax(models, k):
    jlm, params, jdraft, dparams, tlm = models
    prompt, plen, _ = _prompts(k, 3, 7, [7, 4, 6])
    jcfg, tcfg = _cfgs(12)
    want = jspec.speculative_generate(
        jlm, params, jdraft, dparams, jnp.asarray(prompt), jnp.asarray(plen),
        config=jcfg, speculate_len=k)["sequences"]
    draft = tspec.twin_draft(tlm, 1)
    out = tspec.speculative_generate(tlm, draft, _t(prompt).long(),
                                     _t(plen), config=tcfg, speculate_len=k)
    np.testing.assert_array_equal(out["sequences"].numpy(), np.asarray(want))
    assert out["rounds"] >= 1 and out["tokens_per_round"] >= 1.0


def test_twin_draft_shares_the_target_weights(models):
    *_, tlm = models
    draft = tspec.twin_draft(tlm, 1)
    assert draft.cfg.num_hidden_layers == 1
    for name, p in draft.named_parameters():
        src = dict(tlm.named_parameters())[name]
        assert p.data_ptr() == src.data_ptr(), name
        assert p.shape == (src.shape if not name.startswith(
            "decoder.layers.") else (1,) + src.shape[1:])
    with pytest.raises(ValueError, match="outside"):
        tspec.twin_draft(tlm, 3)


def test_perfect_draft_accepts_everything(models):
    """draft == target: every proposal agrees, each round commits k
    tokens (the bonus forgone), the sequences are JAX's greedy ones."""
    jlm, params, _, _, tlm = models
    prompt, plen, _ = _prompts(1, 2, 5, [5, 3])
    jcfg, tcfg = _cfgs(10)
    want = jspec.speculative_generate(
        jlm, params, jlm, params, jnp.asarray(prompt), jnp.asarray(plen),
        config=jcfg, speculate_len=4)
    out = tspec.speculative_generate(tlm, tlm, _t(prompt).long(), _t(plen),
                                     config=tcfg, speculate_len=4)
    np.testing.assert_array_equal(out["sequences"].numpy(),
                                  np.asarray(want["sequences"]))
    assert out["rounds"] == int(want["rounds"]) <= 3
    assert out["tokens_per_round"] > 2.0


@pytest.mark.parametrize("k,n", [(2, 1), (2, 2), (8, 1), (8, 2)])
def test_ngram_speculation_matches_jax(models, k, n):
    jlm, params, _, _, tlm = models
    prompt, plen, _ = _prompts(7 + k + n, 3, 9, [9, 5, 7])
    jcfg, tcfg = _cfgs(14)
    want = jspec.ngram_speculative_generate(
        jlm, params, jnp.asarray(prompt), jnp.asarray(plen), config=jcfg,
        speculate_len=k, ngram=n)
    out = tspec.ngram_speculative_generate(
        tlm, _t(prompt).long(), _t(plen), config=tcfg, speculate_len=k,
        ngram=n)
    np.testing.assert_array_equal(out["sequences"].numpy(),
                                  np.asarray(want["sequences"]))
    assert out["rounds"] == int(want["rounds"])
    assert out["tokens_per_round"] == pytest.approx(
        float(want["tokens_per_round"]))


def test_speculation_with_query_embeds_matches_jax(models):
    """A visual prefix feeds the target (the draft reads the text alone)."""
    jlm, params, jdraft, dparams, tlm = models
    prompt, plen, rng = _prompts(9, 2, 6, [6, 4])
    qe = rng.normal(size=(2, 3, 64)).astype(np.float32)
    jcfg, tcfg = _cfgs(10)
    for twin in (True, False):
        if twin:
            want = jspec.speculative_generate(
                jlm, params, jdraft, dparams, jnp.asarray(prompt),
                jnp.asarray(plen), config=jcfg, speculate_len=3,
                query_embeds=jnp.asarray(qe))
            got = tspec.speculative_generate(
                tlm, tspec.twin_draft(tlm, 1), _t(prompt).long(), _t(plen),
                config=tcfg, speculate_len=3, query_embeds=_t(qe))
        else:
            want = jspec.ngram_speculative_generate(
                jlm, params, jnp.asarray(prompt), jnp.asarray(plen),
                config=jcfg, speculate_len=4, ngram=2,
                query_embeds=jnp.asarray(qe))
            got = tspec.ngram_speculative_generate(
                tlm, _t(prompt).long(), _t(plen), config=tcfg,
                speculate_len=4, ngram=2, query_embeds=_t(qe))
        np.testing.assert_array_equal(got["sequences"].numpy(),
                                      np.asarray(want["sequences"]))


def test_spec_accept_marginal_is_the_target_distribution():
    """Monte-Carlo check of the rejection-sampling core, 6*10^4 samples
    in one batch: the first committed token's law is the target's
    whatever the draft's (4-sigma band per bucket)."""
    vocab, k, n = 7, 3, 60000
    g = torch.Generator().manual_seed(0)
    p_t = torch.softmax(torch.tensor(
        [[2.0, 0.5, 0.0, -1.0, 1.0, -2.0, 0.3],
         [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
         [1.0, 1.0, -3.0, 2.0, 0.0, 0.0, 0.0],
         [0.5, -0.5, 0.5, -0.5, 0.5, -0.5, 0.5]]), -1)
    p_d = torch.softmax(torch.tensor(
        [[-2.0, 1.0, 1.0, 1.0, -1.0, 2.0, 0.0],
         [1.0, -1.0, 0.0, 0.0, 2.0, 0.0, -1.0],
         [0.0, 0.0, 3.0, -1.0, 1.0, 0.0, 1.0]]), -1)
    drafts = torch.multinomial(p_d, n, replacement=True, generator=g).T
    commit, n_commit = tspec._spec_accept(
        g, drafts.int(), p_d.expand(n, k, vocab), p_t.expand(n, k + 1, vocab))
    emp = np.bincount(commit[:, 0].numpy(), minlength=vocab) / n
    sigma = np.sqrt(p_t[0].numpy() * (1 - p_t[0].numpy()) / n)
    np.testing.assert_allclose(emp, p_t[0].numpy(),
                               atol=float((4 * sigma).max()) + 1e-3)
    assert 1.0 < float(n_commit.float().mean()) < k + 1
    assert int(n_commit.max()) <= k


def test_speculative_sampling_runs_and_terminates(models):
    *_, tlm = models
    prompt, plen, _ = _prompts(3, 2, 5, [5, 4])
    cfg = GenerationConfig(max_new_tokens=8, eos_id=2, pad_id=0,
                           do_sample=True, top_k=0, top_p=1.0)
    out = tspec.speculative_generate(
        tlm, tspec.twin_draft(tlm, 1), _t(prompt).long(), _t(plen),
        config=cfg, speculate_len=3, generator=torch.Generator().manual_seed(
            11))
    seqs = out["sequences"].numpy()
    assert seqs.shape == (2, 8) and seqs.min() >= 0 and seqs.max() < V
    for row in seqs:  # after an eos the tail is pad
        hits = np.flatnonzero(row == 2)
        if hits.size:
            assert (row[hits[0] + 1:] == 0).all()
    with pytest.raises(ValueError, match="greedy"):
        tspec.ngram_speculative_generate(tlm, _t(prompt).long(), _t(plen),
                                         config=cfg)


@settings(max_examples=60, deadline=None)
@given(data=hs.data(), n=hs.integers(1, 3), k=hs.integers(1, 5))
def test_ngram_propose_matches_jax(data, n, k):
    b, length = 2, 12
    hist = np.asarray(data.draw(hs.lists(hs.integers(0, 3), min_size=b * length,
                                         max_size=b * length)),
                      np.int32).reshape(b, length)
    lo = np.asarray([data.draw(hs.integers(0, 4)) for _ in range(b)],
                    np.int32)
    cur = np.asarray([data.draw(hs.integers(int(x) + 1, length))
                      for x in lo], np.int32)
    want = jspec._ngram_propose(jnp.asarray(hist), jnp.asarray(cur), n, k,
                                jnp.asarray(lo))
    got = tspec._ngram_propose(_t(hist), _t(cur), n, k, _t(lo))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the entry points on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draft", ["twin", "ngram"])
def test_serve_cli_speculative_runs_on_cpu(tmp_path, draft):
    args = serve.serve_parser().parse_args([
        "--config", "configs/pretrain_tiny.yaml", "--synthetic_data",
        "--num_requests", "3", "--output_dir", str(tmp_path), "--device",
        "cpu", "--speculative", "3", "--draft", draft])
    stats = serve.main(args)
    assert stats["requests"] == 3 and stats["speculative_k"] == 3
    assert stats["draft"] == draft and stats["tokens_per_round"] >= 1.0
    assert stats["draft_layers"] == (1 if draft == "twin" else 0)
    out = json.loads((tmp_path / "serve_results.json").read_text())
    assert [r["video_id"] for r in out] == ["0", "1", "2"]
    assert all(1 <= r["n_tokens"] <= 32 for r in out)
    # the same tokens as the engine's greedy serving
    engine_args = serve.serve_parser().parse_args([
        "--config", "configs/pretrain_tiny.yaml", "--synthetic_data",
        "--num_requests", "3", "--output_dir", str(tmp_path / "e"),
        "--device", "cpu"])
    cfg, model, device = serve.build(engine_args)
    _, greedy, _ = serve.run(engine_args, cfg, model, device)
    assert [r["tokens"] for r in out] == [r["tokens"] for r in greedy]


def test_run_instruct_lookup_and_sampling_on_cpu(tmp_path):
    """``--engine --lookup_k 3`` gives the greedy tokens;
    ``do_sample`` with top_k draws from the seed + 1 generator: the same
    seed, the same tokens.  The prompts go through a tokenizer.json the
    test builds, so their ids (and with them whether the first sampled
    token is eos) are the same in every process, whatever
    PYTHONHASHSEED is (the whitespace tokenizer hashes words with
    Python's salted string hash)."""
    tok = write_tokenizer_dir(tmp_path / "tok", 120, byte_level=False)

    def run(extra, **yaml_keys):
        path = tmp_path / "owl.yaml"
        raw = yaml.safe_load(open("configs/instruct/serve_owl_tiny.yaml"))
        path.write_text(yaml.safe_dump(dict(raw, **yaml_keys)))
        out = tmp_path / str(len(list(tmp_path.iterdir())))
        results, stats = run_instruct.main(run_instruct.parser().parse_args(
            ["--config", str(path), "--synthetic_data", "--engine",
             "--device", "cpu", "--output_dir", str(out), "--tokenizer",
             str(tok)] + extra))
        assert stats["nonfinite_logits"] == 0
        return [r["tokens"] for r in results], stats

    greedy, _ = run([])
    assert run(["--lookup_k", "3"])[0] == greedy
    sampled, stats = run([], do_sample=True, top_k=5)
    assert stats["new_tokens"] > 0
    assert run([], do_sample=True, top_k=5)[0] == sampled
    assert run_instruct.generation_config(
        run_instruct.parser().parse_args(["--config", "x"]),
        run_instruct.load_owl_config(
            "configs/instruct/serve_bloomz_7b_sample.yaml")[0],
        run_instruct.load_owl_config(
            "configs/instruct/serve_bloomz_7b_sample.yaml")[1]) == \
        GenerationConfig(max_new_tokens=64, eos_id=2, pad_id=3,
                         do_sample=True, top_k=5, top_p=0.9, beam_size=1)
