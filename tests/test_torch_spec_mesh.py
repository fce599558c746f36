"""Speculative serving and prompt-lookup decoding on model shards, on CPU
processes over gloo, against the unsharded port and the JAX package.

Two worlds are started (2 ranks: split (1,2); 4 ranks: (2,2)), each rank
running ``tests/torch_mesh_worker.py``'s ``speculative`` mode on the
serve mesh tests' tiny model at fp32 (a decoder of 4 heads of 32 and a
512-token vocab, cut 2 ways); (1,1) runs in this process without a
process group.  Each split:

- serves the requests through ``serve --speculative 2 --draft twin`` (a
  one-layer twin, the same shard of the shallower decoder) and
  ``--speculative 3 --draft ngram``: the merged tokens are (1,1)'s greedy
  engine tokens, request for request, and JAX's engine's greedy tokens on
  the same seeded weights; under (2,2) each data rank decodes its stride;
- decodes every request through the engine's ``step_lookup`` (k = 3) on
  every rank: the greedy tokens again;
- builds the twin of its shard: its logits are the unsharded twin's
  within 1e-5 and bitwise alike on the model ranks, its attention holds
  the rank's heads and the target's model group;
- samples through ``speculative_generate`` (the twin draft, k = 2, the
  generator seeded by the data coordinate): the rounds end, the model
  ranks of a data rank commit the same tokens, and (1,2)'s are (1,1)'s;
- decodes the text prompt alone greedily with the twin of the whole
  decoder as the draft (the twin never reads the visual prefix, so the
  caption runs above commit one token a round): the rounds commit
  accepted drafts, and the tokens are (1,1)'s.

Every process group has an explicit timeout; a world that outlives its
deadline is terminated and the test fails.
"""

import json
import os
import sys
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from youku_mplug_tpu.config import load_config as j_load_config
from youku_mplug_tpu.models import gpt3 as jgpt3
from youku_mplug_tpu.models import tasks as jtasks
from youku_mplug_tpu.models.generation import GenerationConfig as JGen
from youku_mplug_tpu.runtime.precision import FP32_POLICY as J_FP32
from youku_mplug_tpu.serving.engine import ServingEngine as JEngine
from youku_mplug_tpu_torch import bridge

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_serve_mesh as serve_mesh  # noqa: E402
import torch_mesh_worker as worker  # noqa: E402

torch.set_num_threads(1)
TWIN_TOL = 1e-5
WORLDS = {2: ["1x2"], 4: ["2x2"]}
SPLITS = [tag for tags in WORLDS.values() for tag in tags]
DRAFTS = ("twin", "ngram")


def _ranks(tag):
    return int(tag[0]) * int(tag[2])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{tag: {"merged": {draft: merged results}, "ranks": {rank:
    record}, "logits": {rank: twin logits}}, "greedy": (1,1)'s engine
    tokens, "yaml": (1,1)'s YAML}; (1,1) run here."""
    from youku_mplug_tpu_torch.cli import serve

    d = str(tmp_path_factory.mktemp("spec_mesh"))
    for world, tags in WORLDS.items():
        serve_mesh.spawn("speculative", world, d, [
            {"tag": tag, "yaml": serve_mesh._yaml(d, tag)} for tag in tags])
    yaml_11 = serve_mesh._yaml(d, "1x1")
    worker.spec_split("1x1", yaml_11, d)
    greedy_dir = os.path.join(d, "1x1", "greedy")
    args = worker.serve_args(yaml_11, greedy_dir)
    with mock.patch.object(serve, "seeded_init", worker.seeded()):
        cfg, model, device = serve.build(args)
    serve.serve_built(args, cfg, model, device)
    out = {"yaml": yaml_11}
    with open(os.path.join(greedy_dir, "serve_results.json")) as f:
        out["greedy"] = [r["tokens"] for r in json.load(f)]
    for tag in ["1x1"] + SPLITS:
        td, n = os.path.join(d, tag), _ranks(tag)
        rec = {"merged": {}, "ranks": {}, "logits": {}}
        for draft in DRAFTS:
            with open(os.path.join(td, draft, "serve_results.json")) as f:
                rec["merged"][draft] = json.load(f)
        for r in range(n):
            with open(os.path.join(td, f"speculative_rank{r}.json")) as f:
                rec["ranks"][r] = json.load(f)
            rec["logits"][r] = np.load(os.path.join(
                td, f"twin_logits_rank{r}.npy"))
        if tag != "1x1":
            rec["stats"] = {}
            for r in range(n):
                with open(os.path.join(td, "twin", "ranks",
                                       f"rank{r}.json")) as f:
                    rec["stats"][r] = json.load(f)
        out[tag] = rec
    return out


@pytest.fixture(scope="module")
def jax_greedy(runs):
    """JAX's engine's greedy tokens of every request on the (1,1) port
    model's weights (the serve mesh tests' recipe)."""
    from youku_mplug_tpu_torch.cli import serve

    args = worker.serve_args(runs["yaml"], os.path.dirname(runs["yaml"]))
    with mock.patch.object(serve, "seeded_init", worker.seeded()):
        cfg, model, _ = serve.build(args)
    tree = bridge.to_jax_tree(model)
    jcfg = j_load_config(runs["yaml"]).model
    jm = jtasks.MPLUGVideo(jcfg, policy=J_FP32)
    video = jnp.asarray(worker.clips(cfg, worker.REQUESTS).numpy())
    qe = np.asarray(jm.apply({"params": tree}, video,
                             method=jtasks.MPLUGVideo.encode_video)[1])
    jlm = jgpt3.GPT3LM(jcfg.text, policy=J_FP32)
    prompt, _, gen = serve._prompt(cfg)
    eng = JEngine(jlm, jax.tree.map(jnp.asarray, tree["text_decoder"]),
                  num_slots=worker.SLOTS,
                  max_len=qe.shape[1] + 8 + gen.max_new_tokens + 1,
                  prefill_buckets=(8,),
                  config=JGen(max_new_tokens=gen.max_new_tokens,
                              eos_id=gen.eos_id, pad_id=gen.pad_id))
    for row in qe:
        eng.submit(prompt, query_embeds=row)
    return [t for _, t in sorted((f.rid, f.tokens)
                                 for f in eng.run_to_completion())]


def test_unsharded_greedy_is_jax_and_not_degenerate(runs, jax_greedy):
    assert runs["greedy"] == jax_greedy
    assert len({tuple(t) for t in jax_greedy}) > 1


@pytest.mark.parametrize("draft", DRAFTS)
@pytest.mark.parametrize("tag", ["1x1"] + SPLITS)
def test_speculative_serving_gives_the_greedy_tokens(runs, jax_greedy, tag,
                                                     draft):
    merged = runs[tag]["merged"][draft]
    assert [r["tokens"] for r in merged] == runs["greedy"] == jax_greedy
    assert len(merged) == worker.REQUESTS


@pytest.mark.parametrize("tag", SPLITS)
def test_whole_decoder_twin_commits_accepted_drafts_on_a_shard(runs, tag):
    """The twin of the whole decoder on the text prompt alone proposes
    the target's greedy tokens: its rounds commit accepted drafts (more
    than 1.5 tokens a round), and every rank's tokens are (1,1)'s."""
    base = runs["1x1"]["ranks"][0]
    assert base["whole_twin_tokens_per_round"] > 1.5
    for rec in runs[tag]["ranks"].values():
        assert rec["whole_twin"] == base["whole_twin"]
        assert rec["whole_twin_tokens_per_round"] == \
            base["whole_twin_tokens_per_round"]


@pytest.mark.parametrize("tag", SPLITS)
def test_speculative_data_ranks_decode_their_stride(runs, tag):
    """Each data rank decodes its stride of the requests (its rank file's
    own results), the model ranks of a data rank the same tokens."""
    data = int(tag[0])
    by_coord = {tuple(s["coord"]): s for s in runs[tag]["stats"].values()}
    assert sorted(by_coord) == [(d, m) for d in range(data)
                                for m in range(int(tag[2]))]
    for (d, m), s in by_coord.items():
        assert s["split"] == {"data": data, "model": int(tag[2])}
        assert s["graph_replays"] is None  # no engine: lock-step batches
        assert [r["index"] for r in s["results"]] == list(
            range(d, worker.REQUESTS, data))
        assert [r["tokens"] for r in s["results"]] == [
            r["tokens"] for r in by_coord[(d, 0)]["results"]]


@pytest.mark.parametrize("tag", ["1x1"] + SPLITS)
def test_step_lookup_gives_the_greedy_tokens_on_every_rank(runs, jax_greedy,
                                                           tag):
    for rec in runs[tag]["ranks"].values():
        assert rec["lookup"] == runs["greedy"] == jax_greedy


@pytest.mark.parametrize("tag", SPLITS)
def test_twin_of_a_shard_is_the_shard_of_the_twin(runs, tag):
    want = runs["1x1"]["logits"][0]
    heads = runs["1x1"]["ranks"][0]["heads"]
    for r, got in runs[tag]["logits"].items():
        np.testing.assert_allclose(got, want, rtol=TWIN_TOL, atol=TWIN_TOL)
        np.testing.assert_array_equal(got, runs[tag]["logits"][0])
        rec = runs[tag]["ranks"][r]
        assert rec["heads"] == heads // int(tag[2]) and rec["tp"]
    assert not runs["1x1"]["ranks"][0]["tp"]


@pytest.mark.parametrize("tag", SPLITS)
def test_sampled_speculation_ends_and_model_ranks_commit_alike(runs, tag):
    by_data = {}
    for rec in runs[tag]["ranks"].values():
        by_data.setdefault(rec["coord"][0], []).append(
            (rec["sampled"], rec["rounds"]))
    for recs in by_data.values():
        assert len(recs) == int(tag[2])
        assert all(r == recs[0] for r in recs)
        assert 0 < recs[0][1] <= worker.REQUESTS * 8
    if tag == "1x2":  # data coordinate 0: (1,1)'s generator seed
        base = runs["1x1"]["ranks"][0]
        assert by_data[0][0] == (base["sampled"], base["rounds"])
        assert len({tuple(t) for t in base["sampled"]}) > 1
