"""The serve CLI under (data, model) splits on CPU processes over gloo,
against the unsharded port and the JAX package.

One world is started per world size (2 ranks: splits (2,1) and (1,2); 4
ranks: (2,2), (1,4) and (4,1)), each rank running
``tests/torch_mesh_worker.py`` over every split of its world; the
unsharded (1,1) runs in this process, without a process group.  The
loader's batch is 8 of the 16 clips, the flagship serve YAML's ratio, so
a (4,1) data rank's shard of 4 clips is shorter than one batch.  At fp32 on a tiny model whose vision tower has
4 heads of 64 (its temporal attention takes the packed kernel's route,
and at model = 4 the local head takes the head-major one) and whose
decoder has 4 heads of 32 and a 512-token vocab (split 2 and 4 ways):

- each split's merged captions are (1,1)'s, request for request, and
  JAX's engine decodes the same greedy tokens from JAX's encoder on the
  same seeded weights;
- the logits of the prefill and the first decode step are within 1e-4
  of JAX's (relative and absolute), the query features within 1e-4 of
  their largest magnitude;
- under (2,2) the data ranks serve disjoint requests (4 and 3 of 7) and
  the model ranks of a data rank identical tokens; under (4,1) each data
  rank serves its stride (2, 2, 2 and 1 of 7) from a shard shorter than
  a batch;
- sampled tokens under (1,2) are the same on both model ranks and equal
  (1,1)'s for the same seed.

Every process group has an explicit timeout; a world that outlives its
deadline is terminated and the test fails.
"""

import json
import os
import subprocess
import sys
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from youku_mplug_tpu.config import load_config as j_load_config
from youku_mplug_tpu.models import gpt3 as jgpt3
from youku_mplug_tpu.models import tasks as jtasks
from youku_mplug_tpu.models.generation import GenerationConfig as JGen
from youku_mplug_tpu.models.generation import _build_prefix as j_prefix
from youku_mplug_tpu.runtime.precision import FP32_POLICY as J_FP32
from youku_mplug_tpu.serving.engine import ServingEngine as JEngine
from youku_mplug_tpu_torch import bridge

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_worker as worker  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-4
DEADLINE_S = 300  # a world's processes, all splits
REPO = worker.REPO
TINY = dict(
    text_overrides=dict(vocab_size=512, hidden_size=128,
                        num_hidden_layers=2, num_attention_heads=4,
                        max_position_embeddings=256),
    visual_overrides=dict(img_size=128, patch_size=16, embed_dim=256,
                          depth=2, num_heads=4, mlp_ratio=2),
    batch_size=8, num_workers=0, max_length=32, num_frames=2,
    image_res=128, num_learnable_token=8, synthetic_length=16,
    max_new_tokens=6)
WORLDS = {2: [("2x1", False), ("1x2", True)],
          4: [("2x2", False), ("1x4", False), ("4x1", False)]}
SPLITS = [tag for splits in WORLDS.values() for tag, _ in splits]


def _yaml(d, tag):
    data, model = map(int, tag.split("x"))
    path = os.path.join(d, f"mesh_{tag}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({**TINY, "mesh": {"data": data, "model": model}}, f)
    return path


def spawn(mode, world, out, spec, deadline=DEADLINE_S):
    """``world`` gloo ranks of ``torch_mesh_worker.py``; fails (after
    terminating every rank) on a rank's error or past ``deadline``."""
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                            "")}
    rdv = os.path.join(out, f"rendezvous_{mode}_{world}")
    procs = [subprocess.Popen(
        [sys.executable, worker.__file__, mode, str(r), str(world), rdv,
         out, json.dumps(spec)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=deadline)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"a {world}-rank {mode} world outlived {deadline} s")
    bad = [(r, p.returncode, log[-3000:]) for r, (p, log)
           in enumerate(zip(procs, logs)) if p.returncode != 0]
    assert not bad, bad


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every split's outputs: {tag: (merged results, {rank: forced},
    {rank: sampled}, {rank: rank stats})}, (1,1) run here."""
    d = str(tmp_path_factory.mktemp("serve_mesh"))
    for world, splits in WORLDS.items():
        spawn("serve", world, d, [
            {"tag": tag, "yaml": _yaml(d, tag), "sample": sample}
            for tag, sample in splits])
    base = worker.run_split("1x1", _yaml(d, "1x1"), d, sample=True)
    out = {}
    for tag in ["1x1"] + SPLITS:
        td = os.path.join(d, tag)
        ranks = int(tag[0]) * int(tag[2]) if tag != "1x1" else 1
        with open(os.path.join(td, "serve_results.json")) as f:
            merged = json.load(f)
        forced = {r: dict(np.load(os.path.join(td, f"rank{r}.npz")))
                  for r in range(ranks)}
        sampled = {}
        for r in range(ranks):
            with open(os.path.join(td, f"rank{r}_sampled.json")) as f:
                sampled[r] = json.load(f)
        stats = {}
        for r in range(ranks if tag != "1x1" else 0):
            with open(os.path.join(td, "ranks", f"rank{r}.json")) as f:
                stats[r] = json.load(f)
        out[tag] = (merged, forced, sampled, stats)
    out["yaml"] = _yaml(d, "1x1")
    out["base"] = base
    return out


@pytest.fixture(scope="module")
def jax_ref(runs):
    """JAX's encoder and decoder on the (1,1) port model's weights: query
    features, the two steps' logits (fed the port's first greedy token)
    and the engine's greedy tokens for every request."""
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
    lm_params = jax.tree.map(jnp.asarray, tree["text_decoder"])
    prompt, prompt_len, gen = serve._prompt(cfg)
    b = worker.FORCED
    ids = jnp.asarray([prompt] * b, jnp.int32)
    plen = jnp.full((b,), max(prompt_len, 1), jnp.int32)
    embeds, vf, po = j_prefix(jlm, lm_params, ids, plen,
                              jnp.asarray(qe[:b]), gen.pad_id)
    nq = qe.shape[1]
    cache = jlm.apply({"params": lm_params}, b, nq + ids.shape[1] + 4,
                      method=jgpt3.GPT3LM.init_cache)
    step = jax.jit(lambda e, c, cl: jlm.apply(
        {"params": lm_params}, e, c, cl, vf, po,
        method=jgpt3.GPT3LM.decode_step))
    first, cache = step(embeds, cache, jnp.int32(0))
    tok = jnp.asarray(runs["base"][0]["tok"], jnp.int32)
    emb = jlm.apply({"params": lm_params}, tok[:, None],
                    method=jgpt3.GPT3LM.embed)
    second, _ = step(emb, cache,
                     jnp.full((b,), nq + ids.shape[1], jnp.int32))
    eng = JEngine(jlm, lm_params, num_slots=worker.SLOTS,
                  max_len=nq + 8 + gen.max_new_tokens + 1,
                  prefill_buckets=(8,),
                  config=JGen(max_new_tokens=gen.max_new_tokens,
                              eos_id=gen.eos_id, pad_id=gen.pad_id))
    for row in qe:
        eng.submit(prompt, query_embeds=row)
    tokens = [t for _, t in sorted((f.rid, f.tokens)
                                   for f in eng.run_to_completion())]
    return {"qe": qe[:b], "first": np.asarray(first),
            "second": np.asarray(second), "tokens": tokens}


def _close(got, want, key):
    """Logits within TOL (relative and absolute); query features within
    TOL of their largest magnitude."""
    if key == "qe":
        err = np.abs(got - want).max()
        assert err <= TOL * np.abs(want).max(), (err, np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_unsharded_port_matches_jax(runs, jax_ref):
    merged, forced, _, _ = runs["1x1"]
    for key in ("qe", "first", "second"):
        _close(forced[0][key], jax_ref[key], key)
    assert [r["tokens"] for r in merged] == jax_ref["tokens"]
    assert len({tuple(t) for t in jax_ref["tokens"]}) > 1  # not degenerate


@pytest.mark.parametrize("tag", SPLITS)
def test_split_captions_equal_unsharded_and_jax(runs, jax_ref, tag):
    merged, _, _, stats = runs[tag]
    base = runs["1x1"][0]
    assert [r["video_id"] for r in merged] == [r["video_id"] for r in base]
    assert [r["caption"] for r in merged] == [r["caption"] for r in base]
    assert [r["tokens"] for r in merged] == jax_ref["tokens"]
    assert all(s["split"] == {"data": int(tag[0]), "model": int(tag[2])}
               for s in stats.values())
    assert all(s["graph_replays"] == 0 for s in stats.values())


@pytest.mark.parametrize("tag", SPLITS)
def test_split_first_step_logits_match_jax(runs, jax_ref, tag):
    _, forced, _, _ = runs[tag]
    for got in forced.values():
        for key in ("qe", "first", "second"):
            _close(got[key], jax_ref[key], key)
            # every rank holds the gathered values, bitwise alike
            np.testing.assert_array_equal(got[key], forced[0][key])


def test_data_ranks_serve_disjoint_requests_and_model_ranks_agree(runs):
    _, _, _, stats = runs["2x2"]
    by_data = {}
    for s in stats.values():
        d, m = s["coord"]
        by_data.setdefault(d, {})[m] = [(r["index"], r["tokens"])
                                        for r in s["results"]]
    assert sorted(by_data) == [0, 1]
    for d, ranks in by_data.items():
        assert ranks[0] == ranks[1]  # the model ranks' tokens
        assert [i for i, _ in ranks[0]] == list(
            range(d, worker.REQUESTS, 2))
    assert {i for i, _ in by_data[0][0]}.isdisjoint(
        {i for i, _ in by_data[1][0]})


def test_sampled_tokens_agree_across_model_ranks_and_unsharded(runs):
    base = runs["1x1"][2][0]
    got = runs["1x2"][2]
    assert got[0] == got[1] == base
    assert len({tuple(t) for t in base}) > 1


def test_rank_stats_count_each_rank_and_merged_requests_once(runs):
    for tag in SPLITS:
        merged, _, _, stats = runs[tag]
        assert len(merged) == worker.REQUESTS
        served = {}
        for s in stats.values():
            if s["coord"][1] == 0:
                for r in s["results"]:
                    served[r["index"]] = served.get(r["index"], 0) + 1
        assert served == {i: 1 for i in range(worker.REQUESTS)}


def test_short_data_shards_serve_their_stride(runs):
    """(4,1): each data rank's shard (4 clips) is shorter than a batch (8);
    it keeps that partial batch and serves its stride of the 7 requests."""
    merged, _, _, stats = runs["4x1"]
    assert sorted(s["coord"][0] for s in stats.values()) == [0, 1, 2, 3]
    for s in stats.values():
        d = s["coord"][0]
        assert [r["index"] for r in s["results"]] == list(
            range(d, worker.REQUESTS, 4))
        assert all(r["tokens"] for r in s["results"])
    assert len(merged) == worker.REQUESTS


@pytest.mark.parametrize("data", [2, 3, 4, 5])
def test_clip_batches_cover_each_data_ranks_requests(tmp_path, data):
    """Every data rank's batches hold its ``local_requests`` share of the
    run's requests, in the run's order, however short its shard; the run
    serves the unsharded loader's full batches (16 clips, batch 8)."""
    from youku_mplug_tpu_torch.cli import serve
    from youku_mplug_tpu_torch.config import load_config
    from youku_mplug_tpu_torch.runtime.mesh import Mesh

    args = worker.serve_args(_yaml(str(tmp_path), "1x1"), str(tmp_path))
    args.num_requests = 16
    cfg = load_config(args.config)
    ds = serve.run_caption.dataset(args, cfg, train=False)
    n = serve.run_requests(args, cfg, ds)
    assert n == 16
    got = []
    for r in range(data):
        mesh = Mesh(data, 1, r)
        ids = [int(v) for _, vids in serve.clip_batches(args, cfg, mesh, ds)
               for v in vids]
        k = serve.local_requests(n, mesh)
        assert ids[:k] == list(range(r, n, data))
        got += ids[:k]
    assert sorted(got) == list(range(n))
    args.num_requests = 20  # past the full batches: the run serves 16
    assert serve.run_requests(args, cfg, ds) == 16


def test_a_data_rank_short_of_its_requests_raises():
    from youku_mplug_tpu_torch.cli import serve
    from youku_mplug_tpu_torch.runtime.mesh import Mesh

    serve._short(Mesh(4, 1, 3), 2, 2)
    with pytest.raises(RuntimeError, match="data rank 3 of 4 served 1 of "
                                           "its 2 requests"):
        serve._short(Mesh(4, 1, 3), 1, 2)
