"""``run_instruct`` serving mPLUG-Owl under (data, model) splits on CPU
processes over gloo, against the unsharded port and the JAX package.

Two worlds run at once (2 ranks: splits (2,1) and (1,2); 4 ranks: (2,2)
and (1,4)), each rank running ``tests/torch_owl_mesh_worker.py`` over
every split of its world and every serving variant (the batched path
and the engine; greedy, beam 3 and sampled; an int8 KV cache; int8
weights; the engine with ``--lookup_k 3``); the unsharded (1,1) runs in
this process.  At fp32 on a tiny
Owl whose Bloom has 12 heads of 8 (a (1,2) rank holds heads 6-11, a
(1,4) rank heads 6-8: both straddle the ALiBi ladder's half-step branch
at head 8) and a 512-token vocab cut 2 and 4 ways:

- (1,1)'s media features and its prefill and first decode step's logits
  are within 1e-4 of JAX's ``MPLUGOwlVideo`` on the same seeded weights,
  and its greedy, beam and engine tokens (bf16-free, int8 cache too) are
  JAX's;
- every split's merged tokens, of every variant but the sampled ones,
  are (1,1)'s, and its ranks' logits are JAX's within 1e-4 and bitwise
  alike;
- the model ranks of a data rank decode the same tokens, sampled ones
  too, each data rank its stride of the requests; sampled tokens under a
  model split alone equal (1,1)'s for the same seed;
- the engine's tokens are the batched path's (JAX's
  ``test_engine_serving_matches_generate``), with either cache;
- prompt-lookup speculation (``--lookup_k 3``) gives the engine's greedy
  tokens, and JAX's, at (1,1) and on every split, Bloom's verify chunk on
  a shard's heads and slopes;
- a split ``mesh:`` YAML in one process raises the serve CLI's text.

Every process group has an explicit timeout; a world that outlives its
deadline is terminated and the test fails.
"""

import dataclasses
import functools
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

from youku_mplug_tpu.cli import run_instruct as jcli
from youku_mplug_tpu.models import bloom as jbloom
from youku_mplug_tpu.models import owl as jowl
from youku_mplug_tpu.models.generation import GenerationConfig as JGen
from youku_mplug_tpu.runtime.precision import FP32_POLICY as J_FP32
from youku_mplug_tpu_torch import bridge
from youku_mplug_tpu_torch.cli import run_instruct

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_owl_mesh_worker as worker  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-4
DEADLINE_S = 300  # a world's processes, all splits
WORLDS = {2: ["2x1", "1x2"], 4: ["2x2", "1x4"]}
SPLITS = [tag for tags in WORLDS.values() for tag in tags]
DETERMINISTIC = [v for v, (keys, _) in worker.VARIANTS.items()
                 if not keys.get("do_sample")]
SAMPLED = [v for v, (keys, _) in worker.VARIANTS.items()
           if keys.get("do_sample")]


def start(mode, world, out, spec):
    """``world`` gloo ranks of ``torch_owl_mesh_worker.py``, started."""
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": worker.REPO + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    rdv = os.path.join(out, f"rendezvous_{mode}_{world}")
    return [subprocess.Popen(
        [sys.executable, worker.__file__, mode, str(r), str(world), rdv,
         out, json.dumps(spec)], cwd=worker.REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def finish(procs, deadline=DEADLINE_S):
    """Wait for every process; fails (after killing them all) on a rank's
    error or past ``deadline``."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=deadline)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"a {len(procs)}-rank world outlived {deadline} s")
    bad = [(r, p.returncode, log[-3000:]) for r, (p, log)
           in enumerate(zip(procs, logs)) if p.returncode != 0]
    assert not bad, bad


def _read(d, tag, variant):
    """(merged results, {rank: rank file}) of one split's variant."""
    vd = os.path.join(d, tag, variant)
    with open(os.path.join(vd, "instruct_results.json")) as f:
        merged = json.load(f)
    ranks = {}
    if tag != "1x1":
        for r in range(int(tag[0]) * int(tag[2])):
            with open(os.path.join(vd, "ranks", f"rank{r}.json")) as f:
                ranks[r] = json.load(f)
    return merged, ranks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{tag: {variant: (merged, ranks)}, "forced": {tag: {rank: npz}},
    "dir": the runs' directory}; (1,1) run here."""
    d = str(tmp_path_factory.mktemp("owl_mesh"))
    worker.write_inputs(d)
    worlds = [start("serve", world, d, {"splits": tags})
              for world, tags in WORLDS.items()]
    worker.serve_split("1x1", d)
    for procs in worlds:
        finish(procs)
    out = {"dir": d, "forced": {}}
    for tag in ["1x1"] + SPLITS:
        out[tag] = {v: _read(d, tag, v) for v in worker.VARIANTS}
        n = 1 if tag == "1x1" else int(tag[0]) * int(tag[2])
        out["forced"][tag] = {
            r: dict(np.load(os.path.join(d, tag, "greedy", f"rank{r}.npz")))
            for r in range(n)}
    return out


def _jax_cfg(yaml_path):
    cfg, _ = jcli.load_owl_config(yaml_path)
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, attn_impl="xla"),
        text=dataclasses.replace(cfg.text, attn_impl="xla",
                                 decode_attn_impl="gather"))


@pytest.fixture(scope="module")
def jax_ref(runs):
    """JAX on the (1,1) port model's weights: media features, the
    prefill's and first decode step's logits (full causal forwards of
    the prompt and of the prompt with the port's first greedy token),
    and the greedy, beam, engine and int8-cache tokens."""
    d = runs["dir"]
    jsonl, tok = worker.write_inputs(d)
    out = {}
    for variant in ("greedy", "int8kv"):
        vd = os.path.join(d, "1x1", variant)
        args = worker.serve_argv(os.path.join(vd, "owl.yaml"), vd, jsonl, tok)
        with mock.patch.object(run_instruct, "seeded_init", functools.partial(
                bridge.seeded_init, std=worker.STD)):
            cfg, raw, model, _ = run_instruct.build(args)
        _, batch, clips = run_instruct.prepare(
            args, cfg, raw, torch.device("cpu"), torch.float32,
            run_instruct.build_tokenizer(args, cfg))
        jcfg = _jax_cfg(args.config)
        jm = jowl.MPLUGOwlVideo(jcfg, policy=J_FP32)
        params = jax.tree.map(jnp.asarray, bridge.to_jax_tree(model))
        video = jnp.asarray(clips.numpy())
        ids, media, plen = (jnp.asarray(batch[k]) for k in (
            "input_ids", "media_mask", "prompt_len"))

        def gen(beam):
            return np.asarray(jowl.generate_instruct(
                jm, params, video, ids, media, plen,
                JGen(max_new_tokens=raw["max_new_tokens"], eos_id=2,
                     pad_id=3, beam_size=beam))["sequences"])
        out[variant] = gen(1)
        if variant != "greedy":
            continue
        out["beam"] = gen(3)
        out["engine"] = np.asarray(jcli.serve_instruct(
            jm, params, video, batch, JGen(max_new_tokens=raw[
                "max_new_tokens"], eos_id=2, pad_id=3, beam_size=1),
            num_slots=worker.SLOTS))
        qf = jm.apply({"params": params}, video,
                      method=jowl.MPLUGOwlVideo.encode_video)
        emb = jm.apply({"params": params}, ids, media, qf,
                       method=jowl.MPLUGOwlVideo.spliced_embeds)
        jdec = jbloom.BloomLM(jcfg.text, policy=J_FP32)
        dec = {"params": params["text_decoder"]}
        toks = runs["forced"]["1x1"][0]["tok"]
        first, second = [], []
        for i, n in enumerate(np.asarray(plen)):
            e = jnp.concatenate([emb[i, :n], jdec.apply(
                dec, jnp.asarray(toks[i:i + 1], jnp.int32),
                method=jbloom.BloomLM.embed)])[None]
            lg = jdec.apply(dec, input_embeds=e,
                            return_logits=True)["logits"][0]
            first.append(lg[n - 1])
            second.append(lg[n])
        out.update(qf=np.asarray(qf), first=np.asarray(first),
                   second=np.asarray(second))
    return out


def _kept(seqs):
    """The JAX sequences as results' ``tokens`` (pad and eos dropped)."""
    return [[int(t) for t in row if t not in (2, 3)] for row in seqs]


def _tokens(merged):
    return [r["tokens"] for r in merged]


def test_unsharded_port_matches_jax(runs, jax_ref):
    got = runs["forced"]["1x1"][0]
    for key in ("qf", "first", "second"):
        np.testing.assert_allclose(got[key], jax_ref[key], rtol=TOL,
                                   atol=TOL)
    for variant in ("greedy", "beam", "engine", "int8kv"):
        assert _tokens(runs["1x1"][variant][0]) == _kept(jax_ref[variant]), \
            variant
    assert len({tuple(t) for t in _tokens(runs["1x1"]["greedy"][0])}) > 1


@pytest.mark.parametrize("variant", DETERMINISTIC)
@pytest.mark.parametrize("tag", SPLITS)
def test_split_tokens_equal_unsharded(runs, tag, variant):
    merged, ranks = runs[tag][variant]
    base = runs["1x1"][variant][0]
    assert [r["video"] for r in merged] == [r["video"] for r in base]
    assert _tokens(merged) == _tokens(base)
    assert [r["answer"] for r in merged] == [r["answer"] for r in base]
    assert all(rk["split"] == {"data": int(tag[0]), "model": int(tag[2])}
               for rk in ranks.values())


@pytest.mark.parametrize("tag", SPLITS)
def test_split_tokens_equal_jax(runs, jax_ref, tag):
    for variant in ("greedy", "beam", "engine", "int8kv"):
        assert _tokens(runs[tag][variant][0]) == _kept(jax_ref[variant]), \
            variant


@pytest.mark.parametrize("tag", SPLITS)
def test_split_first_step_logits_match_jax(runs, jax_ref, tag):
    forced = runs["forced"][tag]
    for got in forced.values():
        for key in ("qf", "first", "second"):
            np.testing.assert_allclose(got[key], jax_ref[key], rtol=TOL,
                                       atol=TOL)
            # every rank holds the gathered values, bitwise alike
            np.testing.assert_array_equal(got[key], forced[0][key])


@pytest.mark.parametrize("variant", list(worker.VARIANTS))
@pytest.mark.parametrize("tag", SPLITS)
def test_model_ranks_agree_and_data_ranks_serve_their_stride(runs, tag,
                                                             variant):
    merged, ranks = runs[tag][variant]
    data = int(tag[0])
    by_data = {}
    for rk in ranks.values():
        d, m = rk["coord"]
        by_data.setdefault(d, {})[m] = [(r["index"], r["tokens"])
                                        for r in rk["results"]]
    assert sorted(by_data) == list(range(data))
    for d, line in by_data.items():
        assert all(v == line[0] for v in line.values())  # model ranks
        assert [i for i, _ in line[0]] == list(
            range(d, len(worker.QUESTIONS), data))
    assert len(merged) == len(worker.QUESTIONS)
    assert all(r["tokens"] for r in merged)


@pytest.mark.parametrize("variant", SAMPLED)
@pytest.mark.parametrize("tag", ["1x2", "1x4"])
def test_sampled_tokens_under_a_model_split_equal_unsharded(runs, tag,
                                                            variant):
    base = _tokens(runs["1x1"][variant][0])
    assert _tokens(runs[tag][variant][0]) == base
    assert len({tuple(t) for t in base}) > 1


@pytest.mark.parametrize("tag", ["1x1"] + SPLITS)
def test_engine_tokens_equal_the_batched_path(runs, tag):
    for engine, batched in (("engine", "greedy"),
                            ("int8kv_engine", "int8kv")):
        assert _tokens(runs[tag][engine][0]) == \
            _tokens(runs[tag][batched][0]), engine


@pytest.mark.parametrize("tag", ["1x1"] + SPLITS)
def test_lookup_tokens_equal_the_greedy_engine_and_jax(runs, jax_ref, tag):
    got = _tokens(runs[tag]["lookup_engine"][0])
    assert got == _tokens(runs["1x1"]["engine"][0])
    assert got == _kept(jax_ref["engine"])


def test_int8_weights_serve_under_a_split(runs):
    """--int8 quantizes before the shard: each split's tokens are (1,1)'s
    int8 model's, and a model rank holds 1/m of the sharded int8
    leaves' bytes (a (2,1) rank's, the whole decoder, as the reference)."""
    base = runs["1x1"]["int8"][0]
    whole = runs["2x1"]["int8"][1][0]["stats"]["decoder_weight_bytes"]
    for tag in SPLITS:
        merged, ranks = runs[tag]["int8"]
        assert _tokens(merged) == _tokens(base)
        for rk in ranks.values():
            got = rk["stats"]["decoder_weight_bytes"]
            assert (got < whole) == (int(tag[2]) > 1), (tag, got, whole)


@pytest.mark.parametrize("tag", ["1x1"] + SPLITS)
def test_unshard_of_a_sharded_owl_is_the_jax_tree_bitwise(runs, tag):
    n = 1 if tag == "1x1" else int(tag[0]) * int(tag[2])
    for r in range(n):
        with open(os.path.join(runs["dir"], tag, "greedy",
                               f"roundtrip_rank{r}.json")) as f:
            rec = json.load(f)
        assert rec["differ"] == [] and rec["leaves"] == 86


def test_a_module_without_a_model_parallel_form_raises():
    """A leaf the rules split whose module has no ``TP_PARAM`` (no
    model-parallel form) raises in ``shard_params``."""
    from youku_mplug_tpu_torch.parallel import sharding
    from youku_mplug_tpu_torch.runtime.mesh import Mesh

    class Grouped(Mesh):  # a (1, 2) mesh whose groups are never used
        @property
        def model_group(self):
            return object()

    class Plain(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.q_kernel = torch.nn.Parameter(torch.zeros(4, 4))

    root = torch.nn.Module()
    root.abstractor = torch.nn.Module()
    root.abstractor.layers = torch.nn.ModuleList([Plain()])
    with pytest.raises(NotImplementedError,
                       match="has no model-parallel form"):
        sharding.shard_params(root, Grouped(1, 2),
                              sharding.BLOOM_SHARDING_RULES)


def test_a_split_mesh_in_one_process_raises_the_serve_text(tmp_path):
    """A YAML with ``mesh: {model: 2}`` run in one process raises before
    it builds a model, with the serve CLI's words for the same block."""
    from youku_mplug_tpu_torch.cli import serve

    jsonl, tok = worker.write_inputs(str(tmp_path))
    path = worker.write_yaml(str(tmp_path / "owl.yaml"), "1x2")
    raw = yaml.safe_load(open(path))
    raw["mesh"] = {"model": 2}
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    with pytest.raises(ValueError) as owl_err:
        run_instruct.build(worker.serve_argv(path, str(tmp_path), jsonl,
                                             tok))
    with open("configs/pretrain_tiny.yaml") as f:
        cap = yaml.safe_load(f)
    cap["mesh"] = {"model": 2}
    cap_path = tmp_path / "cap.yaml"
    cap_path.write_text(yaml.safe_dump(cap))
    with pytest.raises(ValueError) as serve_err:
        serve.build(serve.serve_parser().parse_args([
            "--config", str(cap_path), "--synthetic_data", "--device",
            "cpu", "--output_dir", str(tmp_path)]))
    assert str(owl_err.value) == str(serve_err.value)
    assert "model=2" in str(owl_err.value)
