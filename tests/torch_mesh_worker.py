"""One gloo rank of the port's mesh tests (``tests/test_torch_serve_mesh.py``,
``tests/test_torch_multihost.py``), and the helpers the tests share with
it.  Run as

    python tests/torch_mesh_worker.py <mode> <rank> <world> <rendezvous
        file> <output dir> <JSON of the mode's arguments>

``mode`` ``serve``: for each split of the JSON, ``serve.build`` and
``serve.serve_built`` on its YAML (captions, ``ranks/rank<r>.json``),
then on the same model the query features and the first two steps' logits of ``FORCED`` requests
(``forced``, written as ``<output>/<tag>/rank<r>.npz``), and with
``"sample": true`` the engine's sampled tokens (``sampled``,
``rank<r>_sampled.json`` beside it).
``mode`` ``speculative``: for each split of the JSON, ``serve.build``
with ``--speculative`` (``SPEC_TWIN``: a twin draft of ``TWIN_LAYERS``
layer) and ``serve.serve_built`` with it and again with ``SPEC_NGRAM``
(prompt lookup) on the same model shard (results under
``<output>/<tag>/twin`` and ``.../ngram``); then on the same shard the
engine's ``step_lookup`` tokens of every request, the twin draft's logits
and head count, sampled speculative tokens, and the greedy tokens of a
twin of the whole decoder on the text prompt alone (``speculative_rank<r>
.json`` under ``<output>/<tag>``).
``mode`` ``merges``: the host merges of ``cli/common.py`` over a
(world, 1) mesh, written as ``<output>/merges_rank<r>.json``.  ``mode``
``shards``: for each split of the JSON, ``shard_params`` then
``unshard`` of a seeded model against its unsharded twin, the local
shapes, whether a model shard refuses ``--speculative`` or a
prompt-lookup step (None when it runs: neither is refused), whether a
model with unmerged LoRA adapters shards (``lora``: None when it does)
and the attributes ``shard_params`` set on the two models' modules
(``shard_state``), written as
``<output>/<tag>/shards_rank<r>.json``.  The
process group comes from ``init_method=file://`` (no TCP port: pytest
workers never collide) with an explicit timeout.  Imports torch and the
port only.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import json
import os
import sys
import unittest.mock as mock

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from youku_mplug_tpu_torch import bridge  # noqa: E402
from youku_mplug_tpu_torch.cli import common, serve  # noqa: E402
from youku_mplug_tpu_torch.data.datasets import (  # noqa: E402
    SyntheticVideoDataset,
)
from youku_mplug_tpu_torch.models.generation import (  # noqa: E402
    GenerationConfig,
    _build_prefix,
)
from youku_mplug_tpu_torch.ops.preprocess import normalize_clip  # noqa: E402
from youku_mplug_tpu_torch.runtime import mesh as mesh_lib  # noqa: E402
from youku_mplug_tpu_torch.runtime.prng import make_rngs  # noqa: E402
from youku_mplug_tpu_torch.serving.engine import ServingEngine  # noqa: E402
from youku_mplug_tpu_torch.serving.speculative import (  # noqa: E402
    speculative_generate,
    twin_draft,
)

TIMEOUT_S = 120   # every collective's limit: a lost rank fails the run
STD = 0.1         # the weights' std: varied tokens from a tiny model
SEED = 3
REQUESTS = 7      # an odd count: the data ranks serve 4 and 3
FORCED = 3        # requests of the teacher-forced first steps
SLOTS = 3
SAMPLE = dict(do_sample=True, top_k=40, top_p=0.95)
TWIN_LAYERS = 1   # of the tiny decoder's 2
SPEC_TWIN = ("--speculative", "2", "--draft", "twin", "--draft_layers",
             str(TWIN_LAYERS))
SPEC_NGRAM = ("--speculative", "3", "--draft", "ngram")
LOOKUP_K = 3
WHOLE_TWIN_TOKENS = 10  # tokens of the whole decoder's twin, no EOS stop


def serve_args(yaml, out_dir, *extra):
    return serve.serve_parser().parse_args([
        "--config", yaml, "--synthetic_data", "--num_requests",
        str(REQUESTS), "--num_slots", str(SLOTS), "--output_dir", out_dir,
        "--device", "cpu", "--fp32", "--seed", str(SEED), *extra])


def seeded(std=STD):
    """serve's weights at the tests' std (the same seed on every rank)."""
    return functools.partial(bridge.seeded_init, std=std)


def clips(cfg, n):
    ds = SyntheticVideoDataset(int(cfg.get("synthetic_length", 16)),
                               cfg.num_frames, cfg.image_res)
    return normalize_clip(torch.from_numpy(np.stack(
        [ds[i]["video"] for i in range(n)])), dtype=torch.float32)


@torch.inference_mode()
def forced(cfg, model):
    """Query features of the first FORCED clips, and the fp32 logits of
    their prefill (prompt after the queries) and of one decode step fed
    its greedy token."""
    lm = model.text_decoder
    prompt, prompt_len, gen = serve._prompt(cfg)
    qe = model.encode_queries(clips(cfg, FORCED))
    b, nq = qe.shape[:2]
    ids = torch.tensor([prompt] * b)
    plen = torch.full((b,), max(prompt_len, 1))
    embeds, vf, po = _build_prefix(lm, ids, plen, qe, gen.pad_id)
    cache = lm.init_cache(b, nq + ids.shape[1] + 4)
    first, cache = lm.decode_step(embeds, cache, 0, vf, po)
    tok = first.argmax(-1)
    cl = torch.full((b,), nq + ids.shape[1])
    second, _ = lm.decode_step(lm.embed(tok[:, None]), cache, cl, vf, po)
    return {"qe": qe.numpy(), "first": first.numpy(),
            "second": second.numpy(), "tok": tok.numpy()}


@torch.inference_mode()
def sampled(cfg, model, mesh):
    """Sampled tokens of REQUESTS requests through the engine, its
    generator serve's (the data coordinate folded in)."""
    lm = model.text_decoder
    prompt, _, gen = serve._prompt(cfg)
    qe = model.encode_queries(clips(cfg, REQUESTS))
    eng = ServingEngine(
        lm, num_slots=SLOTS, max_len=qe.shape[1] + 8 + gen.max_new_tokens
        + 1, prefill_buckets=(8,),
        config=GenerationConfig(max_new_tokens=gen.max_new_tokens,
                                eos_id=gen.eos_id, pad_id=gen.pad_id,
                                **SAMPLE),
        generator=make_rngs(SEED, 0, ("sample",), "cpu", mesh,
                            ("data",))["sample"])
    for row in qe:
        eng.submit(prompt, query_embeds=row)
    fin = eng.run_to_completion()
    return [t for _, t in sorted((f.rid, f.tokens) for f in fin)]


def run_split(tag, yaml, out, sample=False):
    """One split on this rank (see the module docstring); the files go
    under ``out/tag``.  Returns (forced outputs, sampled tokens)."""
    d = os.path.join(out, tag)
    args = serve_args(yaml, d)
    with mock.patch.object(serve, "seeded_init", seeded()):
        cfg, model, device = serve.build(args)
    serve.serve_built(args, cfg, model, device)
    mesh = model.mesh
    got = forced(cfg, model)
    toks = sampled(cfg, model, mesh) if sample else None
    np.savez(os.path.join(d, f"rank{mesh.rank}.npz"), **got)
    with open(os.path.join(d, f"rank{mesh.rank}_sampled.json"), "w") as f:
        json.dump(toks, f)
    return got, toks


@torch.inference_mode()
def lookup_tokens(cfg, model):
    """The engine's tokens of every request with ``step_lookup`` (k =
    LOOKUP_K), the slots and cache of ``sampled``'s engine."""
    lm = model.text_decoder
    prompt, _, gen = serve._prompt(cfg)
    qe = model.encode_queries(clips(cfg, REQUESTS))
    eng = ServingEngine(
        lm, num_slots=SLOTS, max_len=qe.shape[1] + 8 + gen.max_new_tokens
        + 1, prefill_buckets=(8,), config=gen)
    for row in qe:
        eng.submit(prompt, query_embeds=row)
    fin = eng.run_to_completion(lookup_k=LOOKUP_K)
    return [t for _, t in sorted((f.rid, f.tokens) for f in fin)]


@torch.inference_mode()
def twin_record(cfg, model, mesh):
    """The twin draft of the (sharded) decoder: its logits over the
    prompt after the first FORCED clips' queries, its attention's head
    count and whether it carries the target's model group; and sampled
    speculative tokens of those clips (k = 2, the generator seeded as the
    serve CLI's: the data coordinate folded in)."""
    lm = model.text_decoder
    draft = twin_draft(lm, TWIN_LAYERS)
    prompt, prompt_len, gen = serve._prompt(cfg)
    qe = model.encode_queries(clips(cfg, FORCED))
    b = qe.shape[0]
    ids = torch.tensor([prompt] * b)
    plen = torch.full((b,), max(prompt_len, 1))
    hidden = draft(input_embeds=torch.cat([qe, draft.embed(ids)], 1))[
        "last_hidden_state"]
    logits = draft.logits(hidden)
    g = make_rngs(SEED, 0, ("sample",), "cpu", mesh, ("data",))["sample"]
    out = speculative_generate(
        lm, draft, ids, plen, config=GenerationConfig(
            max_new_tokens=gen.max_new_tokens, eos_id=gen.eos_id,
            pad_id=gen.pad_id, **SAMPLE), speculate_len=2, query_embeds=qe,
        generator=g)
    # the whole decoder's twin on the text prompt alone: the draft never
    # reads the visual prefix, so only without one does it propose the
    # target's greedy tokens and the rounds commit accepted drafts
    whole = speculative_generate(
        lm, twin_draft(lm, lm.cfg.num_hidden_layers), ids, plen,
        config=GenerationConfig(max_new_tokens=WHOLE_TWIN_TOKENS,
                                eos_id=-1, pad_id=gen.pad_id),
        speculate_len=2)
    attn = draft.decoder.layers.attn
    return {"logits": logits.numpy(), "heads": attn.n,
            "tp": attn.tp is not None and attn.tp is lm.decoder.layers.attn.tp,
            "sampled": out["sequences"].tolist(), "rounds": out["rounds"],
            "whole_twin": whole["sequences"].tolist(),
            "whole_twin_tokens_per_round": whole["tokens_per_round"]}


def spec_split(tag, yaml, out):
    """See the module docstring (``mode`` ``speculative``); returns this
    rank's record (also written under ``out/tag``)."""
    d = os.path.join(out, tag)
    args = serve_args(yaml, os.path.join(d, "twin"), *SPEC_TWIN)
    with mock.patch.object(serve, "seeded_init", seeded()):
        cfg, model, device = serve.build(args)
    serve.serve_built(args, cfg, model, device)
    serve.serve_built(serve_args(yaml, os.path.join(d, "ngram"),
                                 *SPEC_NGRAM), cfg, model, device)
    mesh = model.mesh
    twin = twin_record(cfg, model, mesh)
    rec = {"coord": list(mesh.coord), "lookup": lookup_tokens(cfg, model),
           **{k: v for k, v in twin.items() if k != "logits"}}
    rank = mesh.rank if mesh.distributed else 0
    with open(os.path.join(d, f"speculative_rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    np.save(os.path.join(d, f"twin_logits_rank{rank}.npy"), twin["logits"])
    return rec


def merges(out, rank):
    """cli/common's host merges over a (world, 1) mesh: the records, rows
    and counters of JAX's two-process tests, and a wrap-padded loader."""
    from youku_mplug_tpu_torch.data.loader import Loader

    mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig())
    recs = ([{"video_id": "v0", "cap": "你好"}, {"video_id": "v2",
                                               "cap": "c2"},
             {"video_id": "v0", "cap": "dup"}] if rank == 0 else
            [{"video_id": "v1", "cap": "c1"}, {"video_id": "v3",
                                               "cap": "世界"}])
    merged = common.collect_records(recs, dedup_key="video_id", mesh=mesh)
    total = common.sum_across_hosts(np.array([1.0 + rank, 10.0]), mesh)
    idx = np.arange(rank, 8, 2) % 6
    rows = idx[:, None].astype(np.float32) * np.ones((1, 3), np.float32)
    m_rows, m_order = common.gather_eval_rows(rows, idx, mesh)

    class DS:
        def __len__(self):
            return 16

        def __getitem__(self, i):
            return {"idx": i}

    loader = Loader(DS(), 4, shuffle=False, shard_index=mesh.data_index,
                    shard_count=mesh.data)
    shard = sorted(int(x) for b in loader for x in b["idx"])
    with open(os.path.join(out, f"merges_rank{rank}.json"), "w") as f:
        json.dump({"coord": list(mesh.coord), "records": merged,
                   "sum": total.tolist(), "rows": m_rows.tolist(),
                   "order": m_order.tolist(), "shard": shard}, f,
                  ensure_ascii=False)


def shards(tag, yaml, out):
    """See the module docstring (``mode`` ``shards``)."""
    from youku_mplug_tpu_torch.config import load_config
    from youku_mplug_tpu_torch.models.tasks import MPLUGVideo
    from youku_mplug_tpu_torch.parallel import sharding
    from youku_mplug_tpu_torch.runtime.precision import FP32_POLICY

    cfg = load_config(yaml)
    mesh = mesh_lib.make_mesh(cfg.mesh)
    model = seeded()(MPLUGVideo(cfg.model, FP32_POLICY), SEED)
    full = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = set_by(lambda: sharding.shard_params(model, mesh), model)
    local = {n: list(p.shape) for n, p in model.named_parameters()}
    back = sharding.unshard(model, mesh)
    refusals = {}

    def refused(name, fn):
        try:
            fn()
            refusals[name] = None
        except NotImplementedError as e:
            refusals[name] = str(e)

    d = os.path.join(out, tag)
    os.makedirs(d, exist_ok=True)
    refused("speculative", lambda: serve.build(serve.serve_parser(
    ).parse_args(["--config", yaml, "--synthetic_data", "--device", "cpu",
                  "--fp32", "--output_dir", d, "--speculative", "2"])))
    lora = lora_twin(cfg)
    refused("lora", lambda: state.extend(set_by(
        lambda: sharding.shard_params(lora, mesh), lora)))
    lora_err = lora_outputs(lora, cfg, mesh)
    _, _, gen = serve._prompt(cfg)
    eng = ServingEngine(model.text_decoder, num_slots=2, max_len=32,
                        prefill_buckets=(8,), config=gen)
    eng.submit([1], query_embeds=None)
    refused("lookup", lambda: eng.step_lookup(2))
    with open(os.path.join(d, f"shards_rank{mesh.rank}.json"), "w") as f:
        json.dump({"coord": list(mesh.coord), "local": local,
                   "split": dict(model.tp_split), "refusals": refusals,
                   "roundtrip": sorted(n for n in full
                                       if not torch.equal(back[n], full[n])),
                   "eager": eng.eager, "lora_err": lora_err,
                   "shard_state": sorted(set(state))}, f)


def set_by(fn, module):
    """The instance attributes ``fn()`` adds to ``module``'s submodules
    (beside their parameters and buffers), as a list."""
    before = {n: set(vars(m)) for n, m in module.named_modules()}
    fn()
    return sorted({a for n, m in module.named_modules()
                   for a in set(vars(m)) - before.get(n, set())})


def lora_twin(cfg):
    """The seeded model with rank-2 LoRA adapters on the decoder and the
    vision tower, every ``lora_*_b`` drawn non-zero (the same on every
    rank)."""
    from youku_mplug_tpu_torch.models.tasks import MPLUGVideo
    from youku_mplug_tpu_torch.runtime.precision import FP32_POLICY

    m = cfg.model
    model = seeded()(MPLUGVideo(dataclasses.replace(
        m, text=dataclasses.replace(m.text, lora_rank=2),
        vision=dataclasses.replace(m.vision, lora_rank=2)), FP32_POLICY),
        SEED)
    g = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for n, p in sorted(model.named_parameters()):
            if "lora_" in n and n.endswith("_b"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.5)
    return model


@torch.inference_mode()
def lora_outputs(model, cfg, mesh):
    """The largest |difference| of the query features and the decoder's
    logits of a sharded ``lora_twin`` from its unsharded twin's (built
    again here), on the first clips and the prompt."""
    twin = lora_twin(cfg)
    video = clips(cfg, 2)
    prompt, _, _ = serve._prompt(cfg)
    ids = torch.tensor([prompt] * 2)
    out = {}
    for name, m in (("got", model), ("want", twin)):
        qe = m.encode_queries(video)
        lm = m.text_decoder
        h = lm(tokens=ids)["last_hidden_state"]
        out[name] = (qe, lm.logits(h))
    return [float((a - b).abs().max()) for a, b in zip(out["got"],
                                                       out["want"])]


def main(argv):
    mode, rank, world, rdv, out, spec = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"file://{rdv}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        if mode == "serve":
            for split in json.loads(spec):
                run_split(split["tag"], split["yaml"], out,
                          split.get("sample", False))
        elif mode == "shards":
            for split in json.loads(spec):
                shards(split["tag"], split["yaml"], out)
        elif mode == "speculative":
            for split in json.loads(spec):
                spec_split(split["tag"], split["yaml"], out)
        else:
            merges(out, rank)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
