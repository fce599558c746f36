"""Caption serving CLI: continuous-batching engine over the port's model.

Counterpart of ``youku_mplug_tpu/cli/serve.py``: clips are encoded to
query prefixes in batches, then requests are admitted a trickle at a time
to the slot pool and every engine step decodes one token for all
in-flight requests (on the card one replay of the decode step's CUDA
graph).  ``--speculative k`` serves lock-step batches through
``serving/speculative.py`` instead: a ``--draft twin`` (the decoder's
first ``--draft_layers`` layers, views of its weights) or ``--draft
ngram`` (prompt lookup) proposes k tokens a round, greedy and exact.
Weights, as the JAX CLI has them: a seeded init, then the checkpoints the
YAML's ``import_torch_weights`` names (a ModelScope GPT-3 directory and a
timm / TimeSformer file, ``models/importers.import_all``), then with
``--resume <train run dir>`` (or ``--evaluate_only``) the run's latest
training checkpoint (``cli/common.resume_state``; the model then keeps
the training split, fp32 trainable and bf16 frozen leaves, so it holds
the checkpoint's values bitwise).  The clips are the caption YAML's test
split (``test_file`` under ``video_root``, ``run_caption.dataset``, in
order on ``num_workers`` decode threads), or with
``--synthetic_data`` procedural clips.  Each result carries the video id,
the caption (the tokens decoded by the run's tokenizer, spaces removed,
as the JAX CLI writes it), the tokens, their count and the request's
latency.  A YAML with ``text_overrides: {kv_cache_dtype: int8}`` serves
over the int8 KV cache (``ops/kv_cache.py``).

Under a split: launched with ``python -m torch.distributed.run
--nproc_per_node=N -m youku_mplug_tpu_torch.cli.serve ...``, the ranks
join one process group (``--dist_backend``: ``nccl`` on the card, one
card a rank, ``cuda:$LOCAL_RANK`` unless ``--device`` names one; ``gloo``
where asked, and for ``--device cpu``; never chosen because NCCL failed)
and serve the YAML's ``mesh:`` split (``runtime/mesh.py``; data x model
must be N, and a split other than 1 x 1 without a process group raises).
Every rank builds the whole model from the same seed (and imports or
resumes the same weights), then keeps its model shard
(``parallel/sharding.shard_params`` with the GPT-3 rules): its heads,
MLP columns and vocab rows, the kernels running on its local heads.  The
run serves the requests the unsharded run would (the first
``--num_requests`` clips of the loader's full batches), whatever the
split: each data rank serves its shard of them (the loader's ``[i::D]``
stride, its last partial batch kept, since a shard may be shorter than
one batch; a rank that runs short raises): request ``j`` of data rank
``i`` is the run's request ``i + j * D``.  The ranks' results are merged over the host group
(``common.collect_records``), and rank 0 writes ``serve_results.json``
and prints the stats, which then carry the split and count every request
once (``wall_s`` the slowest data rank's).  Every rank writes
``ranks/rank<r>.json`` under ``--output_dir``: its coordinate, its own
results, decode steps, graph replays, the kernels' launch counters and
the peak device memory of the build (the whole model) and of the serve
after it (the shard).  Under ``model >
1`` the engine steps eagerly (``serving/engine.py``), and
``--speculative`` decodes each data rank's batches on its model shard
(``serving/speculative.py``: the twin draft is the same shard of the
shallower decoder, every model rank commits the same tokens), merged as
the engine's results are.

Usage (GPU; ``--synthetic_data`` in place of the YAML's files):
    python -m youku_mplug_tpu_torch.cli.serve \
        --config configs/caption/serve_gpt3_1.3B_flagship.yaml \
        --synthetic_data --num_requests 16 --device cuda
    python -m youku_mplug_tpu_torch.cli.serve \
        --config configs/caption/serve_gpt3_1.3B_int8kv.yaml \
        --synthetic_data --num_requests 16 --device cuda
    python -m youku_mplug_tpu_torch.cli.serve \
        --config configs/caption/serve_gpt3_1.3B_flagship.yaml \
        --synthetic_data --speculative 4 --draft twin
    python -m youku_mplug_tpu_torch.cli.serve \
        --config configs/caption/serve_gpt3_1.3B_flagship.yaml \
        --synthetic_data --resume <a run_caption output_dir>
    python -m youku_mplug_tpu_torch.cli.serve \
        --config <a serve YAML whose test_file and video_root name your
                  files> --num_requests 16
    # a YAML with mesh: {data: 2, model: 2}: four ranks, one card each
    python -m torch.distributed.run --nproc_per_node=4 \
        -m youku_mplug_tpu_torch.cli.serve --config <it> --synthetic_data
    # the same four ranks on one card (gloo), or on CPU processes
    python -m torch.distributed.run --nproc_per_node=4 \
        -m youku_mplug_tpu_torch.cli.serve --config <it> --synthetic_data \
        --device cuda:0 --dist_backend gloo
    python -m torch.distributed.run --nproc_per_node=4 \
        -m youku_mplug_tpu_torch.cli.serve --config <it> --synthetic_data \
        --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from youku_mplug_tpu_torch.bridge import seeded_init
from youku_mplug_tpu_torch.cli import common, run_caption
from youku_mplug_tpu_torch.config import load_config
from youku_mplug_tpu_torch.models import importers
from youku_mplug_tpu_torch.models.generation import GenerationConfig
from youku_mplug_tpu_torch.models.tasks import MPLUGVideo
from youku_mplug_tpu_torch.models.tokenizer import load_tokenizer
from youku_mplug_tpu_torch.ops.preprocess import normalize_clip
from youku_mplug_tpu_torch.parallel.sharding import (
    GPT3_SHARDING_RULES,
    shard_params,
)
from youku_mplug_tpu_torch.runtime import mesh as mesh_lib
from youku_mplug_tpu_torch.runtime.prng import make_rngs
from youku_mplug_tpu_torch.runtime.precision import (
    BF16_POLICY,
    DEFAULT_POLICY,
    FP32_POLICY,
)
from youku_mplug_tpu_torch.serving.engine import COUNTERS, ServingEngine
from youku_mplug_tpu_torch.serving.speculative import (
    ngram_speculative_generate,
    speculative_generate,
    twin_draft,
)
from youku_mplug_tpu_torch.train.checkpoint import CheckpointManager
from youku_mplug_tpu_torch.train.state import create_train_state


def serve_parser():
    p = argparse.ArgumentParser(
        description="caption serving (continuous batching)")
    p.add_argument("--config", required=True)
    p.add_argument("--output_dir", default="./output")
    p.add_argument("--seed", type=int, default=42,
                   help="seed of the weight init")
    p.add_argument("--resume", default="",
                   help="train run (or checkpoints) directory whose latest "
                        "checkpoint to serve")
    p.add_argument("--evaluate_only", action="store_true",
                   help="serve the latest checkpoint of --resume, else of "
                        "--output_dir; raises when there is none")
    p.add_argument("--synthetic_data", action="store_true",
                   help="procedural clips in place of the YAML's test_file "
                        "and video_root")
    p.add_argument("--device", default="cuda",
                   help="cuda[:i] (default; under torch.distributed.run "
                        "cuda:$LOCAL_RANK), or cpu")
    p.add_argument("--dist_backend", choices=("nccl", "gloo"), default=None,
                   help="process group backend under torch.distributed.run "
                        "(default nccl on the card, gloo for --device cpu); "
                        "gloo runs several ranks on one card")
    p.add_argument("--fp32", action="store_true",
                   help="fp32 weights and compute (CPU tests)")
    p.add_argument("--num_slots", type=int, default=8)
    p.add_argument("--serve_max_len", type=int, default=0,
                   help="KV capacity per slot (0: queries+prompt+new)")
    p.add_argument("--num_requests", type=int, default=16)
    p.add_argument("--admit_per_step", type=int, default=2,
                   help="max new requests admitted per engine step "
                        "(simulates a steady arrival process)")
    p.add_argument("--speculative", type=int, default=0,
                   help="k>0: lock-step speculative decoding instead of "
                        "the continuous-batching engine (draft: "
                        "--draft_layers-deep twin of the decoder)")
    p.add_argument("--draft_layers", type=int, default=0,
                   help="draft depth for --speculative (0: decoder "
                        "depth // 4)")
    p.add_argument("--draft", choices=("twin", "ngram"), default="twin",
                   help="--speculative proposal source: 'twin' = "
                        "truncated-depth twin of the decoder; 'ngram' = "
                        "draft-free prompt-lookup (copies continuations "
                        "of repeated n-grams from the sequence's own "
                        "history)")
    p.add_argument("--ngram_n", type=int, default=2,
                   help="suffix length matched by --draft ngram")
    return p


def clip_batches(args, cfg, mesh=None, dataset=None):
    """(uint8 clips, video ids) batches of the caption YAML's test split
    (or ``dataset``), or of synthetic clips, in order: the last partial
    batch dropped (JAX serve's loader); under a data split, this data
    rank's shard with its last partial batch kept, since a shard may be
    shorter than one batch (``local_requests`` says how many it
    serves)."""
    if dataset is None:
        dataset = run_caption.dataset(args, cfg, train=False)
    split = mesh is not None and mesh.data > 1
    for raw in common.make_loader(args, cfg, dataset, shuffle=False,
                                  drop_last=not split, mesh=mesh):
        yield raw["video"], raw["video_id"]


def dist_backend(args, device) -> str:
    """``--dist_backend``, else nccl on the card and gloo on the CPU."""
    return args.dist_backend or ("nccl" if device.type == "cuda" else "gloo")


def run_requests(args, cfg, dataset) -> int:
    """How many requests the run serves, whatever its split: the first
    ``--num_requests`` clips of the unsharded loader's full batches."""
    return min(args.num_requests,
               len(dataset) // cfg.batch_size * cfg.batch_size)


def local_requests(n: int, mesh) -> int:
    """How many of the run's first ``n`` requests (clips) fall in this
    data rank's shard: those ``i < n`` with ``i % D`` its coordinate."""
    return max(0, -(-(n - mesh.data_index) // mesh.data))


def _short(mesh, served: int, n_local: int):
    """Raises when this data rank ran out of clips before its share."""
    if served < n_local:
        raise RuntimeError(
            f"data rank {mesh.data_index} of {mesh.data} served {served} of "
            f"its {n_local} requests: its shard ran out of clips")


def build(args):
    """-> (run config, model on the device, device), its weights as the
    module docstring says, cut to this rank's model shard under a split
    (``model.mesh``).  Raises when the requested device is absent:
    nothing falls back to the CPU."""
    device = common.device_of(args)
    mesh_lib.distributed_init(dist_backend(args, device), device=device)
    cfg = load_config(args.config)
    mesh = mesh_lib.make_mesh(cfg.mesh)
    resume = bool(args.resume or args.evaluate_only)
    policy = FP32_POLICY if args.fp32 else (DEFAULT_POLICY if resume
                                            else BF16_POLICY)
    with device:
        model = MPLUGVideo(cfg.model, policy)
    seeded_init(model, args.seed)
    if cfg.get("import_torch_weights"):
        importers.import_all(model, cfg, cfg.get("import_torch_weights"))
    if resume:
        state, _, _ = create_train_state(
            model, cfg.optimizer, frozen_dtype=policy.compute_dtype)
        common.resume_state(args, CheckpointManager(
            os.path.join(args.output_dir, "checkpoints")), state)
    shard_params(model, mesh, GPT3_SHARDING_RULES)
    return cfg, model.eval(), device


def _tokenizer(cfg):
    return load_tokenizer(cfg.get("text_decoder", ""),
                          cfg.model.text.vocab_size)


def _caption(tok, tokens, eos_id: int) -> str:
    """The JAX CLI's caption text of a request's tokens."""
    return tok.detokenize(list(tokens) + [eos_id]).replace(" ", "").strip()


def _prompt(cfg):
    """-> (prompt ids, their true length, generation config): the JAX
    CLI's prompt, the tokenized prompt minus its trailing eos."""
    tok = _tokenizer(cfg)
    ids = tok.tokenize(cfg.prompt)[:cfg.max_length]
    prompt_len = len(ids) - 1
    gen_cfg = GenerationConfig(
        max_new_tokens=int(cfg.get("max_new_tokens", 32)), do_sample=False,
        eos_id=tok.eos_id, pad_id=tok.pad_id)
    return ids[:max(prompt_len, 1)], prompt_len, gen_cfg


def make_engine(args, cfg, lm, mesh=None):
    """-> (the serving engine over ``lm``, the prompt ids every request
    carries): the prefill bucket is the next power of two >= the prompt
    (from 8), the cache holds queries + bucket + max_new_tokens + 1 rows
    unless ``--serve_max_len`` says otherwise; its generator is the run
    seed's with the data coordinate folded in (``runtime/prng.py``: the
    model ranks of a data rank draw alike)."""
    prompt_vec, prompt_len, gen_cfg = _prompt(cfg)
    nq = cfg.model.num_learnable_token
    bucket = max(8, 1 << (max(prompt_len, 1) - 1).bit_length())
    max_len = args.serve_max_len or (nq + bucket + gen_cfg.max_new_tokens
                                     + 1)
    device = lm.word_embeddings.embedding.device
    generator = make_rngs(args.seed, 0, ("sample",), device,
                          mesh or mesh_lib.Mesh(), ("data",))["sample"]
    return ServingEngine(lm, num_slots=args.num_slots, max_len=max_len,
                         prefill_buckets=(bucket,), config=gen_cfg,
                         generator=generator), prompt_vec


def _merge(mesh, out, wall, extra=None):
    """(stats, results) of the run: under a process group every data
    rank's results merged in request order on every rank (each request
    once), the stats over them with the slowest data rank's wall and the
    split; else this rank's own."""
    if mesh.distributed:
        out = sorted(common.collect_records(out, "index", mesh),
                     key=lambda r: r["index"])
        wall = max(common.host_gather(wall, mesh))
    out = [{k: v for k, v in r.items() if k != "index"} for r in out]
    lat = [o["latency_s"] for o in out if o["latency_s"] > 0]
    stats = {
        "requests": len(out),
        "wall_s": round(wall, 3),
        "tokens_per_sec": round(sum(o["n_tokens"] for o in out)
                                / max(wall, 1e-9), 2),
    }
    stats.update(extra if extra is not None else {
        "latency_p50_s": round(float(np.percentile(lat, 50)), 4) if lat
        else None,
        "latency_p95_s": round(float(np.percentile(lat, 95)), 4) if lat
        else None})
    if mesh.distributed:
        stats["split"] = {"data": mesh.data, "model": mesh.model}
    return stats, out


def run(args, cfg, model, device):
    """Serve ``args.num_requests`` clips of ``clip_batches`` (under a split
    this data rank's share of them).  Returns (stats, per-request results,
    the engine): merged over the data ranks under a process group."""
    out, wall, engine = serve_local(args, cfg, model, device)
    stats, out = _merge(model.mesh or mesh_lib.Mesh(), out, wall)
    return stats, out, engine


def serve_local(args, cfg, model, device):
    """``run``'s serving on this rank: (its results, each with its
    request ``index`` in the run, the wall seconds, the engine)."""
    mesh = model.mesh or mesh_lib.Mesh()
    engine, prompt_vec = make_engine(args, cfg, model.text_decoder, mesh)
    max_new = engine.config.max_new_tokens
    tok = _tokenizer(cfg)
    test = run_caption.dataset(args, cfg, train=False)
    n_local = local_requests(run_requests(args, cfg, test), mesh)

    pending = []  # (video_id, query_embeds row)
    results, submit_t, finish_t = {}, {}, {}
    served = 0
    t_start = time.perf_counter()
    batches = clip_batches(args, cfg, mesh, test)
    for clips, vids in batches:
        with torch.inference_mode():
            video = normalize_clip(torch.from_numpy(clips).to(device),
                                   dtype=model.policy.compute_dtype)
            qe = model.encode_queries(video)
        pending.extend(zip(vids, qe))
        while pending and served < n_local:
            # admit a trickle per step, decode everything in flight
            for _ in range(min(args.admit_per_step, len(pending))):
                if served >= n_local:
                    break
                vid, q = pending.pop(0)
                rid = engine.submit(prompt_vec, query_embeds=q,
                                    max_new_tokens=max_new)
                submit_t[rid] = time.perf_counter()
                results[rid] = {"video_id": str(vid),
                                "index": mesh.data_index + served * mesh.data}
                served += 1
            for fin in engine.step():
                finish_t[fin.rid] = time.perf_counter()
                results[fin.rid]["tokens"] = fin.tokens
        if served >= n_local:
            break
    batches.close()  # stops the loader's workers
    _short(mesh, served, n_local)
    for fin in engine.run_to_completion():
        finish_t[fin.rid] = time.perf_counter()
        results[fin.rid]["tokens"] = fin.tokens
    wall = time.perf_counter() - t_start

    out = []
    for rid, r in sorted(results.items()):
        toks = r.get("tokens", [])
        out.append({"video_id": r["video_id"],
                    "caption": _caption(tok, toks, engine.config.eos_id),
                    "tokens": toks, "n_tokens": len(toks),
                    "latency_s": finish_t.get(rid, 0) - submit_t.get(rid, 0),
                    "index": r["index"]})
    return out, wall, engine


def run_speculative(args, cfg, model, device):
    """Lock-step speculative serving (the JAX CLI's ``_serve_speculative``):
    ``speculative_local`` on this rank, merged as ``run`` merges.  Returns
    (stats, per-request results, this rank's own results)."""
    local, wall, extra = speculative_local(args, cfg, model, device)
    return (*_merge(model.mesh or mesh_lib.Mesh(), local, wall, extra),
            local)


@torch.inference_mode()
def speculative_local(args, cfg, model, device):
    """The clips' batches of ``batch_size`` each decoded through
    ``ngram_speculative_generate`` (``--draft ngram``) or
    ``speculative_generate`` with the decoder's ``--draft_layers``-deep
    twin as the draft; under a process group this data rank's shard of
    them.  On a model shard the twin is the shard's (``twin_draft``),
    and sampled rounds would draw from a generator seeded as the engine's
    (the data coordinate folded in).  Returns (this rank's results, each
    with its request ``index`` in the run, the wall seconds, the stats'
    speculative keys)."""
    mesh = model.mesh or mesh_lib.Mesh()
    test = run_caption.dataset(args, cfg, train=False)
    n_local = local_requests(run_requests(args, cfg, test), mesh)
    lm = model.text_decoder
    prompt_vec, prompt_len, gen_cfg = _prompt(cfg)
    tok = _tokenizer(cfg)
    k = args.speculative
    d_layers = 0
    if args.draft == "twin":
        d_layers = args.draft_layers \
            or max(cfg.model.text.num_hidden_layers // 4, 1)
        draft = twin_draft(lm, d_layers)
    generator = make_rngs(args.seed, 0, ("sample",), device, mesh,
                          ("data",))["sample"]
    results, out = [], None
    t_start = time.perf_counter()
    batches = clip_batches(args, cfg, mesh, test)
    for clips, vids in batches:
        if len(results) >= n_local:
            break
        video = normalize_clip(torch.from_numpy(clips).to(device),
                               dtype=model.policy.compute_dtype)
        qe = model.encode_queries(video)
        b = qe.shape[0]
        prompt = torch.tensor([prompt_vec] * b, device=device)
        plen = torch.full((b,), max(prompt_len, 1), device=device)
        t0 = time.perf_counter()
        if args.draft == "ngram":
            out = ngram_speculative_generate(
                lm, prompt, plen, config=gen_cfg, speculate_len=k,
                ngram=args.ngram_n, query_embeds=qe)
        else:
            out = speculative_generate(lm, draft, prompt, plen,
                                       config=gen_cfg, speculate_len=k,
                                       query_embeds=qe, generator=generator)
        seqs = out["sequences"].cpu().numpy()
        dt = time.perf_counter() - t0
        for vid, seq in zip(vids[:n_local - len(results)], seqs):
            toks = [int(t) for t in seq if t != gen_cfg.pad_id]
            results.append({"video_id": str(vid),
                            "caption": _caption(tok, toks, gen_cfg.eos_id),
                            "tokens": toks, "n_tokens": len(toks),
                            "latency_s": dt, "index": mesh.data_index
                            + len(results) * mesh.data})
    batches.close()
    _short(mesh, len(results), n_local)
    wall = time.perf_counter() - t_start
    return results, wall, {
        "speculative_k": k, "draft": args.draft, "draft_layers": d_layers,
        "tokens_per_round": round(out["tokens_per_round"], 3)
        if results else None}


def rank_stats(model, device, engine, local, wall_s, build_peak) -> dict:
    """This rank's own record of a split run (``ranks/rank<r>.json``):
    ``local`` its results (``engine`` None under ``--speculative``); the
    peak device memory of the build (the whole model, before its shard is
    kept) and of the serve after it."""
    mesh = model.mesh
    cuda = device.type == "cuda"
    return {
        "rank": mesh.rank, "coord": list(mesh.coord),
        "split": {"data": mesh.data, "model": mesh.model},
        "device": str(device), "results": local,
        "decode_steps": getattr(engine, "decode_steps", None),
        "graph_replays": getattr(engine, "graph_replays", None),
        "launches": {f"{fn.__name__}.{attr}": getattr(fn, attr)
                     for fn, attr in COUNTERS},
        "peak_memory_bytes": torch.cuda.max_memory_allocated(device)
        if cuda else None,
        "build_peak_memory_bytes": build_peak, "wall_s": wall_s}


def serve_built(args, cfg, model, device) -> dict:
    """``main`` after ``build``: serve, write the results (and under a
    process group this rank's ``ranks/rank<r>.json``), print the stats
    on rank 0; returns the stats.  The model stays built for the caller."""
    build_peak = None
    if device.type == "cuda":  # the serve's peak, after the build's
        build_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    mesh = model.mesh
    engine = local = None
    if args.speculative > 0:
        stats, out, local = run_speculative(args, cfg, model, device)
    else:
        local, wall, engine = serve_local(args, cfg, model, device)
        stats, out = _merge(mesh, local, wall)
    os.makedirs(args.output_dir, exist_ok=True)
    if mesh.distributed:
        os.makedirs(os.path.join(args.output_dir, "ranks"), exist_ok=True)
        with open(os.path.join(args.output_dir, "ranks",
                               f"rank{mesh.rank}.json"), "w") as f:
            json.dump(rank_stats(model, device, engine, local,
                                 time.perf_counter() - t0, build_peak),
                      f, ensure_ascii=False)
    if mesh.rank == 0:
        with open(os.path.join(args.output_dir, "serve_results.json"),
                  "w") as f:
            json.dump(out, f, ensure_ascii=False)
        print("* Serve stats:", json.dumps(stats), flush=True)
    return stats


def main(args):
    def body():
        cfg, model, device = build(args)
        return serve_built(args, cfg, model, device)
    return common.run_main(body)


if __name__ == "__main__":
    main(serve_parser().parse_args())
