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
the checkpoint's values bitwise).  Real video files and text decoding are
not ported yet, so results carry token ids.  A YAML with
``text_overrides: {kv_cache_dtype: int8}`` serves over the int8 KV cache
(``ops/kv_cache.py``).

Usage (synthetic smoke, GPU):
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
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from youku_mplug_tpu_torch.bridge import seeded_init
from youku_mplug_tpu_torch.cli import common
from youku_mplug_tpu_torch.config import load_config
from youku_mplug_tpu_torch.data.datasets import SyntheticVideoDataset
from youku_mplug_tpu_torch.models import importers
from youku_mplug_tpu_torch.models.generation import GenerationConfig
from youku_mplug_tpu_torch.models.tasks import MPLUGVideo
from youku_mplug_tpu_torch.models.tokenizer import load_tokenizer
from youku_mplug_tpu_torch.ops.preprocess import normalize_clip
from youku_mplug_tpu_torch.runtime.precision import (
    BF16_POLICY,
    DEFAULT_POLICY,
)
from youku_mplug_tpu_torch.serving.engine import ServingEngine
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
                   help="procedural videos (the only source ported so far)")
    p.add_argument("--device", default="cuda",
                   help="cuda[:i] (default), or cpu")
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


def _clip_batches(cfg, num_frames: int, size: int):
    """Batches of uint8 (B, T, H, W, C) synthetic clips and their ids, in
    order, dropping the last partial batch (the JAX loader's contract)."""
    ds = SyntheticVideoDataset(length=cfg.get("synthetic_length", 32),
                               num_frames=num_frames, size=size)
    bs = cfg.batch_size
    for start in range(0, len(ds) - bs + 1, bs):
        items = [ds[i] for i in range(start, start + bs)]
        yield (np.stack([it["video"] for it in items]),
               [it["video_id"] for it in items])


def build(args):
    """-> (run config, model on the device, device), its weights as the
    module docstring says.  Raises when the requested device is absent:
    nothing falls back to the CPU."""
    if not args.synthetic_data:
        raise NotImplementedError("only --synthetic_data is ported yet")
    device = common.device_of(args)
    cfg = load_config(args.config)
    resume = bool(args.resume or args.evaluate_only)
    policy = DEFAULT_POLICY if resume else BF16_POLICY
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
    return cfg, model.eval(), device


def _prompt(cfg):
    """-> (prompt ids, their true length, generation config): the JAX
    CLI's prompt, the tokenized prompt minus its trailing eos."""
    tok = load_tokenizer(cfg.get("text_decoder", ""),
                         cfg.model.text.vocab_size)
    ids = tok.tokenize(cfg.prompt)[:cfg.max_length]
    prompt_len = len(ids) - 1
    gen_cfg = GenerationConfig(
        max_new_tokens=int(cfg.get("max_new_tokens", 32)), do_sample=False,
        eos_id=tok.eos_id, pad_id=tok.pad_id)
    return ids[:max(prompt_len, 1)], prompt_len, gen_cfg


def make_engine(args, cfg, lm):
    """-> (the serving engine over ``lm``, the prompt ids every request
    carries): the prefill bucket is the next power of two >= the prompt
    (from 8), the cache holds queries + bucket + max_new_tokens + 1 rows
    unless ``--serve_max_len`` says otherwise."""
    prompt_vec, prompt_len, gen_cfg = _prompt(cfg)
    nq = cfg.model.num_learnable_token
    bucket = max(8, 1 << (max(prompt_len, 1) - 1).bit_length())
    max_len = args.serve_max_len or (nq + bucket + gen_cfg.max_new_tokens
                                     + 1)
    return ServingEngine(lm, num_slots=args.num_slots, max_len=max_len,
                         prefill_buckets=(bucket,), config=gen_cfg), \
        prompt_vec


def run(args, cfg, model, device):
    """Serve ``args.num_requests`` synthetic clips.  Returns
    (stats, per-request results, the engine)."""
    engine, prompt_vec = make_engine(args, cfg, model.text_decoder)
    max_new = engine.config.max_new_tokens

    pending = []  # (video_id, query_embeds row)
    results, submit_t, finish_t = {}, {}, {}
    served = 0
    t_start = time.perf_counter()
    for clips, vids in _clip_batches(cfg, cfg.num_frames, cfg.image_res):
        with torch.inference_mode():
            video = normalize_clip(torch.from_numpy(clips).to(device),
                                   dtype=model.policy.compute_dtype)
            qe = model.encode_queries(video)
        pending.extend(zip(vids, qe))
        while pending and served < args.num_requests:
            # admit a trickle per step, decode everything in flight
            for _ in range(min(args.admit_per_step, len(pending))):
                if served >= args.num_requests:
                    break
                vid, q = pending.pop(0)
                rid = engine.submit(prompt_vec, query_embeds=q,
                                    max_new_tokens=max_new)
                submit_t[rid] = time.perf_counter()
                results[rid] = {"video_id": str(vid)}
                served += 1
            for fin in engine.step():
                finish_t[fin.rid] = time.perf_counter()
                results[fin.rid]["tokens"] = fin.tokens
        if served >= args.num_requests:
            break
    for fin in engine.run_to_completion():
        finish_t[fin.rid] = time.perf_counter()
        results[fin.rid]["tokens"] = fin.tokens
    wall = time.perf_counter() - t_start

    out = []
    for rid, r in sorted(results.items()):
        toks = r.get("tokens", [])
        out.append({"video_id": r["video_id"], "tokens": toks,
                    "n_tokens": len(toks),
                    "latency_s": finish_t.get(rid, 0) - submit_t.get(rid, 0)})
    lat = [o["latency_s"] for o in out if o["latency_s"] > 0]
    stats = {
        "requests": len(out),
        "wall_s": round(wall, 3),
        "tokens_per_sec": round(sum(o["n_tokens"] for o in out)
                                / max(wall, 1e-9), 2),
        "latency_p50_s": round(float(np.percentile(lat, 50)), 4) if lat
        else None,
        "latency_p95_s": round(float(np.percentile(lat, 95)), 4) if lat
        else None,
    }
    return stats, out, engine


@torch.inference_mode()
def run_speculative(args, cfg, model, device):
    """Lock-step speculative serving (the JAX CLI's ``_serve_speculative``):
    the clips' batches of ``batch_size`` are each decoded through
    ``ngram_speculative_generate`` (``--draft ngram``) or
    ``speculative_generate`` with the decoder's ``--draft_layers``-deep
    twin as the draft.  Returns (stats, per-request results)."""
    lm = model.text_decoder
    prompt_vec, prompt_len, gen_cfg = _prompt(cfg)
    k = args.speculative
    d_layers = 0
    if args.draft == "twin":
        d_layers = args.draft_layers \
            or max(cfg.model.text.num_hidden_layers // 4, 1)
        draft = twin_draft(lm, d_layers)
    results, out = [], None
    t_start = time.perf_counter()
    for clips, vids in _clip_batches(cfg, cfg.num_frames, cfg.image_res):
        if len(results) >= args.num_requests:
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
                                       query_embeds=qe)
        seqs = out["sequences"].cpu().numpy()
        dt = time.perf_counter() - t0
        for vid, seq in zip(vids[:args.num_requests - len(results)], seqs):
            toks = [int(t) for t in seq if t != gen_cfg.pad_id]
            results.append({"video_id": str(vid), "tokens": toks,
                            "n_tokens": len(toks), "latency_s": dt})
    wall = time.perf_counter() - t_start
    stats = {"requests": len(results), "wall_s": round(wall, 3),
             "tokens_per_sec": round(sum(r["n_tokens"] for r in results)
                                     / max(wall, 1e-9), 2),
             "speculative_k": k, "draft": args.draft,
             "draft_layers": d_layers,
             "tokens_per_round": round(out["tokens_per_round"], 3)
             if results else None}
    return stats, results


def main(args):
    cfg, model, device = build(args)
    if args.speculative > 0:
        stats, out = run_speculative(args, cfg, model, device)
    else:
        stats, out, _ = run(args, cfg, model, device)
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "serve_results.json"), "w") as f:
        json.dump(out, f)
    print("* Serve stats:", json.dumps(stats), flush=True)
    return stats


if __name__ == "__main__":
    main(serve_parser().parse_args())
