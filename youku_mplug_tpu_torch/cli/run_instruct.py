"""mPLUG-Video BloomZ-7B video instruct on the port: serving, and
instruction finetuning with ``--train``.

Counterpart of ``youku_mplug_tpu/cli/run_instruct.py``.  Serving
(inference through the engine): Human/AI prompts with one ``<|video|>``
placeholder are expanded to the media positions, the clips are encoded
(per-frame CLIP ViT, visual abstractor, ``visual_fc`` and ``vit_eos``)
and spliced into the prompt embeddings in one batch, and every request is
admitted to the continuous-batching engine's slot pool as slots free, the
Bloom decoder decoding over the stacked cache: bf16, or int8 with
per-(token, head) scales when the YAML sets ``text_overrides:
{kv_cache_dtype: int8}`` (``configs/instruct/serve_bloomz_7b_int8.yaml``).
Decoding is greedy, or sampled with the YAML's ``do_sample``, ``top_k``
(default 5) and ``top_p`` (default 0.9) from a generator seeded with
``--seed + 1`` (``configs/instruct/serve_bloomz_7b_sample.yaml``);
``--lookup_k k`` adds greedy prompt-lookup speculation (k proposals a
slot, one verify chunk a dispatch).
``--int8`` serves int8 decoder weights: the kernels and the tied embedding
quantized in place after the init (a port option with no JAX counterpart;
it gives the form ``cli/export_serving.py --int8 --int8_embedding``
writes).  Serving always runs through the engine: the batched
``generate`` is not ported, so ``--engine`` is accepted for the JAX
runner's command lines and changes nothing.

Training (``--train``, the mPLUG-Owl finetune recipe): synthetic clips
with their captions as answers to a fixed question, the response-masked
LM loss, a frozen ViT and a frozen bf16 Bloom whose LoRA adapters train
in fp32 beside the abstractor, ``visual_fc`` and ``vit_eos``, AdamW; one
JSON line per step (``--log_freq``) and one ``log.txt`` line per epoch,
through ``cli/common.py``'s epoch loop, which saves a checkpoint each
``--save_ckpt_freq`` epochs under ``<output_dir>/checkpoints`` and resumes
from ``--resume <run dir>`` or the run's own checkpoints, as the JAX
runner does.

Weights, as the JAX runner has them: a seeded init (serving) or the JAX
``model.init`` rules (``--train``: ``bridge.jax_init``); then with
``--hf_checkpoint <dir>`` an HF mPLUG-Owl checkpoint imported over them
(``models/importers.import_owl``: ``pytorch_model*.bin`` or
``*.safetensors``, fail-loud).  ``--serving_ckpt <dir>`` serves the
export of a trained run (``cli/export_serving.py --owl``) in their place:
the LoRA ranks are 0 (the adapters are merged), and the decoder is int8
exactly when the export's ``qscales`` say so (``--int8`` beside it
raises).  Real video files, jsonl training data and beam search are not
ported yet (ROADMAP.md, Queue 1), and each raises; HF tokenizer files
(the JAX runner's ``--tokenizer``) are not ported either.  Results carry
token ids (the synthetic runs' hash tokenizer has no text).

Usage (the card is the default device; ``--device cpu`` runs a tiny
config on the CPU):
    python -m youku_mplug_tpu_torch.cli.run_instruct \\
        --config configs/instruct/serve_bloomz_7b_flagship.yaml \\
        --synthetic_data --engine
    python -m youku_mplug_tpu_torch.cli.run_instruct \\
        --config configs/instruct/serve_bloomz_7b_int8.yaml \\
        --synthetic_data --engine --int8
    python -m youku_mplug_tpu_torch.cli.run_instruct \\
        --config configs/instruct/serve_bloomz_7b_sample.yaml \\
        --synthetic_data --engine
    python -m youku_mplug_tpu_torch.cli.run_instruct \\
        --config configs/instruct/serve_bloomz_7b_flagship.yaml \\
        --synthetic_data --engine --lookup_k 4
    python -m youku_mplug_tpu_torch.cli.run_instruct --train \\
        --config configs/instruct/train_bloomz_7b_flagship.yaml \\
        --synthetic_data --max_steps 8 --output_dir out \\
        [--hf_checkpoint <HF mPLUG-Owl dir>]
    python -m youku_mplug_tpu_torch.cli.export_serving --owl --int8 \\
        --int8_embedding --run_dir out \\
        --config configs/instruct/train_bloomz_7b_flagship.yaml \\
        --dest out/serving
    python -m youku_mplug_tpu_torch.cli.run_instruct \\
        --config configs/instruct/serve_bloomz_7b_int8.yaml \\
        --synthetic_data --engine --serving_ckpt out/serving
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from youku_mplug_tpu_torch.bridge import jax_init, load_jax_params, seeded_init
from youku_mplug_tpu_torch.cli import common
from youku_mplug_tpu_torch.config import (
    InstructTrainConfig,
    instruct_train_config,
    load_owl_config,
)
from youku_mplug_tpu_torch.data.datasets import SyntheticVideoDataset
from youku_mplug_tpu_torch.data.instruct import (
    VIDEO_PLACEHOLDER,
    WhitespaceTokenizer,
    build_instruct_batch,
    build_instruct_train_batch,
    format_prompt,
)
from youku_mplug_tpu_torch.data.loader import Loader
from youku_mplug_tpu_torch.models import importers
from youku_mplug_tpu_torch.models.generation import GenerationConfig
from youku_mplug_tpu_torch.models.owl import MPLUGOwlVideo
from youku_mplug_tpu_torch.ops import kv_cache as kvc
from youku_mplug_tpu_torch.ops import quant
from youku_mplug_tpu_torch.ops.preprocess import normalize_clip
from youku_mplug_tpu_torch.runtime.precision import (
    BF16_POLICY,
    DEFAULT_POLICY,
)
from youku_mplug_tpu_torch.serving.engine import ServingEngine
from youku_mplug_tpu_torch.train.checkpoint import CheckpointManager
from youku_mplug_tpu_torch.train.state import create_train_state
from youku_mplug_tpu_torch.train.trainer import make_train_step

# the question each synthetic caption answers (the JAX runner's)
SYNTHETIC_QUESTION = "What is shown in the video ?"


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="mPLUG-Video BloomZ video-instruct serving (PyTorch)")
    p.add_argument("--config", required=True, help="YAML run config")
    p.add_argument("--output_dir", default="./output")
    p.add_argument("--input_jsonl", default="",
                   help="rows {'video': path, 'question': text} (or "
                        "'prompt' for a pre-formatted conversation)")
    p.add_argument("--video", default="", help="one-off video path")
    p.add_argument("--question", default="", help="one-off question")
    p.add_argument("--synthetic_data", action="store_true",
                   help="seeded random clips in place of video files")
    p.add_argument("--seed", type=int, default=42,
                   help="seed of the weight init and the synthetic clips")
    p.add_argument("--max_new_tokens", type=int, default=0,
                   help="override the config's max_new_tokens")
    p.add_argument("--engine", action="store_true",
                   help="serve through the continuous-batching engine (the "
                        "only serving path of the port)")
    p.add_argument("--num_slots", type=int, default=4,
                   help="engine slot-pool size")
    p.add_argument("--lookup_k", type=int, default=0,
                   help="--engine: k>0 adds prompt-lookup speculative "
                        "steps (greedy-only, token-exact)")
    p.add_argument("--device", default="cuda",
                   help="cuda[:i] (default), or cpu")
    p.add_argument("--int8", action="store_true",
                   help="int8 decoder kernels and tied embedding, quantized "
                        "in place after the init (the form export_serving "
                        "--int8 --int8_embedding writes)")
    p.add_argument("--hf_checkpoint", default="",
                   help="HF mPLUG-Owl checkpoint directory to import")
    p.add_argument("--serving_ckpt", default="",
                   help="serving checkpoint directory from "
                        "cli/export_serving.py --owl (LoRA merged, int8 "
                        "where exported so), used instead of init / HF")
    # ---- instruction finetuning -------------------------------------
    p.add_argument("--train", action="store_true",
                   help="instruction-finetune instead of serving: "
                        "response-masked LM loss, frozen ViT and Bloom "
                        "(+LoRA when text_overrides.lora_rank > 0), "
                        "trainable abstractor / visual_fc / vit_eos")
    p.add_argument("--resume", default="",
                   help="--train: run (or checkpoints) directory to resume "
                        "from")
    p.add_argument("--max_steps", type=int, default=-1,
                   help="cap steps per epoch (smoke runs)")
    p.add_argument("--save_ckpt_freq", type=int, default=1)
    p.add_argument("--auto_resume_iter", action="store_true", default=True,
                   help="roll back after 3 non-finite steps in a row")
    p.add_argument("--log_freq", type=int, default=1,
                   help="print every log_freq-th step's metrics")
    return p


def load_serving_ckpt(directory: str):
    """The latest step of a ``cli/export_serving.py`` checkpoint ->
    (params tree, qscales tree or None, step), on the CPU."""
    sc = CheckpointManager(directory)
    step = sc.latest_step()
    if step is None:
        raise SystemExit(f"no serving checkpoint under {directory}")
    raw = sc.restore_raw(step, map_location="cpu")
    return raw["params"], raw.get("qscales"), step


def build(args):
    """-> (model config, raw YAML dict, model on the device, device) for
    serving, its weights as the module docstring says.  Raises when the
    device is absent: nothing falls back to the CPU."""
    device = common.device_of(args)
    if args.int8 and args.serving_ckpt:
        raise ValueError("--int8 quantizes an initialized decoder; a "
                         "--serving_ckpt is int8 exactly where "
                         "export_serving --int8 made it so")
    cfg, raw = load_owl_config(args.config)
    if int(raw.get("beam_size", 1)) > 1:
        raise ValueError("the engine serves beam_size=1 (beam search is not "
                         "ported yet)")
    if args.serving_ckpt:  # the export merged the adapters
        cfg = dataclasses.replace(
            cfg, text=dataclasses.replace(cfg.text, lora_rank=0),
            vision=dataclasses.replace(cfg.vision, lora_rank=0))
    with device:  # built on the device: no host copy of 7B
        model = MPLUGOwlVideo(cfg, BF16_POLICY)
    if args.serving_ckpt:
        params, qscales, step = load_serving_ckpt(args.serving_ckpt)
        load_jax_params(model, params, qscales)
        del params
        print(f"loaded serving checkpoint step {step} "
              f"(int8={qscales is not None})", flush=True)
    else:
        seeded_init(model, args.seed)
        if args.hf_checkpoint:
            importers.import_owl(model, cfg, args.hf_checkpoint)
    if args.int8:
        quant.quantize_decoder_(model.text_decoder, include_embedding=True)
    return cfg, raw, model.eval(), device


def load_rows(args):
    """The requests: the jsonl rows, or one row from --question (or a
    default question under --synthetic_data)."""
    if args.input_jsonl:
        with open(args.input_jsonl) as f:
            rows = [json.loads(line) for line in f if line.strip()]
    elif args.question or args.synthetic_data:
        rows = [{"video": args.video,
                 "question": args.question or "What is in the video?"}]
    else:
        rows = []
    if not rows:
        raise SystemExit("nothing to do: pass --input_jsonl or --question")
    return rows


def load_videos(args, raw_cfg, rows) -> np.ndarray:
    """[B, T, H, W, C] uint8 clips, one per row: under --synthetic_data
    drawn from ``np.random.default_rng(seed)`` exactly as the JAX runner
    draws them; decoding video files is not ported yet."""
    t = int(raw_cfg.get("num_frames", 8))
    res = int(raw_cfg.get("image_res", 224))
    if not args.synthetic_data:
        raise NotImplementedError("decoding video files is not ported yet; "
                                  "use --synthetic_data")
    rng = np.random.default_rng(args.seed)
    return rng.integers(0, 255, size=(len(rows), t, res, res, 3),
                        dtype=np.uint8)


def generation_config(args, cfg, raw_cfg) -> GenerationConfig:
    """The YAML's decoding block, with the JAX runner's defaults."""
    return GenerationConfig(
        max_new_tokens=args.max_new_tokens
        or int(raw_cfg.get("max_new_tokens", 128)),
        eos_id=cfg.text.eos_id, pad_id=cfg.text.pad_id,
        do_sample=bool(raw_cfg.get("do_sample", False)),
        top_k=int(raw_cfg.get("top_k", 5)),
        top_p=float(raw_cfg.get("top_p", 0.9)),
        beam_size=int(raw_cfg.get("beam_size", 1)))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_engine(lm, prompt_len, gen_cfg: GenerationConfig, num_slots: int,
                generator: Optional[torch.Generator] = None
                ) -> ServingEngine:
    """The engine ``serve_instruct`` serves prompts of ``prompt_len``
    tokens with: the prefill bucket is the next power of two >= the
    longest (from 8); the cache holds bucket + max_new_tokens + 2 rows."""
    bucket = 8
    while bucket < int(np.max(prompt_len)):
        bucket *= 2
    return ServingEngine(lm, num_slots=num_slots,
                         max_len=bucket + gen_cfg.max_new_tokens + 2,
                         prefill_buckets=(bucket,), config=gen_cfg,
                         generator=generator)


@torch.inference_mode()
def serve_instruct(model: MPLUGOwlVideo, clips: torch.Tensor, batch,
                   gen_cfg: GenerationConfig, *, num_slots: int = 4,
                   lookup_k: int = 0,
                   generator: Optional[torch.Generator] = None):
    """Instruct inference through the continuous-batching engine (the JAX
    runner's ``serve_instruct``): encode and splice every request in one
    batch, submit them all, and admit each to the slot pool as slots free;
    ``lookup_k > 0`` decodes with ``step_lookup(lookup_k)``, else one
    ``step`` at a time.  Sampling draws come from ``generator``.  The
    engine is ``make_engine``'s.

    clips: normalized [B, C, T, H, W] on the model's device; batch: the
    ``build_instruct_batch`` dict.  Returns (sequences [B, max_new_tokens]
    int32 right-padded with pad_id, stats, the engine); the stats name
    the cache's dtype and the decoder's weight and cache bytes."""
    dev = clips.device
    input_ids = torch.as_tensor(batch["input_ids"], device=dev).long()
    media_mask = torch.as_tensor(batch["media_mask"], device=dev)
    prompt_len = np.asarray(batch["prompt_len"])
    b = input_ids.shape[0]

    t0 = time.perf_counter()
    qf = model.encode_video(clips)
    embeds = model.spliced_embeds(input_ids, media_mask, qf)
    _sync(dev)
    t_encoded = time.perf_counter()

    engine = make_engine(model.text_decoder, prompt_len, gen_cfg,
                         min(num_slots, b), generator)
    row_of = {}
    for i in range(b):
        n = int(prompt_len[i])
        rid = engine.submit(batch["input_ids"][i, :n].tolist(),
                            prompt_embeds=embeds[i, :n])
        row_of[rid] = i
    seqs = np.full((b, gen_cfg.max_new_tokens), gen_cfg.pad_id, np.int32)
    done_at = {}
    steps = 0
    while not engine.idle:
        for fin in (engine.step_lookup(lookup_k) if lookup_k > 0
                    else engine.step()):
            toks = fin.tokens[:gen_cfg.max_new_tokens]
            seqs[row_of[fin.rid], :len(toks)] = toks
            done_at[fin.rid] = time.perf_counter()
        steps += 1
    wall = time.perf_counter() - t0
    lat = [done_at[rid] - t0 for rid in sorted(done_at)]
    n_tok = int((seqs != gen_cfg.pad_id).sum())
    stats = {
        "requests": b, "new_tokens": n_tok, "engine_steps": steps,
        "wall_s": wall, "encode_s": t_encoded - t0,
        "tokens_per_sec": n_tok / max(wall, 1e-9),
        "latency_p50_s": float(np.percentile(lat, 50)),
        "latency_p95_s": float(np.percentile(lat, 95)),
        "peak_memory_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                            if dev.type == "cuda" else None),
        "nonfinite_logits": engine.nonfinite_logits,
        "kv_cache_dtype": str(kvc.leaves(engine.cache)[0].dtype
                              ).removeprefix("torch."),
        "cache_bytes": kvc.nbytes(engine.cache),
        "decoder_weight_bytes": quant.decoder_bytes(model.text_decoder),
    }
    return seqs, stats, engine


def prepare(args, cfg, raw_cfg, device, compute_dtype):
    """-> (rows, instruct batch, normalized clips on the device)."""
    rows = load_rows(args)
    prompts = [r.get("prompt") or format_prompt(r["question"])
               for r in rows]
    for p in prompts:
        if VIDEO_PLACEHOLDER not in p:
            raise ValueError(f"prompt lacks {VIDEO_PLACEHOLDER}: {p[:80]!r}")
    tok = WhitespaceTokenizer(cfg.text.vocab_size, eos_id=cfg.text.eos_id,
                              pad_id=cfg.text.pad_id)
    batch = build_instruct_batch(prompts, tok, cfg.num_media_tokens,
                                 pad_id=cfg.text.pad_id)
    video = load_videos(args, raw_cfg, rows)
    clips = normalize_clip(torch.from_numpy(video).to(device),
                           dtype=compute_dtype)
    return rows, batch, clips


def build_train_loader(args, tcfg: InstructTrainConfig, res: int) -> Loader:
    """Synthetic clips (``synthetic_length`` of them) in the JAX runner's
    shuffled order; jsonl training data is not ported yet."""
    if not args.synthetic_data:
        raise NotImplementedError(
            "instruct training reads --synthetic_data only; jsonl datasets "
            "and video decoding are not ported yet (ROADMAP.md, Queue 1)")
    ds = SyntheticVideoDataset(length=tcfg.synthetic_length,
                               num_frames=tcfg.num_frames, size=res)
    return Loader(ds, tcfg.batch_size, seed=args.seed)


def train_setup(args) -> common.Runner:
    """Config, loader, the model on the device (``jax_init``, then
    ``--hf_checkpoint`` imported over it), the trainable/frozen split
    (frozen leaves in bf16; LoRA adapters stay fp32 and train), AdamW,
    whose schedule spans ``min(len(loader), max_steps)`` updates per
    epoch, the checkpoints and the resume (``common.resume_state``)."""
    device = common.device_of(args)
    cfg, raw = load_owl_config(args.config)
    tcfg = instruct_train_config(raw)
    loader = build_train_loader(args, tcfg, cfg.vision.img_size)
    niter = len(loader) if args.max_steps <= 0 else min(len(loader),
                                                        args.max_steps)
    tcfg = dataclasses.replace(tcfg, optimizer=dataclasses.replace(
        tcfg.optimizer, niter_per_ep=max(niter, 1)))
    with device:  # built and seeded on the device
        model = MPLUGOwlVideo(cfg, DEFAULT_POLICY)
    jax_init(model, args.seed)  # the JAX runner's model.init rules
    if args.hf_checkpoint:  # before the split casts the frozen leaves
        importers.import_owl(model, cfg, args.hf_checkpoint)
    state, _, schedule = create_train_state(
        model, tcfg.optimizer, frozen_dtype=DEFAULT_POLICY.compute_dtype)
    os.makedirs(args.output_dir, exist_ok=True)
    ckpt = CheckpointManager(
        os.path.join(args.output_dir, "checkpoints"),
        async_save=bool(raw.get("async_checkpointing", False)))
    state, start_epoch = common.resume_state(args, ckpt, state)
    tok = WhitespaceTokenizer(cfg.text.vocab_size, eos_id=cfg.text.eos_id,
                              pad_id=cfg.text.pad_id)
    return common.Runner(
        args=args, cfg=tcfg, device=device, model=model.train(),
        tokenizer=tok, state=state, schedule=schedule, loader=loader,
        ckpt=ckpt, start_epoch=start_epoch)


def make_instruct_batch(runner: common.Runner, raw):
    """Loader rows -> ``instruct_loss`` inputs on the device: each
    synthetic caption is the answer to ``SYNTHETIC_QUESTION``."""
    text = runner.model.cfg.text
    batch = build_instruct_train_batch(
        [(SYNTHETIC_QUESTION, caption) for caption in raw["text"]],
        runner.tokenizer, runner.model.cfg.num_media_tokens,
        pad_id=text.pad_id, eos_id=text.eos_id,
        max_length=runner.cfg.max_length)
    dev = runner.device
    out = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    out["input_ids"] = out["input_ids"].long()
    out["video"] = torch.from_numpy(raw["video"]).to(dev)
    return out


def make_loss_fn(model: MPLUGOwlVideo):
    def loss_fn(batch):
        video = normalize_clip(batch["video"],
                               dtype=model.policy.compute_dtype)
        return model.instruct_loss(video, batch["input_ids"],
                                   batch["attention_mask"],
                                   batch["media_mask"], batch["prompt_mask"])
    return loss_fn


def build_train_step(runner: common.Runner):
    return make_train_step(make_loss_fn(runner.model),
                           update_freq=runner.cfg.update_freq)


def train_main(args) -> common.Runner:
    """Instruction finetuning: every epoch of the YAML through
    ``cli/common.py``'s epoch loop (see the module docstring)."""
    runner = train_setup(args)
    return common.train_epochs(runner, build_train_step(runner),
                               make_instruct_batch)


def main(args):
    if args.train:
        return train_main(args)
    cfg, raw_cfg, model, device = build(args)
    rows, batch, clips = prepare(args, cfg, raw_cfg, device,
                                 model.policy.compute_dtype)
    seqs, stats, _ = serve_instruct(
        model, clips, batch, generation_config(args, cfg, raw_cfg),
        num_slots=args.num_slots, lookup_k=args.lookup_k,
        generator=torch.Generator(device).manual_seed(args.seed + 1))
    tok = WhitespaceTokenizer(cfg.text.vocab_size)
    results = []
    for r, seq in zip(rows, seqs):
        keep = seq[(seq != cfg.text.pad_id) & (seq != cfg.text.eos_id)]
        results.append({**{k: v for k, v in r.items() if k != "prompt"},
                        "tokens": keep.tolist(),
                        "answer": tok.decode(keep)})
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "instruct_results.json"),
              "w") as f:
        json.dump(results, f, ensure_ascii=False, indent=1)
    print("* Instruct stats:", json.dumps(stats), flush=True)
    return results, stats


if __name__ == "__main__":
    main(parser().parse_args())
