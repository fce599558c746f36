"""mPLUG-Video BloomZ-7B video instruct on the port: serving, and
instruction finetuning with ``--train``.

Counterpart of ``youku_mplug_tpu/cli/run_instruct.py``.  Serving: Human/AI
prompts with one ``<|video|>`` placeholder are expanded to the media
positions, the clips are encoded (per-frame CLIP ViT, visual abstractor,
``visual_fc`` and ``vit_eos``) and spliced into the prompt embeddings in
one batch, and the Bloom decoder answers over the stacked cache: bf16, or
int8 with per-(token, head) scales when the YAML sets ``text_overrides:
{kv_cache_dtype: int8}`` (``configs/instruct/serve_bloomz_7b_int8.yaml``);
``--fp32`` serves fp32 weights and compute.  Two paths, as in the JAX runner:

- without ``--engine``, one lock-step batch through
  ``models/owl.generate_instruct``: greedy, sampled with the YAML's
  ``do_sample``, ``top_k`` (default 5) and ``top_p`` (default 0.9), or
  beam search when the YAML sets ``beam_size > 1`` (the 2K candidates and
  finished pool of ``models/generation.py``; every beam step runs the
  decode kernel over the B x beam_size cache rows);
- with ``--engine``, the continuous-batching engine: every request is
  admitted to the slot pool as slots free; greedy or sampled, and
  ``--lookup_k k`` adds greedy prompt-lookup speculation (k proposals a
  slot, one verify chunk a dispatch).  The engine refuses
  ``beam_size > 1``.

Sampled draws come from a generator seeded with ``--seed + 1``
(``configs/instruct/serve_bloomz_7b_sample.yaml``).  ``--int8`` serves
int8 decoder weights: the kernels and the tied embedding quantized in
place after the init (a port option with no JAX counterpart; it gives the
form ``cli/export_serving.py --int8 --int8_embedding`` writes).

Text: ``--tokenizer <dir or tokenizer.json>`` names HF tokenizer files
(BloomZ's, read through ``tokenizers`` by ``models/hf_tokenizer.py``,
as ``AutoTokenizer`` reads them); each result's ``answer`` is the
tokenizer's decode of its kept tokens (``tokens``: the ids but pad and
eos), stripped.  Without it the whitespace hash tokenizer of synthetic
runs takes the prompts, as in the JAX runner, and an answer is its ids
written ``<id>``.  ``--train`` takes the same tokenizer.

The requests are the ``--input_jsonl`` rows (``video``, ``question`` or
a pre-formatted ``prompt``) or one ``--video`` with ``--question``; each
clip is decoded from its file (``num_frames`` frames at the ``middle``
of their intervals, resized to ``image_res``), or with
``--synthetic_data`` drawn at random.

Training (``--train``, the mPLUG-Owl finetune recipe): the rows of
``--train_jsonl`` or the YAML's ``train_file`` (``video`` under
``video_root``, ``question`` or ``prompt``, ``answer``; the train
transform, ``num_workers`` decode threads), or with ``--synthetic_data``
synthetic clips with their captions as answers to a fixed question; the
response-masked LM loss, a frozen ViT and a frozen bf16 Bloom whose LoRA
adapters train in fp32 beside the abstractor, ``visual_fc`` and
``vit_eos``, and the optimizer the YAML's ``optimizer`` block names
(every ``OptimizerConfig`` field: AdamW or a zoo name, ``momentum``,
``lr_scale_rules``, ``layer_decay``); the ViT's and Bloom's dropout,
drop-path, remat and ``ce_chunk`` as ``vision_overrides`` /
``text_overrides`` set them, vision LoRA included; one
JSON line per step (``--log_freq``) and one ``log.txt`` line per epoch,
through ``cli/common.py``'s epoch loop, which saves a checkpoint each
``--save_ckpt_freq`` epochs under ``<output_dir>/checkpoints`` and resumes
from ``--resume <run dir>`` or the run's own checkpoints, as the JAX
runner does (``async_checkpointing: true`` writes them in the background
after a host snapshot, ``train/checkpoint.py``).

Under a split (the YAML's ``mesh:`` block, ``config.mesh_config``),
launched with ``python -m torch.distributed.run --nproc_per_node=N -m
youku_mplug_tpu_torch.cli.run_instruct ...``: the ranks join one process
group (``--dist_backend``: ``nccl`` on the card, one card a rank,
``cuda:$LOCAL_RANK`` unless ``--device`` names one; ``gloo`` where
asked, and for ``--device cpu``), data x model must be N, and a split in
one process raises (``runtime/mesh.py``, the serve CLI's text).  Every
rank builds the whole model from the same seed (after ``--int8``'s
quantization, so the scales are cut with their kernels) and keeps its
model shard (``parallel/sharding.shard_params`` with JAX's
``BLOOM_SHARDING_RULES``).  Serving: the prompts are batched over every
request (the unsplit run's padding), then each data rank answers its
stride of them (request ``i`` on data rank ``i % D``), through the
batched path or the engine as above (the engine's prefill bucket from
the whole run's padded width, so each rank's engine is the unsplit
run's; sampled draws with the data coordinate folded into the seed
under data > 1); the answers are merged by request on rank 0
(``common.collect_records``), which writes ``instruct_results.json``
and prints the stats with the split, and every rank writes
``ranks/rank<r>.json`` (its coordinate, answers, the kernels' launch
counters and its peak device memory).  Training: each data rank reads its
block of every global batch (the loader's ``block_*``), the step is the
(1,1) step on the global batch (``train/trainer.py``: the loss is a
share of the global masked mean, ``grad_norm`` the whole model's, the
replicated LoRA adapters on split products summed over the model
group), and checkpoints hold the unsharded tree, so a run resumes at any
split; dropout under a split draws the (1,1) run's masks (each at the
global batch's shape, this rank keeping its rows and heads), and a zoo
optimizer on the split abstractor raises (ROADMAP Queue 1 item 10).  ``--lookup_k`` serves
on a Bloom shard as the engine's greedy steps do (the verify chunk's
ALiBi slopes from the shard's head offset, its logits the gathered
vocabulary).

Weights, as the JAX runner has them: a seeded init (serving) or the JAX
``model.init`` rules (``--train``: ``bridge.jax_init``); then with
``--hf_checkpoint <dir>`` an HF mPLUG-Owl checkpoint imported over them
(``models/importers.import_owl``: ``pytorch_model*.bin`` or
``*.safetensors``, fail-loud).  ``--serving_ckpt <dir>`` serves the
export of a trained run (``cli/export_serving.py --owl``) in their place:
the LoRA ranks are 0 (the adapters are merged), and the decoder is int8
exactly when the export's ``qscales`` say so (``--int8`` beside it
raises).

Usage (the card is the default device; ``--device cpu`` runs a tiny
config on the CPU):
    python -m youku_mplug_tpu_torch.cli.run_instruct \\
        --config configs/instruct/serve_bloomz_7b_flagship.yaml \\
        --input_jsonl <rows of video, question> --tokenizer <BloomZ dir>
    python -m youku_mplug_tpu_torch.cli.run_instruct \\
        --config <a copy of a serving YAML with beam_size: 5> \\
        --synthetic_data --tokenizer <BloomZ dir> [--int8]
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
    python -m youku_mplug_tpu_torch.cli.run_instruct --train \\
        --config configs/instruct/train_bloomz_7b_flagship.yaml \\
        --train_jsonl <rows of video, question, answer> --output_dir out
    python -m youku_mplug_tpu_torch.cli.export_serving --owl --int8 \\
        --int8_embedding --run_dir out \\
        --config configs/instruct/train_bloomz_7b_flagship.yaml \\
        --dest out/serving
    python -m youku_mplug_tpu_torch.cli.run_instruct \\
        --config configs/instruct/serve_bloomz_7b_int8.yaml \\
        --synthetic_data --engine --serving_ckpt out/serving
    # a copy of a YAML with mesh: {data: 2, model: 2}: four ranks, one
    # card each (serving; add --train to train); on one card or on CPU
    # processes add --device cuda:0 --dist_backend gloo, or --device cpu
    python -m torch.distributed.run --standalone --nproc_per_node=4 \\
        -m youku_mplug_tpu_torch.cli.run_instruct --config <it> \\
        --synthetic_data --engine
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
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
    mesh_config,
)
from youku_mplug_tpu_torch.data.datasets import SyntheticVideoDataset
from youku_mplug_tpu_torch.data.instruct import (
    VIDEO_PLACEHOLDER,
    InstructJsonlDataset,
    WhitespaceTokenizer,
    build_instruct_batch,
    build_instruct_train_batch,
    format_prompt,
)
from youku_mplug_tpu_torch.data.loader import Loader
from youku_mplug_tpu_torch.data.transforms import (
    test_transform,
    train_transform,
)
from youku_mplug_tpu_torch.data.video_decode import read_frames
from youku_mplug_tpu_torch.models import importers
from youku_mplug_tpu_torch.models.generation import GenerationConfig
from youku_mplug_tpu_torch.models.hf_tokenizer import HFTokenizer
from youku_mplug_tpu_torch.models.owl import MPLUGOwlVideo, generate_instruct
from youku_mplug_tpu_torch.ops import kv_cache as kvc
from youku_mplug_tpu_torch.ops import quant
from youku_mplug_tpu_torch.ops.preprocess import normalize_clip
from youku_mplug_tpu_torch.parallel.sharding import (
    BLOOM_SHARDING_RULES,
    shard_params,
)
from youku_mplug_tpu_torch.runtime import mesh as mesh_lib
from youku_mplug_tpu_torch.runtime.precision import (
    BF16_POLICY,
    DEFAULT_POLICY,
    FP32_POLICY,
)
from youku_mplug_tpu_torch.runtime.prng import fold_in
from youku_mplug_tpu_torch.serving.engine import COUNTERS, ServingEngine
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
    p.add_argument("--fp32", action="store_true",
                   help="serving: fp32 weights and compute instead of "
                        "bf16, as the JAX runner's --fp32 (not with "
                        "--train)")
    p.add_argument("--seed", type=int, default=42,
                   help="seed of the weight init and the synthetic clips")
    p.add_argument("--max_new_tokens", type=int, default=0,
                   help="override the config's max_new_tokens")
    p.add_argument("--engine", action="store_true",
                   help="serve through the continuous-batching engine (slot "
                        "pool, per-request admission; greedy or sampled) "
                        "instead of one lock-step batched generate (greedy, "
                        "sampled or beam search)")
    p.add_argument("--num_slots", type=int, default=4,
                   help="engine slot-pool size")
    p.add_argument("--lookup_k", type=int, default=0,
                   help="--engine: k>0 adds prompt-lookup speculative "
                        "steps (greedy-only, token-exact)")
    p.add_argument("--device", default="cuda",
                   help="cuda[:i] (default; under torch.distributed.run "
                        "cuda:$LOCAL_RANK), or cpu")
    p.add_argument("--dist_backend", choices=("nccl", "gloo"), default=None,
                   help="process group backend under torch.distributed.run "
                        "(default nccl on the card, gloo for --device cpu); "
                        "gloo runs several ranks on one card")
    p.add_argument("--int8", action="store_true",
                   help="int8 decoder kernels and tied embedding, quantized "
                        "in place after the init (the form export_serving "
                        "--int8 --int8_embedding writes)")
    p.add_argument("--hf_checkpoint", default="",
                   help="HF mPLUG-Owl checkpoint directory to import")
    p.add_argument("--tokenizer", default="",
                   help="HF tokenizer directory or tokenizer.json "
                        "(BloomTokenizerFast); without it the whitespace "
                        "hash tokenizer of synthetic runs")
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
    p.add_argument("--train_jsonl", default="",
                   help="--train: rows {'video', 'question', 'answer'} (or "
                        "'prompt' pre-formatted); default the YAML's "
                        "train_file")
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
    serving, its weights as the module docstring says, cut to this rank's
    model shard under a split (``model.mesh``: the YAML's ``mesh:``,
    joined as the serve CLI joins it).  Raises when the device is
    absent: nothing falls back to the CPU."""
    device = common.device_of(args)
    if args.int8 and args.serving_ckpt:
        raise ValueError("--int8 quantizes an initialized decoder; a "
                         "--serving_ckpt is int8 exactly where "
                         "export_serving --int8 made it so")
    cfg, raw = load_owl_config(args.config)
    mesh = common.init_mesh(args, mesh_config(raw))
    if args.serving_ckpt:  # the export merged the adapters
        cfg = dataclasses.replace(
            cfg, text=dataclasses.replace(cfg.text, lora_rank=0),
            vision=dataclasses.replace(cfg.vision, lora_rank=0))
    with device:  # built on the device: no host copy of 7B
        model = MPLUGOwlVideo(cfg, FP32_POLICY if args.fp32
                              else BF16_POLICY)
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
    shard_params(model, mesh, BLOOM_SHARDING_RULES)
    return cfg, raw, model.eval(), device


@functools.lru_cache(maxsize=4)
def _hf_tokenizer(path: str) -> HFTokenizer:
    """HF tokenizer files, read once a process (BloomZ's tokenizer.json
    of 250880 entries takes seconds to parse)."""
    return HFTokenizer(path)


def build_tokenizer(args, cfg, mesh=None):
    """The HF tokenizer files ``--tokenizer`` names, else the whitespace
    hash tokenizer (the JAX runner's choice).  Under a process group
    (``mesh``) the hash tokenizer raises unless ``PYTHONHASHSEED`` is set:
    each rank would hash the prompts with its own seed."""
    if getattr(args, "tokenizer", ""):  # profile_train's parser has none
        return _hf_tokenizer(args.tokenizer)
    if mesh is not None and mesh.distributed \
            and os.environ.get("PYTHONHASHSEED", "random") == "random":
        raise ValueError("the whitespace hash tokenizer under a process "
                         "group: each rank hashes the prompts with its own "
                         "PYTHONHASHSEED; pass --tokenizer or set "
                         "PYTHONHASHSEED")
    return WhitespaceTokenizer(cfg.text.vocab_size, eos_id=cfg.text.eos_id,
                               pad_id=cfg.text.pad_id)


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


def load_videos(args, raw_cfg, rows, index=None) -> np.ndarray:
    """[B, T, H, W, C] uint8 clips, one per row of ``index`` (default
    every row): each row's ``video`` decoded (``middle`` sampling) and
    resized to ``image_res``, or under --synthetic_data drawn for every
    row from ``np.random.default_rng(seed)`` exactly as the JAX runner
    draws them, then those of ``index`` kept."""
    t = int(raw_cfg.get("num_frames", 8))
    res = int(raw_cfg.get("image_res", 224))
    index = np.arange(len(rows)) if index is None else np.asarray(index)
    if args.synthetic_data:
        rng = np.random.default_rng(args.seed)
        return rng.integers(0, 255, size=(len(rows), t, res, res, 3),
                            dtype=np.uint8)[index]
    tf = test_transform(res)
    short_side = int(raw_cfg.get("decode_short_side", 0))
    return np.stack([tf(read_frames(rows[i]["video"], num_frames=t,
                                    sample="middle", short_side=short_side))
                     for i in index])


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
    the cache's dtype and the decoder's weight and cache bytes.  The
    engine serves beam_size 1 only: beam search raises here, as in the
    JAX runner."""
    if gen_cfg.beam_size > 1:
        raise ValueError("--engine serves beam_size=1 (greedy or sampled); "
                         "beam search runs on the batched path (no "
                         "--engine)")
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

    # the bucket from the padded width: the longest prompt of the whole
    # run, so a data rank's engine is the unsplit run's
    engine = make_engine(model.text_decoder, [input_ids.shape[1]], gen_cfg,
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


@torch.inference_mode()
def generate_batched(model: MPLUGOwlVideo, clips: torch.Tensor, batch,
                     gen_cfg: GenerationConfig,
                     generator: Optional[torch.Generator] = None):
    """Instruct inference in one lock-step batch (the JAX runner's default
    path): ``generate_instruct`` over every request, greedy, sampled or
    beam search as ``gen_cfg`` says.  Arguments as ``serve_instruct``'s.
    Returns (sequences [B, max_new_tokens] int32 right-padded with
    pad_id, stats, ``generate``'s output); the stats name the cache's
    dtype and bytes (B x beam_size rows of the prefix and the new
    tokens) and the decoder's weight bytes."""
    dev = clips.device
    input_ids = torch.as_tensor(batch["input_ids"], device=dev).long()
    b, p = input_ids.shape
    t0 = time.perf_counter()
    out = generate_instruct(
        model, clips, input_ids,
        torch.as_tensor(batch["media_mask"], device=dev),
        torch.as_tensor(batch["prompt_len"], device=dev), gen_cfg,
        generator)
    seqs = out["sequences"].cpu().numpy()
    wall = time.perf_counter() - t0
    beam = not gen_cfg.do_sample and gen_cfg.beam_size > 1
    cache = model.text_decoder.init_cache(
        b * (gen_cfg.beam_size if beam else 1), p + gen_cfg.max_new_tokens,
        device="meta")
    n_tok = int((seqs != gen_cfg.pad_id).sum())
    stats = {
        "requests": b, "new_tokens": n_tok, "beam_size": gen_cfg.beam_size,
        "do_sample": gen_cfg.do_sample, "decode_steps": out["decode_steps"],
        "wall_s": wall, "tokens_per_sec": n_tok / max(wall, 1e-9),
        "peak_memory_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                            if dev.type == "cuda" else None),
        "nonfinite_logits": out["nonfinite_logits"],
        "kv_cache_dtype": str(kvc.leaves(cache)[0].dtype
                              ).removeprefix("torch."),
        "cache_bytes": kvc.nbytes(cache),
        "decoder_weight_bytes": quant.decoder_bytes(model.text_decoder),
    }
    return seqs, stats, out


def answers(rows, seqs, tokenizer, text_cfg):
    """One result per request: its row (but ``prompt``), the kept tokens
    (pad and eos dropped) and the tokenizer's decode of them, stripped
    (the JAX runner's ``answer``)."""
    results = []
    for r, seq in zip(rows, seqs):
        keep = seq[(seq != text_cfg.pad_id) & (seq != text_cfg.eos_id)]
        results.append({**{k: v for k, v in r.items() if k != "prompt"},
                        "tokens": keep.tolist(),
                        "answer": tokenizer.decode(
                            keep, skip_special_tokens=True).strip()})
    return results


def prepare(args, cfg, raw_cfg, device, compute_dtype, tokenizer,
            mesh=None):
    """-> (rows, instruct batch, normalized clips on the device): every
    request's prompt through ``tokenizer`` and batched, padded to the
    longest; with a ``mesh`` this data rank's stride of them (request
    ``i`` on data rank ``i % D``), rows, batch and clips alike.  The
    batch's ``index`` holds its requests' indices in the run."""
    rows = load_rows(args)
    prompts = [r.get("prompt") or format_prompt(r["question"])
               for r in rows]
    for p in prompts:
        if VIDEO_PLACEHOLDER not in p:
            raise ValueError(f"prompt lacks {VIDEO_PLACEHOLDER}: {p[:80]!r}")
    batch = build_instruct_batch(prompts, tokenizer, cfg.num_media_tokens,
                                 pad_id=cfg.text.pad_id)
    index = np.arange(len(rows))
    if mesh is not None:
        index = index[mesh.data_index::mesh.data]
        batch = {k: v[index] for k, v in batch.items()}
    batch["index"] = index
    video = load_videos(args, raw_cfg, rows, index)
    clips = normalize_clip(torch.from_numpy(video).to(device),
                           dtype=compute_dtype)
    return [rows[i] for i in index], batch, clips


def build_train_loader(args, tcfg: InstructTrainConfig, raw_cfg,
                       res: int, mesh=None) -> Loader:
    """The training loader in the JAX runner's shuffled order: the rows of
    ``--train_jsonl`` (else the YAML's ``train_file``) on ``num_workers``
    (default 2) decode threads, or ``synthetic_length`` synthetic
    clips; under a data split (``mesh``) this data rank's block of every
    global batch (of each micro-batch under ``update_freq``), as
    ``common.make_loader(block=)`` cuts it."""
    split = mesh is not None and mesh.data > 1
    block = dict(block_index=mesh.data_index, block_count=mesh.data,
                 micro_count=tcfg.update_freq) if split else {}
    if args.synthetic_data:
        ds = SyntheticVideoDataset(length=tcfg.synthetic_length,
                                   num_frames=tcfg.num_frames, size=res)
        return Loader(ds, tcfg.batch_size, seed=args.seed, **block)
    # profile_train's parser has no --train_jsonl: the YAML names the file
    src = getattr(args, "train_jsonl", "") or raw_cfg.get("train_file", "")
    if not src:
        raise SystemExit("--train needs --train_jsonl or train_file")
    ds = InstructJsonlDataset(
        src, raw_cfg.get("video_root", ""), transform=train_transform(res),
        num_frames=tcfg.num_frames, train=True, seed=args.seed,
        decode_short_side=int(raw_cfg.get("decode_short_side", 0)))
    return Loader(ds, tcfg.batch_size, seed=args.seed,
                  num_workers=int(raw_cfg.get("num_workers", 2)), **block)


def train_setup(args) -> common.Runner:
    """The YAML's training mesh (``common.init_mesh``), config, loader,
    the model on the device (``jax_init``, then ``--hf_checkpoint``
    imported over it, then cut to this rank's model shard), the
    trainable/frozen split (frozen leaves in bf16; LoRA adapters stay
    fp32 and train), the YAML's optimizer, whose schedule spans
    ``min(len(loader), max_steps)`` updates per epoch, the checkpoints
    (unsharded, written by rank 0) and the resume
    (``common.resume_state``)."""
    device = common.device_of(args)
    if getattr(args, "fp32", False):
        raise ValueError("--fp32 is a serving flag: training keeps fp32 "
                         "trainable and bf16 frozen leaves")
    cfg, raw = load_owl_config(args.config)
    mesh = common.init_mesh(args, mesh_config(raw))
    tcfg = instruct_train_config(raw)
    loader = build_train_loader(args, tcfg, raw, cfg.vision.img_size, mesh)
    niter = len(loader) if args.max_steps <= 0 else min(len(loader),
                                                        args.max_steps)
    tcfg = dataclasses.replace(tcfg, optimizer=dataclasses.replace(
        tcfg.optimizer, niter_per_ep=max(niter, 1)))
    with device:  # built and seeded on the device
        model = MPLUGOwlVideo(cfg, DEFAULT_POLICY)
    jax_init(model, args.seed)  # the JAX runner's model.init rules
    if args.hf_checkpoint:  # before the split casts the frozen leaves
        importers.import_owl(model, cfg, args.hf_checkpoint)
    shard_params(model, mesh, BLOOM_SHARDING_RULES)
    state, _, schedule = create_train_state(
        model, tcfg.optimizer, frozen_dtype=DEFAULT_POLICY.compute_dtype)
    os.makedirs(args.output_dir, exist_ok=True)
    ckpt = CheckpointManager(
        os.path.join(args.output_dir, "checkpoints"),
        async_save=bool(raw.get("async_checkpointing", False)), mesh=mesh)
    state, start_epoch = common.resume_state(args, ckpt, state)
    return common.Runner(
        args=args, cfg=tcfg, device=device, model=model.train(),
        tokenizer=build_tokenizer(args, cfg, mesh), state=state,
        schedule=schedule, loader=loader, ckpt=ckpt,
        start_epoch=start_epoch, mesh=mesh)


def make_instruct_batch(runner: common.Runner, raw):
    """Loader rows -> ``instruct_loss`` inputs on the device: the jsonl
    rows' (question, answer) pairs, or each synthetic caption as the
    answer to ``SYNTHETIC_QUESTION``."""
    text = runner.model.cfg.text
    if "question" in raw:
        pairs = list(zip(raw["question"], raw["answer"]))
    else:
        pairs = [(SYNTHETIC_QUESTION, caption) for caption in raw["text"]]
    batch = build_instruct_train_batch(
        pairs, runner.tokenizer, runner.model.cfg.num_media_tokens,
        pad_id=text.pad_id, eos_id=text.eos_id,
        max_length=runner.cfg.max_length)
    # under a data split a data rank's block of the global batch
    return common.put_batch(runner, {**batch, "video": raw["video"]})


def make_loss_fn(model: MPLUGOwlVideo):
    def loss_fn(batch, generator=None):
        video = normalize_clip(batch["video"],
                               dtype=model.policy.compute_dtype)
        return model.instruct_loss(video, batch["input_ids"],
                                   batch["attention_mask"],
                                   batch["media_mask"], batch["prompt_mask"],
                                   generator=generator)
    return loss_fn


def build_train_step(runner: common.Runner):
    """The train step; its dropout masks (the ViT's and Bloom's, where a
    rate is set) come from a generator of (``--seed``, step)."""
    return make_train_step(make_loss_fn(runner.model),
                           update_freq=runner.cfg.update_freq,
                           dropout_seed=runner.args.seed)


def train_main(args) -> common.Runner:
    """Instruction finetuning: every epoch of the YAML through
    ``cli/common.py``'s epoch loop (see the module docstring)."""
    runner = train_setup(args)
    return common.train_epochs(runner, build_train_step(runner),
                               make_instruct_batch)


def sample_seed(seed: int, mesh) -> int:
    """The sampling generator's seed: ``--seed + 1`` (the JAX runner's),
    the data coordinate folded in under data > 1 (the model ranks of a
    data rank draw alike)."""
    return seed + 1 if mesh.data <= 1 else fold_in(seed + 1,
                                                    mesh.data_index)


def _merge(mesh, local, stats):
    """(results, stats) of the run: under a process group every data
    rank's answers merged by request on every rank, the stats over them
    (the slowest data rank's wall, each data rank's own stats under
    ``data_ranks``, the split); else this rank's own.  The results lose
    their ``index``."""
    if mesh.distributed:
        local = sorted(common.collect_records(local, "index", mesh),
                       key=lambda r: r["index"])
        parts = common.host_gather(stats, mesh)
        n_tok = sum(p["new_tokens"] for p in parts)
        wall = max(p["wall_s"] for p in parts)
        stats = {**stats, "requests": len(local), "new_tokens": n_tok,
                 "wall_s": wall, "tokens_per_sec": n_tok / max(wall, 1e-9),
                 "split": {"data": mesh.data, "model": mesh.model},
                 "data_ranks": parts}
    return [{k: v for k, v in r.items() if k != "index"}
            for r in local], stats


def serve_built(args, cfg, raw_cfg, model, device):
    """``main``'s serving after ``build``: this data rank's requests
    through the engine or the batched path, the answers merged, rank 0
    writing ``instruct_results.json`` and printing the stats, and under
    a process group every rank its ``ranks/rank<r>.json``.  Returns
    (results, stats)."""
    mesh = model.mesh or mesh_lib.Mesh()
    build_peak = None
    if device.type == "cuda":  # the serve's peak, after the build's
        build_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    tokenizer = build_tokenizer(args, cfg, mesh)
    rows, batch, clips = prepare(args, cfg, raw_cfg, device,
                                 model.policy.compute_dtype, tokenizer,
                                 mesh)
    gen_cfg = generation_config(args, cfg, raw_cfg)
    generator = torch.Generator(device).manual_seed(sample_seed(args.seed,
                                                                mesh))
    engine = None
    if not rows:  # a data rank past the last request
        seqs = np.zeros((0, gen_cfg.max_new_tokens), np.int32)
        stats = {"requests": 0, "new_tokens": 0, "wall_s": 0.0}
    elif args.engine:
        seqs, stats, engine = serve_instruct(
            model, clips, batch, gen_cfg, num_slots=args.num_slots,
            lookup_k=args.lookup_k, generator=generator)
    else:
        seqs, stats, _ = generate_batched(model, clips, batch, gen_cfg,
                                          generator)
    local = [{**r, "index": int(i)} for r, i in zip(
        answers(rows, seqs, tokenizer, cfg.text), batch["index"])]
    results, merged = _merge(mesh, local, stats)
    os.makedirs(args.output_dir, exist_ok=True)
    if mesh.distributed:
        os.makedirs(os.path.join(args.output_dir, "ranks"), exist_ok=True)
        with open(os.path.join(args.output_dir, "ranks",
                               f"rank{mesh.rank}.json"), "w") as f:
            json.dump({
                "rank": mesh.rank, "coord": list(mesh.coord),
                "split": {"data": mesh.data, "model": mesh.model},
                "device": str(device), "results": local, "stats": stats,
                "decode_steps": getattr(engine, "decode_steps",
                                        stats.get("decode_steps")),
                "graph_replays": getattr(engine, "graph_replays", None),
                "launches": {f"{fn.__name__}.{attr}": getattr(fn, attr)
                             for fn, attr in COUNTERS},
                "peak_memory_bytes": torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else None,
                "build_peak_memory_bytes": build_peak}, f,
                ensure_ascii=False)
    if mesh.rank == 0:
        with open(os.path.join(args.output_dir, "instruct_results.json"),
                  "w") as f:
            json.dump(results, f, ensure_ascii=False, indent=1)
        print("* Instruct stats:", json.dumps(merged), flush=True)
    return results, merged


def main(args):
    def body():
        if args.train:
            return train_main(args)
        cfg, raw_cfg, model, device = build(args)
        return serve_built(args, cfg, raw_cfg, model, device)
    return common.run_main(body)


if __name__ == "__main__":
    main(parser().parse_args())
