"""Smoke check of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line or a few; any failure exits nonzero before
the last line is printed):

1. device and build: require CUDA (one card: the first visible one),
   print the card's name and power limit, build the hand-written kernels
   from youku_mplug_tpu_torch/csrc/ (one nvcc per source, in parallel);
2. the flash builds (forward, backward dq and dk/dv) at head dims 64,
   80, 96 and 128: registers and spills from nvcc's -Xptxas -v report and
   the blocks resident on one SM as the card counts them
   (cudaOccupancyMaxActiveBlocksPerMultiprocessor), failing on a spill in
   any flash build or on a count other than FWD_BLOCKS_PER_SM (the wave
   the split-KV policy assumes) or BWD_BLOCKS_PER_SM; then
   each kernel against its plain PyTorch version, in bf16, at the shapes
   the serving, training and instruct paths give it, with the kernel's,
   the plain version's and F.scaled_dot_product_attention's times from
   CUDA events and the bound from this run's inputs;
   the card's name, power limit, SM clock and power draw sampled under
   load: the forward (K1 none / period; K4 at the serving batch, split
   two ways, at the pretrain batch, and split three ways over a ragged
   1000 keys with kv_len 900) at the serving shapes and K1 at the CLIP
   ViT-L/14 frame shapes, then at each of the four training shapes (vision
   spatial, grouped temporal with period 8, decoder causal,
   AttentionPool head-major, plus a small kv_len case) and the five
   ALiBi / head dim 128 shapes (Bloom training [8, 105, 32x128], S 768,
   40 heads, d 64, d 128 without ALiBi) and the head dim 96 shapes of
   clip-b16's AttentionPool (q [32, 8, 128, 96] over 1570 keys, the cls
   train step, and over 786, ITM's; forward alone at an evaluation
   call's 4 clips; q [24, 8, 128, 96] over 3138 keys, the 2.7B caption
   recipe's 16 frames; 256 queries over 1570 keys, kv_len 1500, which
   take the key-tile dk/dv kernel, off the paths) and the head dim 80
   shapes of the GPT-3 2.7B
   decoder (head views of its fused qkv row: [180, 208, 32x80] causal,
   the cls evaluation's passes; [32, 208, 32x80] causal for K4b, which
   no shipped YAML runs; a head-major call split three ways) the
   forward's o and lse and the
   backward's delta (rowsum(dO * O)), dq and dk/dv kernels on that
   forward's output (the dk/dv kernel the wrapper picks: at head dim 96
   and Sq <= 128 the short-query one); K1 causal
   at the downstream evaluations' decoder calls ([180, 208, 32x64] cls,
   [32, 208] ITM, [96, 80] retrieval text); and the
   decode step's attention with its cache write in one launch (K5 with K6
   folded in: bf16 head dim 64 at the caption cache [24,8,256,2x32x64];
   head dim 80, bf16 and int8, at the 2.7B beam step's [8 of 32 layers,
   120, 256, 2x32x80];
   head dim 128 with the ALiBi ladder at BloomZ-7B1's [30,8,256,
   2x32x128], at 40 heads, and without ALiBi; int8 at the caption and
   BloomZ-7B1 caches and 40 heads, beside each the bf16 kernel's time on
   the same cache dequantized; q, k, v views of the models' fused rows;
   both cache leaves bitwise equal to the plain write, no other row
   touched), each timed warm and with the layer rotated over all L
   layers, and the wrapper's host time per call;
3. the serve slice: the serve CLI's path at the flagship model's full
   width (configs/caption/serve_gpt3_1.3B_flagship.yaml, seeded weights),
   16 requests over synthetic clips, 8 slots, 32 new tokens, greedy, each
   decode step one replay of the engine's k = 1 CUDA graph; the forward
   kernels' launch counters must rise, the decode kernel launch once per
   layer per decode step (the replay-aware counters), and every logit be
   finite;
4. teacher-forced check: the video encoder and the first decode steps
   again with the plain versions in place of the kernels, fed the same
   inputs and tokens; query features and logits within a stated
   tolerance, greedy agreement printed;
4a. caption dispatch modes: the serve path's engine on the same 16
   requests three times, the eager step, the k = 1 graph and
   run_to_completion(steps_per_dispatch=8) (k = 8 graphs): every
   request's tokens equal in the three; 24 K5 launches (with K6) per
   decode step of the k = 8 run from the replay-aware counters; for each
   mode tokens/s, peak memory, the graphs' pool, and at the run's last
   lengths host ms, device kernel ms, launches, traced decode kernels
   (24 a step, gated) and idle share per decode step;
4c. speculative serving: the serve CLI's --speculative 4 --draft twin
   (6 of the 24 layers, views of the decoder's weights) and --speculative
   8 --draft ngram on the same 16 clips; tokens equal to the greedy
   step's up to each request's first near-tie (the plain replay's top-2
   gap below CAPTION_TIE_GAP), near-ties and divergences printed, tokens
   per round and the draft steps' K5 launches;
4b. the caption int8-KV slice: phases 3 and 4 again on
   configs/caption/serve_gpt3_1.3B_int8kv.yaml (bf16 weights, int8
   cache): per decode step 24 launches of K5 int8 (each with its K6
   write) and none of the bf16 K5; the replay with the plain write and
   plain int8 decode; phase 4a on this cache;
5. the train slice: the pretrain CLI's path (run_pretrain.setup and
   train_one_epoch) on configs/pretrain/pretrain_gpt3_1.3B_flagship.yaml
   at full width, synthetic clips, seeded weights: 2 warm-up and 5 timed
   steps; loss and grad_norm finite, no skipped step, trainable leaves
   moved, the frozen bf16 decoder bitwise unchanged, the forward, dq and
   dk/dv launch counters risen;
6. plain replay: the first training batch on the trained weights, loss
   and gradients with the kernels and again with their plain versions
   (flash_fwd_plain, flash_bwd_plain) patched in; loss and every
   trainable leaf's gradient (relative L2) within the stated tolerances;
7. the instruct slice: the run_instruct CLI's serving function at the
   full width and depth of configs/instruct/serve_bloomz_7b_flagship.yaml
   (per-frame CLIP ViT-L/14, the Owl abstractor, BloomZ-7B1; seeded
   weights built on the card), 16 synthetic requests, 8 slots, 64 new
   tokens, greedy; the K1 counter must rise, K5-ALiBi (with K6) launch
   once per layer per decode step, and every logit be finite; tokens/s,
   p50/p95, peak memory and the decode step's time;
8. instruct teacher-forced check: the clips' media features and the
   first decode steps again with the plain versions of K1 and K5 (with
   its write) fed the same inputs and tokens, within the stated
   tolerances;
8a. instruct dispatch modes: phase 4a on the instruct engine and its 16
   requests (30 K5-ALiBi launches a decode step); run_instruct's serving
   with --lookup_k 4, held to the greedy tokens as in 4c (bound
   OWL_TIE_REL x the replay's max |logit|); sampling on
   configs/instruct/serve_bloomz_7b_sample.yaml (top_k 5): the engine's
   _pick captured in a CUDA graph with its generator registered,
   SAMPLE_REPLAYS replays on fixed [8, V] logits (no draw outside the
   filtered support, chi-square p > 1e-3 per row, fresh draws), then 8
   sampled requests with the CLI's generator twice and another seed once
   (finite, reproducible by seed, 30 K5-ALiBi launches a step);
8b. the instruct int8 slice: run_instruct.build with --int8 on
   configs/instruct/serve_bloomz_7b_int8.yaml (seeded as phase 7, then
   the decoder's kernels and tied embedding quantized in place), 16
   requests, 8 slots, 64 tokens: per decode step 30 launches of K5 int8
   with ALiBi (each with its K6 write), no bf16 K5; tokens/s, p50/p95,
   decode step,
   peak memory, weight and cache bytes; its teacher-forced plain replay
   within OWL_REL_TOL; and, as a readout only, its teacher-forced logits
   and greedy agreement against phase 8's bf16 model on the same seed;
   phase 8a's dispatch modes with K5 int8 ALiBi;
9. the instruct-train slice: the run_instruct CLI's --train path
   (train_setup and run_pretrain.train_one_epoch) at the full width and
   depth of configs/instruct/train_bloomz_7b_flagship.yaml (frozen bf16
   ViT-L/14 and BloomZ-7B1 with rank-8 fp32 LoRA, trainable abstractor,
   visual_fc and vit_eos; batch 8, S 105), 8 steps: loss and grad_norm
   finite, no skipped step, the frozen weights bitwise unchanged, every
   trainable leaf (every adapter included) moved, and per step 30
   launches each of K1, dq and dk/dv with ALiBi, 24 of K1 (the ViT), no
   other; step ms, clips/s, peak memory;
10. instruct-train plain replay: the first batch of the instruct-train
   run with every wrapper plain (loss gated), then with Bloom's attention
   plain and the frozen ViT on its kernel in both runs (loss and every
   trainable gradient gated as in phase 6);
11. a JSON line describing each kernel (errors, times of the kernel, its
   plain version and the SDPA library call, the bound, launches per
   path, each shape), the card's line, then the result line;
12. the caption slice (run after phase 6, on phase 5's runner, so that
   the instruct phases find the card empty): phase 5's state saved by
   cli/common.save_epoch (bytes and seconds printed); run_caption on
   configs/caption/caption_gpt3_1.3B_flagship.yaml resuming from it at
   full width and depth, the restored trainable and frozen leaves, AdamW
   moments, update count and step bitwise equal to the saved state; 2
   finetune steps of batch 24 (loss and grad_norm finite, no skipped
   step, the frozen bf16 decoder bitwise unchanged, trainable leaves
   moved, the K1, K4, dq and dk/dv counters risen; step ms, clips/s, peak
   memory; the finetuned state saved for phase 16); the beam search (5
   beams, 32 new tokens) over 2 test batches
   of 24 clips: 24 launches of K5 (with its K6 write) per decode step and
   no other decode kernel, one result per clip, finite caption metrics,
   every returned sequence's beam score against its teacher-forced
   rescore with the plain versions of K1, K4 and K5 within
   RESCORE_TOL_PER_TOKEN a token; the beam's tokens/s, host ms per decode
   step and the beam reorder's device ms per step (traced).  Phase 2
   holds K5 at the beam step's cache [24,120,256,2x32x64] too;
13. the downstream recipes (run after phase 12): run_cls, run_retrieval_itm
   and run_retrieval through their prepare / train / evaluation
   functions on the reference YAMLs (configs/cls/cls_gpt3_1.3B_youku_v0_
   sharp_2.yaml, configs/retrieval/retrieval{_itm,}_gpt3_1.3B_youku_v0.
   yaml) at full width and depth: clip-b16 (12 blocks, 8 heads of 96, the
   0.1 lr scale on its leaves) and the frozen 1.3B decoder with its 0.1
   dropouts, seeded weights, synthetic 224 px clips; the cuts printed on
   a line ([downstream]).  Per recipe: 2 train steps (cls 32 clips x 8
   frames, ITM 32 x 4, retrieval 96 x 4; finite, no skipped step, the
   frozen decoder bitwise unchanged, leaves moved, the 0.1 lr scale on
   exactly the CLIP tower's non-temporal leaves), launches per step (cls
   and ITM: one K4, dq and dk/dv at d 96 and nothing else, the decoder
   under dropout on plain attention; retrieval: 24 K1); the first batch
   replayed with every wrapper plain on the same dropout generator (loss
   gated; retrieval's gradients gated too) and, for cls and ITM, with
   only the backward kernels plain (every gradient gated: one bf16 ulp
   of AttentionPool's output moves the cls head's gradients ~10% through
   the seeded decoder, so the all-plain gradients are printed); the
   decoder input's zeroed share (0.1 within DROPOUT_SHARE_TOL); the
   evaluation (cls: 45-way over 2 test batches, 4 clips a call; ITM: a
   16 x 16 V x T matrix, 4 clips x 8 texts a call; retrieval: recall over
   64 clips), its launches per call (one K4 d 96 and 48 K1; retrieval 24
   K1 a text batch) and one call replayed plain; step ms, peak memory,
   metrics ([cls], [itm], [retrieval] lines);
14. the GPT-3 2.7B decoder (run after phase 13; 32 layers x 2560, 32
   heads of 80, vocab 51200, seeded weights; [gpt3-2.7B] lists the cuts):
   run_caption on configs/caption/caption_gpt3_2.7B_youku_v0.yaml
   (clip-b16 at 16 frames, batch 24, the decoder's 0.1 dropouts): 2
   finetune steps (one K4, dq and dk/dv at d 96 a step and nothing else:
   the decoder on plain attention), the beam-5 evaluation of 2 test
   batches (32 launches of K5 at d 80 with its K6 write a decode step,
   one K4 d 96 a batch, no other kernel), traced and rescored plain as in
   phase 12 ([caption27 ...] lines); then phase 13's cls run on
   configs/cls/cls_gpt3_2.7B_youku_v0_sharp_2.yaml ([cls27] line: 64 K4
   launches at d 80 and one at d 96 an evaluation call, no K1);
15. serve_imported (run after phase 4c, on phase 3's model): phase 3's
   seeded weights rounded through fp16 and written by chip_smoke's own
   inverse of the importers as two Megatron mp_rank shards (the GPT-3
   decoder, split along Megatron's partition dims) and a timm TimeSformer
   file; phase 3 again with a YAML naming both under
   import_torch_weights: every decoder and vision leaf imported (the
   merges' count) and equal to the fp16-rounded source bitwise, every
   other leaf to the seeded source's; K5 and K6 launches a decode step
   exact; phase 4's teacher-forced gate; checkpoint GB, write and import
   seconds and GB/s;
16. serve_resumed (run after phase 12, whose caption run saves its
   finetuned state): phase 3 with --resume <that run>: every leaf bitwise
   equal to the checkpoint's (fp32 trainable, bf16 frozen), 16 requests,
   launches exact;
17. instruct_hf (run after phase 10): a seeded Owl at full width, Bloom
   cut to OWL_CUT's 4 of its 30 layers, written as an HF checkpoint
   (language_model.transformer.*, vision_model.* in the external tower's
   naming, abstractor.*, query_tokens) in two by-key .bin shards and in
   two .safetensors files in another directory (the second read by the
   port's reader, every tensor bitwise equal to the first); phase 7 with
   --hf_checkpoint: every leaf imported and equal to the source bitwise,
   K1 once per ViT block and K5-ALiBi (with K6) once per layer a decode
   step, exact; phase 8's teacher-forced gate;
18. instruct_hf_train: run_instruct --train --hf_checkpoint on the
   training YAML cut the same way, 2 steps of rank-8 LoRA (per step K1,
   dq, dk/dv with ALiBi and the delta kernel once per layer, K1 once per
   ViT block, nothing else), the epoch's checkpoint saved; a second
   invocation with --resume restores trainable and frozen leaves, AdamW
   moments, count and step bitwise; cli/export_serving.py --owl --int8
   --int8_embedding writes the serving checkpoint;
19. instruct_serving_int8: run_instruct --engine --serving_ckpt on
   serve_bloomz_7b_int8.yaml cut the same way, without --int8: the int8
   leaves and their scales equal quantize_gpt3_decoder of the training
   checkpoint's LoRA-merged decoder bitwise; K1 and K5 int8 ALiBi (with
   K6) launches exact; phase 8's teacher-forced gate against the plain
   versions.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import unittest.mock as mock

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP_YAML = os.path.join(REPO, "configs", "caption",
                             "serve_gpt3_1.3B_flagship.yaml")
# bf16 outputs, elementwise |kernel - plain| <= KERNEL_TOL * (1 + |plain|):
# four bf16 ulps (2^-8 relative each) for the output rounding and the bf16
# probabilities of the PV product, which the two versions round at
# different points
KERNEL_TOL = 2.0 ** -6
LSE_TOL = 1e-3           # fp32 log-sum-exp, fp32 accumulation on both sides
# backward kernels, relative L2 of each of dq, dk, dv against the plain
# backward on the same (q, k, v, o, lse, dO): p and dS are rounded to
# bf16 from fp32 values that differ in the last bits (the kernel's
# __expf), and the outputs are bf16, so two bf16 ulps (2^-8 each)
BWD_TOL = 2.0 ** -7
# the delta kernel (rowsum(dO * O) in fp32) against its plain version:
# relative L2, the same fp32 products summed in another order
DELTA_TOL = 1e-5
QUERY_TOL = 0.1          # query features after 12 vision blocks, bf16
LOGIT_TOL = 0.1          # fp32 logits after 24 decoder layers, bf16
FORCED_STEPS = 4
# plain replay of one train step (bf16 compute, fp32 master weights): the
# kernels and their plain versions round o, p and dS to bf16 from fp32
# values that differ in the last bits; the flips are carried through 12
# vision blocks, AttentionPool and 24 decoder layers forward and back
REPLAY_LOSS_TOL = 1e-2   # |loss_kernels - loss_plain|, loss ~ ln(51200)
# per trainable leaf: |g_kernels - g_plain| <= REPLAY_GRAD_TOL x
# max(|g_plain|, REPLAY_GRAD_FLOOR x |whole gradient|) (L2 norms).  The
# floor holds a leaf whose exact gradient nearly cancels to an absolute
# bound: AttentionPool's k_bias shifts every key but the appended bias
# key, and softmax ignores a shift of all keys, so its gradient is a small
# residue of large terms and its bf16 rounding noise is of its own size.
REPLAY_GRAD_TOL = 0.05
REPLAY_GRAD_FLOOR = 1e-3
TRAIN_YAML = os.path.join(REPO, "configs", "pretrain",
                          "pretrain_gpt3_1.3B_flagship.yaml")
CAPTION_YAML = os.path.join(REPO, "configs", "caption",
                            "caption_gpt3_1.3B_flagship.yaml")
CAPTION_STEPS, CAPTION_EVAL_BATCHES = 2, 2
# a beam's score (length penalty 0) is the sum of its tokens' log-probs;
# a log-prob is a logit less the log-sum-exp, so it moves by at most
# twice the largest logit error, and LOGIT_TOL bounds that error between
# the kernels and the plain versions after the video encoder and 24
# decoder layers (the teacher-forced phase): per token 2 x LOGIT_TOL
RESCORE_TOL_PER_TOKEN = 2 * LOGIT_TOL
WARMUP_STEPS, TIMED_STEPS = 2, 5
OWL_YAML = os.path.join(REPO, "configs", "instruct",
                        "serve_bloomz_7b_flagship.yaml")
OWL_REQUESTS, OWL_SLOTS = 16, 8
OWL_TRAIN_YAML = os.path.join(REPO, "configs", "instruct",
                              "train_bloomz_7b_flagship.yaml")
OWL_TRAIN_STEPS = 8
INT8KV_YAML = os.path.join(REPO, "configs", "caption",
                           "serve_gpt3_1.3B_int8kv.yaml")
OWL_INT8_YAML = os.path.join(REPO, "configs", "instruct",
                             "serve_bloomz_7b_int8.yaml")
# instruct teacher-forced check, max |kernels - plain| over max |plain|,
# for the media features (24 ViT-L blocks, 6 abstractor layers and
# visual_fc) and the fp32 logits (30 Bloom layers), all in bf16: each
# attention call's output differs by a few bf16 ulps (2^-8 relative) as
# the two versions round at different points; ~30 such independent flips
# through residual streams and LayerNorms add up to about sqrt(30) x 2^-8
# ~ 2% of the largest value, and the bound leaves three times that
OWL_REL_TOL = 2.0 ** -4
# speculative and lookup decoding verify a chunk with plain attention
# while the greedy step runs the decode kernel: where the plain replay's
# two best logits lie closer than twice the teacher-forced logit
# tolerance, either rounding may pick either token (caption: absolute;
# instruct: times the replay's max |logit|)
CAPTION_TIE_GAP = 2 * LOGIT_TOL
OWL_TIE_REL = 2 * OWL_REL_TOL
# the downstream recipes (phase 13): their reference YAMLs, 2 train steps,
# 4 clips an evaluation call, the ITM and retrieval test splits' clips
CLS_YAML = os.path.join(REPO, "configs", "cls",
                        "cls_gpt3_1.3B_youku_v0_sharp_2.yaml")
ITM_YAML = os.path.join(REPO, "configs", "retrieval",
                        "retrieval_itm_gpt3_1.3B_youku_v0.yaml")
RETRIEVAL_YAML = os.path.join(REPO, "configs", "retrieval",
                              "retrieval_gpt3_1.3B_youku_v0.yaml")
DOWNSTREAM_STEPS, DOWNSTREAM_EVAL_CLIPS = 2, 4
DOWNSTREAM_SPLITS = {"itm": 16, "retrieval": 64}
# the GPT-3 2.7B recipes (phase 14) and their cuts
CAPTION27_YAML = os.path.join(REPO, "configs", "caption",
                              "caption_gpt3_2.7B_youku_v0.yaml")
CLS27_YAML = os.path.join(REPO, "configs", "cls",
                          "cls_gpt3_2.7B_youku_v0_sharp_2.yaml")
CAPTION27_CUTS = {"max_new_tokens": 32, "synthetic_length": 48}
CLS27_CUTS = {"eval_video_batch": DOWNSTREAM_EVAL_CLIPS,
              "synthetic_length": 64}
# the zeroed share of the decoder's input under dropout 0.1 (one draw of
# ~10^7 values: its standard error is ~10^-4) and, without dropout, the
# bound on exact zeros of bf16 embeddings
DROPOUT_SHARE_TOL = 0.01
# normalized retrieval features after 24 decoder layers in bf16, relative
# L2: each attention call differs by a few bf16 ulps (2^-8), ~24 such
# flips add up to about sqrt(24) x 2^-8 ~ 2%, and the bound leaves three
# times that (as OWL_REL_TOL)
FEATURE_TOL = 2.0 ** -4
DISPATCH_K = 8          # decode steps a dispatch of the multi-step runs
SAMPLE_REPLAYS = 10_000  # replays of the captured sampling step
SAMPLE_YAML = os.path.join(REPO, "configs", "instruct",
                           "serve_bloomz_7b_sample.yaml")
SPIN_CYCLES = 200_000_000  # >= 0.1 s at the H100's 1.98 GHz boost clock
# the H100 SXM's published dense bf16 and int8 tensor-core rates, fp32
# rate outside the tensor cores and HBM3 bandwidth (the bounds in the
# kernel report)
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def time_ms(fn, iters: int) -> float:
    """Device ms per call.  A spin kernel holds the device while the host
    enqueues the calls, so the events time them back to back and not the
    host's launch rate (which bounds small kernels on a slow host)."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def within(got: torch.Tensor, want: torch.Tensor) -> bool:
    diff = (got.float() - want.float()).abs()
    return bool((diff <= KERNEL_TOL * (1 + want.float().abs())).all())


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return ((got.float() - want).norm()
            / want.norm().clamp_min(1e-30)).item()


def phase_device_and_build():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    print(f"[device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}",
          flush=True)
    from youku_mplug_tpu_torch.ops import _native

    so, seconds, log = _native.build()
    _native.library()
    # nvcc -Xptxas -v: per template instance, its registers and spills
    builds = _native.ptxas_report(log)
    print(f"[build] {os.path.relpath(so, REPO)} in {seconds:.1f} s "
          f"(sm_90a) | " + " ; ".join(
              f"{name} {u['registers']} regs, spills {u['spill_stores']}/"
              f"{u['spill_loads']} B" for name, u in builds.items()),
          flush=True)
    return card, builds


def phase_flash_builds(fa, builds) -> dict:
    """The flash builds at each head dim: registers and spills from nvcc's
    report, and the blocks resident on one SM as the card counts them
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), for the forward and
    for the backward's dq and dk/dv kernels.  Fails if any flash build
    spills, if the forward's count is not FWD_BLOCKS_PER_SM (the wave
    kv_splits sizes its splits by) or the backward's not
    BWD_BLOCKS_PER_SM."""
    out = {}
    kinds = ("bwd_dq", "bwd_dkv", "bwd_dkv_short")
    for kind, dims in (("fwd", fa.HEAD_DIMS), ("bwd_dq", fa.HEAD_DIMS),
                       ("bwd_dkv", fa.HEAD_DIMS),
                       ("bwd_dkv_short", fa.SHORT_HEAD_DIMS)):
        for d in dims:
            u = builds.get(f"flash_{kind}<{d},plain>")
            if u is None:
                fail(f"no -Xptxas -v report for flash_{kind}<{d},plain>")
            out[f"{kind}<{d}>"] = {**u}
    got_bwd = {}
    for d in fa.HEAD_DIMS:
        out[f"fwd<{d}>"]["blocks_per_sm"] = fa.fwd_blocks_per_sm(d)
        got_bwd[d] = fa.bwd_blocks_per_sm(d)
        for kind, n in zip(kinds, got_bwd[d]):
            if n is not None:
                out[f"{kind}<{d}>"]["blocks_per_sm"] = n
    print("[kernel] flash builds (registers, spill bytes stored / loaded, "
          "blocks an SM from cudaOccupancyMaxActiveBlocksPerMultiprocessor): "
          + json.dumps(out), flush=True)
    spilled = [name for name, u in builds.items()
               if name.startswith("flash_") and (u["spill_stores"]
                                                 or u["spill_loads"])]
    if spilled:
        fail(f"flash builds spill: {spilled}")
    got = {d: out[f"fwd<{d}>"]["blocks_per_sm"] for d in fa.HEAD_DIMS}
    if got != fa.FWD_BLOCKS_PER_SM:
        fail(f"forward blocks an SM {got} != FWD_BLOCKS_PER_SM "
             f"{fa.FWD_BLOCKS_PER_SM}")
    if got_bwd != fa.BWD_BLOCKS_PER_SM:
        fail(f"backward (dq, dk/dv, short-query dk/dv) blocks an SM "
             f"{got_bwd} != BWD_BLOCKS_PER_SM {fa.BWD_BLOCKS_PER_SM}")
    return out


def _bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS
           ) -> dict:
    """The least time the card could take for the work: the larger of the
    operations at ``peak`` (the bf16 dense rate unless said) and the bytes
    at the HBM rate."""
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops_ms": t_ops, "bytes_ms": t_bytes}


def _attn_bounds(fa, b, h, sq, sk, d, causal, period, kv_len):
    """Bounds of the forward, the dq kernel and the dk/dv kernel on these
    inputs: the products over the (query, key) pairs the mask leaves
    (QK^T and PV forward; S, dP and dQ for dq; S^T, dP^T, dV and dK for
    dk/dv; 2 operations per multiply-add), each bf16 operand read once
    and each output written once, lse and delta in fp32."""
    pairs = b * h * int(fa._allowed(sq, sk, causal=causal, period=period,
                                    kv_len=kv_len, device="cpu").sum())
    row = 2 * d * b * h  # bytes of one bf16 row over all (sample, head)
    stat = 4 * b * h * sq
    return {"fwd": _bound(4 * pairs * d, row * (2 * sq + 2 * sk) + stat),
            "dq": _bound(6 * pairs * d, row * (3 * sq + 2 * sk) + 2 * stat),
            "dkv": _bound(8 * pairs * d,
                          row * (2 * sq + 4 * sk) + 2 * stat)}


def _sdpa_kwargs(fa, q, k, causal, period, kv_len, slopes):
    """The library yardstick's mask for these inputs: is_causal, a bool
    mask, or (ALiBi) the float bias with -inf where the mask drops a key,
    in q's dtype as SDPA takes it."""
    sq, sk = q.shape[2], k.shape[2]
    if slopes is None and period == 0 and kv_len is None:
        return {"is_causal": causal}
    allowed = fa._allowed(sq, sk, causal=causal, period=period,
                          kv_len=kv_len, device=q.device)
    if slopes is None:
        return {"attn_mask": allowed}
    bias = slopes[:, None, None] * torch.arange(sk, device=q.device,
                                                dtype=torch.float32)
    return {"attn_mask": bias.masked_fill(~allowed, float("-inf"))[None]
            .to(q.dtype)}


def _library_ms(q, k, v, mask_kw, do=None):
    """F.scaled_dot_product_attention on the same inputs: the forward's
    ms, and with ``do`` also the backward's (forward + backward through
    autograd, less the forward; leaves are contiguous copies)."""
    import torch.nn.functional as F

    fwd = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, **mask_kw),
                  20)
    if do is None:
        return fwd, None
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]

    def fwd_bwd():
        out = F.scaled_dot_product_attention(*leaves, **mask_kw)
        torch.autograd.grad(out, leaves, do)

    with torch.no_grad():
        fwd_leaves = time_ms(lambda: F.scaled_dot_product_attention(
            *leaves, **mask_kw), 20)
    return fwd, max(time_ms(fwd_bwd, 20) - fwd_leaves, 0.0)


def _bwd_case(rand, fa, b, sq, sk, n, causal, period, kv_len, layout,
              d=64, alibi=False, path="train", on_path=True):
    """One training-shape check, in the layouts the model hands the
    kernels (packed slices of one qkv projection, head views of Bloom's
    head-major fused projection, or head views of AttentionPool's
    projections): the forward kernel's o and lse against
    flash_fwd_plain, then the dq and dk/dv kernels against
    flash_bwd_plain on the same (q, k, v, o, lse, dO); all with the
    kernel's, the plain version's and the library call's times and the
    bound."""
    from youku_mplug_tpu_torch.ops import decode_attention as dec

    nd = n * d
    if layout == "packed":
        qkv = rand(b, sq, 3 * nd)
        parts = [qkv[..., :nd], qkv[..., nd:2 * nd], qkv[..., 2 * nd:]]
        parts = [t.unflatten(-1, (n, d)) for t in parts]
    elif layout == "head-major":
        qkv5 = rand(b, sq, n, 3, d)
        parts = [qkv5[..., i, :] for i in range(3)]
    else:
        parts = [rand(b, s, nd).unflatten(-1, (n, d))
                 for s in (sq, sk, sk)]
    q, k, v = (t.transpose(1, 2) for t in parts)
    slopes = (torch.from_numpy(dec.alibi_slopes(n)).to(q.device)
              if alibi else None)
    kw = dict(scale=d ** -0.5, causal=causal, period=period, kv_len=kv_len,
              alibi_slopes=slopes)
    shape = (f"[{b},{sq},{n}x{d}] kv {sk}"
             + (" causal" if causal else "") + (" ALiBi" if alibi else "")
             + (f" period {period}" if period else "")
             + (f" kv_len {kv_len}" if kv_len is not None else "")
             + f" {layout} ({path})")
    bounds = _attn_bounds(fa, b, n, sq, sk, d, causal, period, kv_len)
    mask_kw = _sdpa_kwargs(fa, q, k, causal, period, kv_len, slopes)
    o = fa._head_major_empty(q)
    lse = fa.flash_fwd_cuda(q, k, v, o, **kw)
    want_o, want_lse = fa.flash_fwd_plain(q, k, v, **kw)
    fwd_err, lse_err = err(o, want_o), err(lse, want_lse)
    if not (within(o, want_o) and lse_err <= LSE_TOL):
        fail(f"forward {shape}: max err {fwd_err} (tol {KERNEL_TOL}), lse "
             f"{lse_err} (tol {LSE_TOL})")
    do = fa._head_major_empty(q).copy_(rand(b, n, sq, d))
    lib_fwd, lib_bwd = _library_ms(q, k, v, mask_kw, do)
    fwd = {"shape": shape, "on_path": on_path, "max_abs_err": fwd_err,
           "lse_err": lse_err,
           "splits": fa.kv_splits(b, n, sq, sk, head_dim=d, causal=causal,
                                  period=period, kv_len=kv_len,
                                  sms=fa._device_sms(q.device.index)),
           "ms": time_ms(lambda: fa.flash_fwd_cuda(q, k, v, o, **kw), 20),
           "plain_ms": time_ms(lambda: fa.flash_fwd_plain(q, k, v, **kw),
                               20),
           "library_ms": lib_fwd, **bounds["fwd"]}
    delta = fa.flash_bwd_delta_plain(o, do)
    got_delta = fa.flash_bwd_delta_cuda(o, do)
    e_delta = rel_l2(got_delta, delta)
    if not e_delta <= DELTA_TOL:
        fail(f"delta {shape}: relative L2 {e_delta} (tol {DELTA_TOL})")
    got = fa.flash_bwd_cuda(q, k, v, o, lse, do, **kw)
    want = fa.flash_bwd_plain(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    errs = {name: rel_l2(g, w) for name, g, w in zip(("dq", "dk", "dv"),
                                                     got, want)}
    abs_err = {name: err(g, w) for name, g, w in zip(("dq", "dk", "dv"),
                                                     got, want)}
    if max(errs.values()) > BWD_TOL or not all(
            torch.isfinite(g).all() for g in got):
        fail(f"backward {shape}: relative L2 {errs} (tol {BWD_TOL})")
    if kv_len is not None and (got[1][:, :, kv_len:].any()
                               or got[2][:, :, kv_len:].any()):
        fail(f"backward {shape}: keys past kv_len got a gradient")
    dq, dk, dv = (fa._head_major_empty(t) for t in (q, k, v))
    iters = 20
    dq_ms = time_ms(lambda: fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta,
                                                 dq, **kw), iters)
    dkv_ms = time_ms(lambda: fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                   dk, dv, **kw), iters)
    plain_ms = time_ms(lambda: fa.flash_bwd_plain(q, k, v, o, lse, do, **kw),
                       iters)

    def bwd_row(kind, ms, grads):
        return {"shape": shape, "on_path": on_path,
                "rel_l2": {gn: errs[gn] for gn in grads},
                "max_abs_err": max(abs_err[gn] for gn in grads), "ms": ms,
                "plain_ms": plain_ms, "library_ms": lib_bwd,
                **bounds[kind]}

    rows = b * n * sq
    return {"layout": layout, "fwd": fwd,
           "dq": bwd_row("dq", dq_ms, ("dq",)),
           "dkv": bwd_row("dkv", dkv_ms, ("dk", "dv")),
           "delta": {"shape": shape, "on_path": on_path,
                     "rel_l2": e_delta, "max_abs_err": err(got_delta, delta),
                     "ms": time_ms(lambda: fa.flash_bwd_delta_cuda(o, do),
                                   iters),
                     "plain_ms": time_ms(
                         lambda: fa.flash_bwd_delta_plain(o, do), iters),
                     "library_ms": None,
                     **_bound(2 * rows * d, 2 * 2 * rows * d + 4 * rows,
                              PEAK_FP32_FLOPS)}}


# (rows, Sq, Sk, heads, causal, period, kv_len, layout, head dim, ALiBi,
# path, on the path); the first four are the flagship train step's shapes
# (16 clips x 8 frames; 16 clips x 14 temporal groups; 16 x (128 queries
# + 80 tokens); AttentionPool's 128 queries over 1 + 8 x 196 tokens and
# the bias key), then a small kv_len case
BWD_SHAPES = [(128, 197, 197, 12, False, 0, None, "packed"),
              (224, 112, 112, 12, False, 8, None, "packed"),
              (16, 208, 208, 32, True, 0, None, "packed"),
              (16, 128, 1570, 12, False, 0, None, "heads"),
              (2, 65, 130, 1, False, 0, 70, "heads", 64, False, "train",
               False)]
# Bloom's training attention, ALiBi causal at head dim 128 on head views
# of the head-major fused projection: the instruct-train step's [8, 105,
# 32x128] (a 99-token prompt with the 65 media positions, 5 answer words
# and eos: a ragged second tile), the YAML's max_length 768 (12 causal
# tiles, biases up to ~645), 40 heads (the half-step ladder), ALiBi at
# d = 64 (packed), and the d = 128 build without ALiBi
ALIBI_SHAPES = [
    (8, 105, 105, 32, True, 0, None, "head-major", 128, True,
     "instruct_train", True),
    (2, 768, 768, 32, True, 0, None, "head-major", 128, True,
     "max_length", False),
    (2, 256, 256, 40, True, 0, None, "head-major", 128, True, "40 heads",
     False),
    (2, 208, 208, 32, True, 0, None, "packed", 64, True, "d 64", False),
    (2, 256, 256, 32, True, 0, None, "head-major", 128, False,
     "d 128 without ALiBi", False)]


# head dim 96, clip-b16's AttentionPool (8 heads of 96, 128 queries over
# 1 + T x 196 tokens and the bias key, head views of [B, S, 768]
# projections): the cls train step's 32 clips x 8 frames and the ITM
# train step's 32 clips x 4 frames (forward and both backward kernels),
# then an evaluation call's 4 clips of each (forward, split over the keys)
D96_SHAPES = [
    (32, 128, 1570, 8, False, 0, None, "heads", 96, False, "cls_train",
     True),
    (32, 128, 786, 8, False, 0, None, "heads", 96, False, "itm_train",
     True),
    (4, 128, 1570, 8, False, 0, None, "heads", 96, False, "cls_eval", True),
    (4, 128, 786, 8, False, 0, None, "heads", 96, False, "itm_eval", True),
    # the 2.7B caption recipe's 24 clips x 16 frames (1 + 16 x 196 tokens
    # and the bias key), in its finetune and its evaluation's encode
    (24, 128, 3138, 8, False, 0, None, "heads", 96, False,
     "caption27_train", True),
    # more than 128 queries (ragged keys, kv_len < Sk): the key-tile dk/dv
    # kernel, which no path runs at d 96
    (4, 256, 1570, 8, False, 0, 1500, "heads", 96, False, "key-tile dk/dv",
     False)]
D96_PATHS = ("cls_train", "cls_eval", "itm_train", "itm_eval",
             "caption27_train", "caption27_eval", "cls27_train", "cls27_eval")
D96_TRAIN_PATHS = ("cls_train", "itm_train", "caption27_train", "cls27_train")
# the paths of the checkpoint phases (15-19): caption serving with the
# imported and the resumed weights; Owl serving from the HF import, its
# LoRA training and the int8 serving export
CKPT_SERVE_PATHS = ("serve_imported", "serve_resumed")
CKPT_OWL_PATHS = ("instruct_hf", "instruct_hf_train",
                  "instruct_serving_int8")
# every path that runs a flash backward (the delta kernel's)
BWD_PATHS = ("train", "caption_train", "instruct_train",
             "instruct_hf_train") + D96_TRAIN_PATHS

# head dim 80, the GPT-3 2.7B decoder (32 heads of 80), on head views of
# the fused qkv projection: the cls evaluation's decoder passes (4 clips x
# 45 class pairs of 128 queries + 80 tokens, causal: K4 forward); a
# dropout-free training pass of 32 rows (K4b dq and dk/dv: no shipped
# YAML trains the decoder without its 0.1 attention dropout); and a
# head-major call split over the keys three ways (kv_len 900 of 1000)
D80_SHAPES = [
    (180, 208, 208, 32, True, 0, None, "packed", 80, False, "cls27_eval",
     True),
    (32, 208, 208, 32, True, 0, None, "packed", 80, False,
     "dropout-free training", False),
    (1, 100, 1000, 32, False, 0, 900, "heads", 80, False, "split-KV",
     False)]


# lengths of the decode cases: live keys 1 (the row the step writes),
# 18, 132, 0 (valid_from past the row: zeros, the row still written),
# 201, 156, 2 and 58
DEC_CLEN = [0, 17, 136, 150, 200, 255, 100, 60]
DEC_VFROM = [0, 0, 5, 151, 0, 100, 99, 3]
# the caption evaluation's beam search on the flagship: 24 clips x 5
# beams, prefix 128 queries + 20 prompt tokens (1 real, 19 pads), 32 new
# tokens
BEAM_ROWS, BEAM_PREFIX, BEAM_VALID_FROM, BEAM_NEW = 120, 148, 19, 32


def _step_views(qkv, n, d):
    """q, k, v of one decode step as the decoders hand them over: slices
    of GPT-3's packed row [B, 3*n*d] (d 64 and 80), head views of Bloom's
    head-major row [B, n, 3, d] (d 128)."""
    if qkv.dim() == 2:
        nd = n * d
        return qkv[:, :nd], qkv[:, nd:2 * nd], qkv[:, 2 * nd:]
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def _rotating(n_layers):
    """A layer index that moves on by one at each call, over all layers."""
    state = [0]

    def nxt():
        state[0] = (state[0] + 1) % n_layers
        return state[0]
    return nxt


def _decode_case(dec, kvc, rand, n, d, layers, alibi, int8, shape, on_path,
                 clens=DEC_CLEN, vfroms=DEC_VFROM):
    """One check of the decode kernel with its cache write (K5 and K6) on
    the cache [layers, B, 256, 2*n*d] (B = len(clens) samples writing at
    ``clens`` and attending from ``vfroms``; random bf16 rows, int8:
    quantized) at layer L-1: the kernel against
    write_decode_attention_plain on copies of the cache, both leaves
    bitwise equal and no row but (L-1, b, cache_len[b]) touched, the
    output within KERNEL_TOL, a sample with no live key zeros.  Times
    over 200 calls: warm (layer L-1 each call, its live rows in L2) and
    rotated (the layer index moved over all L layers, so the live rows
    come from HBM as on the path), the plain
    version; SDPA over the live cache view with the same mask and bias,
    warm and rotated (int8: none; ``bf16_ms`` is the bf16 kernel's on the
    same cache dequantized).  ``host_ms``: the wrapper's host time per
    call, enqueued back to back with no sync.  The bound counts the
    operations over every live key, reads the live K and V rows the
    kernel takes from the cache once (int8: their lanes and 8 bytes of
    scales per head; not the new row, which it scores from registers), q
    and the new K and V rows, and writes o and the new cache row once."""
    import torch.nn.functional as F

    b, m, lidx = len(clens), 256, layers - 1
    qkv = rand(b, 3 * n * d) if d != 128 else rand(b, n, 3, d)
    q, k, v = _step_views(qkv, n, d)
    rows = rand(layers, b, m, 2 * n * d)
    if int8:
        kv8, scales = kvc.quantize_rows(rows, n)
        del rows
        cache = {"kv": kv8, "scale": scales}
        bf16_cache = kvc.dequantize_rows(kv8, scales, n, torch.bfloat16)
    else:
        cache = bf16_cache = rows
    clen, vfrom = (torch.tensor(x, dtype=torch.int32, device="cuda")
                   for x in (clens, vfroms))
    kw = dict(alibi_slopes=dec.alibi_slopes(n) if alibi else None)
    tag = "K5 int8" if int8 else "K5"
    copy = (lambda c: {key: t.clone() for key, t in c.items()}) if int8 \
        else (lambda c: c.clone())
    got_c, want_c = copy(cache), copy(cache)
    got = dec.write_decode_attention(q, k, v, got_c, n, lidx, clen, vfrom,
                                     **kw)
    want = dec.write_decode_attention_plain(q, k, v, want_c, n, lidx, clen,
                                            vfrom, **kw)
    torch.cuda.synchronize()
    rows_ok, touched = True, set()
    for g, w, c in zip(kvc.leaves(got_c), kvc.leaves(want_c),
                       kvc.leaves(cache)):
        if c is None:  # a bf16 cache has one leaf
            continue
        rows_ok &= torch.equal(g, w)
        touched |= {tuple(t) for t in (g != c).reshape(layers, b, m, -1)
                    .any(-1).nonzero().tolist()}
    dead = [i for i in range(b) if vfroms[i] > clens[i]]
    e = err(got, want)
    empty = got[dead].abs().max().item() if dead else 0.0
    if not within(got, want) or empty != 0 or not rows_ok \
            or not touched <= {(lidx, i, clens[i]) for i in range(b)}:
        fail(f"{tag} {shape}: max err {e} (tol {KERNEL_TOL}); empty slot "
             f"max {empty}; cache leaves equal to plain {rows_ok}; rows "
             f"touched {sorted(touched)[:10]}")
    del got_c, want_c
    nd = n * d
    live = sum(max(min(c, m - 1) - f + 1, 0) for c, f in zip(clens, vfroms))
    # rows read from the cache: the live ones but the new row, when live
    live_read = sum(max(min(c, m - 1) - f + 1 - (f <= c < m), 0)
                    for c, f in zip(clens, vfroms))
    elem = 1 if int8 else 2
    row_bytes = 2 * nd * elem + (8 * n if int8 else 0)
    write_bytes = b * (2 * 2 * nd + row_bytes)  # read k, v; write the row

    def fused(layer, c=cache):
        return dec.write_decode_attention(q, k, v, c, n, layer(), clen,
                                          vfrom, **kw)

    def last():
        return lidx

    new_rows = torch.cat([k.reshape(b, -1), v.reshape(b, -1)], -1)
    rot = _rotating(layers)
    case = {"shape": shape, "on_path": on_path, "max_abs_err": e,
            "cache_bitwise_equal": True,
            "ms": time_ms(lambda: fused(last), 200),
            "rotated_ms": time_ms(lambda: fused(rot), 200),
            "plain_ms": time_ms(lambda: dec.write_decode_attention_plain(
                q, k, v, cache, n, lidx, clen, vfrom, **kw), 20),
            "write_bytes": write_bytes,
            "write_plain_ms": time_ms(lambda: kvc.cache_write(
                cache, new_rows[:, None], clen, lidx), 20),
            **_bound(4 * live * n * d,
                     live_read * row_bytes + 2 * 2 * b * nd + write_bytes,
                     PEAK_INT8_OPS if int8 else PEAK_BF16_FLOPS)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        fused(last)
    case["host_ms"] = (time.perf_counter() - t0) / 200 * 1e3
    torch.cuda.synchronize()
    if int8:
        case["library_ms"] = case["library_rotated_ms"] = None
        case["bf16_ms"] = time_ms(lambda: fused(last, bf16_cache), 200)
        case["bf16_rotated_ms"] = time_ms(lambda: fused(rot, bf16_cache),
                                          200)
        return case
    # the bf16 write as one PyTorch call (indexed assignment)
    samples = torch.arange(b, device=q.device)
    case["write_library_ms"] = time_ms(lambda: cache[lidx].index_put_(
        (samples, clen.long()), new_rows), 200)
    qh = q.reshape(b, n, 1, d)
    heads = [(layer[..., :nd].unflatten(-1, (n, d)).transpose(1, 2),
              layer[..., nd:].unflatten(-1, (n, d)).transpose(1, 2))
             for layer in cache]
    j = torch.arange(m, device=q.device)
    allowed = ((j[None] >= vfrom[:, None]) & (j[None] <= clen[:, None]))
    bias = torch.zeros(b, n, 1, m, device=q.device)
    if alibi:
        bias = bias + torch.as_tensor(kw["alibi_slopes"], device=q.device)[
            None, :, None, None] * j.float()
    bias = bias.masked_fill(~allowed[:, None, None], float("-inf")).to(
        q.dtype)

    def sdpa(layer):
        kh, vh = heads[layer()]
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias)

    case["library_ms"] = time_ms(lambda: sdpa(last), 200)
    case["library_rotated_ms"] = time_ms(lambda: sdpa(rot), 200)
    return case


def _write_row(case):
    """K6's row of a decode case: the write now runs inside the decode
    kernel's launch, so its time is that launch's; plain = the plain write
    (cache_write) alone; library = the bf16 write as one indexed
    assignment (none for int8); the bound moves the write's bytes (int8:
    and ~4 fp32 operations a value to quantize)."""
    int8 = "int8" in case["shape"]
    row = {k: case[k] for k in ("shape", "on_path", "ms", "rotated_ms",
                                "cache_bitwise_equal")}
    return {**row, "max_abs_err": 0.0, "plain_ms": case["write_plain_ms"],
            "library_ms": None if int8 else case["write_library_ms"],
            **_bound(case["write_bytes"] if int8 else 0,
                     case["write_bytes"], PEAK_FP32_FLOPS)}


DEC_COUNTERS = ("launches", "alibi_launches", "int8_launches",
                "int8_alibi_launches", "d80_launches", "int8_d80_launches")
# the paths that run each decode kernel variant (each launch with its K6
# write): the serve CLI's and run_instruct's (k = 1 graphs), the k = 8
# runs, the twin draft's steps and the sampled instruct runs
K5_PATHS = {"K5": ("serve", "serve_k8", "speculative_twin",
                   "caption_eval") + CKPT_SERVE_PATHS,
            "K5-ALiBi": ("instruct", "instruct_k8", "instruct_sample",
                         "instruct_hf"),
            "K5-int8": ("serve_int8kv", "serve_int8kv_k8"),
            "K5-int8-ALiBi": ("instruct_int8", "instruct_int8_k8",
                              "instruct_serving_int8"),
            "K5-d80": ("caption27_eval",), "K5-int8-d80": ()}


def _decode_entries(dec, kvc, rand):
    """The decode kernel's report entries: K5 by variant (bf16 / int8,
    with or without ALiBi) and K6, the cache write fused into it, whose
    launches are all of the kernel's."""
    cases = {}
    # the caption evaluation's beam step: 24 clips x 5 beams, each writing
    # at 148 + t - 1 (128 queries + a 20-token prompt before the t-th new
    # token, t = 1..31) and attending from 19 (the prompt's pads)
    beam = [BEAM_PREFIX + i % (BEAM_NEW - 1) for i in range(BEAM_ROWS)]
    cases["K5"] = [_decode_case(
        dec, kvc, rand, 32, 64, 24, False, False,
        f"[24,{BEAM_ROWS},256,2x32x64] d 64 (caption_eval, beam 5)", True,
        beam, [BEAM_VALID_FROM] * BEAM_ROWS)]
    gc.collect()
    torch.cuda.empty_cache()
    # the same beam step on the 2.7B decoder's cache (32 heads of 80), bf16
    # (the 2.7B caption evaluation) and int8 (no shipped YAML), 8 of its
    # 32 layers (each 315 MB, so rotating over 8 reads from HBM as 32 do)
    for key, int8 in (("K5-d80", False), ("K5-int8-d80", True)):
        cases[key] = [_decode_case(
            dec, kvc, rand, 32, 80, 8, False, int8,
            f"[8,{BEAM_ROWS},256,2x32x80]" + (" int8" if int8 else "")
            + " d 80 (caption27_eval, beam 5)", not int8, beam,
            [BEAM_VALID_FROM] * BEAM_ROWS)]
        gc.collect()
        torch.cuda.empty_cache()
    for key, n, d, layers, alibi, int8, path in (
            ("K5", 32, 64, 24, False, False, "serve"),
            ("K5-ALiBi", 32, 128, 30, True, False, "instruct"),
            ("K5-ALiBi", 40, 128, 8, True, False, None),
            ("K5", 32, 128, 8, False, False, None),
            ("K5-int8", 32, 64, 24, False, True, "serve_int8kv"),
            ("K5-int8-ALiBi", 32, 128, 30, True, True, "instruct_int8"),
            ("K5-int8-ALiBi", 40, 128, 8, True, True, None)):
        shape = (f"[{layers},8,256,2x{n}x{d}]" + (" int8" if int8 else "")
                 + f" d {d}" + (" ALiBi" if alibi else "")
                 + (f" ({path})" if path else ""))
        cases.setdefault(key, []).append(_decode_case(
            dec, kvc, rand, n, d, layers, alibi, int8, shape, bool(path)))
        gc.collect()
        torch.cuda.empty_cache()
    wrapper = dec.write_decode_attention
    dec_int8 = f"{TPU_DEC}:56 (quantized=True, :58-68, :126-127, :142)"
    return [
        _entry("K5 decode attention with the cache write (decoder decode "
               "step, head dim 64)", DEC_SRC, f"{TPU_DEC}:56", wrapper,
               K5_PATHS["K5"], "K5", cases["K5"]),
        _entry("K5 decode attention with the cache write, ALiBi ladder, "
               "head dim 128 (Bloom decode step)", DEC_SRC, f"{TPU_DEC}:56",
               wrapper, K5_PATHS["K5-ALiBi"], "K5-ALiBi", cases["K5-ALiBi"],
               counter="alibi_launches"),
        _entry("K5 decode attention with the cache write, int8 cache "
               "(caption int8-KV decode step, head dim 64)", DEC_SRC,
               dec_int8, wrapper, K5_PATHS["K5-int8"], "K5-int8",
               cases["K5-int8"], counter="int8_launches"),
        _entry("K5 decode attention with the cache write, int8 cache, ALiBi "
               "ladder, head dim 128 (Bloom int8 decode step)", DEC_SRC,
               dec_int8, wrapper, K5_PATHS["K5-int8-ALiBi"], "K5-int8-ALiBi",
               cases["K5-int8-ALiBi"], counter="int8_alibi_launches"),
        _entry("K5 decode attention with the cache write, head dim 80 (GPT-3 "
               "2.7B decode step: teams of 10 lanes, three a warp)", DEC_SRC,
               f"{TPU_DEC}:56", wrapper, K5_PATHS["K5-d80"], "K5-d80",
               cases["K5-d80"], counter="d80_launches"),
        _entry("K5 decode attention with the cache write, int8 cache, head "
               "dim 80 (GPT-3 2.7B, no shipped YAML)", DEC_SRC, dec_int8,
               wrapper, K5_PATHS["K5-int8-d80"], "K5-int8-d80",
               cases["K5-int8-d80"], counter="int8_d80_launches"),
        _entry("K6 the decode step's cache write, bf16 or int8 (quantized "
               "as quantize_rows), fused into K5's launch (ms: that "
               "launch's)", DEC_SRC,
               "youku_mplug_tpu/ops/kv_cache.py:93 (cache_scatter_write "
               ":110, pallas_call :171)", wrapper,
               sum(K5_PATHS.values(), ()), "K6",
               [_write_row(c) for rows in cases.values() for c in rows],
               counter=DEC_COUNTERS)]


def _entry(name, source, replaces, wrapper, paths, key, per_shape,
           counter="launches", build=None):
    """A kernel's report entry.  The error is the worst over every shape;
    the times and bounds are sums over the shapes its paths run (over
    every shape for a kernel that no path runs).  ``build``: the build's
    registers, spills and blocks an SM, where the report shows them."""
    on = [p for p in per_shape if p["on_path"]] or per_shape
    ops, nbytes = sum(p["ops_ms"] for p in on), sum(p["bytes_ms"] for p in on)
    library = [p["library_ms"] for p in on]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "wrapper": wrapper, "counter": counter,
            "paths": paths, "key": key,
            "max_abs_err": max(p["max_abs_err"] for p in per_shape),
            "ms": sum(p["ms"] for p in on),
            "plain_ms": sum(p["plain_ms"] for p in on),
            "bound_ms": sum(p["bound_ms"] for p in on),
            "bound_by": "operations" if ops >= nbytes else "bytes",
            "library_ms": None if None in library else sum(library),
            "per_shape": per_shape, **({"build": build} if build else {})}


FWD_SRC = "youku_mplug_tpu_torch/csrc/flash_fwd.cu"
BWD_SRC = "youku_mplug_tpu_torch/csrc/flash_bwd.cu"
DEC_SRC = "youku_mplug_tpu_torch/csrc/decode_attention.cu"
TPU_FLASH = "youku_mplug_tpu/ops/flash_attention.py"
TPU_DEC = "youku_mplug_tpu/ops/decode_attention.py"

def phase_kernels(dev, builds):
    from youku_mplug_tpu_torch.ops import decode_attention as dec
    from youku_mplug_tpu_torch.ops import flash_attention as fa
    from youku_mplug_tpu_torch.ops import kv_cache as kvc

    flash_builds = phase_flash_builds(fa, builds)

    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    # K1 forward alone: vision spatial [B*T, 197, 12*64], temporal
    # [B*14, 112, 12*64] period 8 (B = 8 clips serving), the CLIP
    # ViT-L/14 frames [16 clips x 8 frames, 1 + 16*16, 16*64] of instruct
    # serving and [8 x 8, 257, 16*64] of instruct training; the frozen
    # 1.3B decoder's causal calls of the downstream evaluations: a cls
    # call's 4 clips x 45 class pairs and an ITM call's 4 clips x 8 texts
    # (128 queries + 80 tokens), and a retrieval text batch of 96 (80
    # tokens); q/k/v as views of one qkv projection
    k1 = []
    for rows, s, n, period, causal, path in (
            (64, 197, 12, 0, False, "serve"),
            (112, 112, 12, 8, False, "serve"),
            (128, 257, 16, 0, False, "instruct"),
            (64, 257, 16, 0, False, "instruct_train"),
            (180, 208, 32, 0, True, "cls_eval"),
            (32, 208, 32, 0, True, "itm_eval"),
            (96, 80, 32, 0, True, "retrieval")):
        nd = n * 64
        qkv = rand(rows, s, 3 * nd)
        q, k, v = qkv[..., :nd], qkv[..., nd:2 * nd], qkv[..., 2 * nd:]
        kw = dict(period=period, causal=causal)
        got = fa.flash_attention_packed(q, k, v, n, **kw)
        want = fa.flash_attention_packed_plain(q, k, v, n, **kw)
        views = [t.unflatten(-1, (n, 64)).transpose(1, 2)
                 for t in (q, k, v)]
        lse = fa.flash_fwd_cuda(*views, torch.empty_like(views[0]),
                                scale=0.125, **kw)
        _, want_lse = fa.flash_fwd_plain(*views, scale=0.125, **kw)
        e, e_lse = err(got, want), err(lse, want_lse)
        shape = (f"[{rows},{s},{n}x64] "
                 + ("causal" if causal else f"period {period}")
                 + f" ({path})")
        if not (within(got, want) and e_lse <= LSE_TOL):
            fail(f"K1 {shape}: max err {e} (tol {KERNEL_TOL}), lse {e_lse} "
                 f"(tol {LSE_TOL})")
        lib, _ = _library_ms(*views, _sdpa_kwargs(fa, views[0], views[1],
                                                  causal, period, None,
                                                  None))
        k1.append({
            "shape": shape, "on_path": True, "max_abs_err": e,
            "lse_err": e_lse,
            "ms": time_ms(lambda: fa.flash_attention_packed(q, k, v, n, **kw),
                          20),
            "plain_ms": time_ms(lambda: fa.flash_attention_packed_plain(
                q, k, v, n, **kw), 20),
            "library_ms": lib,
            **_attn_bounds(fa, rows, n, s, s, 64, causal, period,
                           None)["fwd"]})

    # K4: AttentionPool, q [B,12,128,64] over k/v [B,12,1570,64] (head
    # views of [B, S, 768] projections) at the serving (B 8, split two
    # ways) and pretrain (B 16) batches, then a split-KV case off the
    # paths: ragged Sq and Sk, kv_len < Sk, split three ways
    k4 = []
    for b, sq, sk, kv_len, path, on_path in (
            (8, 128, 1570, None, "serve", True),
            (16, 128, 1570, None, "train", True),
            (4, 100, 1000, 900, "split-KV", False)):
        q = rand(b, sq, 768).unflatten(-1, (12, 64)).transpose(1, 2)
        k, v = (rand(b, sk, 768).unflatten(-1, (12, 64)).transpose(1, 2)
                for _ in range(2))
        splits = fa.kv_splits(b, 12, sq, sk, kv_len=kv_len,
                              sms=fa._device_sms(q.device.index))
        got = fa.flash_attention(q, k, v, kv_len=kv_len)
        want = fa.flash_attention_plain(q, k, v, kv_len=kv_len)
        lse = fa.flash_fwd_cuda(q, k, v, torch.empty_like(q), scale=0.125,
                                kv_len=kv_len)
        e, e_lse = err(got, want), err(lse, fa.flash_fwd_plain(
            q, k, v, scale=0.125, kv_len=kv_len)[1])
        shape = (f"[{b},{sq},12x64] kv {sk}"
                 + (f" kv_len {kv_len}" if kv_len else "")
                 + f" heads ({path})")
        if not (within(got, want) and e_lse <= LSE_TOL) or (
                path == "split-KV" and splits < 2):
            fail(f"K4 {shape}: max err {e}, lse {e_lse}, {splits} splits")
        mask_kw = _sdpa_kwargs(fa, q, k, False, 0, kv_len, None)
        k4.append({
            "shape": shape, "on_path": on_path, "max_abs_err": e,
            "lse_err": e_lse, "splits": splits,
            "ms": time_ms(lambda: fa.flash_attention(q, k, v, kv_len=kv_len),
                          20),
            "plain_ms": time_ms(lambda: fa.flash_attention_plain(
                q, k, v, kv_len=kv_len), 20),
            "library_ms": _library_ms(q, k, v, mask_kw)[0],
            **_attn_bounds(fa, b, 12, sq, sk, 64, False, 0, kv_len)["fwd"]})
    # the clock the kernel times run at: the split-KV case keeps the card
    # busy while nvidia-smi samples it
    card_load = _card_under_load(
        lambda: fa.flash_attention(q, k, v, kv_len=kv_len))

    # the forward again, then the backward kernels, at the training shapes
    # (K1 packed and K4 head-major) and at Bloom's ALiBi shapes
    cases = [_bwd_case(rand, fa, *c) for c in BWD_SHAPES]
    alibi_cases = [_bwd_case(rand, fa, *c) for c in ALIBI_SHAPES]
    no_alibi_128 = alibi_cases.pop()
    d96 = [_bwd_case(rand, fa, *c) for c in D96_SHAPES]
    d80 = [_bwd_case(rand, fa, *c) for c in D80_SHAPES]
    k1 += [c["fwd"] for c in cases if c["layout"] == "packed"]
    k1.append(no_alibi_128["fwd"])
    # the pretrain K4 forward is timed above; the small kv_len case here
    k4 += [c["fwd"] for c in cases
           if c["layout"] == "heads" and not c["fwd"]["on_path"]]
    report = [
        _entry("K1 flash_attention_packed (vision spatial + temporal, "
               "decoder causal, CLIP ViT-L frames)", FWD_SRC,
               f"{TPU_FLASH}:426", fa.flash_attention_packed,
               ("serve", "train", "instruct", "instruct_train",
                "serve_int8kv", "instruct_int8", "speculative_twin",
                "speculative_ngram", "instruct_lookup", "instruct_sample",
                "caption_train", "caption_eval", "cls_eval", "itm_eval",
                "retrieval_train", "retrieval_eval") + CKPT_SERVE_PATHS
               + CKPT_OWL_PATHS, "K1", k1),
        _entry("K4 flash_attention (AttentionPool; split-KV shares merged "
               "by flash_fwd_merge_kernel)", FWD_SRC,
               f"{TPU_FLASH}:59", fa.flash_attention,
               ("serve", "train", "serve_int8kv", "speculative_twin",
                "speculative_ngram", "caption_train", "caption_eval")
               + CKPT_SERVE_PATHS, "K4", k4)]
    for kind, wrapper, line, line_hm in (
            ("dq", fa.flash_bwd_dq_cuda, 723, 148),
            ("dkv", fa.flash_bwd_dkv_cuda, 791, 195)):
        report.append(_entry(
            f"K2/K3 + K4b backward {kind} kernel (flash_bwd_{kind}_cuda; "
            f"also replaces flash_attention.py:{line_hm})", BWD_SRC,
            f"{TPU_FLASH}:{line}", wrapper, ("train", "caption_train"), kind,
            [c[kind] for c in cases] + [no_alibi_128[kind]]))
    report.append(_entry(
        "K1 flash_attention_packed, ALiBi causal (Bloom training, head dim "
        "128)", FWD_SRC, f"{TPU_FLASH}:426", fa.flash_attention_packed,
        ("instruct_train", "instruct_hf_train"), "K1-ALiBi",
        [c["fwd"] for c in alibi_cases],
        counter="alibi_launches"))
    for kind, wrapper, line in (("dq", fa.flash_bwd_dq_cuda, 723),
                                ("dkv", fa.flash_bwd_dkv_cuda, 791)):
        report.append(_entry(
            f"K{2 if kind == 'dq' else 3} backward {kind} kernel, ALiBi "
            f"causal (Bloom training, head dim 128)", BWD_SRC,
            f"{TPU_FLASH}:{line}", wrapper,
            ("instruct_train", "instruct_hf_train"),
            f"{kind}-ALiBi", [c[kind] for c in alibi_cases],
            counter="alibi_launches"))

    train96 = [c for c, shape in zip(d96, D96_SHAPES)
               if shape[10] in D96_TRAIN_PATHS]
    key_tiles96 = d96[-1]
    report.append(_entry(
        "K4 flash_attention, head dim 96 (clip-b16 AttentionPool; D-wide "
        "tiles, a 64-byte-swizzled tail panel; split-KV at an evaluation "
        "call's 4 clips)", FWD_SRC, f"{TPU_FLASH}:59", fa.flash_attention,
        D96_PATHS, "K4-d96", [c["fwd"] for c in d96],
        counter="d96_launches", build=flash_builds["fwd<96>"]))
    report.append(_entry(
        "K4b backward dq kernel, head dim 96 (clip-b16 AttentionPool; "
        "D-wide tiles)", BWD_SRC, f"{TPU_FLASH}:148", fa.flash_bwd_dq_cuda,
        D96_TRAIN_PATHS, "dq-d96",
        [c["dq"] for c in train96 + [key_tiles96]],
        counter="d96_launches", build=flash_builds["bwd_dq<96>"]))
    report.append(_entry(
        "K4b backward dkv kernel, head dim 96 (clip-b16 AttentionPool; "
        "D-wide tiles; its 128 queries run the short-query kernel, every "
        "query resident and the key tiles streaming; the key-tile kernel "
        "at 256 queries, off the paths)", BWD_SRC, f"{TPU_FLASH}:195",
        fa.flash_bwd_dkv_cuda, D96_TRAIN_PATHS, "dkv-d96",
        [c["dkv"] for c in train96 + [key_tiles96]],
        counter="d96_short_launches",
        build={**flash_builds["bwd_dkv_short<96>"],
               "key_tile_kernel": flash_builds["bwd_dkv<96>"]}))
    report.append(_entry(
        "K4 flash_attention, head dim 80 (GPT-3 2.7B decoder, causal, via "
        "dot_product_attention; D-wide tiles, a 32-byte-swizzled tail "
        "panel; split-KV off the paths)", FWD_SRC, f"{TPU_FLASH}:59",
        fa.flash_attention, ("cls27_eval",), "K4-d80",
        [c["fwd"] for c in d80], counter="d80_launches",
        build=flash_builds["fwd<80>"]))
    for kind, wrapper, line in (("dq", fa.flash_bwd_dq_cuda, 148),
                                ("dkv", fa.flash_bwd_dkv_cuda, 195)):
        report.append(_entry(
            f"K4b backward {kind} kernel, head dim 80 (GPT-3 2.7B decoder "
            "trained without attention dropout: no shipped YAML)", BWD_SRC,
            f"{TPU_FLASH}:{line}", wrapper, (), f"{kind}-d80",
            [d80[1][kind]], counter="d80_launches",
            build=flash_builds[f"bwd_{kind}<80>"]))
    report.append(_entry(
        "backward delta = rowsum(dO * O) in fp32, one launch a backward at "
        "every head dim (XLA-fused in the JAX package: no Pallas kernel)",
        BWD_SRC, f"{TPU_FLASH}:252 (_bwd; :951 in _bwd_packed)",
        fa.flash_bwd_delta_cuda, BWD_PATHS, "delta",
        [c["delta"] for c in cases + alibi_cases + [no_alibi_128]
         + train96 + [key_tiles96] + d80[1:]]))
    report += _decode_entries(dec, kvc, rand)
    for r in report:
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        build = ("" if "build" not in r else
                 " | {registers} registers, spills {spill_stores}/"
                 "{spill_loads} B, {blocks_per_sm} blocks an SM".format(
                     **r["build"]))
        print(f"[kernel] {r['name']}: max_abs_err {r['max_abs_err']:.3g} | "
              f"kernel {r['ms']:.4f} ms | plain {r['plain_ms']:.4f} ms | "
              f"library {lib} | bound {r['bound_ms']:.4f} "
              f"ms ({r['bound_by']}){build}", flush=True)
        for p in r["per_shape"]:
            print(f"[kernel]   {p['shape']}: "
                  + json.dumps({k: v for k, v in p.items() if k != "shape"}),
                  flush=True)
    print("[kernel] card under load (name, power limit, SM clock, max SM "
          "clock, power draw): " + card_load, flush=True)
    print(f"[kernel] tolerances: forward elementwise {KERNEL_TOL:.3g} x "
          f"(1 + |plain|) (K5 int8 too), lse {LSE_TOL}, backward relative "
          f"L2 {BWD_TOL:.3g} per gradient, delta relative L2 {DELTA_TOL}, "
          "K6 (the cache leaves after the "
          "fused launch) bitwise; library = F.scaled_dot_product_attention "
          "with the same mask (and ALiBi as a float bias), the backward's "
          "as forward + backward less the forward, none for K5 int8 and "
          "delta, K6 "
          "bf16 one index_put_; K5 rotated = the layer index moved over all "
          "L layers a call (live rows from HBM); bound = max(operations / "
          "989 TFLOP/s bf16, 1979 TOP/s int8 (K5 int8) or 67 TFLOP/s fp32 "
          "(K6, delta), bytes / 3.35 TB/s)", flush=True)
    return report


def _card_under_load(fn):
    """nvidia-smi's name, power limit, SM clock (now and its maximum) and
    power draw, sampled while ``fn`` keeps the card busy (~1 s)."""
    query = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,"
         "power.draw", "--format=csv,noheader"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    t0 = time.perf_counter()
    while query.poll() is None and time.perf_counter() - t0 < 30:
        time_ms(fn, 200)
    out = query.communicate(timeout=60)[0].strip().splitlines()
    return out[0] if out else "nvidia-smi gave nothing"


def _counters(r):
    """The counter names of a report entry (K6: all of K5's)."""
    c = r["counter"]
    return (c,) if isinstance(c, str) else c


def _reset_counts(report):
    for r in report:
        for c in _counters(r):
            setattr(r["wrapper"], c, 0)


def _read_counts(report, path):
    for r in report:
        r.setdefault("launches_by_path", {})[path] = sum(
            getattr(r["wrapper"], c) for c in _counters(r))
    missing = [r["name"] for r in report
               if path in r["paths"] and r["launches_by_path"][path] == 0]
    if missing:
        fail(f"the {path} path never launched: {missing}")


def _engine_run(make, requests, k, eager=False):
    """Serve ``requests`` ((prompt ids, submit kwargs)) on a fresh engine
    from ``make()``, ``k`` decode steps a dispatch; ``eager``: the engine's
    eager k-step body in place of its graph replay (the reference the
    graphs are held to).  Returns (tokens per request in submission order,
    wall s including each graph's capture, the engine)."""
    eng = make()
    if eager:
        eng._replay = eng._decode_many_impl
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ids, kw in requests:
        eng.submit(ids, **kw)
    fin = eng.run_to_completion(steps_per_dispatch=k)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if eng.nonfinite_logits:
        fail(f"{eng.nonfinite_logits} logit rows were not finite")
    return [t for _, t in sorted((f.rid, f.tokens) for f in fin)], wall, eng


def _mode_stats(engine, k, eager, layers, path, iters=20, tries=3):
    """k decode steps of every slot from the engine's last host state (the
    run's last lengths): ``iters`` dispatches on the host clock, each
    ended by the read of its tokens, then enough dispatches for 3 decode
    steps or more under torch.profiler (profile_train's summary).  Returns
    host ms per decode step (one token for every slot) and, per decode
    step, the device's kernel ms, launches and decode kernels, and the
    idle share, from the first trace that holds every decode kernel
    (``_check_decode_trace``; at most ``tries`` traces)."""
    def dispatch():
        if eager:
            engine._stage()
            return engine._decode_many_impl(k).cpu()
        return engine._launch(k).cpu()

    for _ in range(3):
        dispatch()
    t1 = time.perf_counter()
    for _ in range(iters):
        dispatch()
    host = (time.perf_counter() - t1) / (iters * k) * 1e3
    tag = f"{path} k={k}{' eager' if eager else ''}"
    traced = -(-3 // k)
    for attempt in range(1, tries + 1):
        out = {"host_ms_per_step": host, "traces": attempt,
               **_trace_decode(dispatch, traced, k)}
        if _check_decode_trace(tag, out, layers, traced * k,
                               last=attempt == tries):
            return out
        print(f"[{tag}] trace {attempt} of {tries} lost decode kernel "
              f"events ({out['decode_attn_kernels']} of "
              f"{layers * traced * k}); tracing again", flush=True)


def _trace_decode(dispatch, traced, k):
    """``traced`` dispatches of ``k`` decode steps under torch.profiler:
    per decode step the device's kernel ms, launches and idle share
    (profile_train's summary), the decode kernels traced in all, and per
    decode step each kernel named for indexing."""
    from youku_mplug_tpu_torch.cli import profile_train

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(traced):
            with torch.profiler.record_function(profile_train.STEP_SPAN):
                dispatch()
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "decode_trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
    summary = profile_train.summarize(events, traced, top=6)
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    decode = sum("decode_attn_kernel" in n for n in kernels)
    return {"kernel_ms_per_step": summary["kernel_ms_per_step"] / k,
            "launches_per_step": summary["launches_per_step"] / k,
            "idle_share": summary["idle_share"],
            "decode_attn_kernels": decode,
            "decode_attn_launches_per_step": decode / (traced * k),
            "index_kernels_per_step": {
                name[:80]: sum(n == name for n in kernels) / (traced * k)
                for name in sorted({n for n in kernels
                                    if "index" in n.lower()})}}


def _plain_gaps(make, requests, tokens):
    """The plain replay of each request's greedy tokens: prefill, then one
    chunk of them through ``decode_step(..., return_all=True)`` (plain
    attention, the path of a verify chunk).  Returns (per request the top-1
    minus top-2 logit at each generated position after the first, which
    every mode takes from the same prefill; the replay's max |logit|)."""
    eng = make()
    for ids, kw in requests:
        eng.submit(ids, **kw)
    eng._admit()
    width = max(max(len(t) for t in tokens) - 1, 1)
    chunk = torch.zeros((eng.num_slots, width), dtype=torch.long)
    for i, t in enumerate(tokens):
        chunk[i, :len(t) - 1] = torch.tensor(t[:-1], dtype=torch.long)
    eng._stage()
    cache_len, valid_from, pos_offset, _ = eng._inputs
    lm = eng.model
    with torch.inference_mode():
        logits, _ = lm.decode_step(lm.embed(chunk.cuda()), eng.cache,
                                   cache_len, valid_from, pos_offset,
                                   return_all=True)
        top2 = logits.topk(2, dim=-1).values
        gaps = (top2[..., 0] - top2[..., 1]).cpu()
        top = logits.abs().amax().item()
    return [gaps[i, :len(t) - 1].tolist() for i, t in enumerate(tokens)], \
        top


def _tie_check(tag, got, want, gaps, bound):
    """``got`` (tokens per request) equal to the greedy step's ``want`` up
    to each request's first position whose plain-replay top-2 gap is below
    ``bound``; prints those near-tie positions and every divergence."""
    compared, ties, diverged = 0, [], []
    for i, (g, w, gap) in enumerate(zip(got, want, gaps)):
        near = [j + 1 for j, x in enumerate(gap) if x < bound]
        stop = near[0] if near else len(w)
        first = next((j for j in range(max(len(g), len(w)))
                      if j >= len(g) or j >= len(w) or g[j] != w[j]), None)
        if near:
            ties.append((i, near[:4]))
        if first is not None:
            diverged.append((i, first, round(gap[first - 1], 4)
                             if 0 < first <= len(gap) else None))
            if first < stop:
                fail(f"{tag}: request {i} leaves the greedy tokens at "
                     f"position {first}, before its first near-tie "
                     f"({stop}; bound {bound:.4g}): {g[:first + 2]} vs "
                     f"{w[:first + 2]}")
        compared += min(stop, len(w))
    print(f"[{tag}] tokens equal to the greedy step's on {compared} "
          f"positions before the first near-tie of each request (top-2 gap "
          f"< {bound:.4g}); near-ties (request, positions) {ties}; "
          f"divergences (request, position, gap there) {diverged}",
          flush=True)
    return compared, diverged


def _check_decode_trace(path, trace, layers, steps, last):
    """The traced ``steps`` decode steps launched the decode kernel once
    per layer and no kernel named for indexing once per layer or more (an
    indexed cache write would be one).  The profiler can lose kernel
    events, never add them: chip runs read 89 of 90 decode kernels in an
    eager trace and 689 of 720 in a 24-step graph trace, where the launch
    counters (``_per_step``) held the exact count.  So a trace with fewer
    decode kernels returns False, to be taken again, and fails only when
    it is the ``last``; one with more, or with a per-layer index kernel,
    fails at once."""
    per_layer = {k: v for k, v in trace["index_kernels_per_step"].items()
                 if v >= layers}
    got, want = trace["decode_attn_kernels"], layers * steps
    if got > want or per_layer or (got < want and last):
        fail(f"{path}: the traced decode steps launched the decode kernel "
             f"{got} times over {steps} steps (want once per layer, "
             f"{want}); index kernels per step {per_layer}")
    return got == want


def _per_step(report, path, steps, want):
    """Launches per decode step of the run on ``path``: each kernel key of
    ``want`` exactly that many, every other decode kernel entry (the other
    K5 variants) none.  K6 counts the K5 launches, which carry its
    write."""
    got = {r["key"]: r["launches_by_path"][path] / max(steps, 1)
           for r in report if r["key"].startswith(("K5", "K6"))}
    if steps == 0 or any(got[k] != v for k, v in want.items()) or any(
            v for k, v in got.items() if k not in want):
        fail(f"{path}: launches per decode step {got} over {steps} steps, "
             f"expected {want} and no other decode kernel")
    return got


def phase_slice(report, out_dir, yaml=FLAGSHIP_YAML, path="serve",
                extra=()):
    """The serve CLI's path on ``yaml`` (``extra``: more CLI arguments):
    16 requests; the decode kernels' launches per decode step checked (24
    layers: K5, or K5 int8 with an int8 cache, each launch with its K6
    write)."""
    from youku_mplug_tpu_torch.cli import serve

    def args_for(n):
        return serve.serve_parser().parse_args([
            "--config", yaml, "--synthetic_data",
            "--num_requests", str(n), "--num_slots", "8", "--device", "cuda",
            "--output_dir", out_dir, *extra])

    args = args_for(16)
    t0 = time.perf_counter()
    cfg, model, device = serve.build(args)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    serve.run(args_for(2), cfg, model, device)  # warm-up (cuBLAS, caches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(report)
    stats, out, engine = serve.run(args, cfg, model, device)
    torch.cuda.synchronize()
    _read_counts(report, path)
    if stats["requests"] != 16 or any(not o["tokens"] for o in out):
        fail(f"slice served {stats['requests']} requests: {out}")
    if engine.nonfinite_logits:
        fail(f"{engine.nonfinite_logits} logit rows were not finite")
    layers = cfg.model.text.num_hidden_layers
    int8 = cfg.model.text.kv_cache_dtype == "int8"
    per_step = _per_step(report, path, engine.decode_steps,
                         {"K5-int8" if int8 else "K5": layers,
                          "K6": layers})
    from youku_mplug_tpu_torch.ops import kv_cache as kvc

    peak = torch.cuda.max_memory_allocated()
    n_tok = sum(o["n_tokens"] for o in out)
    print(f"[slice {path}] {json.dumps(stats)} | build (weights "
          f"included) {build_s:.2f} s | {n_tok} tokens | "
          f"{engine.decode_steps} decode steps in {engine.graph_replays} "
          f"graph replays, launches per step {per_step} | "
          f"cache {kvc.leaves(engine.cache)[0].dtype} "
          f"{kvc.nbytes(engine.cache) / 2**20:.1f} MiB | peak memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    return cfg, model, stats


def _forced_decode(lm, requests, max_len, bucket, gen_cfg, tokens=None):
    """Prefill the requests ((prompt ids, submit kwargs), one slot each)
    through the serving engine, then FORCED_STEPS decode steps.  Returns
    (logits per step, tokens fed): greedy from these logits, or
    ``tokens`` when given."""
    from youku_mplug_tpu_torch.serving.engine import ServingEngine

    eng = ServingEngine(lm, num_slots=len(requests), max_len=max_len,
                        prefill_buckets=(bucket,), config=gen_cfg)
    for ids, kw in requests:
        eng.submit(ids, **kw)
    eng._admit()
    fed = [torch.from_numpy(eng.last_token.copy()).long()]
    logits = []
    dev = eng.device
    with torch.inference_mode():
        for step in range(FORCED_STEPS):
            tok = fed[-1] if tokens is None else tokens[step]
            cl = torch.from_numpy(eng.cache_len + step).to(dev)
            emb = lm.embed(tok.to(dev)[:, None])
            lg, _ = lm.decode_step(emb, eng.cache, cl,
                                   torch.from_numpy(eng.valid_from).to(dev),
                                   torch.from_numpy(eng.pos_offset).to(dev))
            logits.append(lg)
            fed.append(lg.argmax(-1).cpu())
    return logits, fed[:FORCED_STEPS]


def _decode_kernel_counts():
    from youku_mplug_tpu_torch.ops import decode_attention as dec

    return [getattr(dec.write_decode_attention, c) for c in DEC_COUNTERS]


def phase_teacher_forced(cfg, model, tag="teacher-forced"):
    """The caption model's query features and FORCED_STEPS decode steps,
    with the kernels and again with the plain versions of K1, K4 and K5
    with K6 (bf16 or int8) patched in, fed the same inputs and tokens."""
    from youku_mplug_tpu_torch.data.datasets import SyntheticVideoDataset
    from youku_mplug_tpu_torch.models import gpt3, vision
    from youku_mplug_tpu_torch.ops import decode_attention as dec
    from youku_mplug_tpu_torch.ops import flash_attention as fa
    from youku_mplug_tpu_torch.ops.preprocess import normalize_clip

    from youku_mplug_tpu_torch.models.generation import GenerationConfig

    ds = SyntheticVideoDataset(8, cfg.num_frames, cfg.image_res)
    clips = torch.stack([torch.from_numpy(ds[i]["video"]) for i in range(8)])
    with torch.inference_mode():
        video = normalize_clip(clips.cuda(), dtype=torch.bfloat16)
        qe = model.encode_queries(video)
    # prompt [1] after the 128 query rows, bucket 8
    requests = [([1], {"query_embeds": qe[i]}) for i in range(8)]
    gen_cfg = GenerationConfig(max_new_tokens=64, eos_id=2, pad_id=2)
    forced = dict(lm=model.text_decoder, requests=requests,
                  max_len=128 + 8 + 33, bucket=8, gen_cfg=gen_cfg)
    logits, tokens = _forced_decode(**forced)
    counts = _decode_kernel_counts()
    plain = (mock.patch.object(vision, "flash_attention_packed",
                               fa.flash_attention_packed_plain),
             mock.patch.object(fa, "flash_attention",
                               fa.flash_attention_plain),
             mock.patch.object(gpt3, "write_decode_attention",
                               dec.write_decode_attention_plain))
    for p in plain:
        p.start()
    try:
        with torch.inference_mode():
            qe_plain = model.encode_queries(video)
        logits_plain, _ = _forced_decode(**forced, tokens=tokens)
    finally:
        for p in plain:
            p.stop()
    if counts != _decode_kernel_counts():
        fail(f"the {tag} plain replay launched a decode kernel")
    e_q = err(qe, qe_plain)
    e_l = max(err(a, b) for a, b in zip(logits, logits_plain))
    agree = sum(int((a.argmax(-1) == b.argmax(-1)).sum())
                for a, b in zip(logits, logits_plain))
    total = FORCED_STEPS * 8
    finite = all(torch.isfinite(x).all() for x in logits + logits_plain)
    print(f"[{tag}] query features max err {e_q:.4g} (tol "
          f"{QUERY_TOL}) | logits over {FORCED_STEPS} steps max err "
          f"{e_l:.4g} (tol {LOGIT_TOL}) | greedy agreement {agree}/{total}",
          flush=True)
    if not finite or e_q > QUERY_TOL or e_l > LOGIT_TOL:
        fail(f"{tag} check out of tolerance")


def phase_train(report, out_dir):
    """The pretrain CLI's path at full width; returns its runner."""
    from youku_mplug_tpu_torch.cli import common, run_pretrain

    args = run_pretrain.base_parser().parse_args([
        "--config", TRAIN_YAML, "--output_dir", out_dir, "--synthetic_data",
        "--max_steps", str(WARMUP_STEPS + TIMED_STEPS), "--device", "cuda"])
    t0 = time.perf_counter()
    runner = run_pretrain.setup(args)
    train_step = run_pretrain.build_train_step(runner)
    state = runner.state
    frozen0 = {k: p.detach().clone() for k, p in state.frozen.items()}
    trainable0 = {k: p.detach().clone() for k, p in state.trainable.items()}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(report)
    history = common.train_one_epoch(runner, train_step, 0,
                                     run_pretrain.make_batch)
    torch.cuda.synchronize()
    _read_counts(report, "train")
    peak = torch.cuda.max_memory_allocated()
    if len(history) != WARMUP_STEPS + TIMED_STEPS:
        fail(f"train slice ran {len(history)} steps")
    bad = [h for h in history if not (math.isfinite(h["loss"])
                                      and math.isfinite(h["grad_norm"]))
           or h["skipped_nonfinite"] != 0]
    if bad:
        fail(f"non-finite or skipped train steps: {bad}")
    moved = sum(not torch.equal(p.detach(), trainable0[k])
                for k, p in state.trainable.items())
    if moved == 0:
        fail("no trainable leaf moved")
    changed = [k for k, p in state.frozen.items()
               if not torch.equal(p.detach(), frozen0[k])]
    if changed or any(p.dtype != torch.bfloat16
                      for p in state.frozen.values()):
        fail(f"the frozen decoder changed: {changed[:5]}")
    timed = history[WARMUP_STEPS:]
    step_s = sum(h["step_time"] for h in timed) / len(timed)
    stats = {"steps": len(history), "setup_s": round(setup_s, 2),
             "step_ms": step_s * 1e3,
             "step_ms_each": [h["step_time"] * 1e3 for h in timed],
             "clips_per_s": runner.cfg.batch_size / step_s,
             "loss": [h["loss"] for h in history],
             "grad_norm": [h["grad_norm"] for h in history],
             "lr": [h["lr"] for h in history],
             "trainable_leaves_moved": f"{moved}/{len(state.trainable)}",
             "frozen_leaves_unchanged": len(frozen0),
             "peak_memory_gib": peak / 2 ** 30,
             "launches": {r["key"]: r["launches_by_path"]["train"]
                          for r in report}}
    print(f"[train] {json.dumps(stats)}", flush=True)
    return runner, stats


FLASH_COUNTERS = ("launches", "d80_launches", "d96_launches",
                  "alibi_launches")


def _flash_counts(fa, attrs=FLASH_COUNTERS, backward_only=False):
    fns = (fa.flash_bwd_dq_cuda, fa.flash_bwd_dkv_cuda)
    if not backward_only:
        fns += (fa.flash_attention_packed, fa.flash_attention)
    return [getattr(f, c) for f in fns for c in attrs]


def _replay(runner, make_batch, make_loss_fn, tag, plain_when=None,
            make_gen=None, on_kernels=None, backward_only=False):
    """Loss and trainable gradients of the first batch with the kernels,
    then with the wrappers taking their plain versions on the card for
    the calls ``plain_when(q)`` picks (all when None), or with
    ``backward_only`` the forward kernels in both runs and the plain
    backward (``flash_bwd_plain``) in place of the backward kernels; the
    batch and loss are built by the CLI functions the run used, and with
    ``make_gen`` each run's loss takes a fresh generator from it (the
    same dropout masks both times).  ``on_kernels``: a context manager
    around the kernels' run.  Fails if a call that should be plain
    launched a kernel.  Returns (loss with the kernels, loss plain,
    finite, whole gradient norm, per-leaf rows (gated error, relative
    L2, norm, leaf) worst first)."""
    import contextlib

    from youku_mplug_tpu_torch.ops import flash_attention as fa

    runner.loader.set_epoch(0)
    batch = make_batch(runner, next(iter(runner.loader)))
    loss_fn = make_loss_fn(runner.model)
    params = runner.state.trainable

    def loss_and_grads():
        for p in params.values():
            p.grad = None
        out = (loss_fn(batch) if make_gen is None
               else loss_fn(batch, make_gen()))
        out["loss"].backward()
        grads = {k: p.grad for k, p in params.items() if p.grad is not None}
        for p in params.values():
            p.grad = None
        return out["loss"].item(), grads

    with on_kernels or contextlib.nullcontext():
        loss_k, grads_k = loss_and_grads()
    # all plain: no counter moves; else no ALiBi counter (the plain
    # calls are Bloom's, head dim 128)
    attrs = FLASH_COUNTERS if plain_when is None else ("alibi_launches",)
    counts = _flash_counts(fa, attrs, backward_only)
    patch = (mock.patch.object(fa, "flash_bwd_cuda", fa.flash_bwd_plain)
             if backward_only else
             mock.patch.object(fa, "_on_cpu", plain_when or (lambda t: True)))
    with patch:
        loss_p, grads_p = loss_and_grads()
    if counts != _flash_counts(fa, attrs, backward_only):
        fail(f"the {tag} launched a kernel it should not")
    if set(grads_k) != set(grads_p):
        fail(f"gradient leaves differ: {set(grads_k) ^ set(grads_p)}")
    whole = torch.stack([g.float().norm() for g in grads_p.values()]
                        ).norm().item()
    rows = []
    for k in grads_k:
        diff = (grads_k[k].float() - grads_p[k].float()).norm().item()
        norm = grads_p[k].float().norm().item()
        bound = max(norm, REPLAY_GRAD_FLOOR * whole)
        rows.append((diff / bound, diff / max(norm, 1e-30), norm, k))
    rows.sort(reverse=True)
    finite = math.isfinite(loss_k) and all(
        torch.isfinite(g).all() for g in grads_k.values())
    rel = sorted(r[1] for r in rows)
    print(f"[{tag}] loss kernels {loss_k:.6f} plain {loss_p:.6f} (tol "
          f"{REPLAY_LOSS_TOL}) | {len(rows)} leaves, whole gradient norm "
          f"{whole:.4g}: relative L2 median {rel[len(rel) // 2]:.4g}"
          f", max {rel[-1]:.4g} | gated error max {rows[0][0]:.4g} (tol "
          f"{REPLAY_GRAD_TOL}, floor {REPLAY_GRAD_FLOOR} x whole) | worst: "
          + ", ".join(f"{k} gated {g:.3g} rel {r:.3g} norm {n:.3g}"
                      for g, r, n, k in rows[:4]), flush=True)
    return loss_k, loss_p, finite, whole, rows


def phase_replay(runner, make_batch, make_loss_fn):
    """The pretrain step: every wrapper plain; loss and every trainable
    leaf's gradient within the replay tolerances."""
    loss_k, loss_p, finite, _, rows = _replay(runner, make_batch,
                                              make_loss_fn, "replay")
    if not finite or abs(loss_k - loss_p) > REPLAY_LOSS_TOL \
            or rows[0][0] > REPLAY_GRAD_TOL:
        fail("plain replay out of tolerance")


def _state_diff(a, b):
    """Leaves, AdamW moments and counters of two train states that are not
    bitwise equal (dtype included), by JAX path."""
    bad = []
    for part in ("trainable", "frozen"):
        da, db = getattr(a, part), getattr(b, part)
        bad += [f"{part} set"] if set(da) != set(db) else [
            k for k in da if da[k].dtype != db[k].dtype
            or not torch.equal(da[k], db[k])]
    sa = a.optimizer.torch_optimizer.state
    sb = b.optimizer.torch_optimizer.state
    for k in set(a.trainable) & set(b.trainable):
        ma, mb = sa.get(a.trainable[k], {}), sb.get(b.trainable[k], {})
        if set(ma) != set(mb) or not ma or any(
                not torch.equal(ma[x], mb[x].to(ma[x].device)) for x in ma):
            bad.append(f"adam {k}")
    if (a.optimizer.count, a.step) != (b.optimizer.count, b.step):
        bad.append(f"count/step {(a.optimizer.count, a.step)} vs "
                   f"{(b.optimizer.count, b.step)}")
    return bad


def _rescore(model, video, ids, mask, seqs, eos):
    """The sum of log-probs of each sequence up to and including its
    first eos (all of it without one), teacher-forced: query features,
    prefill and one decode step per token (S = 1), with the plain versions
    of K1, K4 and K5 (with its write) patched in."""
    from youku_mplug_tpu_torch.models import generation, gpt3, vision
    from youku_mplug_tpu_torch.ops import decode_attention as dec
    from youku_mplug_tpu_torch.ops import flash_attention as fa

    lm = model.text_decoder
    plain = (mock.patch.object(vision, "flash_attention_packed",
                               fa.flash_attention_packed_plain),
             mock.patch.object(fa, "flash_attention",
                               fa.flash_attention_plain),
             mock.patch.object(gpt3, "write_decode_attention",
                               dec.write_decode_attention_plain))
    for p in plain:
        p.start()
    try:
        with torch.inference_mode():
            qf = model.encode_queries(video)
            plen = mask.sum(-1).to(torch.int32) - 1
            embeds, vf, off = generation._build_prefix(lm, ids, plen, qf,
                                                       eos)
            prefix = embeds.shape[1]
            cache = lm.init_cache(ids.shape[0], prefix + seqs.shape[1],
                                  device=ids.device)
            logits, cache = lm.decode_step(embeds, cache, 0, vf, off)
            total = torch.zeros(ids.shape[0], device=ids.device)
            live = torch.ones(ids.shape[0], dtype=torch.bool,
                              device=ids.device)
            for t in range(seqs.shape[1]):
                tok = seqs[:, t].long()
                logp = torch.log_softmax(logits.float(), -1)
                total += torch.where(live, logp.gather(1, tok[:, None])[:, 0],
                                     0.0)
                live &= tok != eos
                if t + 1 == seqs.shape[1] or not bool(live.any()):
                    break
                logits, cache = lm.decode_step(lm.embed(tok[:, None]), cache,
                                               prefix + t, vf, off)
    finally:
        for p in plain:
            p.stop()
    return total


def _launched_in(events, windows):
    """The kernel events of a chrome trace whose launches (host runtime or
    driver calls, the latter cuBLAS's, matched by correlation id) fall in
    any of the host time ``windows``."""
    corr = {e["args"]["correlation"] for e in events
            if e.get("cat") in ("cuda_runtime", "cuda_driver")
            and "correlation" in e.get("args", {})
            and any(a <= e["ts"] < b for a, b in windows)}
    return [e for e in events if e.get("cat") == "kernel"
            and e.get("args", {}).get("correlation") in corr]


def _beam_trace(events):
    """From the trace of one beam search with each reorder in a
    ``gather_beams`` host span: the reorders' device ms, their number,
    and, over the decode steps between the first and the last reorder,
    the device ms a step by kernel category, launches a step and the
    device's idle share of those steps' wall time."""
    from youku_mplug_tpu_torch.cli import profile_train

    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"
                   and e.get("name") == "gather_beams")
    gather_ms = sum(e["dur"] for e in _launched_in(events, spans)) * 1e-3
    steps = len(spans) - 1
    window = (spans[0][1], spans[-1][1])
    kernels = _launched_in(events, [window])
    if steps < 1 or not kernels:
        fail(f"the traced beam search: {len(spans)} reorders, "
             f"{len(kernels)} kernels between them")
    by_cat = {}
    for e in kernels:
        cat = profile_train.category(e)
        by_cat[cat] = by_cat.get(cat, 0.0) + e["dur"] * 1e-3 / steps
    t0 = min(e["ts"] for e in kernels)
    t1 = max(e["ts"] + e["dur"] for e in kernels)
    busy = profile_train._busy_us([(e["ts"], e["ts"] + e["dur"])
                                   for e in kernels])
    return gather_ms, len(spans), {
        "device_ms_per_step": sum(by_cat.values()),
        "device_ms_per_step_by_category": dict(
            sorted(by_cat.items(), key=lambda kv: -kv[1])),
        "launches_per_step": len(kernels) / steps,
        "idle_share": 1.0 - busy / (t1 - t0)}


def phase_caption(report, holder, out_dir):
    """Phase 12, the caption slice: the pretrain runner's state (popped
    from ``holder``, so that it is freed here) saved by ``save_epoch``;
    ``run_caption`` on CAPTION_YAML resuming from it (the restored state
    bitwise equal to the saved one); 2 finetune steps, whose state is
    saved under ``<out_dir>/caption`` (phase 16 serves it); the
    beam-search evaluation of 2 test batches (48 clips); each returned
    sequence rescored with the plain versions.  Returns the caption run's
    directory."""
    from youku_mplug_tpu_torch.cli import common, run_caption
    from youku_mplug_tpu_torch.train.checkpoint import STATE_FILE

    t_phase = time.perf_counter()
    pretrain = holder.pop()
    t0 = time.perf_counter()
    common.save_epoch(pretrain, 0)
    torch.cuda.synchronize()
    save_s = time.perf_counter() - t0
    step = pretrain.ckpt.latest_step()
    if step != pretrain.state.step:
        fail(f"save_epoch wrote step {step}, the state is at "
             f"{pretrain.state.step}")
    ckpt_bytes = os.path.getsize(os.path.join(pretrain.ckpt.directory,
                                              str(step), STATE_FILE))
    print(f"[caption] saved step {step}: {ckpt_bytes} bytes in "
          f"{save_s:.2f} s ({ckpt_bytes / save_s / 2**30:.2f} GiB/s)",
          flush=True)

    cap_dir = os.path.join(out_dir, "caption")
    args = run_caption.parser().parse_args([
        "--config", CAPTION_YAML, "--resume", pretrain.args.output_dir,
        "--synthetic_data", "--max_steps", str(CAPTION_STEPS), "--device",
        "cuda", "--output_dir", cap_dir])
    t0 = time.perf_counter()
    runner, test_loader = run_caption.prepare(args)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    diff = _state_diff(pretrain.state, runner.state)
    if diff:
        fail(f"the resumed state differs from the saved one: {diff[:8]}")
    print(f"[caption] resumed step {runner.state.step} (epoch "
          f"{runner.start_epoch}) in {resume_s:.2f} s, setup and load "
          f"included: {len(runner.state.trainable)} trainable and "
          f"{len(runner.state.frozen)} frozen leaves, AdamW moments, count "
          f"{runner.state.optimizer.count} and step bitwise equal",
          flush=True)
    del pretrain, diff
    gc.collect()
    torch.cuda.empty_cache()
    train = _caption_finetune(report, runner, "caption_train")
    print(f"[caption finetune] {json.dumps(train)}", flush=True)
    # the finetuned state, for phase 16 (serve --resume from this run)
    common.save_epoch(runner, runner.start_epoch)
    out = _caption_eval(report, runner, test_loader, "caption_eval", "K5",
                        CAPTION_EVAL_BATCHES)
    print(f"[caption eval] {json.dumps(out)}", flush=True)
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[caption] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return cap_dir


def _caption_finetune(report, runner, path):
    """The runner's finetune (``--max_steps`` steps) on ``path``: finite,
    no skipped step, the frozen bf16 decoder bitwise unchanged, trainable
    leaves moved; step ms, clips/s, peak memory and launches."""
    from youku_mplug_tpu_torch.cli import common, run_caption

    state = runner.state
    frozen0 = {k: p.detach().clone() for k, p in state.frozen.items()}
    trainable0 = {k: p.detach().clone() for k, p in state.trainable.items()}
    train_step = run_caption.build_train_step(runner)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(report)
    history = common.train_one_epoch(runner, train_step, runner.start_epoch,
                                     run_caption.make_batch)
    torch.cuda.synchronize()
    _read_counts(report, path)
    train_peak = torch.cuda.max_memory_allocated()
    if len(history) != runner.args.max_steps or any(
            not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]))
            or h["skipped_nonfinite"] != 0 for h in history):
        fail(f"{path} steps: {history}")
    changed = [k for k, p in state.frozen.items()
               if not torch.equal(p.detach(), frozen0[k])]
    if changed or any(p.dtype != torch.bfloat16
                      for p in state.frozen.values()):
        fail(f"{path}: the frozen decoder changed: {changed[:5]}")
    moved = sum(not torch.equal(p.detach(), trainable0[k])
                for k, p in state.trainable.items())
    if moved == 0:
        fail(f"{path}: no trainable leaf moved")
    del frozen0, trainable0
    gc.collect()
    torch.cuda.empty_cache()
    batch = runner.cfg.batch_size
    return {"steps": len(history),
            "step_ms_each": [h["step_time"] * 1e3 for h in history],
            "clips_per_s_last": batch / history[-1]["step_time"],
            "loss": [h["loss"] for h in history],
            "grad_norm": [h["grad_norm"] for h in history],
            "lr": [h["lr"] for h in history],
            "trainable_leaves_moved": f"{moved}/{len(state.trainable)}",
            "peak_memory_gib": train_peak / 2 ** 30,
            "launches": {r["key"]: r["launches_by_path"][path]
                         for r in report if r["launches_by_path"][path]}}


def _caption_eval(report, runner, test_loader, path, k5_key, batches):
    """The runner's beam-search evaluation of ``batches`` test batches on
    ``path``: ``k5_key`` (with its K6 write) launched once per decoder
    layer per decode step and no other decode kernel; one result per
    clip, finite metrics; host ms per decode step; the first batch traced
    (the beam reorder's and a decode step's device ms); every returned
    sequence's beam score against its teacher-forced rescore with the
    plain versions of K1, K4 and K5 within RESCORE_TOL_PER_TOKEN a
    token."""
    from youku_mplug_tpu_torch.cli import run_caption
    from youku_mplug_tpu_torch.models import generation

    # each decode step's host time read at its beam reorder (the step's
    # last call; None marks a batch's start)
    stamps = []
    gather = generation._gather_beams
    captions = run_caption.generate_captions

    def stamped(*a, **kw):
        out = gather(*a, **kw)
        stamps.append(time.perf_counter())
        return out

    def marked(*a, **kw):
        stamps.append(None)
        return captions(*a, **kw)

    torch.cuda.reset_peak_memory_stats()
    _reset_counts(report)
    with mock.patch.object(generation, "_gather_beams", stamped), \
            mock.patch.object(run_caption, "generate_captions", marked):
        metrics, results, stats = run_caption.evaluation(runner, test_loader)
    torch.cuda.synchronize()
    _read_counts(report, path)
    eval_peak = torch.cuda.max_memory_allocated()
    layers = runner.cfg.model.text.num_hidden_layers
    per_step = _per_step(report, path, stats["decode_steps"],
                         {k5_key: layers, "K6": layers})
    clips = batches * runner.cfg.batch_size
    if stats["clips"] != clips or len(results) != clips or not all(
            math.isfinite(v) for v in metrics.values()):
        fail(f"{path}: {stats}, {len(results)} results, metrics {metrics}")
    host = sorted(b - a for a, b in zip(stamps, stamps[1:])
                  if a is not None and b is not None)

    # the reorder's device time, traced over the first test batch
    gen_cfg = run_caption.generation_config(runner)
    raws = [raw for _, raw in zip(range(batches), test_loader)]

    def spanned(*a, **kw):
        with torch.profiler.record_function("gather_beams"):
            return gather(*a, **kw)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    runner.model.eval()
    video, ids, mask = run_caption.eval_inputs(runner, raws[0])
    with mock.patch.object(generation, "_gather_beams", spanned), \
            torch.profiler.profile(activities=acts) as prof:
        traced = run_caption.generate_captions(runner.model, video, ids,
                                               mask, gen_cfg)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "beam_trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
    gather_ms, n_gathers, step_trace = _beam_trace(events)
    if n_gathers != traced["decode_steps"]:
        fail(f"{path}: traced {n_gathers} beam reorders over "
             f"{traced['decode_steps']} decode steps")

    # every returned sequence rescored with the plain versions
    by_id = {r["video_id"]: r for r in results}
    rows = []
    for raw in raws:
        video, ids, mask = run_caption.eval_inputs(runner, raw)
        recs = [by_id[v] for v in raw["video_id"]]
        seqs = torch.tensor([r["tokens"] for r in recs], device=ids.device)
        want = _rescore(runner.model, video, ids, mask, seqs,
                        gen_cfg.eos_id).tolist()
        for r, w in zip(recs, want):
            n_tok = next((i + 1 for i, t in enumerate(r["tokens"])
                          if t == gen_cfg.eos_id), len(r["tokens"]))
            e = abs(r["score"] - w)
            rows.append((e / n_tok, e, n_tok, r["video_id"], r["score"], w))
    rows.sort(reverse=True)
    tail = _tail_bytes(runner, gen_cfg)
    if not all(math.isfinite(r[4]) and math.isfinite(r[5]) for r in rows) \
            or rows[0][0] > RESCORE_TOL_PER_TOKEN:
        fail(f"{path}: beam scores against the plain rescore: worst "
             f"{rows[:3]} (tol {RESCORE_TOL_PER_TOKEN} a token)")
    runner.model.train()
    print(f"[{path}] worst rescores (err a token, err, tokens, clip, beam "
          f"score, plain score): {rows[:3]}", flush=True)
    return {"clips": stats["clips"], "batches": stats["batches"],
            "beam_size": gen_cfg.beam_size,
            "max_new_tokens": gen_cfg.max_new_tokens,
            "decode_steps": stats["decode_steps"],
            "tokens": stats["tokens"],
            "beam_tokens_per_s": stats["tokens"] / stats["generate_s"],
            "generate_s": stats["generate_s"],
            "host_ms_per_decode_step_median": 1e3 * host[len(host) // 2],
            "host_ms_per_decode_step_max": 1e3 * host[-1],
            "gather_device_ms_per_step": gather_ms / n_gathers,
            "gather_tail_bytes": tail,
            "gather_bound_ms": 2 * tail / PEAK_HBM_BYTES * 1e3,
            "traced_decode_step": step_trace,
            "launches_per_decode_step": per_step,
            "launches": {r["key"]: r["launches_by_path"][path]
                         for r in report if r["launches_by_path"][path]},
            "peak_memory_gib": eval_peak / 2 ** 30,
            "metrics": metrics,
            "rescore_max_abs_err": rows[0][1],
            "rescore_max_err_per_token": rows[0][0],
            "rescore_tol_per_token": RESCORE_TOL_PER_TOKEN}


def _tail_bytes(runner, gen_cfg):
    """Bytes of the cache rows one beam reorder gathers: every layer's
    B*K rows past the prefix (128 queries and the PROMPT_LENGTH-token
    prompt), bf16; the least it can move is reading them once and
    writing them once."""
    from youku_mplug_tpu_torch.cli import run_caption

    text = runner.cfg.model.text
    prefix = runner.cfg.model.num_learnable_token + run_caption.PROMPT_LENGTH
    m = -(-(prefix + gen_cfg.max_new_tokens) // 128) * 128
    return (text.num_hidden_layers * runner.cfg.batch_size
            * gen_cfg.beam_size * (m - prefix) * 2 * text.hidden_size * 2)


def phase_instruct_replay(runner):
    """The instruct-train step, twice.  First every wrapper plain: the
    loss within REPLAY_LOSS_TOL.  The gradients of that replay are
    printed but not gated leaf by leaf: the frozen ViT's forward alone,
    taken plain, moves the abstractor's gradients by ~5% (its features
    differ by bf16 roundings, ~2% of their scale, which the instruct
    teacher-forced check bounds), whatever the Bloom kernels do.  Then
    the gated replay: Bloom's attention (head dim 128: K1, dq and dk/dv
    with ALiBi) plain, the ViT on its kernel in both runs, so both see
    the same features; loss and every trainable leaf's gradient within
    the replay tolerances."""
    from youku_mplug_tpu_torch.cli import run_instruct

    fns = (run_instruct.make_instruct_batch, run_instruct.make_loss_fn)
    loss_k, loss_p, finite, _, _ = _replay(
        runner, *fns, "instruct-train replay, every wrapper plain")
    if not finite or abs(loss_k - loss_p) > REPLAY_LOSS_TOL:
        fail("instruct-train plain replay out of tolerance")
    loss_k, loss_p, finite, _, rows = _replay(
        runner, *fns, "instruct-train replay, Bloom attention plain",
        plain_when=lambda t: t.shape[-1] == 128)
    if not finite or abs(loss_k - loss_p) > REPLAY_LOSS_TOL \
            or rows[0][0] > REPLAY_GRAD_TOL:
        fail("instruct-train replay of Bloom's attention out of tolerance")


OWL_QUESTIONS = ("What is in the video?", "What happens next?",
                 "Describe the scene in detail.", "Who is speaking?",
                 "Is it day or night?", "What colour is the car?",
                 "How many people are there?", "Where was this filmed?")


def phase_instruct(report, out_dir, yaml=OWL_YAML, path="instruct",
                   int8=False, extra=()):
    """The run_instruct CLI's serving path on ``yaml`` at full width and
    depth (``int8``: with --int8, the decoder's kernels and tied embedding
    quantized after the seeded init; ``extra``: more CLI arguments); the
    decode kernels' launches per decode step checked (30 layers: K5
    ALiBi, or K5 int8 ALiBi with an int8 cache, each launch with its K6
    write), and K1 launched once per ViT block (one encode of every
    request) and no other flash kernel.  Returns (model, instruct batch,
    clips, generation config)."""
    from youku_mplug_tpu_torch.cli import run_instruct
    from youku_mplug_tpu_torch.ops import kv_cache as kvc

    jsonl = os.path.join(out_dir, "requests.jsonl")
    with open(jsonl, "w") as f:
        for i in range(OWL_REQUESTS):
            f.write(json.dumps({
                "video": f"clip{i}.mp4",
                "question": OWL_QUESTIONS[i % len(OWL_QUESTIONS)]
                + " " * (i // len(OWL_QUESTIONS))}) + "\n")
    args = run_instruct.parser().parse_args([
        "--config", yaml, "--synthetic_data", "--engine",
        "--input_jsonl", jsonl, "--num_slots", str(OWL_SLOTS),
        "--device", "cuda", "--output_dir", out_dir, *extra]
        + (["--int8"] if int8 else []))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, raw, model, device = run_instruct.build(args)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in model.parameters())
    _, batch, clips = run_instruct.prepare(args, cfg, raw, device,
                                           model.policy.compute_dtype)
    gen_cfg = run_instruct.generation_config(args, cfg, raw)
    # warm-up (cuBLAS handles, the allocator): two requests, 4 tokens
    run_instruct.serve_instruct(
        model, clips[:2], {k: v[:2] for k, v in batch.items()},
        dataclasses.replace(gen_cfg, max_new_tokens=4), num_slots=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(report)
    seqs, stats, engine = run_instruct.serve_instruct(
        model, clips, batch, gen_cfg, num_slots=args.num_slots)
    torch.cuda.synchronize()
    _read_counts(report, path)
    layers = cfg.text.num_hidden_layers
    per_step = _per_step(report, path, engine.decode_steps,
                         {"K5-int8-ALiBi" if kvc.is_quantized(engine.cache)
                          else "K5-ALiBi": layers, "K6": layers})
    flash = {r["key"]: r["launches_by_path"][path] for r in report
             if not r["key"].startswith(("K5", "K6"))}
    if any(n != (cfg.vision.depth if k == "K1" else 0)
           for k, n in flash.items()):
        fail(f"{path}: flash launches {flash}, expected K1 {cfg.vision.depth}"
             " and no other")
    if stats["requests"] != OWL_REQUESTS \
            or not (seqs != gen_cfg.pad_id).any(1).all():
        fail(f"instruct slice served {stats['requests']} requests: "
             f"{seqs.tolist()}")
    if engine.nonfinite_logits:
        fail(f"{engine.nonfinite_logits} instruct logit rows were not "
             "finite")

    # the tied logits alone
    lm = model.text_decoder
    hidden = torch.randn(OWL_SLOTS, cfg.text.hidden_size, device=device,
                         dtype=torch.bfloat16)
    with torch.inference_mode():
        logits_ms = time_ms(lambda: lm.logits(hidden), 50)
    stats.update({
        "build_s": build_s, "build_peak_memory_gib": build_peak / 2 ** 30,
        "params": n_params,
        "int8_params": sum(p.numel() for p in model.parameters()
                           if p.dtype == torch.int8),
        "prompt_len": [int(x) for x in batch["prompt_len"][:2]],
        "decode_steps": engine.decode_steps,
        "graph_replays": engine.graph_replays,
        "launches_per_step": per_step, "tied_logits_ms": logits_ms,
        "launches": {r["key"]: r["launches_by_path"][path]
                     for r in report}})
    print(f"[{path}] {json.dumps(stats)} | first answer "
          f"{seqs[0][:8].tolist()}", flush=True)
    return model, batch, clips, gen_cfg


def phase_instruct_forced(model, batch, clips,
                          tag="instruct teacher-forced", reference=None):
    """The first OWL_SLOTS clips' media features, and FORCED_STEPS decode
    steps from their spliced prompts, with the kernels and again with the
    plain versions of K1 (the ViT) and K5 with its K6 write (bf16 or
    int8, the Bloom decode step) patched in, fed the same inputs and
    tokens.  With
    ``reference`` (another model's (logits, tokens) of this phase), also a
    readout, not a gate: this model's logits fed the reference's tokens
    against the reference's.  Returns (logits, tokens) with the
    kernels."""
    from youku_mplug_tpu_torch.models import bloom, vision
    from youku_mplug_tpu_torch.models.generation import GenerationConfig
    from youku_mplug_tpu_torch.ops import decode_attention as dec
    from youku_mplug_tpu_torch.ops import flash_attention as fa

    n = OWL_SLOTS
    dev = clips.device
    text = model.cfg.text
    ids = torch.as_tensor(batch["input_ids"][:n], device=dev).long()
    mask = torch.as_tensor(batch["media_mask"][:n], device=dev)
    plen = [int(x) for x in batch["prompt_len"][:n]]
    with torch.inference_mode():
        media = model.encode_video(clips[:n])
        embeds = model.spliced_embeds(ids, mask, media)
    bucket = 8
    while bucket < max(plen):
        bucket *= 2
    requests = [(batch["input_ids"][i, :plen[i]].tolist(),
                 {"prompt_embeds": embeds[i, :plen[i]]}) for i in range(n)]
    forced = dict(lm=model.text_decoder, requests=requests,
                  max_len=bucket + FORCED_STEPS + 2, bucket=bucket,
                  gen_cfg=GenerationConfig(max_new_tokens=64,
                                           eos_id=text.eos_id,
                                           pad_id=text.pad_id))
    logits, tokens = _forced_decode(**forced)
    counts = [fa.flash_attention_packed.launches] + _decode_kernel_counts()
    plain = (mock.patch.object(vision, "flash_attention_packed",
                               fa.flash_attention_packed_plain),
             mock.patch.object(bloom, "write_decode_attention",
                               dec.write_decode_attention_plain))
    for p in plain:
        p.start()
    try:
        with torch.inference_mode():
            media_plain = model.encode_video(clips[:n])
        logits_plain, _ = _forced_decode(**forced, tokens=tokens)
    finally:
        for p in plain:
            p.stop()
    if counts != [fa.flash_attention_packed.launches] \
            + _decode_kernel_counts():
        fail(f"the {tag} plain replay launched a kernel")
    e_m = err(media, media_plain)
    e_l = max(err(a, b) for a, b in zip(logits, logits_plain))
    top_m = media_plain.float().abs().max().item()
    top_l = max(x.abs().max().item() for x in logits_plain)
    agree = sum(int((a.argmax(-1) == b.argmax(-1)).sum())
                for a, b in zip(logits, logits_plain))
    finite = all(torch.isfinite(x).all() for x in logits + logits_plain)
    print(f"[{tag}] media features max err {e_m:.4g} of "
          f"max |plain| {top_m:.4g} | logits over {FORCED_STEPS} steps max "
          f"err {e_l:.4g} of max |plain| {top_l:.4g} (tol {OWL_REL_TOL:.4g} "
          f"x max |plain|) | greedy agreement {agree}/{FORCED_STEPS * n}",
          flush=True)
    if not finite or e_m > OWL_REL_TOL * top_m or e_l > OWL_REL_TOL * top_l:
        fail(f"{tag} check out of tolerance")
    if reference is not None:
        ref_logits, ref_tokens = reference
        fed, _ = _forced_decode(**forced, tokens=ref_tokens)
        e_r = max(err(a, b) for a, b in zip(fed, ref_logits))
        top_r = max(x.abs().max().item() for x in ref_logits)
        agree_r = sum(int((a.argmax(-1) == b.argmax(-1)).sum())
                      for a, b in zip(fed, ref_logits))
        rel = [((a.float() - b.float()).norm() / b.float().norm()).item()
               for a, b in zip(fed, ref_logits)]
        print(f"[{tag}] readout (not a gate) against the bf16 model of the "
              f"same seed, fed its tokens: logits max err {e_r:.4g} of max "
              f"|bf16| {top_r:.4g}, relative L2 per step "
              f"{[round(r, 5) for r in rel]} | greedy agreement "
              f"{agree_r}/{FORCED_STEPS * n}", flush=True)
    return logits, tokens


def phase_dispatch(report, tag, path, make, requests, layers, want_key):
    """The engine's decode modes on ``requests``: the eager step (each
    step's kernels launched from Python), the k = 1 graph and the k =
    DISPATCH_K graph, each on a fresh engine from ``make()``.  Gates: every
    request's tokens equal in the three runs, and the k = DISPATCH_K run's
    replay-aware counters give ``layers`` launches of ``want_key`` (with
    its K6 write) per decode step.  Prints for each mode tokens/s, peak
    memory, the graphs' pool, and (``_mode_stats``, at the run's last
    lengths) host ms, device kernel ms, launches and idle share per decode
    step.  Returns the greedy tokens per request."""
    runs, modes = {}, (("k1_eager", 1, True), ("k1_graph", 1, False),
                       (f"k{DISPATCH_K}_graph", DISPATCH_K, False))
    for mode, k, eager in modes:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if k > 1:
            _reset_counts(report)
        tokens, wall, eng = _engine_run(make, requests, k, eager)
        if k > 1:
            _read_counts(report, path)
            per_step = _per_step(report, path, eng.decode_steps,
                                 {want_key: layers, "K6": layers})
        n_tok = sum(len(t) for t in tokens)
        runs[mode] = {"tokens": tokens, "stats": {
            "tokens_per_s": n_tok / wall, "wall_s": wall, "tokens": n_tok,
            "decode_steps": eng.decode_steps,
            "graph_replays": eng.graph_replays,
            "capture_s": eng.capture_s,
            "graph_pool_mib": eng.graph_pool_bytes / 2 ** 20,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}}
        if k == 1:
            del eng
    want = runs["k1_eager"]["tokens"]
    for mode, run in runs.items():
        bad = [i for i, t in enumerate(run["tokens"]) if t != want[i]]
        if bad:
            fail(f"{tag}: {mode} tokens differ from the eager step's for "
                 f"requests {bad}: {run['tokens'][bad[0]][:12]} vs "
                 f"{want[bad[0]][:12]}")
    for mode, k, eager in modes:  # on the last run's engine
        runs[mode]["stats"].update(_mode_stats(eng, k, eager, layers, path))
    print(f"[{tag}] {len(requests)} requests, tokens equal in every mode; "
          f"k={DISPATCH_K} launches per decode step {per_step}; graph pool "
          f"after the measurements {eng.graph_pool_bytes / 2 ** 20:.1f} MiB "
          f"| {json.dumps({m: r['stats'] for m, r in runs.items()})}",
          flush=True)
    return want


def _caption_requests(cfg, model, n=16):
    """The first ``n`` synthetic clips of the serve path encoded to query
    prefixes: (prompt ids, submit kwargs) each."""
    from youku_mplug_tpu_torch.cli import serve
    from youku_mplug_tpu_torch.ops.preprocess import normalize_clip

    prompt_vec, _, gen_cfg = serve._prompt(cfg)
    requests = []
    for clips, _ in serve._clip_batches(cfg, cfg.num_frames, cfg.image_res):
        with torch.inference_mode():
            qe = model.encode_queries(normalize_clip(
                torch.from_numpy(clips).cuda(), dtype=torch.bfloat16))
        requests += [(prompt_vec, {"query_embeds": q,
                                   "max_new_tokens": gen_cfg.max_new_tokens})
                     for q in qe]
        if len(requests) >= n:
            return requests[:n]
    fail(f"the synthetic clips hold fewer than {n} requests")


def _serve_args(yaml, slots, *extra):
    from youku_mplug_tpu_torch.cli import serve

    return serve.serve_parser().parse_args([
        "--config", yaml, "--synthetic_data", "--num_requests", "16",
        "--num_slots", str(slots), "--device", "cuda", *extra])


def phase_caption_modes(report, cfg, model, yaml, path):
    """``phase_dispatch`` on the serve path's engine and its 16 requests
    (24 layers: K5, or K5 int8 on an int8 cache)."""
    from youku_mplug_tpu_torch.cli import serve

    args = _serve_args(yaml, 8)
    int8 = cfg.model.text.kv_cache_dtype == "int8"
    requests = _caption_requests(cfg, model)
    greedy = phase_dispatch(
        report, f"dispatch {path}", f"{path}_k{DISPATCH_K}",
        lambda: serve.make_engine(args, cfg, model.text_decoder)[0],
        requests, cfg.model.text.num_hidden_layers,
        "K5-int8" if int8 else "K5")
    return requests, greedy


def phase_speculative(report, cfg, model, requests, greedy):
    """The serve CLI's --speculative path on the caption flagship: a twin
    draft (k 4, the decoder's first 6 layers) and prompt lookup (k 8),
    over the same 16 clips as the greedy engine runs; tokens held to the
    greedy step's up to each request's first near-tie (CAPTION_TIE_GAP)
    in the plain replay of those tokens; tokens per round and the draft
    steps' decode-kernel launches printed."""
    from youku_mplug_tpu_torch.cli import serve
    from youku_mplug_tpu_torch.ops import decode_attention as dec

    args16 = _serve_args(FLAGSHIP_YAML, 16)
    gaps, _ = _plain_gaps(
        lambda: serve.make_engine(args16, cfg, model.text_decoder)[0],
        requests, greedy)
    for k, draft, path in ((4, "twin", "speculative_twin"),
                           (8, "ngram", "speculative_ngram")):
        args = _serve_args(FLAGSHIP_YAML, 8, "--speculative", str(k),
                           "--draft", draft)
        _reset_counts(report)
        torch.cuda.synchronize()
        stats, out = serve.run_speculative(args, cfg, model,
                                           torch.device("cuda"))
        torch.cuda.synchronize()
        _read_counts(report, path)
        if stats["requests"] != 16:
            fail(f"{path} served {stats['requests']} requests")
        _tie_check(path, [r["tokens"] for r in out], greedy, gaps,
                   CAPTION_TIE_GAP)
        print(f"[{path}] {json.dumps(stats)} | decode kernel launches (the "
              f"draft's one-token prefill and proposal steps) "
              f"{dec.write_decode_attention.launches}", flush=True)


def _instruct_requests(model, batch, clips):
    """Every request's prompt ids and spliced prompt embeddings."""
    ids = torch.as_tensor(batch["input_ids"], device="cuda").long()
    mask = torch.as_tensor(batch["media_mask"], device="cuda")
    with torch.inference_mode():
        embeds = model.spliced_embeds(ids, mask, model.encode_video(clips))
    return [(batch["input_ids"][i, :n].tolist(),
             {"prompt_embeds": embeds[i, :n]})
            for i, n in enumerate(int(x) for x in batch["prompt_len"])]


def phase_instruct_modes(report, model, batch, clips, gen_cfg, path,
                         want_key):
    """``phase_dispatch`` on the instruct engine (``serve_instruct``'s)
    and its 16 requests (30 layers: K5 ALiBi, or K5 int8 ALiBi)."""
    from youku_mplug_tpu_torch.cli import run_instruct

    requests = _instruct_requests(model, batch, clips)
    greedy = phase_dispatch(
        report, f"dispatch {path}", f"{path}_k{DISPATCH_K}",
        lambda: run_instruct.make_engine(model.text_decoder,
                                         batch["prompt_len"], gen_cfg,
                                         OWL_SLOTS),
        requests, model.cfg.text.num_hidden_layers, want_key)
    return requests, greedy


def phase_lookup(report, model, batch, clips, gen_cfg, requests, greedy):
    """run_instruct's serving with --lookup_k 4 on the bf16 instruct
    model: tokens held to the greedy step's up to each request's first
    near-tie (OWL_TIE_REL x the plain replay's max |logit|)."""
    from youku_mplug_tpu_torch.cli import run_instruct

    gaps, top = _plain_gaps(
        lambda: run_instruct.make_engine(model.text_decoder,
                                         batch["prompt_len"], gen_cfg,
                                         len(requests)),
        requests, greedy)
    _reset_counts(report)
    seqs, stats, eng = run_instruct.serve_instruct(
        model, clips, batch, gen_cfg, num_slots=OWL_SLOTS, lookup_k=4)
    torch.cuda.synchronize()
    _read_counts(report, "instruct_lookup")
    if stats["nonfinite_logits"]:
        fail(f"instruct lookup: {stats['nonfinite_logits']} logit rows "
             "were not finite")
    got = [row[:len(w)].tolist() if (row[len(w):] == gen_cfg.pad_id).all()
           else row.tolist() for row, w in zip(seqs, greedy)]
    _tie_check("instruct_lookup", got, greedy, gaps, OWL_TIE_REL * top)
    print(f"[instruct_lookup] {json.dumps(stats)} | tokens per dispatch "
          f"{stats['new_tokens'] / max(stats['engine_steps'], 1):.3f}",
          flush=True)


def phase_sampling(report, model, batch, clips):
    """Sampling on the instruct model with the decoding block of
    SAMPLE_YAML (top_k 5, top_p 0.9): the engine's ``_pick`` captured in a
    CUDA graph with the engine's generator registered, SAMPLE_REPLAYS
    replays on fixed [8, V] logits (no draw outside the filtered support,
    each row's frequencies against the filtered softmax by a chi-square
    test, p > 1e-3, two replays in a row differing); then run_instruct's
    serving on 8 requests with the CLI's generator (seed + 1) twice and
    with another seed: finite logits, the same tokens for the same seed,
    others for another, and 30 K5-ALiBi launches per decode step."""
    from scipy import stats as sstats

    from youku_mplug_tpu_torch.cli import run_instruct
    from youku_mplug_tpu_torch.models.generation import (
        NEG_INF,
        top_k_top_p_filter,
    )

    cfg, raw = run_instruct.load_owl_config(SAMPLE_YAML)
    if cfg != model.cfg:
        fail("the sample YAML's model is not the flagship's")
    args = run_instruct.parser().parse_args(
        ["--config", SAMPLE_YAML, "--synthetic_data", "--engine"])
    gen_cfg = run_instruct.generation_config(args, cfg, raw)
    if not (gen_cfg.do_sample and gen_cfg.top_k == 5):
        fail(f"the sample YAML reads as {gen_cfg}")
    eng = run_instruct.make_engine(
        model.text_decoder, batch["prompt_len"], gen_cfg, OWL_SLOTS,
        torch.Generator("cuda").manual_seed(args.seed + 1))
    g = torch.Generator("cuda").manual_seed(0)
    logits = 2 * torch.randn(OWL_SLOTS, cfg.text.vocab_size, generator=g,
                             device="cuda")
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(eng.generator)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream), torch.inference_mode():
        eng._pick(logits)
    torch.cuda.current_stream().wait_stream(stream)
    with torch.inference_mode():
        with torch.cuda.graph(graph, stream=stream):
            drawn = eng._pick(logits)
        draws = torch.empty(SAMPLE_REPLAYS, OWL_SLOTS, dtype=torch.int32,
                            device="cuda")
        t0 = time.perf_counter()
        for i in range(SAMPLE_REPLAYS):
            graph.replay()
            draws[i].copy_(drawn)
        torch.cuda.synchronize()
        replay_ms = (time.perf_counter() - t0) / SAMPLE_REPLAYS * 1e3
        kept = top_k_top_p_filter(logits / gen_cfg.temperature,
                                  gen_cfg.top_k, gen_cfg.top_p)
    support = kept != NEG_INF
    outside = int((~support.gather(1, draws.T.long())).sum())
    pvalues = []
    for row in range(OWL_SLOTS):
        idx = support[row].nonzero()[:, 0]
        p = torch.softmax(kept[row, idx].double(), 0).cpu().numpy()
        seen = torch.bincount(draws[:, row].long(),
                              minlength=cfg.text.vocab_size)[idx]
        pvalues.append(float(sstats.chisquare(
            seen.cpu().numpy(), p * SAMPLE_REPLAYS).pvalue))
    fresh = bool((draws[0] != draws[1]).any())
    print(f"[sampling] captured _pick, {SAMPLE_REPLAYS} replays on [8, "
          f"{cfg.text.vocab_size}] logits ({replay_ms:.4f} ms a replay): "
          f"support sizes {support.sum(1).tolist()}, draws outside "
          f"{outside}, chi-square p per row "
          f"{[round(x, 4) for x in pvalues]}, first two replays differ "
          f"{fresh}", flush=True)
    if outside or min(pvalues) <= 1e-3 or not fresh:
        fail("captured sampling left its support, missed the filtered "
             "softmax or drew the same numbers again")

    sub = {k: v[:OWL_SLOTS] for k, v in batch.items()}
    runs = []
    for seed in (args.seed + 1, args.seed + 1, args.seed + 2):
        if not runs:
            _reset_counts(report)
        seqs, st, eng = run_instruct.serve_instruct(
            model, clips[:OWL_SLOTS], sub, gen_cfg, num_slots=OWL_SLOTS,
            generator=torch.Generator("cuda").manual_seed(seed))
        torch.cuda.synchronize()
        if not runs:
            _read_counts(report, "instruct_sample")
            per_step = _per_step(report, "instruct_sample",
                                 eng.decode_steps, {"K5-ALiBi": 30,
                                                    "K6": 30})
        if st["nonfinite_logits"] or not 0 <= seqs.min() <= seqs.max() \
                < cfg.text.vocab_size:
            fail(f"sampled instruct run: {st}")
        runs.append((seqs, st))
    same = (runs[0][0] == runs[1][0]).all()
    other = (runs[0][0] != runs[2][0]).any()
    print(f"[instruct_sample] {json.dumps(runs[0][1])} | launches per "
          f"step {per_step} | same seed same tokens {bool(same)}, another "
          f"seed other tokens {bool(other)} | first answers "
          f"{runs[0][0][0][:8].tolist()} / {runs[2][0][0][:8].tolist()}",
          flush=True)
    if not (same and other):
        fail("sampled serving is not reproducible by its seed")


def _downstream_yaml(path, overrides, out_dir):
    """A copy of a reference YAML with ``overrides`` (the phase's cuts)
    and its model JSONs named by absolute path."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    for key in ("text_cfg", "visual_cfg"):
        raw[key] = os.path.join(REPO, raw[key])
    raw.update(overrides)
    dst = os.path.join(out_dir, os.path.basename(path))
    with open(dst, "w") as f:
        yaml.safe_dump(raw, f, allow_unicode=True)
    return dst


def _launches_per(report, path, units, want):
    """Launches per unit (a train step, an evaluation call) of the run on
    ``path``: each kernel key of ``want`` exactly that many, every other
    kernel none."""
    got = {r["key"]: r["launches_by_path"][path] / units for r in report}
    if any(got[k] != v for k, v in want.items()) or any(
            v for k, v in got.items() if k not in want):
        fail(f"{path}: launches per unit {got} over {units}, expected "
             f"{want} and no other kernel")
    return {k: v for k, v in got.items() if v}


def _clip_lr_scale(state):
    """The AdamW groups at lr scale 0.1 hold exactly the CLIP tower's
    non-temporal leaves, at a tenth of the other groups' lr."""
    by_id = {id(p): k for k, p in state.trainable.items()}
    groups = state.optimizer.torch_optimizer.param_groups
    scaled = {by_id[id(p)] for g in groups if g["lr_scale"] == 0.1
              for p in g["params"]}
    want = {k for k in state.trainable
            if "visual_encoder" in k and "temporal" not in k}
    base = [g["lr"] for g in groups if g["lr_scale"] == 1.0]
    ratios = {g["lr"] / base[0] for g in groups if g["lr_scale"] == 0.1}
    if not want or scaled != want or not base or base[0] <= 0 or any(
            abs(r - 0.1) > 1e-6 for r in ratios):
        fail(f"lr scale: {len(scaled)} leaves at 0.1 ({len(want)} CLIP "
             f"leaves), lr ratios {ratios}, base lr {base}")
    return {"clip_leaves_at_0.1": len(scaled), "lr": base[0],
            "clip_lr": base[0] * 0.1}


def _plain(fn):
    """``fn()`` with every flash wrapper on its plain version; fails if a
    kernel launched."""
    from youku_mplug_tpu_torch.ops import flash_attention as fa

    counts = _flash_counts(fa)
    with mock.patch.object(fa, "_on_cpu", lambda t: True):
        out = fn()
    if counts != _flash_counts(fa):
        fail("a plain replay launched a kernel")
    return out


def _eval_replay(tag, runner, module, prepared, split):
    """One evaluation call with the kernels and again with the plain
    versions: generative scores within RESCORE_TOL_PER_TOKEN a scored
    token (cls: log-probabilities, each moved by at most twice the
    largest score's error), head logits within LOGIT_TOL (ITM: P(match)
    within LOGIT_TOL / 2), retrieval features within FEATURE_TOL
    (relative L2).  Returns the errors and their bounds."""
    model = runner.model
    model.eval()
    with torch.inference_mode():
        if tag == "cls":
            classnames = prepared[3]
            raw = next(iter(prepared[2]))
            raw = {k: v[:DOWNSTREAM_EVAL_CLIPS] for k, v in raw.items()}
            got = module.score_batch(runner, raw, classnames)
            want = _plain(lambda: module.score_batch(runner, raw,
                                                     classnames))
            text = runner.tokenizer(
                [(module._title(t, runner.cfg.max_length), c)
                 for t in raw["text"] for c in classnames])
            scored = int((text["attention_mask"].sum(1) - 1
                          - text["prompt_lengths"]).max())
            lg, lw = (torch.from_numpy(x["generation_logits"]).clamp_min(
                1e-30).log() for x in (got, want))
            live = (lg > -69) & (lw > -69)  # neither underflowed
            out = {"gen_logprob_err": (lg - lw).abs()[live].max().item(),
                   "gen_bound": 2 * RESCORE_TOL_PER_TOKEN * scored,
                   "cls_logit_err": err(torch.from_numpy(got["cls_logits"]),
                                        torch.from_numpy(
                                            want["cls_logits"])),
                   "cls_bound": LOGIT_TOL,
                   "top1_agree": float((got["generation_logits"].argmax(1)
                                        == want["generation_logits"]
                                        .argmax(1)).mean())}
        elif tag == "itm":
            video = torch.from_numpy(next(iter(prepared[0].loader))[
                "video"][:DOWNSTREAM_EVAL_CLIPS]).to(runner.device)
            texts = split.text[:module.TEXTS_PER_CALL]
            got = module.score_block(runner, video, texts)
            want = _plain(lambda: module.score_block(runner, video, texts))
            scored = 2  # the yes word and eos
            out = {"gen_err": float(abs(got[0] - want[0]).max()),
                   "gen_bound": RESCORE_TOL_PER_TOKEN * scored,
                   "cls_err": float(abs(got[1] - want[1]).max()),
                   "cls_bound": LOGIT_TOL / 2}
        else:
            got = module.features(runner, split)
            want = _plain(lambda: module.features(runner, split))
            out = {"text_feature_rel_l2": rel_l2(torch.from_numpy(got[1]),
                                                 torch.from_numpy(want[1])),
                   "vision_feature_rel_l2": rel_l2(
                       torch.from_numpy(got[0]), torch.from_numpy(want[0])),
                   "bound": FEATURE_TOL}
    model.train()
    errs = [(out[k], out[b]) for k, b in (
        ("gen_logprob_err", "gen_bound"), ("cls_logit_err", "cls_bound"),
        ("gen_err", "gen_bound"), ("cls_err", "cls_bound"),
        ("text_feature_rel_l2", "bound"), ("vision_feature_rel_l2", "bound"))
        if k in out]
    if any(not math.isfinite(e) or e > b for e, b in errs):
        fail(f"[{tag}] evaluation scores against the plain versions: {out}")
    return out


def _downstream_task(report, tag, module, yaml_path, overrides, out_dir,
                     kind=None, want=None):
    """One downstream recipe through its CLI's functions at full width and
    depth: prepare (setup) on the reference YAML with the cuts,
    DOWNSTREAM_STEPS train steps, the plain replay of the first step with
    the same dropout generator and the dropout law on the decoder's
    input, the evaluation, and one evaluation call replayed plain.
    ``tag`` names the run's paths (``<tag>_train``, ``<tag>_eval``) and
    lines, ``kind`` the recipe (cls, itm or retrieval; default ``tag``),
    ``want`` the launches (per train step, per evaluation call) to check
    (default the 1.3B decoder's)."""
    kind = kind or tag
    from youku_mplug_tpu_torch.cli import common, run_cls
    from youku_mplug_tpu_torch.data.datasets import SyntheticRetrievalSplit
    from youku_mplug_tpu_torch.train.trainer import dropout_generator

    cfg_path = _downstream_yaml(yaml_path, overrides, out_dir)
    args = module.parser().parse_args([
        "--config", cfg_path, "--synthetic_data", "--max_steps",
        str(DOWNSTREAM_STEPS), "--device", "cuda", "--output_dir",
        os.path.join(out_dir, tag)])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prepared = module.prepare(args)
    runner = prepared[0]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cfg, state = runner.cfg, runner.state
    layers = cfg.model.text.num_hidden_layers
    make_batch = (run_cls.make_batch_factory(prepared[3], cfg.max_length)
                  if kind == "cls" else module.make_batch)
    if want is None:
        want = (({"K1": layers}, {"K1": layers}) if kind == "retrieval" else
                ({"K4-d96": 1, "dq-d96": 1, "dkv-d96": 1, "delta": 1},
                 {"K4-d96": 1, "K1": 2 * layers}))
    held = torch.cuda.memory_allocated()
    frozen0 = {k: p.detach().clone() for k, p in state.frozen.items()}
    trainable0 = {k: p.detach().clone() for k, p in state.trainable.items()}
    held = torch.cuda.memory_allocated() - held

    torch.cuda.reset_peak_memory_stats()
    _reset_counts(report)
    history = common.train_one_epoch(runner, module.build_train_step(runner),
                                     0, make_batch)
    torch.cuda.synchronize()
    _read_counts(report, f"{tag}_train")
    train_peak = torch.cuda.max_memory_allocated() - held
    if len(history) != DOWNSTREAM_STEPS or any(
            not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]))
            or h["skipped_nonfinite"] != 0 for h in history):
        fail(f"[{tag}] train steps: {history}")
    changed = [k for k, p in state.frozen.items()
               if not torch.equal(p.detach(), frozen0[k])]
    if changed or any(p.dtype != torch.bfloat16
                      for p in state.frozen.values()):
        fail(f"[{tag}] the frozen decoder changed: {changed[:5]}")
    moved = sum(not torch.equal(p.detach(), trainable0[k])
                for k, p in state.trainable.items())
    if moved == 0:
        fail(f"[{tag}] no trainable leaf moved")
    n_frozen = len(frozen0)
    del frozen0, trainable0
    per_step = _launches_per(report, f"{tag}_train", len(history), want[0])
    lr_scale = _clip_lr_scale(state)

    # the plain replay of the first batch, the same dropout masks both
    # runs; the decoder's first input (embeddings after dropout) sampled
    # in the kernels' run
    shares = []
    decoder_layers = runner.model.text_decoder.decoder.layers

    class _Sampled:
        def __enter__(self):
            self.h = decoder_layers.register_forward_pre_hook(
                lambda mod, a: None if shares else shares.append(
                    (a[0] == 0).float().mean().item()))

        def __exit__(self, *exc):
            self.h.remove()

    dropout = kind != "retrieval"
    make_gen = ((lambda: dropout_generator(args.seed, 0, runner.device))
                if dropout else None)
    loss_k, loss_p, finite, _, rows = _replay(
        runner, make_batch, module.make_loss_fn,
        f"{tag} replay, every wrapper plain", make_gen=make_gen,
        on_kernels=_Sampled())
    if not finite or abs(loss_k - loss_p) > REPLAY_LOSS_TOL or (
            not dropout and rows[0][0] > REPLAY_GRAD_TOL):
        fail(f"[{tag}] plain replay out of tolerance")
    rel = sorted(r[1] for r in rows)
    replay = {"loss_kernels": loss_k, "loss_plain": loss_p,
              "grad_rel_l2_median": rel[len(rel) // 2],
              "worst_gated_grad_err": rows[0][0], "worst_leaf": rows[0][3]}
    if dropout:  # the backward kernels against plain on one forward
        loss_k, loss_b, finite, _, rows = _replay(
            runner, make_batch, module.make_loss_fn,
            f"{tag} replay, backward plain", make_gen=make_gen,
            backward_only=True)
        if not finite or loss_k != loss_b or rows[0][0] > REPLAY_GRAD_TOL:
            fail(f"[{tag}] backward replay out of tolerance")
        replay |= {"backward_worst_gated_grad_err": rows[0][0],
                   "backward_worst_leaf": rows[0][3]}
    rate = cfg.model.text.hidden_dropout
    if not shares or (abs(shares[0] - rate) > DROPOUT_SHARE_TOL if dropout
                      else shares[0] > DROPOUT_SHARE_TOL):
        fail(f"[{tag}] the decoder input's zeroed share {shares} (dropout "
             f"{rate if dropout else 0}, tol {DROPOUT_SHARE_TOL})")

    # the evaluation
    split = None
    if kind != "cls":
        split = SyntheticRetrievalSplit(DOWNSTREAM_SPLITS[kind],
                                        num_frames=cfg.num_frames,
                                        size=cfg.image_res)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(report)
    t0 = time.perf_counter()
    if kind == "cls":
        metrics = module.evaluation(runner, prepared[2], prepared[3])
        calls = -(-cfg.batch_size // DOWNSTREAM_EVAL_CLIPS) * DOWNSTREAM_STEPS
    elif kind == "itm":
        metrics = module.evaluation(runner, split)
        calls = -(-len(split) // int(cfg.get("eval_video_batch", 4))) * -(
            -len(split.text) // module.TEXTS_PER_CALL)
    else:
        metrics = module.evaluation(runner, split)
        calls = -(-len(split.text) // cfg.batch_size)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    _read_counts(report, f"{tag}_eval")
    eval_peak = torch.cuda.max_memory_allocated()
    per_call = _launches_per(report, f"{tag}_eval", calls, want[1])
    if not all(math.isfinite(v) for v in metrics.values()):
        fail(f"[{tag}] evaluation metrics {metrics}")
    eval_replay = _eval_replay(kind, runner, module, prepared, split)

    step_ms = [h["step_time"] * 1e3 for h in history]
    out = {"yaml": os.path.relpath(yaml_path, REPO), "cuts": overrides,
           "setup_s": setup_s, "steps": len(history),
           "batch": cfg.batch_size, "frames": cfg.num_frames,
           "step_ms_each": step_ms,
           "clips_per_s_last": cfg.batch_size / history[-1]["step_time"],
           **{k: [h[k] for h in history] for k in history[0]
              if k.startswith("loss") or k in ("grad_norm", "lr")},
           "train_peak_memory_gib": train_peak / 2 ** 30,
           "launches_per_step": per_step,
           "trainable_leaves_moved": f"{moved}/{len(state.trainable)}",
           "frozen_leaves_unchanged": n_frozen, "lr_scale": lr_scale,
           "decoder_input_zero_share": shares[0],
           "replay": replay,
           "eval_s": eval_s, "eval_calls": calls,
           "eval_ms_per_call": eval_s / calls * 1e3,
           "launches_per_eval_call": per_call,
           "eval_peak_memory_gib": eval_peak / 2 ** 30,
           "metrics": metrics, "eval_replay": eval_replay}
    print(f"[{tag}] {json.dumps(out, ensure_ascii=False)}", flush=True)
    return out


def phase_downstream(report, out_dir):
    """Phase 13, the downstream recipes (cls, ITM rerank, dual-encoder
    retrieval) on their reference YAMLs: clip-b16 and the 1.3B decoder
    with its 0.1 dropouts, seeded weights, synthetic 224 px clips."""
    from youku_mplug_tpu_torch.cli import run_cls, run_retrieval
    from youku_mplug_tpu_torch.cli import run_retrieval_itm

    t_phase = time.perf_counter()
    print("[downstream] cuts: an evaluation call scores "
          f"{DOWNSTREAM_EVAL_CLIPS} clips (eval_video_batch; 45 x 32 "
          "pairs of 208 positions would hold a 61 GB fp32 logits tensor); "
          "the ITM match head has num_classes 2 (the YAML's 1-way head is "
          "refused, ROADMAP Queue 3); the ITM batch is 32 clips, not the "
          "YAML's 96 (3 x 96 decoder rows of 208 positions, twice, would "
          "hold ~150 GB of activations); synthetic clips and seeded weights; "
          "the synthetic splits are sized for "
          f"{DOWNSTREAM_STEPS} train batches and the evaluations "
          f"({DOWNSTREAM_SPLITS})", flush=True)
    out = {}
    for tag, module, path, cuts in (
            ("cls", run_cls, CLS_YAML,
             {"eval_video_batch": DOWNSTREAM_EVAL_CLIPS,
              "synthetic_length": 64}),
            ("itm", run_retrieval_itm, ITM_YAML,
             {"num_classes": 2, "eval_video_batch": DOWNSTREAM_EVAL_CLIPS,
              "batch_size": 32, "synthetic_length": 64}),
            ("retrieval", run_retrieval, RETRIEVAL_YAML,
             {"synthetic_length": 192})):
        out[tag] = _downstream_task(report, tag, module, path, cuts,
                                    out_dir)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[downstream] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


def phase_gpt3_27b(report, out_dir):
    """Phase 14, the GPT-3 2.7B decoder (32 layers, 2560 wide, 32 heads of
    80, vocab 51200; seeded weights) on two reference recipes at full
    width and depth, with clip-b16: the caption recipe through
    run_caption (2 finetune steps of 24 clips x 16 frames, the decoder on
    plain attention under its 0.1 dropouts; the beam-5 evaluation of 2
    test batches, whose decode steps run K5 at head dim 80 with its K6
    write, rescored plain), and the cls recipe through run_cls as phase
    13 runs the 1.3B one (its dropout-free evaluation passes run K4 at
    head dim 80, once a layer a pass, and no packed K1)."""
    from youku_mplug_tpu_torch.cli import run_caption, run_cls

    t_phase = time.perf_counter()
    with open(os.path.join(REPO, "configs", "models",
                           "config_gpt3_2.7B.json")) as f:
        layers = json.load(f)["num_hidden_layers"]
    print(f"[gpt3-2.7B] cuts: caption {CAPTION27_CUTS} (the beam's new "
          "tokens 32, as on the 1.3B flagship, for the decoder's default "
          "100; synthetic clips for 2 train and 2 test batches); cls as "
          f"phase 13's: {CLS27_CUTS}; synthetic clips, seeded weights",
          flush=True)
    cfg_path = _downstream_yaml(CAPTION27_YAML, CAPTION27_CUTS, out_dir)
    args = run_caption.parser().parse_args([
        "--config", cfg_path, "--synthetic_data", "--max_steps",
        str(CAPTION_STEPS), "--device", "cuda", "--output_dir",
        os.path.join(out_dir, "caption27")])
    t0 = time.perf_counter()
    runner, test_loader = run_caption.prepare(args)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    text = runner.cfg.model.text
    geometry = (text.num_hidden_layers, text.hidden_size,
                text.num_attention_heads, text.head_dim, text.vocab_size,
                runner.cfg.num_frames, runner.cfg.batch_size)
    if geometry != (layers, 2560, 32, 80, 51200, 16, 24) \
            or text.attention_dropout != 0.1:
        fail(f"the 2.7B caption recipe's geometry {geometry}, attention "
             f"dropout {text.attention_dropout}")
    train = _caption_finetune(report, runner, "caption27_train")
    train["setup_s"] = setup_s
    train["launches_per_step"] = _launches_per(
        report, "caption27_train", train["steps"],
        {"K4-d96": 1, "dq-d96": 1, "dkv-d96": 1, "delta": 1})
    print(f"[caption27 finetune] {json.dumps(train)}", flush=True)
    out = _caption_eval(report, runner, test_loader, "caption27_eval",
                        "K5-d80", CAPTION_EVAL_BATCHES)
    # besides the decode kernel, one K4 at head dim 96 a batch (the
    # encode's AttentionPool); the prefill runs plain attention
    others = {k: v for k, v in out["launches"].items()
              if not k.startswith(("K5", "K6"))}
    if others != {"K4-d96": out["batches"]}:
        fail(f"caption27_eval: launches {out['launches']}, expected one "
             "K4-d96 a batch besides K5-d80 and K6")
    print(f"[caption27 eval] {json.dumps(out)}", flush=True)
    del runner, test_loader
    gc.collect()
    torch.cuda.empty_cache()
    cls = _downstream_task(
        report, "cls27", run_cls, CLS27_YAML, CLS27_CUTS, out_dir,
        kind="cls", want=({"K4-d96": 1, "dq-d96": 1, "dkv-d96": 1,
                           "delta": 1},
                          {"K4-d96": 1, "K4-d80": 2 * layers}))
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[gpt3-2.7B] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return train, out, cls


def phase_instruct_train(report, out_dir):
    """The run_instruct CLI's training path (``--train``) at the full
    width and depth of configs/instruct/train_bloomz_7b_flagship.yaml:
    OWL_TRAIN_STEPS steps of batch 8; returns (runner, stats)."""
    from youku_mplug_tpu_torch.cli import common, run_instruct

    args = run_instruct.parser().parse_args([
        "--config", OWL_TRAIN_YAML, "--train", "--synthetic_data",
        "--max_steps", str(OWL_TRAIN_STEPS), "--device", "cuda",
        "--output_dir", out_dir])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = run_instruct.train_setup(args)
    train_step = run_instruct.build_train_step(runner)
    state = runner.state
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated()
    # copies for the bitwise check, held through the steps: their bytes
    # come off the steps' peak
    held = torch.cuda.memory_allocated()
    frozen0 = {k: p.detach().clone() for k, p in state.frozen.items()}
    trainable0 = {k: p.detach().clone() for k, p in state.trainable.items()}
    held = torch.cuda.memory_allocated() - held
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(report)
    history = common.train_one_epoch(runner, train_step, 0,
                                     run_instruct.make_instruct_batch)
    torch.cuda.synchronize()
    _read_counts(report, "instruct_train")
    peak = torch.cuda.max_memory_allocated() - held
    if len(history) != OWL_TRAIN_STEPS:
        fail(f"instruct-train slice ran {len(history)} steps")
    bad = [h for h in history if not (math.isfinite(h["loss"])
                                      and math.isfinite(h["grad_norm"]))
           or h["skipped_nonfinite"] != 0]
    if bad:
        fail(f"non-finite or skipped instruct-train steps: {bad}")
    changed = [k for k, p in state.frozen.items()
               if not torch.equal(p.detach(), frozen0[k])]
    if changed or any(p.dtype != torch.bfloat16
                      for p in state.frozen.values()):
        fail(f"the frozen ViT / Bloom base changed: {changed[:5]}")
    roots = {k.split("/")[0] for k in state.frozen}
    if roots != {"visual_encoder", "text_decoder"} or any(
            "lora_" in k for k in state.frozen):
        fail(f"unexpected frozen leaves: {sorted(roots)}")
    still = [k for k, p in state.trainable.items()
             if torch.equal(p.detach(), trainable0[k])]
    lora = [k for k in state.trainable if "lora_" in k]
    if still or len(lora) != 8 or any(
            p.dtype != torch.float32 for p in state.trainable.values()):
        fail(f"trainable leaves that did not move: {still[:8]}; LoRA "
             f"leaves {lora}")
    layers = runner.model.cfg.text.num_hidden_layers
    depth = runner.model.cfg.vision.depth
    per_step = {r["key"]: r["launches_by_path"]["instruct_train"]
                / OWL_TRAIN_STEPS for r in report}
    want = {"K1-ALiBi": layers, "dq-ALiBi": layers, "dkv-ALiBi": layers,
            "delta": layers, "K1": depth}
    if any(per_step[k] != v for k, v in want.items()) or any(
            per_step[k] for k in per_step if k not in want):
        fail(f"launches per step {per_step}, expected {want} and no other "
             "(the frozen ViT takes no backward)")
    step_s = [h["step_time"] for h in history]
    batch = runner.cfg.batch_size
    stats = {"steps": len(history), "setup_s": setup_s,
             "step_ms": sum(step_s) / len(step_s) * 1e3,
             "step_ms_each": [t * 1e3 for t in step_s],
             "step_ms_after_first": sum(step_s[1:]) / (len(step_s) - 1)
             * 1e3,
             "clips_per_s": batch / (sum(step_s[1:]) / (len(step_s) - 1)),
             "loss": [h["loss"] for h in history],
             "grad_norm": [h["grad_norm"] for h in history],
             "lr": [h["lr"] for h in history],
             "trainable_leaves_moved": len(trainable0),
             "frozen_leaves_unchanged": len(frozen0),
             "trainable_params": sum(p.numel()
                                     for p in state.trainable.values()),
             "frozen_params": sum(p.numel() for p in state.frozen.values()),
             "peak_memory_gib": peak / 2 ** 30,
             "setup_peak_memory_gib": setup_peak / 2 ** 30,
             "launches_per_step": per_step}
    print(f"[instruct-train] {json.dumps(stats)}", flush=True)
    del frozen0, trainable0
    return runner, stats


# ---------------------------------------------------------------------
# phases 15-19: weights in and out (checkpoint import, serve --resume, the
# instruct HF import, its LoRA training checkpoints and the serving
# export).  Each writes its files under the run's temporary directory in
# the external formats, from chip_smoke's own inverse of the importers.

# Megatron's partition dim per parameter-name suffix (column-parallel
# weights split dim 0, row-parallel dim 1, the vocab dim 0)
MEGATRON_SPLIT = (("query_key_value.weight", 0), ("query_key_value.bias", 0),
                  ("attention.dense.weight", 1), ("dense_h_to_4h.weight", 0),
                  ("dense_h_to_4h.bias", 0), ("dense_4h_to_h.weight", 1),
                  ("word_embeddings.weight", 0))
MP_RANKS = 2
# the Owl checkpoint phases cut the Bloom decoder to 4 of its 30 layers
# (width kept): full depth would write and read back ~14 GB a format
OWL_CUT = {"num_hidden_layers": 4}
OWL_CUT_TRAIN_STEPS = 2


def _gb(paths):
    """GB (1e9 bytes) of the files and directory trees in ``paths``."""
    return sum(sum(os.path.getsize(os.path.join(d, f))
                   for d, _, files in os.walk(p) for f in files)
               if os.path.isdir(p) else os.path.getsize(p)
               for p in paths) / 1e9


def _megatron_state(dec):
    """The GPT-3 decoder's tree (JAX names) in ModelScope's Megatron
    naming: fused QKV rows head-major (n, 3, d)."""
    lm, lay = "language_model.", dec["decoder"]["layers"]
    n_layers, h = lay["ln1_scale"].shape
    a, m = lay["attn"], lay["mlp"]
    sd = {lm + "embedding.word_embeddings.weight":
          dec["word_embeddings"]["embedding"],
          lm + "embedding.position_embeddings.weight":
          dec["decoder"]["position_embeddings"],
          lm + "transformer.final_layernorm.weight":
          dec["decoder"]["ln_f_scale"],
          lm + "transformer.final_layernorm.bias": dec["decoder"]["ln_f_bias"]}
    for i in range(n_layers):
        p = lm + f"transformer.layers.{i}."
        sd.update({
            p + "input_layernorm.weight": lay["ln1_scale"][i],
            p + "input_layernorm.bias": lay["ln1_bias"][i],
            p + "post_attention_layernorm.weight": lay["ln2_scale"][i],
            p + "post_attention_layernorm.bias": lay["ln2_bias"][i],
            p + "attention.query_key_value.weight": a["qkv_kernel"][i]
            .permute(0, 2, 1, 3).reshape(h, 3 * h).t(),
            p + "attention.query_key_value.bias": a["qkv_bias"][i]
            .permute(1, 0, 2).reshape(-1),
            p + "attention.dense.weight": a["out_kernel"][i].reshape(h, h).t(),
            p + "attention.dense.bias": a["out_bias"][i],
            p + "mlp.dense_h_to_4h.weight": m["fc1_kernel"][i].t(),
            p + "mlp.dense_h_to_4h.bias": m["fc1_bias"][i],
            p + "mlp.dense_4h_to_h.weight": m["fc2_kernel"][i].t(),
            p + "mlp.dense_4h_to_h.bias": m["fc2_bias"][i]})
    return sd


def _timm_state(ve, patch):
    """The TimeSformer's tree (JAX names) in timm naming: the q and v
    biases fused into ``qkv.bias`` around a zero k."""
    dim = ve["cls_token"].shape[-1]
    sd = {"cls_token": ve["cls_token"], "pos_embed": ve["pos_embed"],
          "temporal_embed": ve["temporal_embed"],
          "patch_embed.proj.weight": ve["patch_embed"]["kernel"].t()
          .reshape(dim, 3, patch, patch),
          "patch_embed.proj.bias": ve["patch_embed"]["bias"],
          "norm.weight": ve["norm"]["scale"], "norm.bias": ve["norm"]["bias"]}
    i = 0
    while f"blocks_{i}" in ve:
        b, blk = f"blocks.{i}.", ve[f"blocks_{i}"]
        for nrm in ("norm1", "norm2", "temporal_ln"):
            sd[b + nrm + ".weight"] = blk[nrm]["scale"]
            sd[b + nrm + ".bias"] = blk[nrm]["bias"]
        for att in ("attn", "temporal_attn"):
            at = blk[att]
            q, v = at["q_bias"].reshape(-1), at["v_bias"].reshape(-1)
            sd[b + att + ".qkv.weight"] = at["qkv_kernel"].reshape(
                dim, 3 * dim).t()
            sd[b + att + ".qkv.bias"] = torch.cat([q, torch.zeros_like(q), v])
            sd[b + att + ".proj.weight"] = at["proj_kernel"].reshape(
                dim, dim).t()
            sd[b + att + ".proj.bias"] = at["proj_bias"]
        sd[b + "temporal_fc.weight"] = blk["temporal_fc_kernel"].t()
        sd[b + "temporal_fc.bias"] = blk["temporal_fc_bias"]
        for fc in ("fc1", "fc2"):
            sd[b + f"mlp.{fc}.weight"] = blk["mlp"][f"{fc}_kernel"].t()
            sd[b + f"mlp.{fc}.bias"] = blk["mlp"][f"{fc}_bias"]
        i += 1
    return sd


def _owl_hf_state(tree, cfg):
    """An Owl model's tree (JAX names) in the external HF naming:
    ``language_model.transformer.*`` (HF Bloom: QKV rows head-major),
    ``vision_model.*`` (the MplugOwlVisionModel tower, Megatron-style,
    a zero k bias), ``abstractor.*`` (the published abstractor) and
    ``query_tokens``."""
    sd = {}
    dec, lay = tree["text_decoder"], tree["text_decoder"]["decoder"]["layers"]
    n_layers, h = lay["ln1_scale"].shape
    t = "language_model.transformer."
    sd[t + "word_embeddings.weight"] = dec["word_embeddings"]["embedding"]
    for ext, ours in (("word_embeddings_layernorm", "emb_ln"),
                      ("ln_f", "ln_f")):
        sd[t + ext + ".weight"] = dec["decoder"][ours + "_scale"]
        sd[t + ext + ".bias"] = dec["decoder"][ours + "_bias"]
    a, m = lay["attn"], lay["mlp"]
    for i in range(n_layers):
        p = t + f"h.{i}."
        sd.update({
            p + "input_layernorm.weight": lay["ln1_scale"][i],
            p + "input_layernorm.bias": lay["ln1_bias"][i],
            p + "post_attention_layernorm.weight": lay["ln2_scale"][i],
            p + "post_attention_layernorm.bias": lay["ln2_bias"][i],
            p + "self_attention.query_key_value.weight":
            a["qkv_kernel"][i].reshape(h, 3 * h).t(),
            p + "self_attention.query_key_value.bias":
            a["qkv_bias"][i].reshape(-1),
            p + "self_attention.dense.weight":
            a["out_kernel"][i].reshape(h, h).t(),
            p + "self_attention.dense.bias": a["out_bias"][i],
            p + "mlp.dense_h_to_4h.weight": m["fc1_kernel"][i].t(),
            p + "mlp.dense_h_to_4h.bias": m["fc1_bias"][i],
            p + "mlp.dense_4h_to_h.weight": m["fc2_kernel"][i].t(),
            p + "mlp.dense_4h_to_h.bias": m["fc2_bias"][i]})
    ve, v = tree["visual_encoder"], "vision_model."
    dim, patch = ve["cls_token"].shape[-1], cfg.vision.patch_size
    sd[v + "embeddings.cls_token"] = ve["cls_token"]
    sd[v + "embeddings.position_embedding"] = ve["pos_embed"]
    sd[v + "embeddings.patch_embed.weight"] = ve["patch_embed"][
        "kernel"].t().reshape(dim, 3, patch, patch)
    for ext, ours in (("embeddings.pre_layernorm", "norm_pre"),
                      ("post_layernorm", "norm")):
        sd[v + ext + ".weight"] = ve[ours]["scale"]
        sd[v + ext + ".bias"] = ve[ours]["bias"]
    for i in range(cfg.vision.depth):
        blk, p = ve[f"blocks_{i}"], v + f"encoder.layers.{i}."
        at = blk["attn"]
        sd.update({
            p + "input_layernorm.weight": blk["norm1"]["scale"],
            p + "input_layernorm.bias": blk["norm1"]["bias"],
            p + "post_attention_layernorm.weight": blk["norm2"]["scale"],
            p + "post_attention_layernorm.bias": blk["norm2"]["bias"],
            p + "self_attn.query_key_value.weight": at["qkv_kernel"]
            .permute(0, 2, 1, 3).reshape(dim, 3 * dim).t(),
            p + "self_attn.query_key_value.bias": torch.stack(
                [at["q_bias"], torch.zeros_like(at["q_bias"]),
                 at["v_bias"]], dim=1).reshape(-1),
            p + "self_attn.dense.weight": at["proj_kernel"].reshape(
                dim, dim).t(),
            p + "self_attn.dense.bias": at["proj_bias"]})
        for fc in ("fc1", "fc2"):
            sd[p + f"mlp.{fc}.weight"] = blk["mlp"][f"{fc}_kernel"].t()
            sd[p + f"mlp.{fc}.bias"] = blk["mlp"][f"{fc}_bias"]
    ab = tree["abstractor"]
    sd["query_tokens"] = ab["query_embeds"]
    sd["abstractor.temporal_position_embeddings"] = ab["temporal_embed"]
    sd["abstractor.visual_fc.weight"] = tree["visual_fc"]["kernel"].t()
    sd["abstractor.visual_fc.bias"] = tree["visual_fc"]["bias"]
    sd["abstractor.vit_eos"] = tree["vit_eos"]
    for i in range(cfg.abstractor.num_layers):
        lt = ab[f"layers_{i}"]
        p = f"abstractor.encoder.layers.{i}.crossattention."
        for ext, ours in (("norm1", "norm_q"), ("normk", "norm_kv"),
                          ("output.norm2", "norm_mlp")):
            sd[p + ext + ".weight"] = lt[ours]["scale"]
            sd[p + ext + ".bias"] = lt[ours]["bias"]
        for ext, ours in (("attention.query", "q"), ("attention.key", "k"),
                          ("attention.value", "v"),
                          ("output.out_proj", "out")):
            sd[p + ext + ".weight"] = lt[ours + "_kernel"].t()
            sd[p + ext + ".bias"] = lt[ours + "_bias"]
        for w in ("w1", "w2", "w3"):
            sd[p + f"output.mlp.{w}.weight"] = lt["mlp"][w + "_kernel"].t()
            sd[p + f"output.mlp.{w}.bias"] = lt["mlp"][w + "_bias"]
        sd[p + "output.mlp.ffn_ln.weight"] = lt["mlp"]["ffn_ln"]["scale"]
        sd[p + "output.mlp.ffn_ln.bias"] = lt["mlp"]["ffn_ln"]["bias"]
    return sd


_ST_NAMES = {torch.bfloat16: "BF16", torch.float16: "F16",
             torch.float32: "F32"}


def _write_safetensors(path, tensors):
    """The safetensors format: an 8-byte little-endian header length, a
    JSON header of dtype / shape / data offsets per name (padded to 8
    bytes), then the data."""
    import struct

    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for k in sorted(tensors):
        t = tensors[k]
        nbytes = t.numel() * t.element_size()
        header[k] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                     "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head)
        for k in sorted(tensors):
            tensors[k].contiguous().reshape(-1).view(torch.uint8).numpy(
                ).tofile(f)


class _MergeCount:
    """Sums the leaves ``importers.merge_into`` / ``merge_exact`` copy
    while patched in, and the seconds ``fn`` (an importer) takes."""

    def __init__(self, importers, fn_name):
        self.leaves, self.seconds = 0, 0.0
        self._patches = [mock.patch.object(importers, name, self._count(
            getattr(importers, name))) for name in ("merge_into",
                                                    "merge_exact")]
        self._patches.append(mock.patch.object(importers, fn_name, self._time(
            getattr(importers, fn_name))))

    def _count(self, merge):
        def counted(params, imported, prefix=""):
            n = merge(params, imported, prefix)
            if not prefix:
                self.leaves += n
            return n
        return counted

    def _time(self, fn):
        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            return out
        return timed

    def __enter__(self):
        for p in self._patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self._patches:
            p.stop()


def phase_serve_imported(report, source, out_dir):
    """Phase 15: the serve slice's weights (``source``, the seeded bf16
    model phase 3 served, seed 42) rounded through fp16 and written as two
    Megatron ``mp_rank`` shards (GPT-3 decoder, under ``{"module": ...}``)
    and a timm ``{"state_dict": ...}`` file (TimeSformer); served through
    the serve CLI with a YAML naming both under ``import_torch_weights``.
    Gates: every decoder and vision leaf imported (the merges' count) and
    bitwise equal to the fp16-rounded source, every other leaf (seeded,
    seed 42) equal to the source's; then phase 3's and phase 4's gates on
    the served requests."""
    from youku_mplug_tpu_torch.models import importers

    t_phase = time.perf_counter()
    tree = importers.param_tree(source)
    gdir = os.path.join(out_dir, "gpt3_megatron")
    os.makedirs(os.path.join(gdir, "model"))
    shards = [{} for _ in range(MP_RANKS)]
    with torch.no_grad():
        for name, t in _megatron_state(tree["text_decoder"]).items():
            t = t.detach().half().cpu().contiguous()
            dim = next((d for sfx, d in MEGATRON_SPLIT
                        if name.endswith(sfx)), None)
            parts = ([t] * MP_RANKS if dim is None
                     else torch.chunk(t, MP_RANKS, dim))
            for shard, part in zip(shards, parts):
                shard[name] = part.clone()
        for r, shard in enumerate(shards):
            torch.save({"module": shard}, os.path.join(
                gdir, "model", f"mp_rank_{r:02d}_model_states.pt"))
        del shards
        vfile = os.path.join(out_dir, "timesformer_timm.pth")
        torch.save({"state_dict": {
            k: t.detach().half().cpu().contiguous()
            for k, t in _timm_state(tree["visual_encoder"],
                                    source.cfg.vision.patch_size).items()}},
            vfile)
    write_s = time.perf_counter() - t_phase
    ckpt_gb = _gb([gdir, vfile])
    yaml = _downstream_yaml(FLAGSHIP_YAML, {"import_torch_weights": {
        "gpt3": gdir, "vision": vfile}}, out_dir)
    with _MergeCount(importers, "import_all") as merged:
        cfg, model, _ = phase_slice(report, out_dir, yaml, "serve_imported")
    names = [k for k in dict(source.named_parameters())
             if k.startswith(("text_decoder.", "visual_encoder."))]
    got, want = dict(model.named_parameters()), dict(
        source.named_parameters())
    rounded = changed = 0
    bad = []
    with torch.no_grad():
        for k, w in want.items():
            imported = k in names
            ref = w.half().to(w.dtype) if imported else w
            if got[k].dtype != w.dtype or not torch.equal(got[k], ref):
                bad.append(k)
            if imported:
                rounded += 1
                changed += int(not torch.equal(ref, w))
    if bad or merged.leaves != len(names):
        fail(f"serve_imported: {merged.leaves} leaves imported of "
             f"{len(names)}; differing from the (fp16-rounded) source: "
             f"{bad[:8]}")
    print(f"[serve_imported] checkpoint {ckpt_gb:.3f} GB (fp16; {MP_RANKS} "
          f"Megatron shards and a timm file) written in {write_s:.2f} s; "
          f"import {merged.seconds:.2f} s ({ckpt_gb / merged.seconds:.2f} "
          f"GB/s), {merged.leaves} leaves, each the fp16-rounded source "
          f"bitwise ({changed} of {rounded} moved by the rounding), the "
          f"other {len(want) - rounded} the seeded source's", flush=True)
    phase_teacher_forced(cfg, model, "serve_imported teacher-forced")
    del model, got
    print(f"[serve_imported] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def phase_serve_resumed(report, run_dir, out_dir):
    """Phase 16: the serve CLI with ``--resume`` from phase 12's caption
    run: the loaded leaves bitwise equal to its latest checkpoint (dtype
    included: fp32 trainable, bf16 frozen), then phase 3's gates on 16
    requests."""
    from youku_mplug_tpu_torch import bridge
    from youku_mplug_tpu_torch.train.checkpoint import (
        STATE_FILE,
        CheckpointManager,
    )

    t_phase = time.perf_counter()
    ckpt = CheckpointManager(os.path.join(run_dir, "checkpoints"))
    step = ckpt.latest_step()
    _, model, _ = phase_slice(report, out_dir, FLAGSHIP_YAML, "serve_resumed",
                              extra=("--resume", run_dir))
    raw = ckpt.restore_raw(step, map_location="cuda")
    leaves = {**raw["trainable"], **raw["frozen"]}
    got = {bridge.jax_path(k): p for k, p in model.named_parameters()}
    bad = sorted(set(got) ^ set(leaves)) or [
        k for k, p in got.items() if p.dtype != leaves[k].dtype
        or not torch.equal(p.detach(), leaves[k])]
    if bad:
        fail(f"serve_resumed: leaves differing from checkpoint step {step}: "
             f"{bad[:8]}")
    gb = os.path.getsize(os.path.join(ckpt.directory, str(step),
                                      STATE_FILE)) / 1e9
    print(f"[serve_resumed] step {step} of {run_dir}: {len(got)} leaves "
          f"({len(raw['trainable'])} fp32 trainable, {len(raw['frozen'])} "
          f"bf16 frozen) bitwise equal; checkpoint {gb:.3f} GB | phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    del model, raw, leaves, got


def _owl_yaml(path, out_dir, text_overrides, **extra):
    """A copy of an instruct YAML with its Bloom JSON named by absolute
    path, ``text_overrides`` added to its own, and ``extra`` keys."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    raw["bloom_model_json"] = os.path.normpath(os.path.join(
        os.path.dirname(path), raw["bloom_model_json"]))
    raw["text_overrides"] = {**(raw.get("text_overrides") or {}),
                             **text_overrides}
    raw.update(extra)
    dst = os.path.join(out_dir, "cut_" + os.path.basename(path))
    with open(dst, "w") as f:
        yaml.safe_dump(raw, f)
    return dst


def phase_instruct_hf(report, out_dir):
    """Phase 17: a seeded Owl (seed 42) at full width with Bloom cut to
    OWL_CUT written as an HF checkpoint of two by-key ``.bin`` shards and,
    in a second directory, as two ``.safetensors`` files (every tensor of
    the second load bitwise equal to the first's); served through
    ``run_instruct --engine --hf_checkpoint`` (phase 7's gates, K1 once
    per ViT block, every leaf imported and bitwise equal to the source)
    and its teacher-forced replay (phase 8's gate).  Returns the ``.bin``
    directory."""
    import shutil

    from youku_mplug_tpu_torch.cli import run_instruct
    from youku_mplug_tpu_torch.models import importers

    t_phase = time.perf_counter()
    yaml = _owl_yaml(OWL_YAML, out_dir, OWL_CUT)
    src_args = run_instruct.parser().parse_args([
        "--config", yaml, "--synthetic_data", "--device", "cuda"])
    cfg, _, source, _ = run_instruct.build(src_args)
    with torch.no_grad():
        sd = {k: t.detach().cpu().contiguous() for k, t in
              _owl_hf_state(importers.param_tree(source), cfg).items()}
    names = sorted(sd)
    bin_dir, st_dir = (os.path.join(out_dir, d) for d in ("hf_bin", "hf_st"))
    t0 = time.perf_counter()
    for d, ext in ((bin_dir, ".bin"), (st_dir, ".safetensors")):
        os.makedirs(d)
        for i in range(2):
            part = {k: sd[k] for k in names[i::2]}
            if ext == ".bin":
                torch.save(part, os.path.join(
                    d, f"pytorch_model-{i + 1:05d}-of-00002.bin"))
            else:
                _write_safetensors(os.path.join(
                    d, f"model-{i + 1:05d}-of-00002.safetensors"), part)
    write_s = time.perf_counter() - t0
    gb = _gb([bin_dir])
    loads = {}
    for d in (bin_dir, st_dir):
        t0 = time.perf_counter()
        loads[d] = (importers.load_hf_torch_state(d),
                    time.perf_counter() - t0)
    a, b = loads[bin_dir][0], loads[st_dir][0]
    bad = ["names"] if set(a) != set(sd) or set(b) != set(sd) else [
        k for k in sd if a[k].dtype != b[k].dtype
        or not torch.equal(a[k], b[k]) or not torch.equal(a[k], sd[k])]
    if bad:
        fail(f"instruct_hf: .bin and .safetensors loads differ: {bad[:8]}")
    print(f"[instruct_hf] HF checkpoint ({len(sd)} tensors, bf16) {gb:.3f} "
          f"GB a format, both written in {write_s:.2f} s; read "
          f"{loads[bin_dir][1]:.2f} s (.bin), {loads[st_dir][1]:.2f} s "
          f"(.safetensors, the port's reader), every tensor bitwise equal",
          flush=True)
    del loads, a, b, sd
    shutil.rmtree(st_dir)
    with _MergeCount(importers, "import_owl") as merged:
        model, batch, clips, _ = phase_instruct(
            report, out_dir, yaml, "instruct_hf",
            extra=("--hf_checkpoint", bin_dir))
    want = dict(source.named_parameters())
    got = dict(model.named_parameters())
    bad = sorted(set(got) ^ set(want)) or [
        k for k in want if got[k].dtype != want[k].dtype
        or not torch.equal(got[k], want[k])]
    if bad or merged.leaves != len(want):
        fail(f"instruct_hf: {merged.leaves} leaves imported of {len(want)}; "
             f"differing from the source: {bad[:8]}")
    rate = gb / merged.seconds
    print(f"[instruct_hf] import {merged.seconds:.2f} s ({rate:.2f} GB/s), "
          f"{merged.leaves} leaves, every one the source's bitwise",
          flush=True)
    del source, want, got
    gc.collect()
    torch.cuda.empty_cache()
    phase_instruct_forced(model, batch, clips, "instruct_hf teacher-forced")
    del model, batch, clips
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[instruct_hf] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return bin_dir


def phase_instruct_hf_train(report, out_dir, hf_dir):
    """Phase 18: ``run_instruct --train --hf_checkpoint`` on the training
    YAML cut as phase 17 (rank-8 LoRA, batch 8, one epoch of
    OWL_CUT_TRAIN_STEPS steps) through ``train_main``: launches per step
    as phase 9's, the epoch's checkpoint saved; a second invocation with
    ``--resume`` restores trainable and frozen leaves, AdamW moments,
    count and step bitwise; ``cli/export_serving.py --owl --int8
    --int8_embedding`` writes the serving checkpoint.  Returns (run dir,
    training YAML, serving checkpoint directory)."""
    from youku_mplug_tpu_torch.cli import export_serving, run_instruct
    from youku_mplug_tpu_torch.train.checkpoint import (
        STATE_FILE,
        CheckpointManager,
    )

    t_phase = time.perf_counter()
    yaml = _owl_yaml(OWL_TRAIN_YAML, out_dir, OWL_CUT, epochs=1)
    run_dir = os.path.join(out_dir, "instruct_run")

    def args(out, *extra):
        return run_instruct.parser().parse_args([
            "--config", yaml, "--train", "--synthetic_data", "--max_steps",
            str(OWL_CUT_TRAIN_STEPS), "--hf_checkpoint", hf_dir, "--device",
            "cuda", "--output_dir", out, *extra])

    _reset_counts(report)
    t0 = time.perf_counter()
    runner = run_instruct.train_main(args(run_dir))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    _read_counts(report, "instruct_hf_train")
    history = runner.history
    if len(history) != OWL_CUT_TRAIN_STEPS or any(
            not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]))
            or h["skipped_nonfinite"] for h in history):
        fail(f"instruct_hf_train steps: {history}")
    layers = runner.model.cfg.text.num_hidden_layers
    per_step = _launches_per(
        report, "instruct_hf_train", OWL_CUT_TRAIN_STEPS,
        {"K1-ALiBi": layers, "dq-ALiBi": layers, "dkv-ALiBi": layers,
         "delta": layers, "K1": runner.model.cfg.vision.depth})
    ckpt = CheckpointManager(os.path.join(run_dir, "checkpoints"))
    step = ckpt.latest_step()
    if step != runner.state.step:
        fail(f"instruct_hf_train saved step {step}, the state is at "
             f"{runner.state.step}")
    ckpt_gb = os.path.getsize(os.path.join(ckpt.directory, str(step),
                                           STATE_FILE)) / 1e9
    print(f"[instruct_hf_train] {len(history)} steps "
          f"(ms {[round(h['step_time'] * 1e3, 1) for h in history]}, loss "
          f"{[round(h['loss'], 4) for h in history]}) and the checkpoint of "
          f"step {step} ({ckpt_gb:.3f} GB) in {train_s:.2f} s, setup and "
          f"import included; launches per step {per_step}", flush=True)
    del runner, history
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    again = run_instruct.train_setup(args(os.path.join(out_dir, "again"),
                                          "--resume", run_dir))
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    raw = ckpt.restore_raw(step, map_location="cuda")
    st = again.state
    bad = [f"{part} set" for part in ("trainable", "frozen")
           if set(getattr(st, part)) != set(raw[part])]
    bad += [k for part in ("trainable", "frozen")
            for k, p in getattr(st, part).items()
            if not bad and (p.dtype != raw[part][k].dtype
                            or not torch.equal(p.detach(), raw[part][k]))]
    moments = st.optimizer.torch_optimizer.state
    bad += [f"adam {k}" for k, p in st.trainable.items()
            if set(moments.get(p, {})) != set(raw["adam"].get(k, {})) or any(
                not torch.equal(moments[p][m].to(v.device), v)
                for m, v in raw["adam"].get(k, {}).items())]
    if bad or (st.optimizer.count, st.step) != (raw["count"], raw["step"]):
        fail(f"instruct_hf_train --resume differs from step {step}: "
             f"{bad[:8]}, count/step {(st.optimizer.count, st.step)}")
    print(f"[instruct_hf_train] --resume in {resume_s:.2f} s, import "
          f"included: {len(st.trainable)} trainable and {len(st.frozen)} "
          f"frozen leaves, {len(raw['adam'])} AdamW moment pairs, count "
          f"{st.optimizer.count} and step {st.step} bitwise equal",
          flush=True)
    del again, st, raw, moments
    gc.collect()
    torch.cuda.empty_cache()

    dest = os.path.join(out_dir, "serving")
    t0 = time.perf_counter()
    export_serving.main(["--owl", "--int8", "--int8_embedding", "--run_dir",
                         run_dir, "--config", yaml, "--dest", dest])
    export_s = time.perf_counter() - t0
    if CheckpointManager(dest).latest_step() != step:
        fail("export_serving wrote no serving checkpoint")
    print(f"[instruct_hf_train] export_serving --owl --int8 --int8_embedding "
          f"in {export_s:.2f} s: {_gb([dest]):.3f} GB | phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return run_dir, yaml, dest


def phase_instruct_serving_int8(report, out_dir, run_dir, train_yaml, dest):
    """Phase 19: ``run_instruct --engine --serving_ckpt`` on
    configs/instruct/serve_bloomz_7b_int8.yaml cut as phase 17, without
    --int8 (the int8 decoder comes from the export): the int8 leaves and
    scales bitwise equal to ``quantize_gpt3_decoder`` (with the
    embedding) of the training checkpoint's LoRA-merged decoder, the other
    decoder leaves to the merged ones; phase 8b's launch gates (K5 int8
    ALiBi a layer a decode step) and its plain replay."""
    from youku_mplug_tpu_torch import bridge
    from youku_mplug_tpu_torch.config import load_owl_config
    from youku_mplug_tpu_torch.ops import quant
    from youku_mplug_tpu_torch.ops.lora import merge_lora
    from youku_mplug_tpu_torch.train.checkpoint import CheckpointManager

    t_phase = time.perf_counter()
    yaml = _owl_yaml(OWL_INT8_YAML, out_dir, OWL_CUT)
    model, batch, clips, _ = phase_instruct(
        report, out_dir, yaml, "instruct_serving_int8",
        extra=("--serving_ckpt", dest))
    text = load_owl_config(train_yaml)[0].text
    ckpt = CheckpointManager(os.path.join(run_dir, "checkpoints"))
    raw = ckpt.restore_raw(ckpt.latest_step(), map_location="cuda")
    dec = bridge.unflatten({**raw["trainable"], **raw["frozen"]})[
        "text_decoder"]
    del raw
    q, scales = quant.quantize_gpt3_decoder(
        merge_lora(dec, text.lora_rank, text.lora_alpha),
        include_embedding=True)
    del dec
    params = dict(model.named_parameters())
    bad, n_int8 = [], 0
    for path, want in bridge.flatten(q, "text_decoder").items():
        p = params[bridge.port_name(path)]
        n_int8 += p.dtype == torch.int8
        if p.dtype != want.dtype or not torch.equal(p.detach(), want):
            bad.append(path)
    for path, want in bridge.flatten(scales, "text_decoder").items():
        owner, leaf = bridge.port_name(path).rsplit(".", 1)
        if not torch.equal(quant.qscale(model.get_submodule(owner), leaf),
                           want):
            bad.append(path + " scale")
    if bad or n_int8 != 5:
        fail(f"instruct_serving_int8: {n_int8} int8 leaves; differing from "
             f"quantize_gpt3_decoder of the merged checkpoint: {bad[:8]}")
    print(f"[instruct_serving_int8] the export's {n_int8} int8 leaves and "
          f"their scales equal quantize_gpt3_decoder(merge_lora(checkpoint "
          f"step {ckpt.latest_step()})) bitwise, the other decoder leaves "
          f"the merged ones", flush=True)
    del q, scales, params
    gc.collect()
    torch.cuda.empty_cache()
    phase_instruct_forced(model, batch, clips,
                          "instruct_serving_int8 teacher-forced")
    del model, batch, clips
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[instruct_serving_int8] phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


def main():
    # one card: the first visible one (set before CUDA initializes)
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ("0" if visible is None
                                          else visible.split(",")[0])
    sys.path.insert(0, REPO)
    from youku_mplug_tpu_torch.cli import run_instruct, run_pretrain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    card, builds = phase_device_and_build()
    dev = torch.device("cuda")
    report = phase_kernels(dev, builds)
    with tempfile.TemporaryDirectory() as out_dir:
        cfg, model, _ = phase_slice(report, out_dir)
    phase_teacher_forced(cfg, model)
    requests, greedy = phase_caption_modes(report, cfg, model,
                                           FLAGSHIP_YAML, "serve")
    phase_speculative(report, cfg, model, requests, greedy)
    del requests
    with tempfile.TemporaryDirectory() as out_dir:
        phase_serve_imported(report, model, out_dir)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        cfg, model, _ = phase_slice(report, out_dir, INT8KV_YAML,
                                    "serve_int8kv")
    phase_teacher_forced(cfg, model, "int8-KV teacher-forced")
    phase_caption_modes(report, cfg, model, INT8KV_YAML, "serve_int8kv")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        runner, _ = phase_train(report, out_dir)
        phase_replay(runner, run_pretrain.make_batch,
                     run_pretrain.make_loss_fn)
        # phase 12 saves phase 5's state and frees it; the directory with
        # its checkpoint goes when the block ends
        holder = [runner]
        del runner
        cap_dir = phase_caption(report, holder, out_dir)
        gc.collect()
        torch.cuda.empty_cache()
        phase_serve_resumed(report, cap_dir, out_dir)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        phase_downstream(report, out_dir)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        phase_gpt3_27b(report, out_dir)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        model, batch, clips, gen_cfg = phase_instruct(report, out_dir)
    bf16 = phase_instruct_forced(model, batch, clips)
    requests, greedy = phase_instruct_modes(report, model, batch, clips,
                                            gen_cfg, "instruct", "K5-ALiBi")
    phase_lookup(report, model, batch, clips, gen_cfg, requests, greedy)
    del requests
    phase_sampling(report, model, batch, clips)
    del model, batch, clips
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        model, batch, clips, gen_cfg = phase_instruct(
            report, out_dir, OWL_INT8_YAML, "instruct_int8", int8=True)
    phase_instruct_forced(model, batch, clips,
                          "instruct int8 teacher-forced", reference=bf16)
    phase_instruct_modes(report, model, batch, clips, gen_cfg,
                         "instruct_int8", "K5-int8-ALiBi")
    del model, batch, clips, bf16
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        runner, _ = phase_instruct_train(report, out_dir)
        phase_instruct_replay(runner)
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        hf_dir = phase_instruct_hf(report, out_dir)
        run_dir, train_yaml, dest = phase_instruct_hf_train(report, out_dir,
                                                            hf_dir)
        phase_instruct_serving_int8(report, out_dir, run_dir, train_yaml,
                                    dest)
    kernels = []
    for r in report:
        entry = {k: r[k] for k in ("name", "route", "source", "replaces")}
        entry["launches"] = sum(r["launches_by_path"].values())
        entry |= {k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "launches_by_path", "per_shape")}
        if "build" in r:
            entry["build"] = r["build"]
        kernels.append(entry)
    print(f"[done] {time.perf_counter() - t0:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
