"""Smoke check of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line or a few; any failure exits nonzero before
the last line is printed).  A 1200 s limit on the whole run holds the
script to a budget (PERF.md §4): a few phases run a decoder, or the
zoo's tree, cut in depth, each gate taken from the cut's counts: Bloom
at OWL_SERVE_LAYERS of its 30 layers in phases 7, 8, 8a (its sampling on
a full-depth model of its own: a cut seeded Bloom is too peaked to
sample), 8b, 25 and 26;
the 1.3B decoder at GPT13_CUT_LAYERS of 24 in phases 13 and 27
(pretrain13), SERVE_MESH_LAYERS in 40, TRAIN_MESH_LAYERS in 41 and
DOWNSTREAM_MESH_LAYERS in 45, with clip-b16 at DOWNSTREAM_MESH_BLOCKS of
its 12 blocks (it runs whole in 3-6 and 12); the 2.7B at GPT27_LAYERS of 32 in phases 14
and 27; phase 32 over the leaves of ZOO_BLOCKS of the 12 vision blocks;
phase 42's Owl at OWL_MESH_LAYERS of Bloom's 30 layers and OWL_MESH_VIT
of the ViT's 24 blocks.  Where a phase below says "depth", read the cut.

1. device and build: require CUDA (one card: the first visible one),
   print the card's name and power limit, build the hand-written kernels
   from youku_mplug_tpu_torch/csrc/ (one nvcc per source, in parallel);
2. the flash builds (forward, backward dq and dk/dv) at head dims 64,
   80, 88, 96 and 128, and the fp32-output builds at 64 (ring attention's
   partials): registers and spills from nvcc's -Xptxas -v report and
   the blocks resident on one SM as the card counts them
   (cudaOccupancyMaxActiveBlocksPerMultiprocessor), failing on a spill in
   any flash build or on a count other than FWD_BLOCKS_PER_SM (the wave
   the split-KV policy assumes), BWD_BLOCKS_PER_SM or
   F32_OUT_BLOCKS_PER_SM; then
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
   take the key-tile dk/dv kernel, off the paths), the head dim 88 shape
   of EVA-ViT-g's AttentionPool (q [16, 16, 128, 88] over 258 keys, phase
   37's) and the head dim 80 shapes of the GPT-3 2.7B
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
   full width of configs/instruct/serve_bloomz_7b_flagship.yaml
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
   yaml) at full width: clip-b16 (12 blocks, 8 heads of 96, the
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
   versions;
20. files_written (run after phase 2): FILE_CLIPS clips of 10 s at 25
   fps, 640x360, written by cv2 (mp4v in .mp4, else MJPG in .avi; the
   container, codec and backend printed) under a temporary directory on
   as many threads as cores, each frame's index encoded in the grey
   levels of two bands; an annotation file per format (pretrain CSV,
   caption jsonl, three-column cls CSVs, retrieval jsonl, instruct
   jsonl); every clip's ``read_frames(8, middle)`` frames are the
   sampler's indices and within FILE_MAE_TOL of the frames written;
   write s, decode ms a clip on one thread;
21. serve_files (run after phase 4c, on phase 3's model): the serve CLI's
   run on serve_gpt3_1.3B_flagship.yaml with test_file and video_root
   naming the clips: the threaded loader's batches bitwise equal to a
   one-thread pass and each sample the index asked for; 16 requests, K5
   and K6 launches a decode step exact, every result a caption; phase
   4's teacher-forced gate on the first 8 decoded clips; the loader's
   clips/s at 1 thread, the YAML's 4 and one a core;
22. pretrain_files (run after phase 6, on phase 5's runner):
   run_pretrain.build_loader on the pretrain CSV (batch 16, the train
   transform), FILES_TRAIN_STEPS steps with the YAML's 4 decode workers
   as threads, then as many as forked processes: finite, launches per
   step equal to phase 5's; step ms beside phase 5's, ms waited on the
   loader, clips/s;
23. cls_files (run after phase 13): run_cls on
   cls_gpt3_1.3B_youku_v0_sharp_2.yaml with its files the three-column
   CSVs, phase 13's cuts: 2 train steps and the evaluation of a test
   batch (8 calls): every title and label the loaders yield the file's
   (no -1), launches per step and call as phase 13's cls;
24. instruct_files (run after phase 19): run_instruct --engine
   --input_jsonl over FILES_OWL_ROWS rows of the clips and 2 --train
   --train_jsonl LoRA steps, Bloom cut to OWL_CUT: K1, K5-ALiBi (with K6)
   and the ALiBi backward's launches exact, phase 8's teacher-forced gate on the
   decoded clips;
25. instruct_batched (run after phase 8a, on phase 7's bf16 model):
   run_instruct's default path without --engine (generate_batched, i.e.
   models/owl.generate_instruct) on the 16 requests, greedy, 64 new
   tokens, the prompts through a Bloom-form tokenizer.json the script
   trains with ``tokenizers`` (--tokenizer; OWL_TOKENIZER_VOCAB
   entries): K1 once per ViT block and K5 ALiBi (with K6) once per layer
   a decode step, no other kernel; the tokens equal to the engine's on
   the same requests up to each request's first near-tie (as 8a); the
   batched prefill and first FORCED_STEPS steps replayed with the plain
   versions within OWL_REL_TOL; every answer the tokenizer's text, a few
   printed with the share of kept ids inside its vocabulary;
26. instruct_beam and instruct_beam_int8 (after phase 25 on the bf16
   model; after phase 8b on the int8 one): the same path with a YAML copy
   setting beam_size OWL_BEAM (80 cache rows): launches as phase 25 (K5
   int8 ALiBi on the int8 cache), every returned sequence's score against
   its plain rescore within RESCORE_TOL_PER_TOKEN a token, the answers'
   text, host ms a beam step and, traced, device ms a step by category,
   the reorder's ms against its bound, launches and idle share.  Phase 2
   holds K5 ALiBi, bf16 and int8, at the beam step's cache
   [8 of 30 layers, 80, 256, 2x32x128];
27. shipped (after phase 14): phase 13's recipe runs on the shipped YAMLs
   no phase above runs: the reference pretrain recipe at GPT-3 1.3B and
   2.7B (configs/pretrain/gpt3_*/pretrain_gpt3_freezeGPT_youku_v0.yaml:
   clip-b16 at 4 frames, batch 48, the decoders' 0.1 dropouts; 2 steps,
   one K4, dq, dk/dv at d 96 and one delta a step, the replays and the
   dropout law; no evaluation), retrieval at 2.7B (batch 96, no kernel:
   the text tower's 80 tokens at 32 heads of 80 run plain attention, as
   in JAX) and ITM at 2.7B (batch ITM27_BATCH, num_classes 2; its
   evaluation 64 K4 d 80 launches and one K4 d 96 a call), each recipe's
   geometry checked and its cuts printed ([shipped], [pretrain13],
   [pretrain27], [retrieval27], [itm27] lines);
28. knobs_pretrain (run last, with 29-32, after phase 24): the pretrain
   path on configs/pretrain/pretrain_gpt3_1.3B_flagship.yaml with
   lora_rank 8 (GPT-3 adapters), connect_ln, freeze_vit, vision LoRA rank 4 and
   drop-path 0.1, adamp and async_checkpointing: 3 steps, the state of
   step 2 saved asynchronously while step 3 runs, then restored and held
   bitwise to a snapshot taken before step 3; launches per step equal
   phase 5's (K1, K4, dq, dk/dv, delta), the frozen base bitwise
   unchanged, every lora_*_b moved, phase 6's plain replay on the same
   dropout generator;
29. knobs_dropout: the same with vision drop_rate and attn_drop_rate 0.1
   and the decoder's 0.1 dropouts: 2 finite steps, launches per step
   exactly KNOBS_DROPOUT_LAUNCHES (JAX's rule: every vision and decoder
   attention on the plain path, AttentionPool's K4 / K4b alone);
30. knobs_lora_serve: serve --resume on phase 28's run (the adapters
   unmerged inside the decode graph), then cli/export_serving.py merges
   them and the rank-0 model serves: 24 K5 (with K6) a decode step each,
   teacher-forced logits of the two within LOGIT_TOL, greedy tokens
   equal up to near-ties (CAPTION_TIE_GAP);
31. knobs_instruct_train: the instruct-train YAML with Bloom cut to
   OWL_CUT, hidden dropout 0.1, remat "names", ce_chunk a divisor of the
   batch's S, vision LoRA rank 4 and drop-path 0.1, lamb with layer decay
   0.9 over the ViT's 24 blocks and an lr-scale rule: 2 steps;
   K1-ALiBi, dq-ALiBi, dk/dv-ALiBi and K1 launches per step and layer
   equal phase 9's; phase 10's replays;
   the chunked loss against the dense one within CE_CHUNK_TOL;
32. optim_zoo: every zoo name (and lookahead_adamw past its first sync)
   over the flagship's trainable leaves in their JAX shapes (the vision
   tower's first ZOO_BLOCKS blocks), ZOO_UPDATES
   updates in fp32 on the card against the same in fp64 on the CPU (one
   reference a distinct rule): every leaf within ZOO_TOL relative L2, ms
   an update printed;
   [knobs] prints the five phases' total;
33. mplug_pretrain (run last, with 34-35): run_mplug_pretrain's setup,
   train step and momentum update at full width on
   configs/mplug/mplug_vitb16_zh.yaml (the flagship's ViT-B/16 tower, 12
   heads of 64, 8 frames, remat sixth; the Chinese mPLUG BERT: 6 text, 6
   fusion and 12 decoder layers of 768, vocab 21128, dropout 0.1; queues
   of 65536, momentum 0.995, alpha 0.4), MPLUG_PRETRAIN_STEPS steps of 16
   synthetic clips: finite, the queue pointer advanced by 64, the twin
   after the last step equal to e * m + p * (1 - m) within EMA_TOL,
   launches per step exactly JAX's rule (_vision_launches: K1 52, K2/K3
   and delta 24 each), the first batch replayed plain (the same dropout,
   MLM masks, twin features and hard negatives) within REPLAY_LOSS_TOL and
   REPLAY_GRAD_TOL; step ms, clips/s, peak memory;
34. mplug_cls, mplug_retrieval, mplug_caption: run_mplug_downstream on the
   same YAML, BERT_STEPS train steps of 16 clips each (K1 28, K2/K3 and
   delta 24 a step) and the evaluation over BERT_EVAL_CLIPS clips, one call
   of 24 K1: cls 45-way top-1 / top-5, retrieval itm_eval, caption beam 5
   with 20 new tokens (beam tokens/s) and its first batch decoded again
   with the plain K1: tokens equal, or where a clip's differ both beam
   scores under the plain encoder within RESCORE_TOL_PER_TOKEN a token;
35. alpro_pretrain, alpro_cls, alpro_retrieval: run_alpro on
   configs/alpro/alpro_vitb16_zh.yaml (one 12-layer BERT split at layer
   6), as phase 34, the pretrain batch replayed plain with ITM + MLM gated
   and ITA printed (_without_ita); [bert_family] prints the three
   phases' total;
36. image_pretrain (run last, with 37-39, after IMAGE_FILES JPEGs of
   IMAGE_SIZE are written with cv2.imwrite and read back, [images_written]):
   MPLUGVideo.image_pretrain_loss on the flagship pretrain YAML with the
   image tower alone (its ViT-B/16, 12 heads of 64, 197 tokens; 128
   queries; the frozen GPT-3 1.3B with remat and ce_chunk 32), batch 16,
   80 tokens, IMAGE_STEPS AdamW steps through make_train_step over
   ImageTextDataset and the YAML's threaded Loader: finite, none skipped,
   the frozen decoder bitwise unchanged, launches a step exactly
   IMAGE_PRETRAIN_LAUNCHES, the first batch replayed plain (phase 6's
   gates); step ms, images/s, peak memory; phase 2 holds K1 and K2/K3 at
   the tower's [16, 197, 12x64] (coca's too) and K4 / K4b at its
   AttentionPool's [16, 128, 12x64] over 198 keys;
37. eva_pretrain: the same with EVA_VIT_G at full width and depth (1408 x
   40, 16 heads of 88, patch 14, MLP 6144, drop-path 0.4, every block
   checkpointed, ~1.0B trainable parameters), EVA_STEPS steps: launches
   exactly EVA_PRETRAIN_LAUNCHES (K4, dq and dk/dv at head dim 88 once a
   step), the replay on the same drop-path generator; phase 2 holds the
   d 88 kernels at its AttentionPool's [16, 128, 16x88] over 258 keys;
38. coca: MPLUGCOCA at the default COCAConfig (ViT-B/16, two GPT-2 small
   decoders, every leaf trainable, seeded), COCA_STEPS steps over
   ImageTextDataset with MIMPretrainTransform (224 px, the second stream
   at 112, 75 of 196 patches masked), COCA_TOKENS tokens, seeded MIM
   targets [16, 196, 512]: loss_caption finite and 0 < loss_mim < 2.1 each
   step, launches exactly COCA_LAUNCHES, the replay;
39. clip: CLIP (the default CLIPConfig) on 16 of the JPEGs and 16 x 77
   seeded ids, XCLIP over 16 clips of 8 frames at 224: bf16 against fp32
   on the card within CLIP_BF16_TOL, the inflate contract within
   CLIP_INFLATE_TOL, no kernel launched (plain attention, as in JAX);
   [image_family] prints the four phases' total;
40. serve_mesh (run last): the serve CLI under (data, model) splits,
   one ``python -m torch.distributed.run --standalone --nproc_per_node=N
   chip_smoke.py --mesh-rank ...`` a split, each rank running the CLI's
   ``build`` and ``serve_built`` (all that ``python -m
   youku_mplug_tpu_torch.cli.serve`` runs) on a copy of
   serve_gpt3_1.3B_flagship.yaml with its mesh: block set (full width,
   the decoder at SERVE_MESH_LAYERS layers, seeded weights, 16 requests,
   8 slots, greedy): (1,1) with NCCL and
   one rank, (1,2) and (2,2) with gloo, their 2 and 4 ranks on card 0
   (--device cuda:0; gloo copies the collectives through the host, so
   these numbers say nothing of NCCL).  Gates: the merged results cover
   the 16 requests once each; each data rank served its stride of them
   and the model ranks of a data rank decoded the same tokens; each
   rank's launches exactly MESH_LAUNCHES (predicted in PERF.md), no graph
   replay on a model shard; each rank's serve peak memory (after the
   build, whose peak holds the whole model before the shard is kept, and
   is printed beside it) below (1,1)'s.  Then, on the same model, data
   rank 0's ranks replay (1,1)'s 16 served sequences teacher-forced
   (every position, prefill included): query features within QUERY_TOL
   and logits within LOGIT_TOL of (1,1)'s own replay; where a split's
   served tokens leave (1,1)'s, (1,1)'s top-1 - top-2 lead at the first
   divergence within MESH_TIE_BOUND; and they time a decode step of the
   8 slots (host ms over its dispatches, device ms, launches and idle
   share traced on rank 0).  Two NCCL ranks on card 0 must fail with
   NCCL's own error.  Phase 2 holds K1 at the model = 2 shard's local
   heads ([64,197,6x64], [112,112,6x64] period 8), K4 head-major at a
   model = 4 shard's ([64,3,197,64], [112,3,112,64] period 8) and K5 at
   the rank's cache [24,8,256,2x16x64].  On the model shards of the (1,2)
   and (2,2) calls the same model then serves the first
   SPEC_MESH_REQUESTS requests through the CLI's --speculative 4 with
   --draft twin (one layer, the shard of the shallower decoder) and
   --draft ngram: every request once, each data rank its stride, the
   model ranks of a data rank the same tokens, K1 and K4 a rank
   SPEC_MESH_LAUNCHES (K5 on the twin's proposals alone), and the tokens
   the split's greedy ones up to each request's first near-tie
   (CAPTION_TIE_GAP) in the split's plain replay of them.  The twin reads
   the text prompt alone and the target the 128 query features too, so
   on the seeded decoder the caption runs commit one token a round; the
   twin of the whole cut decoder then decodes the text prompt alone
   (k 4, no EOS stop), its rounds committing accepted drafts on the
   shard: more than one token a round, the model ranks of a data rank
   the same tokens ([speculative_mesh <split>] lines).  The same calls
   then run phase 41's and 42's splits (below), so three calls carry
   phases 40-42.
   [serve_mesh <split>] lines;
41. train_mesh (in phase 40's calls): the pretrain CLI's path (run_pretrain's
   setup under torch.distributed.run: init_mesh, the block loader,
   shard_params, the state; common.train_one_epoch) on a copy of
   configs/pretrain/pretrain_gpt3_1.3B_flagship.yaml with its mesh: block
   (full width, the decoder at TRAIN_MESH_LAYERS layers, seeded weights,
   synthetic clips, batch 16, 80 tokens), TRAIN_MESH_STEPS steps of the
   same global batches in each split: (1,1) with NCCL and (1,2) with gloo
   ranks on card 0 in phase 40's own torch.distributed.run calls, after
   their serving (the serving model freed first), then (2,1) in the
   (1,2) call's two ranks (a second mesh over the same group).  Gates: every
   rank's launches exactly TRAIN_MESH_LAUNCHES a step (predicted in
   PERF.md), each step finite and taken; each step's loss within
   REPLAY_LOSS_TOL and grad_norm within TRAIN_MESH_NORM_TOL (relative) of
   (1,1)'s; every trainable leaf after the steps, unsharded, against
   (1,1)'s as the replay gates a gradient (REPLAY_GRAD_TOL with its
   floor), and every leaf's move over the steps against (1,1)'s within
   TRAIN_MESH_MOVE_TOL (floor REPLAY_GRAD_FLOOR x the whole move); (1,2)
   saves its state (every rank gathers, rank 0 writes the unsharded
   file), (2,1) resumes it in a second runner and takes the step (1,1)
   takes next (one step of epoch 1): its loss within REPLAY_LOSS_TOL and
   its update, where the restored Adam moments act, against (1,1)'s
   within TRAIN_MESH_MOVE_TOL.  Printed per rank: peak memory, step ms,
   all_reduces and their bytes a step (gloo's host copies, not NCCL),
   setup, save and rank seconds.
   Phase 2 holds K1, K2/K3 and delta at a model = 2 rank's shapes
   ([128,197,6x64], [224,112,6x64] period 8, [16,208,16x64] causal) and a
   data rank's ([64,197,12x64], [112,112,12x64] period 8, [8,208,32x64]
   causal; K4 / K4b at [8,12,128,64] over 1570 keys), and K4 / K4b
   head-major with the period mask at a model = 4 rank's [224,3,112,64].
   [train_mesh <split>] lines;
42. instruct_mesh (in phase 40's calls, after phase 41's splits): run_instruct
   on mPLUG-Owl at full width (configs/instruct/serve_bloomz_7b_flagship
   .yaml and train_bloomz_7b_flagship.yaml with their mesh: blocks; Bloom
   at OWL_MESH_LAYERS layers, the ViT at OWL_MESH_VIT blocks, seeded
   weights, the tokenizer files of phases 25-26).  Serving at (1,1) NCCL,
   (1,2) and (2,2) gloo: ``run_instruct.build`` once, then
   ``serve_built`` once a run of OWL_MESH_RUNS (the batched path and the
   engine over a bf16 cache, the batched path over an int8 one: the text
   config's kv_cache_dtype swapped on the same weights; the engine with
   --lookup_k 4), OWL_MESH_REQUESTS
   requests of OWL_MESH_NEW tokens, greedy; then data rank 0's ranks
   replay (1,1)'s batched tokens teacher-forced.  Gates: every request
   once, each data rank its stride, the model ranks of a data rank the
   same tokens, no graph replay on a model shard, a rank's launches a run
   K1 OWL_MESH_VIT and K5 ALiBi (int8 ALiBi on the int8 cache) once a
   layer a decode step and no other decode kernel, the merged tokens
   (1,1)'s up to a near-tie (OWL_TIE_REL x (1,1)'s largest replay logit),
   the lookup run's the engine run's of the same split up to a near-tie
   in that split's own plain replay of them (phase 8a's gate), media
   features and logits of the replay within OWL_REL_TOL of (1,1)'s
   largest.  Training: run_instruct --train at (1,1), (1,2), (2,1) (in
   the (1,2) call, resuming (1,2)'s checkpoint) through phase 41's path
   and gates (launches OWL_TRAIN_MESH_LAUNCHES a step; the abstractor's
   k_bias, a zero gradient but for rounding, out of the move gate:
   ZERO_GRADIENT_LEAVES).  Phase 2 holds K5 at a model = 2 rank's heads
   16-31 of 32 ([OWL_MESH_LAYERS,8,256,2x16x128], bf16 and int8), K1 /
   K2/K3 ALiBi at [8,105,16x128] with the slopes 16..31 and K1 at the
   ViT's 8 local heads [64,257,8x64].  [instruct_mesh <split>] and
   [instruct_train_mesh <split>] lines;
43. parallel (in phase 40's (1,2) call, after phase 42's runs, on its
   two gloo ranks on card 0; gated after phase 42): the port's context,
   pipeline and expert parallelism, each part against the same code at
   one rank (no group) in the same processes, forward and backward (a
   loss of the output times fixed bf16 weights), with launches a rank
   exactly as ``parallel_launches`` predicts, no plain or library
   attention (patched to raise), outputs within KERNEL_TOL, outputs and
   gradients within BWD_TOL (relative L2; the ring's within RING_FWD_TOL
   and RING_GRAD_TOL, what its fp32 partials read): ``ring_attention`` at
   sp = 2 on
   SP_SHAPE ([2, 32, 8192, 64] bf16, the GPT-3 1.3B's 32 heads of 64,
   4096 tokens a rank), causal and not, its blocks on K4 and K4b's
   fp32-output builds (the ring's own counter for the forward's K4), the
   partials merged and summed in fp32; ``ulysses_attention`` on the
   same (16 heads a rank over the 8192 tokens, K4 and K4b through
   dot_product_attention); ``gpipe`` at pipe = 2 over the 1.3B decoder's
   24 layers at full width (12 a stage, the port's layer loop, K1 causal
   forward and K2/K3 / delta backward) on 4 microbatches of 4 rows at
   208 tokens, every stage leaf's gradient and the microbatches' held
   against the 24-layer stack; ``MoEMLP`` at ep = 2 (the 1.3B's FFN
   width, M 2048, F 8192, E 8, k 2, capacity factor 1.25, fp32 leaves) on
   [16, 208, 2048] bf16, its experts cut by ``shard_params`` with the
   expert rules, y, aux and the gradients of x and all five leaves (the
   router's whole on each rank) against the whole module.  Per part the
   ms of a forward and backward at P = 2 (both ranks, host clock) and at
   one rank alone, exchanges and all_reduces a rank and their bytes, peak
   memory; phase 2 holds K4 / K4b at the ring's block shapes ([2, 32,
   4096, 64] contiguous, causal and not; the fp32-output builds and the
   bf16 ones against one plain reference with fp32 outputs, the fp32
   builds' gradients within F32_OUT_TOL and each output unrounded, and
   rounding to the bf16 build's, in F32_UNROUNDED_SHARE of its elements)
   and K1 / K2/K3 at GPipe's [4, 208, 32x64].  Two ranks on one card
   under gloo: the exchanges copy
   through the host, so no number here measures NCCL.  [parallel <part>]
   lines;
44. gpt3_13b (run after phase 14): the GPT-3 13B decoder
   (configs/models/config_gpt3_13B.json: 40 layers of hidden 5120, 40
   heads of 128, vocab 51200; GPT13B_LAYERS of its 40; seeded weights) at
   full width.  Serving: phase 3 on a copy of
   serve_gpt3_1.3B_flagship.yaml with the 13B decoder (16 requests, 8
   slots, 32 tokens, k = 1 CUDA graphs; 40 launches a decode step of K5
   at head dim 128 without ALiBi, each with its K6 write, on a [40, 8,
   256, 2x40x128] cache), phase 4's teacher-forced replay with the plain
   versions (its logits within GPT13B_LOGIT_REL_TOL, 2^-5, of their
   largest magnitude), and the served tokens against a
   plain replay of them up to each request's first near-tie
   (CAPTION_TIE_GAP).  Training: the
   pretrain CLI's path at JAX's compile configuration
   (tools/compile_13b.py: the flagship pretrain YAML with the 13B decoder
   frozen, batch GPT13B_BATCH, 80 text tokens, remat, ce_chunk 32), the
   frozen decoder built in bf16 (``common.build_train_model``: no fp32
   copy of its 52 GB), GPT13B_STEPS steps with their launches a step
   exactly GPT13B_TRAIN_LAUNCHES (K1, K2/K3 and delta at d 128 on the
   decoder), finite, the trainable leaves moved, the frozen decoder's
   sums unchanged; phase 6's plain replay of one step.  Printed: tokens/s,
   peak memory of the serve, the setup and the steps, step ms.  Phase 2
   holds K1 / K2/K3 at d 128 at its [4, 208, 40x128] causal and K5 at
   its cache.  [slice gpt3_13b_serve], [gpt3-13B ...] lines;
45. downstream_mesh (in phase 40's (1,1) and (1,2) calls, after phase
   41's splits; gated after phase 41): run_cls, run_retrieval and
   run_retrieval_itm through their own prepare / build_train_step /
   make_batch / evaluation on their shipped YAMLs with a mesh: block at
   full width (clip-b16 768 wide, 8 heads of 96; the 1.3B 2048 wide, 32
   heads of 64; the decoder at DOWNSTREAM_MESH_LAYERS of 24 layers,
   clip-b16 at DOWNSTREAM_MESH_BLOCKS of 12 blocks, seeded weights,
   synthetic clips; the shipped 0.1 decoder dropouts on, run_cls's vision
   rates set to 0.1; ITM at num_classes 2 and batch 32, phase 13's cuts),
   DOWNSTREAM_MESH_STEPS train steps of the same global batches at (1,1)
   NCCL, (1,2) and (2,1) gloo on card 0, then one evaluation (a test
   batch of cls, DOWNSTREAM_MESH_SPLIT clips and texts of retrieval and
   ITM).  Gates: every rank's launches exactly DOWNSTREAM_MESH_LAUNCHES a
   step and an evaluation call (K4 / K4b at d 96 in the cls and ITM
   steps, K1 in the evaluations and the retrieval text tower); phase 41's
   gates on the steps, the leaves and their moves against (1,1)'s; every
   dropout draw's kept elements, summed over the blocks the ranks keep,
   equal to (1,1)'s exactly (the masks are drawn at the global shape);
   the evaluation's scores against (1,1)'s within phase 13's replay
   bounds and its metrics (1,1)'s but where a decision moved at a near
   tie; and AttentionPool's k_bias gradient as the port takes it (-dk of
   the appended bias key) from K4 / K4b at POOL_BIAS_SHAPE, bf16, against
   an fp64 plain reference within POOL_BIAS_TOL (the same gradient as the
   sum of every other key's dk rows printed beside it).  Phase 2 holds
   K4 / K4b d 96 at a (2,1) rank's [16,8,128,96]
   over 1570 keys and K1 at a model = 2 rank's [180,208,16x64],
   [32,208,16x64], [96,80,16x64] and a (2,1) rank's [48,80,32x64].
   [downstream_mesh <recipe> <split>] lines.
[time] lines give the script's seconds after each group of phases.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
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
# the fp32-output builds (ring attention's block partials): each output
# (o, dq, dk, dv) carries bits below bf16's in at least
# F32_UNROUNDED_SHARE of its elements (a share of elements that differ
# from their own bf16 rounding: 0 for an output rounded to bf16 on its
# way out) and rounds, in that share, to the bf16 build's output on the
# same inputs (the same tiles; only the epilogue's stores differ); the
# gradients' relative L2 against the fp32 plain reference within
# F32_OUT_TOL (H100 runs read 3.2e-5 to 4.3e-5, PERF.md §6; a bf16-rounded
# output reads ~1.7e-3; the forward's P is rounded to bf16 against a
# running maximum in the kernel and against the final one in the plain
# version, so its o differs by bf16 noise and keeps KERNEL_TOL)
F32_UNROUNDED_SHARE = 0.99
F32_OUT_TOL = 2.0 ** -12
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
# floor holds a leaf whose gradient is tiny against the whole to an
# absolute bound (AttentionPool's k_bias: the softmax ignores a shift of
# every key, so only the appended bias key's score moves it).
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
# the BERT family (phases 33-35): mPLUG and ALPRO at full width on the
# flagship's vision tower, batch 16, synthetic clips; train steps a run
# (pretrain: MPLUG_PRETRAIN_STEPS), the evaluations' clips (one call)
# phases 36-39 (the image-era family): the JPEGs (written with
# cv2.imwrite, read back within IMAGE_MAE_TOL a channel: JPEG's loss on
# the smooth stripes they hold), the train steps of each path and the
# launches a step JAX's dispatch rule predicts (PERF.md): the
# flagship's ViT-B/16 as an image tower (12 heads of 64: K1 per block,
# again in the backward's recompute, as JAX remats every PlainBlock under
# grad_ckpt), AttentionPool's K4 / K4b at 64, the frozen GPT-3 1.3B's K1
# 24 + 24 rematerialized and K2/K3 24; EVA-ViT-g's blocks on einsum
# attention (16 heads of 88: no packed kernel), its AttentionPool on K4 /
# K4b at 88; COCA's ViT-B/16 twice a forward (the MIM branch runs the
# tower again, as JAX) with the GPT-2 decoders on plain attention
IMAGE_FILES = 64
IMAGE_SIZE = (640, 360)  # width, height
IMAGE_MAE_TOL = 6.0
IMAGE_STEPS = 4
EVA_STEPS = 3
COCA_STEPS = 3
COCA_TOKENS = 40
IMAGE_PRETRAIN_LAUNCHES = {"K1": 72, "K4": 1, "dq": 37, "dkv": 37,
                           "delta": 37}
EVA_PRETRAIN_LAUNCHES = {"K1": 48, "dq": 24, "dkv": 24, "K4-d88": 1,
                         "dq-d88": 1, "dkv-d88": 1, "delta": 25}
COCA_LAUNCHES = {"K1": 24, "dq": 24, "dkv": 24, "delta": 24}
IMAGE_TRAIN_PATHS = ("image_pretrain", "eva_pretrain", "coca")
# CLIP / XCLIP in bf16 (the policy's compute dtype) against the same
# weights in fp32, relative L2 of image / video features and logits: only
# the patches, conv1 and ln_pre run bf16 (every Dense promotes to its fp32
# kernel, as in JAX), so the difference is that rounding (~2^-8) carried
# through 12 blocks, read at 0.0012-0.0037 on the card (PERF.md); the text
# towers run fp32 under both policies, so they are not compared; the
# inflated VideoFormer against per-frame CLIP, both fp32
CLIP_BF16_TOL = 2.0 ** -6
CLIP_INFLATE_TOL = 1e-4
MPLUG_YAML = os.path.join(REPO, "configs", "mplug", "mplug_vitb16_zh.yaml")
ALPRO_YAML = os.path.join(REPO, "configs", "alpro", "alpro_vitb16_zh.yaml")
MPLUG_PRETRAIN_STEPS, BERT_STEPS, BERT_EVAL_CLIPS = 4, 2, 16
# the EMA twin after a step against e * m + p * (1 - m) computed apart
# (the same fp32 products and sum)
EMA_TOL = 1e-6
# the GPT-3 2.7B recipes (phase 14) and their cuts
CAPTION27_YAML = os.path.join(REPO, "configs", "caption",
                              "caption_gpt3_2.7B_youku_v0.yaml")
CLS27_YAML = os.path.join(REPO, "configs", "cls",
                          "cls_gpt3_2.7B_youku_v0_sharp_2.yaml")
# the script's budget (PERF.md §4): decoders cut in depth where a phase
# holds a path another phase runs at full depth (the 1.3B decoder's 24
# layers in phases 5-6, the 2.7B's in none: its kernels are the same at
# any depth), each gate kept with its counts taken from the cut
GPT27_LAYERS = 4         # of 32: phases 14 and 27
GPT13_CUT_LAYERS = 6     # of 24: phases 13 and 27 (pretrain13)
SERVE_MESH_LAYERS = 2    # of the 1.3B's 24: phase 40
TRAIN_MESH_LAYERS = 2    # of the 1.3B's 24: phase 41
OWL_SERVE_LAYERS = 6     # of Bloom's 30: phases 7, 8, 8a, 8b, 25, 26
ZOO_BLOCKS = 1           # of the vision tower's 12: phase 32's leaves
CAPTION27_CUTS = {"max_new_tokens": 32, "synthetic_length": 48,
                  "text_overrides": {"num_hidden_layers": GPT27_LAYERS}}
CLS27_CUTS = {"eval_video_batch": DOWNSTREAM_EVAL_CLIPS,
              "synthetic_length": 64,
              "text_overrides": {"num_hidden_layers": GPT27_LAYERS}}
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
# the spin that holds the device while ``time_ms`` enqueues its calls:
# SPIN_HOST_FACTOR times the host's time a call, as the warm-up calls
# measured it, and at least SPIN_MS_PER_CALL a call (several times a
# wrapper's host time a call: K5's 0.04-0.08 ms, phase 2), at the H100's
# 1.98 GHz boost clock (longer at a lower clock); never more than
# SPIN_MAX_S in all (a call that waits on the device gains nothing)
SPIN_MS_PER_CALL = 0.5
SPIN_HOST_FACTOR = 4
SPIN_MAX_S = 1.0
SPIN_CLOCK_HZ = 1.98e9
# the H100 SXM's published dense bf16 and int8 tensor-core rates, fp32
# rate outside the tensor cores and HBM3 bandwidth (the bounds in the
# kernel report)
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# the video files of phases 20-24: FILE_CLIPS clips of FILE_SECONDS s at
# FILE_FPS frames a second, FILE_SIZE (w, h), a common web rendition,
# written by cv2 as mp4v (Motion-JPEG .avi where the build cannot read
# that back); a frame's bands encode its index in two base-16 digits 16
# grey levels apart (mp4v moves them by at most ~4); a decoded frame's
# mean absolute error against the written one (2.5 on the textured frames
# with cv2 5.0's encoder) within FILE_MAE_TOL
FILE_CLIPS, FILE_SECONDS, FILE_FPS, FILE_SIZE = 64, 10, 25, (640, 360)
FILE_MAE_TOL = 6.0
FILE_BAND_ROWS = 24
FILES_TRAIN_STEPS = 8   # pretrain_files: the CSV's 128 rows at batch 16
FILES_OWL_ROWS, FILES_OWL_TRAIN_STEPS = 8, 2
# the batched instruct path (phases 25-26): beam 5 over the 16 requests
# (80 cache rows), the prompts through a Bloom-form tokenizer.json the
# script trains (byte-level BPE of OWL_TOKENIZER_VOCAB entries; BloomZ's
# own files are not in the repository)
OWL_BEAM = 5
OWL_TOKENIZER_VOCAB = 1024
OWL_TOKENIZER_CORPUS = (
    "The following is a conversation between a curious human and AI "
    "assistant. The assistant gives helpful, detailed, and polite answers "
    "to the user's questions.",
    "Human: What is in the video?", "AI: a man is playing the guitar on "
    "the stage while people dance .", "Describe the scene in detail.",
    "Who is speaking? Is it day or night? What colour is the car?",
    "How many people are there? Where was this filmed?",
    "一只猫在沙发上睡觉", "两个人在公园里跑步", "视频里有什么？这是在哪里拍摄的？",
    "小狗在草地上追逐皮球，孩子们在旁边笑。")
# the shipped recipes not run above (phase 27): the reference pretrain
# recipe at GPT-3 1.3B and 2.7B, dual-encoder retrieval and ITM rerank at
# 2.7B; their cuts: the synthetic sets sized for DOWNSTREAM_STEPS train
# batches and the evaluations, ITM's 2-way match head and ITM27_BATCH
# clips a step for the YAML's 96 (phase 13 already needed 32 at 1.3B)
PRETRAIN13_REF_YAML = os.path.join(REPO, "configs", "pretrain", "gpt3_1.3B",
                                   "pretrain_gpt3_freezeGPT_youku_v0.yaml")
PRETRAIN27_YAML = os.path.join(REPO, "configs", "pretrain", "gpt3_2.7B",
                               "pretrain_gpt3_freezeGPT_youku_v0.yaml")
RETRIEVAL27_YAML = os.path.join(REPO, "configs", "retrieval",
                                "retrieval_gpt3_2.7B_youku_v0.yaml")
ITM27_YAML = os.path.join(REPO, "configs", "retrieval",
                          "retrieval_itm_gpt3_2.7B_youku_v0.yaml")
ITM27_BATCH = 16


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def time_ms(fn, iters: int) -> float:
    """Device ms per call.  A spin kernel holds the device while the host
    enqueues the calls (SPIN_HOST_FACTOR x the slower of the last two
    warm-up calls' host time, at least SPIN_MS_PER_CALL, a call; at most
    SPIN_MAX_S), so the events time them back to back and not the host's
    launch rate (which bounds small kernels on a slow host)."""
    fn()
    torch.cuda.synchronize()
    host_s = 0.0
    for _ in range(2):
        t0 = time.perf_counter()
        fn()
        host_s = max(host_s, time.perf_counter() - t0)
    spin_ms = max(SPIN_MS_PER_CALL, SPIN_HOST_FACTOR * host_s * 1e3)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(min(max(iters, 4) * spin_ms * 1e-3, SPIN_MAX_S)
                          * SPIN_CLOCK_HZ))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ms_blocks(fn, iters: int, blocks: int = 2):
    """``time_ms`` over ``blocks`` blocks of ``iters`` calls: the lowest
    reading and every block's (a stall inside one block shows as their
    spread instead of as the kernel's time)."""
    readings = [time_ms(fn, iters) for _ in range(blocks)]
    return min(readings), readings


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
    for the backward's dq and dk/dv kernels, and the same for the
    fp32-output builds (``<d,f32>`` rows).  Fails if any flash build
    spills, if the forward's count is not FWD_BLOCKS_PER_SM (the wave
    kv_splits sizes its splits by), the backward's not BWD_BLOCKS_PER_SM
    or the fp32-output builds' not F32_OUT_BLOCKS_PER_SM."""
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
    got_f32 = {}
    for d in fa.F32_OUT_HEAD_DIMS:
        for kind in ("fwd", "bwd_dq", "bwd_dkv"):
            u = builds.get(f"flash_{kind}<{d},plain,f32>")
            if u is None:
                fail(f"no -Xptxas -v report for flash_{kind}<{d},plain,f32>")
            out[f"{kind}<{d},f32>"] = {**u}
        got_f32[d] = fa.f32_out_blocks_per_sm(d)
        for kind, n in zip(("fwd", "bwd_dq", "bwd_dkv"), got_f32[d]):
            out[f"{kind}<{d},f32>"]["blocks_per_sm"] = n
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
    if got_f32 != fa.F32_OUT_BLOCKS_PER_SM:
        fail(f"fp32-output builds (forward, dq, dk/dv) blocks an SM "
             f"{got_f32} != F32_OUT_BLOCKS_PER_SM "
             f"{fa.F32_OUT_BLOCKS_PER_SM}")
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


def _attn_bounds(fa, b, h, sq, sk, d, causal, period, kv_len, out_bytes=2):
    """Bounds of the forward, the dq kernel and the dk/dv kernel on these
    inputs: the products over the (query, key) pairs the mask leaves
    (QK^T and PV forward; S, dP and dQ for dq; S^T, dP^T, dV and dK for
    dk/dv; 2 operations per multiply-add), each bf16 operand read once
    and each output written once (``out_bytes`` an element: 4 for the
    fp32-output builds), lse and delta in fp32."""
    pairs = b * h * int(fa._allowed(sq, sk, causal=causal, period=period,
                                    kv_len=kv_len, device="cpu").sum())
    row = 2 * d * b * h  # bytes of one bf16 row over all (sample, head)
    out = row * out_bytes // 2  # ... of one output row
    stat = 4 * b * h * sq
    return {"fwd": _bound(4 * pairs * d,
                          row * (sq + 2 * sk) + out * sq + stat),
            "dq": _bound(6 * pairs * d,
                         row * (2 * sq + 2 * sk) + out * sq + 2 * stat),
            "dkv": _bound(8 * pairs * d,
                          row * (2 * sq + 2 * sk) + out * 2 * sk
                          + 2 * stat)}


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
              d=64, alibi=False, path="train", on_path=True, f32=False):
    """One training-shape check, in the layouts the model hands the
    kernels (packed slices of one qkv projection, head views of Bloom's
    head-major fused projection, or head views of AttentionPool's
    projections); ``alibi``: True for the ladder of the n heads, or
    (offset, total) for a model shard's heads offset .. offset + n - 1
    of the ladder of total: the forward kernel's o and lse against
    flash_fwd_plain, then the dq and dk/dv kernels against
    flash_bwd_plain on the same (q, k, v, o, lse, dO); all with the
    kernel's (the lower of two blocks of calls, both printed), the plain
    version's and the library call's times and the bound.  ``f32``:
    the plain versions once with fp32 outputs (``out_dtype``), the
    reference of the bf16 kernels and of the fp32-output builds alike,
    which are checked and timed too (rows ``fwd_f32``, ``dq_f32`` and
    ``dkv_f32``; ring attention's block partials)."""
    from youku_mplug_tpu_torch.ops import decode_attention as dec

    nd = n * d
    if layout == "packed":
        qkv = rand(b, sq, 3 * nd)
        parts = [qkv[..., :nd], qkv[..., nd:2 * nd], qkv[..., 2 * nd:]]
        parts = [t.unflatten(-1, (n, d)) for t in parts]
    elif layout == "head-major":
        qkv5 = rand(b, sq, n, 3, d)
        parts = [qkv5[..., i, :] for i in range(3)]
    elif layout == "bhsd":  # contiguous [B, H, S, D], the ring's blocks
        parts = [rand(b, n, s, d).transpose(1, 2) for s in (sq, sk, sk)]
    else:
        parts = [rand(b, s, nd).unflatten(-1, (n, d))
                 for s in (sq, sk, sk)]
    q, k, v = (t.transpose(1, 2) for t in parts)
    off, total = alibi if isinstance(alibi, tuple) else (0, n)
    slopes = (torch.from_numpy(dec.alibi_slopes(total)[off:off + n]).to(
        q.device) if alibi else None)
    kw = dict(scale=d ** -0.5, causal=causal, period=period, kv_len=kv_len,
              alibi_slopes=slopes)
    plain_kw = dict(kw, out_dtype=torch.float32 if f32 else None)
    shape = (f"[{b},{sq},{n}x{d}] kv {sk}"
             + (" causal" if causal else "") + (" ALiBi" if alibi else "")
             + (f" heads {off}-{off + n - 1} of {total}" if off else "")
             + (f" period {period}" if period else "")
             + (f" kv_len {kv_len}" if kv_len is not None else "")
             + f" {layout} ({path})")
    bounds = _attn_bounds(fa, b, n, sq, sk, d, causal, period, kv_len)
    mask_kw = _sdpa_kwargs(fa, q, k, causal, period, kv_len, slopes)
    o = fa._head_major_empty(q)
    lse = fa.flash_fwd_cuda(q, k, v, o, **kw)
    want_o, want_lse = fa.flash_fwd_plain(q, k, v, **plain_kw)
    fwd_err, lse_err = err(o, want_o), err(lse, want_lse)
    if not (within(o, want_o) and lse_err <= LSE_TOL):
        fail(f"forward {shape}: max err {fwd_err} (tol {KERNEL_TOL}), lse "
             f"{lse_err} (tol {LSE_TOL})")
    do = fa._head_major_empty(q).copy_(rand(b, n, sq, d))
    lib_fwd, lib_bwd = _library_ms(q, k, v, mask_kw, do)
    fwd_ms, fwd_blocks = time_ms_blocks(
        lambda: fa.flash_fwd_cuda(q, k, v, o, **kw), 20)
    fwd = {"shape": shape, "on_path": on_path, "max_abs_err": fwd_err,
           "lse_err": lse_err,
           "splits": fa.kv_splits(b, n, sq, sk, head_dim=d, causal=causal,
                                  period=period, kv_len=kv_len,
                                  sms=fa._device_sms(q.device.index)),
           "ms": fwd_ms, "ms_blocks": fwd_blocks,
           "plain_ms": time_ms(lambda: fa.flash_fwd_plain(q, k, v,
                                                          **plain_kw), 20),
           "library_ms": lib_fwd, **bounds["fwd"]}
    delta = fa.flash_bwd_delta_plain(o, do)
    got_delta = fa.flash_bwd_delta_cuda(o, do)
    e_delta = rel_l2(got_delta, delta)
    if not e_delta <= DELTA_TOL:
        fail(f"delta {shape}: relative L2 {e_delta} (tol {DELTA_TOL})")
    got = fa.flash_bwd_cuda(q, k, v, o, lse, do, **kw)
    want = fa.flash_bwd_plain(q, k, v, o, lse, do, **plain_kw)
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
    dq_ms = time_ms_blocks(lambda: fa.flash_bwd_dq_cuda(
        q, k, v, do, lse, delta, dq, **kw), iters)
    dkv_ms = time_ms_blocks(lambda: fa.flash_bwd_dkv_cuda(
        q, k, v, do, lse, delta, dk, dv, **kw), iters)
    plain_ms = time_ms(lambda: fa.flash_bwd_plain(q, k, v, o, lse, do,
                                                  **plain_kw), iters)

    def bwd_row(kind, timed, grads):
        return {"shape": shape, "on_path": on_path,
                "rel_l2": {gn: errs[gn] for gn in grads},
                "max_abs_err": max(abs_err[gn] for gn in grads),
                "ms": timed[0], "ms_blocks": timed[1],
                "plain_ms": plain_ms, "library_ms": lib_bwd,
                **bounds[kind]}

    rows = b * n * sq
    out = {}
    if f32:
        out = _f32_rows(fa, q, k, v, do, lse, got_delta, kw, shape,
                        on_path, want_o, want_lse, want, o, got,
                        fwd["plain_ms"],
                        plain_ms,
                        _attn_bounds(fa, b, n, sq, sk, d, causal, period,
                                     kv_len, out_bytes=4), iters)
    return {"layout": layout, "fwd": fwd, **out,
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


def _unrounded(x32: torch.Tensor, x16: torch.Tensor) -> dict:
    """Of an fp32 output: the share of its elements that differ from
    their own bf16 rounding, and the share whose bf16 rounding is the
    bf16 build's output ``x16`` on the same inputs."""
    r = x32.to(torch.bfloat16)
    return {"unrounded": (r.float() != x32).float().mean().item(),
            "rounds_to_bf16_build": (r == x16).float().mean().item()}


def _f32_rows(fa, q, k, v, do, lse, delta, kw, shape, on_path, want_o,
              want_lse, want, o16, got16, fwd_plain_ms, bwd_plain_ms,
              bounds, iters):
    """The fp32-output forward, dq and dk/dv kernels on ``_bwd_case``'s
    inputs (``delta`` the delta kernel's, as the bf16 builds' backward
    had it) against its fp32 plain outputs (``want_o``, ``want_lse``,
    ``want``: the same reference as the bf16 builds'), checked as those
    are (forward elementwise KERNEL_TOL, lse LSE_TOL), the gradients'
    relative L2 within F32_OUT_TOL, and each output unrounded and
    rounding to the bf16 build's (``o16``, ``got16``) in
    F32_UNROUNDED_SHARE of its elements; and timed.  The plain times are
    ``_bwd_case``'s (the same calls), no library call computes an fp32
    output from bf16 inputs."""
    o32 = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse32 = fa.flash_fwd_cuda(q, k, v, o32, **kw)
    e_o, e_lse = err(o32, want_o), err(lse32, want_lse)
    if not (within(o32, want_o) and e_lse <= LSE_TOL):
        fail(f"fp32-output forward {shape}: max err {e_o} (tol "
             f"{KERNEL_TOL}), lse {e_lse} (tol {LSE_TOL})")
    dq, dk, dv = (torch.empty(t.shape, dtype=torch.float32, device=t.device)
                  for t in (q, k, v))
    fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, dq, **kw)
    fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, dk, dv, **kw)
    torch.cuda.synchronize()
    got = dict(zip(("dq", "dk", "dv"), (dq, dk, dv)))
    errs = {gn: rel_l2(got[gn], w) for gn, w in zip(got, want)}
    abs_err = {gn: err(got[gn], w) for gn, w in zip(got, want)}
    if max(errs.values()) > F32_OUT_TOL or not all(
            torch.isfinite(g).all() for g in got.values()):
        fail(f"fp32-output backward {shape}: relative L2 {errs} (tol "
             f"{F32_OUT_TOL})")
    shares = {name: _unrounded(x32, x16) for name, x32, x16 in zip(
        ("o", "dq", "dk", "dv"), (o32, dq, dk, dv), (o16, *got16))}
    if min(min(sh.values()) for sh in shares.values()) < F32_UNROUNDED_SHARE:
        fail(f"fp32-output builds {shape}: shares unrounded and rounding "
             f"to the bf16 build's {shares} (at least "
             f"{F32_UNROUNDED_SHARE})")
    fwd_ms = time_ms_blocks(lambda: fa.flash_fwd_cuda(q, k, v, o32, **kw),
                            iters)
    dq_ms = time_ms_blocks(lambda: fa.flash_bwd_dq_cuda(
        q, k, v, do, lse, delta, dq, **kw), iters)
    dkv_ms = time_ms_blocks(lambda: fa.flash_bwd_dkv_cuda(
        q, k, v, do, lse, delta, dk, dv, **kw), iters)
    shape = shape + " fp32 out"

    def row(kind, timed, grads, plain):
        return {"shape": shape, "on_path": on_path,
                **({"rel_l2": {gn: errs[gn] for gn in grads}} if grads
                   else {"lse_err": e_lse}),
                "shares": {n: shares[n] for n in (grads or ("o",))},
                "max_abs_err": (max(abs_err[gn] for gn in grads) if grads
                                else e_o),
                "ms": timed[0], "ms_blocks": timed[1], "plain_ms": plain,
                "library_ms": None, **bounds[kind]}
    return {"fwd_f32": row("fwd", fwd_ms, (), fwd_plain_ms),
            "dq_f32": row("dq", dq_ms, ("dq",), bwd_plain_ms),
            "dkv_f32": row("dkv", dkv_ms, ("dk", "dv"), bwd_plain_ms)}


# (rows, Sq, Sk, heads, causal, period, kv_len, layout, head dim, ALiBi,
# path, on the path); the first four are the flagship train step's shapes
# (16 clips x 8 frames; 16 clips x 14 temporal groups; 16 x (128 queries
# + 80 tokens), the frozen decoder of the image paths too; AttentionPool's
# 128 queries over 1 + 8 x 196 tokens and the bias key), then the image
# paths' ViT-B/16 over 16 images (197 tokens) and their AttentionPool's
# 128 queries over 1 + 196 tokens and the bias key (4 key tiles, the last
# holding 6 keys), then a small kv_len case
BWD_SHAPES = [(128, 197, 197, 12, False, 0, None, "packed"),
              (224, 112, 112, 12, False, 8, None, "packed"),
              (16, 208, 208, 32, True, 0, None, "packed", 64, False,
               "train, image_pretrain, eva_pretrain", True),
              (16, 128, 1570, 12, False, 0, None, "heads"),
              (16, 197, 197, 12, False, 0, None, "packed", 64, False,
               "image_pretrain, coca", True),
              (16, 128, 198, 12, False, 0, None, "heads", 64, False,
               "image_pretrain", True),
              (2, 65, 130, 1, False, 0, 70, "heads", 64, False, "train",
               False)]
# phase 41's local shapes: a model = 2 rank's 6 vision heads (spatial,
# temporal period 8) and 16 decoder heads over the 16 clips; a data rank's
# 8 clips at every head (AttentionPool's 128 queries over 1570 keys
# included); and the head-major route of a model = 4 rank's 3 vision
# heads under the period mask (K4 and K4b; the CPU tests run model = 4)
TRAIN_MESH_SHAPES = [
    (128, 197, 197, 6, False, 0, None, "packed", 64, False,
     "train_mesh_1x2", True),
    (224, 112, 112, 6, False, 8, None, "packed", 64, False,
     "train_mesh_1x2", True),
    (16, 208, 208, 16, True, 0, None, "packed", 64, False,
     "train_mesh_1x2", True),
    (64, 197, 197, 12, False, 0, None, "packed", 64, False,
     "train_mesh_2x1", True),
    (112, 112, 112, 12, False, 8, None, "packed", 64, False,
     "train_mesh_2x1", True),
    (8, 208, 208, 32, True, 0, None, "packed", 64, False,
     "train_mesh_2x1", True),
    (8, 128, 1570, 12, False, 0, None, "heads", 64, False,
     "train_mesh_2x1", True),
    (224, 112, 112, 3, False, 8, None, "heads", 64, False,
     "model = 4 shard, head-major with the period mask", False)]
# phase 43: ring attention's K/V blocks at sp = 2 (contiguous [2, 32,
# 4096, 64], the 1.3B's heads over 4096 tokens a rank: the diagonal block
# causal, an earlier rank's unmasked; K4 forward and K4b backward, the
# ring's own wrapper counting the forward), Ulysses' 16 heads a rank over
# the whole 8192 tokens (contiguous [2, 16, 8192, 64] after its
# all_to_all, causal and not; K4 through flash_attention and K4b), and
# GPipe's microbatch of 4 rows through a 1.3B decoder layer (K1 causal
# and its backward); the ring's blocks run the fp32-output builds on the
# path (their bf16 builds beside them, held to the one fp32 reference)
RING_SHAPES = [
    (2, 4096, 4096, 32, True, 0, None, "bhsd", 64, False, "ring_sp2", True,
     True),
    (2, 4096, 4096, 32, False, 0, None, "bhsd", 64, False, "ring_sp2",
     True, True)]
ULYSSES_SHAPES = [
    (2, 8192, 8192, 16, True, 0, None, "bhsd", 64, False, "ulysses_sp2",
     True),
    (2, 8192, 8192, 16, False, 0, None, "bhsd", 64, False, "ulysses_sp2",
     True)]
PARALLEL_SHAPES = [
    (4, 208, 208, 32, True, 0, None, "packed", 64, False, "gpipe_pipe2",
     True)]
# Bloom's training attention, ALiBi causal at head dim 128 on head views
# of the head-major fused projection: the instruct-train step's [8, 105,
# 32x128] (a 99-token prompt with the 65 media positions, 5 answer words
# and eos: a ragged second tile), the YAML's max_length 768 (12 causal
# tiles, biases up to ~645), 40 heads (the half-step ladder), ALiBi at
# d = 64 (packed); the d = 128 build without ALiBi: D128_SHAPES
ALIBI_SHAPES = [
    (8, 105, 105, 32, True, 0, None, "head-major", 128, True,
     "instruct_train", True),
    (2, 768, 768, 32, True, 0, None, "head-major", 128, True,
     "max_length", False),
    (2, 256, 256, 40, True, 0, None, "head-major", 128, True, "40 heads",
     False),
    (2, 208, 208, 32, True, 0, None, "packed", 64, True, "d 64", False),
    # phase 42: a model = 2 rank's 16 heads, the second half of the
    # ladder of 32 (its slopes 16..31)
    (8, 105, 105, 16, True, 0, None, "head-major", 128, (16, 32),
     "instruct_train_mesh_1x2", True)]

# the GPT-3 13B decoder's training attention, causal at head dim 128
# without ALiBi on packed slices of its qkv row: the pretrain step's 4
# clips x (128 queries + 80 tokens), 40 heads (phase 44)
D128_SHAPES = [
    (4, 208, 208, 40, True, 0, None, "packed", 128, False, "gpt3_13b_train",
     True)]


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
    # the reference pretrain recipe's 48 clips x 4 frames (1.3B and 2.7B)
    # and the ITM 2.7B step's 16 clips x 4 frames (phase 27)
    (48, 128, 786, 8, False, 0, None, "heads", 96, False,
     "pretrain13_train, pretrain27_train", True),
    (16, 128, 786, 8, False, 0, None, "heads", 96, False,
     "itm27_train, itm_mesh_2x1_train", True),
    # phase 45's (2,1) data rank of the cls step: 16 of its 32 clips
    (16, 128, 1570, 8, False, 0, None, "heads", 96, False,
     "cls_mesh_2x1_train", True),
    # more than 128 queries (ragged keys, kv_len < Sk): the key-tile dk/dv
    # kernel, which no path runs at d 96
    (4, 256, 1570, 8, False, 0, 1500, "heads", 96, False, "key-tile dk/dv",
     False)]
# head dim 88, EVA-ViT-g's AttentionPool (16 heads of 88, 128 queries over
# 1 + 256 patches and the bias key, head views of [B, S, 1408]
# projections) at the image pretrain step's 16 images: forward, dq and
# the key-tile dk/dv kernel (no short-query build at 88)
D88_SHAPES = [
    (16, 128, 258, 16, False, 0, None, "heads", 88, False, "eva_pretrain",
     True)]
# phase 45: each downstream recipe under each split, its train steps and
# its evaluation, one path each ("cls_mesh_1x2_train", ...)
DOWNSTREAM_MESH_TAGS = ("1x1", "1x2", "2x1")


def _ds_mesh_paths(kinds, part):
    return tuple(f"{k}_mesh_{t}_{part}" for k in kinds
                 for t in DOWNSTREAM_MESH_TAGS)


D96_PATHS = ("cls_train", "cls_eval", "itm_train", "itm_eval",
             "caption27_train", "caption27_eval", "cls27_train", "cls27_eval",
             "cls_files_train", "cls_files_eval", "pretrain13_train",
             "pretrain27_train", "itm27_train", "itm27_eval") \
    + _ds_mesh_paths(("cls", "itm"), "train") \
    + _ds_mesh_paths(("cls", "itm"), "eval")
D96_TRAIN_PATHS = ("cls_train", "itm_train", "caption27_train", "cls27_train",
                   "cls_files_train", "pretrain13_train", "pretrain27_train",
                   "itm27_train") + _ds_mesh_paths(("cls", "itm"), "train")
# the paths of the checkpoint phases (15-19): caption serving with the
# imported and the resumed weights; Owl serving from the HF import, its
# LoRA training and the int8 serving export
CKPT_SERVE_PATHS = ("serve_imported", "serve_resumed")
# phase 40: the serve CLI under torch.distributed.run, one path a split
MESH_PATHS = ("serve_mesh_1x1", "serve_mesh_1x2", "serve_mesh_2x2")
# ... and its --speculative runs on a model shard, one path a draft and
# split (prompt lookup proposes without a draft: no decode kernel)
SPEC_TWIN_MESH_PATHS = ("speculative_twin_mesh_1x2",
                        "speculative_twin_mesh_2x2")
SPEC_MESH_PATHS = SPEC_TWIN_MESH_PATHS + ("speculative_ngram_mesh_1x2",
                                          "speculative_ngram_mesh_2x2")
# phase 44: the GPT-3 13B decoder's pretrain step and caption serving
GPT13B_PATHS = ("gpt3_13b_train", "gpt3_13b_serve")
# phase 41: the pretrain step under a split, one path a split
TRAIN_MESH_PATHS = ("train_mesh_1x1", "train_mesh_1x2", "train_mesh_2x1")
# phase 42: run_instruct under a split, serving (every run of a split's
# torch.distributed.run one path) and LoRA training, one path a split
OWL_MESH_PATHS = ("instruct_mesh_1x1", "instruct_mesh_1x2",
                  "instruct_mesh_2x2")
OWL_TRAIN_MESH_PATHS = ("instruct_train_mesh_1x1", "instruct_train_mesh_1x2",
                        "instruct_train_mesh_2x1")
# the batched instruct path (phases 25-26): greedy, beam bf16, beam int8
OWL_BATCHED_PATHS = ("instruct_batched", "instruct_beam",
                     "instruct_beam_int8")
CKPT_OWL_PATHS = ("instruct_hf", "instruct_hf_train",
                  "instruct_serving_int8")
# phases 28-31: the training knobs' paths (phase 29 runs no K1: attention
# dropout takes every vision and decoder attention off the kernels)
KNOBS_SERVE_PATHS = ("knobs_lora_serve", "knobs_lora_serve_merged")
KNOBS_TRAIN_PATHS = ("knobs_pretrain", "knobs_dropout")
# phases 33-35, the BERT family's paths: its train steps (K1 forward and
# rematerialized, K2/K3 and delta backward; mPLUG pretrain's EMA twin
# forward too) and evaluations (K1)
BERT_TRAIN_PATHS = ("mplug_pretrain", "mplug_cls_train",
                    "mplug_retrieval_train", "mplug_caption_train",
                    "alpro_pretrain", "alpro_cls_train",
                    "alpro_retrieval_train")
BERT_EVAL_PATHS = ("mplug_cls_eval", "mplug_retrieval_eval",
                   "mplug_caption_eval", "alpro_cls_eval",
                   "alpro_retrieval_eval")
# every path that runs a flash backward (the delta kernel's)
BWD_PATHS = ("train", "caption_train", "instruct_train",
             "instruct_hf_train", "pretrain_files", "cls_files_train",
             "instruct_files_train", "knobs_instruct_train") \
    + D96_TRAIN_PATHS + KNOBS_TRAIN_PATHS + BERT_TRAIN_PATHS \
    + IMAGE_TRAIN_PATHS + TRAIN_MESH_PATHS + OWL_TRAIN_MESH_PATHS \
    + ("ring_sp2", "ulysses_sp2", "gpipe_pipe2", "gpt3_13b_train")

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
     "itm27_eval forward; dropout-free training backward", True),
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
                 clens=DEC_CLEN, vfroms=DEC_VFROM, head_offset=0):
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
    and the new K and V rows, and writes o and the new cache row once.
    ``head_offset``: the n heads are a model shard's, heads head_offset ..
    head_offset + n - 1 of a ladder of 2n (their slopes that slice)."""
    import torch.nn.functional as F

    b, m, lidx = len(clens), 256, layers - 1
    # the fused qkv row: packed (GPT-3), or head-major (Bloom, ALiBi)
    qkv = rand(b, n, 3, d) if alibi else rand(b, 3 * n * d)
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
    total = 2 * n if head_offset else n
    kw = dict(alibi_slopes=dec.alibi_slopes(total)[head_offset:
                                                   head_offset + n]
              if alibi else None)
    # the kernel builds the slopes from the offset and the total
    kkw = dict(kw, head_offset=head_offset, n_total=total)
    tag = "K5 int8" if int8 else "K5"
    copy = (lambda c: {key: t.clone() for key, t in c.items()}) if int8 \
        else (lambda c: c.clone())
    got_c, want_c = copy(cache), copy(cache)
    got = dec.write_decode_attention(q, k, v, got_c, n, lidx, clen, vfrom,
                                     **kkw)
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
                                          vfrom, **kkw)

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
                "int8_alibi_launches", "d80_launches", "int8_d80_launches",
                "d128_launches", "int8_d128_launches")
# the paths that run each decode kernel variant (each launch with its K6
# write): the serve CLI's and run_instruct's (k = 1 graphs), the k = 8
# runs, the twin draft's steps and the sampled instruct runs
K5_PATHS = {"K5": ("serve", "serve_k8", "speculative_twin",
                   "caption_eval", "serve_files") + CKPT_SERVE_PATHS
            + KNOBS_SERVE_PATHS + MESH_PATHS + SPEC_TWIN_MESH_PATHS,
            "K5-ALiBi": ("instruct", "instruct_k8", "instruct_sample",
                         "instruct_hf", "instruct_files", "instruct_batched",
                         "instruct_beam") + OWL_MESH_PATHS,
            "K5-int8": ("serve_int8kv", "serve_int8kv_k8"),
            "K5-int8-ALiBi": ("instruct_int8", "instruct_int8_k8",
                              "instruct_serving_int8", "instruct_beam_int8")
            + OWL_MESH_PATHS,
            "K5-d80": ("caption27_eval",), "K5-int8-d80": (),
            "K5-d128": ("gpt3_13b_serve",)}


def _decode_entries(dec, kvc, rand, owl_beam):
    """The decode kernel's report entries: K5 by variant (bf16 / int8,
    with or without ALiBi) and K6, the cache write fused into it, whose
    launches are all of the kernel's.  ``owl_beam``: the instruct beam
    step's rows (``_owl_beam_rows``)."""
    cases = {}
    # the instruct beam step (phase 26): 16 requests x 5 beams over
    # BloomZ-7B1's cache, bf16 and int8, 8 of its 30 layers (each 335 MB,
    # so rotating over 8 reads from HBM as 30 do)
    prefix, writes, vfroms = owl_beam
    for key, int8 in (("K5-ALiBi", False), ("K5-int8-ALiBi", True)):
        cases[key] = [_decode_case(
            dec, kvc, rand, 32, 128, 8, True, int8,
            f"[8 of 30 layers,{len(writes)},256,2x32x128]"
            + (" int8" if int8 else "") + f" d 128 ALiBi (instruct_beam"
            + ("_int8" if int8 else "") + f", beam {OWL_BEAM}, prefix "
            f"{prefix})", True, writes, vfroms)]
        gc.collect()
        torch.cuda.empty_cache()
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
    # (key, heads, head dim, layers, ALiBi, int8, path, head offset): the
    # last two are phase 42's model = 2 rank, heads 16-31 of BloomZ-7B1's
    # 32 at its cut depth
    for key, n, d, layers, alibi, int8, path, off in (
            ("K5", 32, 64, 24, False, False, "serve", 0),
            ("K5", 16, 64, 24, False, False, "serve_mesh_1x2", 0),
            ("K5-ALiBi", 32, 128, 30, True, False, "instruct", 0),
            ("K5-ALiBi", 40, 128, 8, True, False, None, 0),
            ("K5-d128", 40, 128, 40, False, False, "gpt3_13b_serve", 0),
            ("K5-int8", 32, 64, 24, False, True, "serve_int8kv", 0),
            ("K5-int8-ALiBi", 32, 128, 30, True, True, "instruct_int8", 0),
            ("K5-int8-ALiBi", 40, 128, 8, True, True, None, 0),
            ("K5-ALiBi", 16, 128, OWL_MESH_LAYERS, True, False,
             "instruct_mesh_1x2", 16),
            ("K5-int8-ALiBi", 16, 128, OWL_MESH_LAYERS, True, True,
             "instruct_mesh_1x2", 16)):
        shape = (f"[{layers},8,256,2x{n}x{d}]" + (" int8" if int8 else "")
                 + f" d {d}" + (" ALiBi" if alibi else "")
                 + (f" heads {off}-{off + n - 1} of {2 * n}" if off else "")
                 + (f" ({path})" if path else ""))
        cases.setdefault(key, []).append(_decode_case(
            dec, kvc, rand, n, d, layers, alibi, int8, shape, bool(path),
            head_offset=off))
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
        _entry("K5 decode attention with the cache write, head dim 128 "
               "without ALiBi (GPT-3 13B decode step, 40 heads)", DEC_SRC,
               f"{TPU_DEC}:56", wrapper, K5_PATHS["K5-d128"], "K5-d128",
               cases["K5-d128"], counter="d128_launches"),
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

def phase_kernels(dev, builds, owl_beam):
    from youku_mplug_tpu_torch.ops import decode_attention as dec
    from youku_mplug_tpu_torch.ops import flash_attention as fa
    from youku_mplug_tpu_torch.ops import kv_cache as kvc
    from youku_mplug_tpu_torch.parallel import ring_attention as ra

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
    # tokens); the vision tower's local heads of a model = 2 serving split
    # (6 of 12, phase 40) and the CLIP ViT-L/14's of phase 42 (8 of 16,
    # 8 clips x 8 frames); q/k/v as views of one qkv projection
    k1 = []
    for rows, s, n, period, causal, path in (
            (64, 197, 12, 0, False, "serve"),
            (112, 112, 12, 8, False, "serve"),
            (64, 197, 6, 0, False, "serve_mesh_1x2"),
            (112, 112, 6, 8, False, "serve_mesh_1x2"),
            (128, 257, 16, 0, False, "instruct"),
            (64, 257, 16, 0, False, "instruct_train"),
            (64, 257, 8, 0, False, "instruct_mesh_1x2"),
            (180, 208, 32, 0, True, "cls_eval"),
            (32, 208, 32, 0, True, "itm_eval"),
            (96, 80, 32, 0, True, "retrieval"),
            # phase 45: a model = 2 rank's 16 decoder heads in a cls and
            # an ITM evaluation call and the retrieval text tower, and a
            # (2,1) data rank's 48 texts of a retrieval train step
            (180, 208, 16, 0, True, "cls_mesh_1x2_eval"),
            (32, 208, 16, 0, True, "itm_mesh_1x2_eval"),
            (96, 80, 16, 0, True, "retrieval_mesh_1x2"),
            (48, 80, 32, 0, True, "retrieval_mesh_2x1_train")):
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
    # ways) and pretrain (B 16) batches, over the 198 keys of one image
    # (B 16), then a split-KV case off the paths: ragged Sq and Sk,
    # kv_len < Sk, split three ways
    k4 = []
    for b, sq, sk, kv_len, path, on_path in (
            (8, 128, 1570, None, "serve", True),
            (16, 128, 1570, None, "train", True),
            (16, 128, 198, None, "image_pretrain", True),
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
    k4 += _local_head_k4(fa, rand)

    # the forward again, then the backward kernels, at the training shapes
    # (K1 packed and K4 head-major) and at Bloom's ALiBi shapes
    cases = [_bwd_case(rand, fa, *c)
             for c in BWD_SHAPES + TRAIN_MESH_SHAPES + PARALLEL_SHAPES]
    ring_cases = [_bwd_case(rand, fa, *c) for c in RING_SHAPES]
    ulysses_cases = [_bwd_case(rand, fa, *c) for c in ULYSSES_SHAPES]
    alibi_cases = [_bwd_case(rand, fa, *c) for c in ALIBI_SHAPES]
    d128 = [_bwd_case(rand, fa, *c) for c in D128_SHAPES]
    d96 = [_bwd_case(rand, fa, *c) for c in D96_SHAPES]
    d80 = [_bwd_case(rand, fa, *c) for c in D80_SHAPES]
    d88 = [_bwd_case(rand, fa, *c) for c in D88_SHAPES]
    # the second d 80 case: an ITM 2.7B evaluation call's forward (4 clips
    # x 8 texts); its backward runs on no path
    for kind in ("dq", "dkv", "delta"):
        d80[1][kind]["on_path"] = False
    k1 += [c["fwd"] for c in cases if c["layout"] == "packed"]
    # the pretrain K4 forward is timed above; the small kv_len case, a data
    # rank's AttentionPool and the model = 4 period case here
    k4 += [c["fwd"] for c in cases
           if c["layout"] == "heads" and (not c["fwd"]["on_path"]
                                          or "train_mesh" in
                                          c["fwd"]["shape"])]
    k4 += [c["fwd"] for c in ulysses_cases]
    # the bf16 build at the ring's block shapes, beside its fp32 one (the
    # ring's path runs the fp32 build)
    k4 += [{**c["fwd"], "on_path": False} for c in ring_cases]
    report = [
        _entry("K1 flash_attention_packed (vision spatial + temporal, "
               "decoder causal, CLIP ViT-L frames)", FWD_SRC,
               f"{TPU_FLASH}:426", fa.flash_attention_packed,
               ("serve", "train", "instruct", "instruct_train",
                "serve_int8kv", "instruct_int8", "speculative_twin",
                "speculative_ngram", "instruct_lookup", "instruct_sample",
                "caption_train", "caption_eval", "cls_eval", "itm_eval",
                "retrieval_train", "retrieval_eval") + CKPT_SERVE_PATHS
               + CKPT_OWL_PATHS + ("serve_files", "pretrain_files",
                                   "cls_files_eval", "instruct_files",
                                   "instruct_files_train") + OWL_BATCHED_PATHS
               + KNOBS_SERVE_PATHS + ("knobs_pretrain",
                                      "knobs_instruct_train")
               + BERT_TRAIN_PATHS + BERT_EVAL_PATHS + IMAGE_TRAIN_PATHS
               + MESH_PATHS + TRAIN_MESH_PATHS + OWL_MESH_PATHS
               + OWL_TRAIN_MESH_PATHS + ("gpipe_pipe2",) + GPT13B_PATHS
               + SPEC_MESH_PATHS + _ds_mesh_paths(("cls", "itm"), "eval")
               + _ds_mesh_paths(("retrieval",), "train")
               + _ds_mesh_paths(("retrieval",), "eval"), "K1", k1),
        _entry("K4 flash_attention (AttentionPool; split-KV shares merged "
               "by flash_fwd_merge_kernel)", FWD_SRC,
               f"{TPU_FLASH}:59", fa.flash_attention,
               ("serve", "train", "serve_int8kv", "speculative_twin",
                "speculative_ngram", "caption_train", "caption_eval",
                "serve_files", "pretrain_files", "image_pretrain")
               + CKPT_SERVE_PATHS + KNOBS_SERVE_PATHS + KNOBS_TRAIN_PATHS
               + MESH_PATHS + TRAIN_MESH_PATHS + ("ulysses_sp2",)
               + GPT13B_PATHS + SPEC_MESH_PATHS, "K4", k4),
        _entry("K4 flash_fwd_cuda, fp32-output build, as ring attention's "
               "block kernel (each K/V block's partial o_b in fp32 and its "
               "lse, merged in fp32 by the lse and rounded once; in place "
               "of the einsum _block_attend, "
               "youku_mplug_tpu/parallel/ring_attention.py:27)", FWD_SRC,
               f"{TPU_FLASH}:59", ra.ring_attention, ("ring_sp2",),
               "K4-ring-f32", [c["fwd_f32"] for c in ring_cases],
               build=flash_builds["fwd<64,f32>"])]
    for kind, wrapper, line, line_hm in (
            ("dq", fa.flash_bwd_dq_cuda, 723, 148),
            ("dkv", fa.flash_bwd_dkv_cuda, 791, 195)):
        report.append(_entry(
            f"K2/K3 + K4b backward {kind} kernel (flash_bwd_{kind}_cuda; "
            f"also replaces flash_attention.py:{line_hm})", BWD_SRC,
            f"{TPU_FLASH}:{line}", wrapper,
            ("train", "caption_train", "pretrain_files",
             "knobs_instruct_train") + KNOBS_TRAIN_PATHS + BERT_TRAIN_PATHS
            + IMAGE_TRAIN_PATHS + TRAIN_MESH_PATHS
            + ("ulysses_sp2", "gpipe_pipe2", "gpt3_13b_train"), kind,
            [c[kind] for c in cases + ulysses_cases]
            + [{**c[kind], "on_path": False} for c in ring_cases]))
    for kind, wrapper, line in (("dq", fa.flash_bwd_dq_cuda, 148),
                                ("dkv", fa.flash_bwd_dkv_cuda, 195)):
        report.append(_entry(
            f"K4b backward {kind} kernel, fp32-output build (ring "
            f"attention's block gradients, summed in fp32 round the ring; "
            f"head dim 64)", BWD_SRC, f"{TPU_FLASH}:{line}", wrapper,
            ("ring_sp2",), f"{kind}-ring-f32",
            [c[f"{kind}_f32"] for c in ring_cases], counter="f32_launches",
            build=flash_builds[f"bwd_{kind}<64,f32>"]))
    report.append(_entry(
        "K1 flash_attention_packed, causal, head dim 128 without ALiBi "
        "(the GPT-3 13B decoder's 40 heads)", FWD_SRC, f"{TPU_FLASH}:426",
        fa.flash_attention_packed, ("gpt3_13b_train",), "K1-d128",
        [c["fwd"] for c in d128], counter="d128_launches",
        build=flash_builds["fwd<128>"]))
    for kind, wrapper, line in (("dq", fa.flash_bwd_dq_cuda, 723),
                                ("dkv", fa.flash_bwd_dkv_cuda, 791)):
        report.append(_entry(
            f"K{2 if kind == 'dq' else 3} backward {kind} kernel, causal, "
            f"head dim 128 without ALiBi (the GPT-3 13B decoder)", BWD_SRC,
            f"{TPU_FLASH}:{line}", wrapper, ("gpt3_13b_train",),
            f"{kind}-d128", [c[kind] for c in d128], counter="d128_launches",
            build=flash_builds[f"bwd_{kind}<128>"]))
    report.append(_entry(
        "K1 flash_attention_packed, ALiBi causal (Bloom training, head dim "
        "128)", FWD_SRC, f"{TPU_FLASH}:426", fa.flash_attention_packed,
        ("instruct_train", "instruct_hf_train", "instruct_files_train",
         "knobs_instruct_train") + OWL_TRAIN_MESH_PATHS, "K1-ALiBi",
        [c["fwd"] for c in alibi_cases],
        counter="alibi_launches"))
    for kind, wrapper, line in (("dq", fa.flash_bwd_dq_cuda, 723),
                                ("dkv", fa.flash_bwd_dkv_cuda, 791)):
        report.append(_entry(
            f"K{2 if kind == 'dq' else 3} backward {kind} kernel, ALiBi "
            f"causal (Bloom training, head dim 128)", BWD_SRC,
            f"{TPU_FLASH}:{line}", wrapper,
            ("instruct_train", "instruct_hf_train", "instruct_files_train",
             "knobs_instruct_train") + OWL_TRAIN_MESH_PATHS, f"{kind}-ALiBi",
            [c[kind] for c in alibi_cases],
            counter="alibi_launches"))

    train96 = [c for c, shape in zip(d96, D96_SHAPES)
               if set(shape[10].split(", ")) & set(D96_TRAIN_PATHS)]
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
        fa.flash_attention, ("cls27_eval", "itm27_eval"), "K4-d80",
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
        "K4 flash_attention, head dim 88 (EVA-ViT-g AttentionPool; d 96's "
        "D-wide tiles with the tail's columns 88-95 zero in shared memory, "
        "m64n24k16 into a 44-value accumulator)", FWD_SRC,
        f"{TPU_FLASH}:59", fa.flash_attention, ("eva_pretrain",), "K4-d88",
        [c["fwd"] for c in d88], counter="d88_launches",
        build=flash_builds["fwd<88>"]))
    for kind, wrapper, line in (("dq", fa.flash_bwd_dq_cuda, 148),
                                ("dkv", fa.flash_bwd_dkv_cuda, 195)):
        report.append(_entry(
            f"K4b backward {kind} kernel, head dim 88 (EVA-ViT-g "
            "AttentionPool; D-wide tiles, the key-tile dk/dv kernel)",
            BWD_SRC, f"{TPU_FLASH}:{line}", wrapper, ("eva_pretrain",),
            f"{kind}-d88", [c[kind] for c in d88], counter="d88_launches",
            build=flash_builds[f"bwd_{kind}<88>"]))
    report.append(_entry(
        "backward delta = rowsum(dO * O) in fp32, one launch a backward at "
        "every head dim (XLA-fused in the JAX package: no Pallas kernel)",
        BWD_SRC, f"{TPU_FLASH}:252 (_bwd; :951 in _bwd_packed)",
        fa.flash_bwd_delta_cuda, BWD_PATHS, "delta",
        [c["delta"] for c in cases + ring_cases + ulysses_cases + alibi_cases
         + d128 + train96 + [key_tiles96] + d80[1:] + d88]))
    report += _decode_entries(dec, kvc, rand, owl_beam)
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


def _local_head_k4(fa, rand):
    """K4 on the vision tower's local heads of a model = 4 split (3 of 12
    heads of 64, an odd count of 128-lane strips: the head-major route),
    spatial [64, 3x197x64] and grouped temporal [112, 3x112x64] with the
    period-8 mask, head views of a packed projection; no chip split runs
    model = 4 (the CPU tests do)."""
    cases = []
    for b, s, period in ((64, 197, 0), (112, 112, 8)):
        qkv = rand(b, s, 3 * 192)
        q, k, v = (qkv[..., i * 192:(i + 1) * 192].unflatten(
            -1, (3, 64)).transpose(1, 2) for i in range(3))
        got = fa.flash_attention(q, k, v, period=period)
        want = fa.flash_attention_plain(q, k, v, period=period)
        lse = fa.flash_fwd_cuda(q, k, v, torch.empty_like(q), scale=0.125,
                                period=period)
        e, e_lse = err(got, want), err(lse, fa.flash_fwd_plain(
            q, k, v, scale=0.125, period=period)[1])
        shape = (f"[{b},3,{s},64] heads" + (f" period {period}" if period
                                            else "") + " (model = 4 shard)")
        if not (within(got, want) and e_lse <= LSE_TOL):
            fail(f"K4 {shape}: max err {e}, lse {e_lse}")
        cases.append({
            "shape": shape, "on_path": False, "max_abs_err": e,
            "lse_err": e_lse,
            "ms": time_ms(lambda: fa.flash_attention(q, k, v, period=period),
                          20),
            "plain_ms": time_ms(lambda: fa.flash_attention_plain(
                q, k, v, period=period), 20),
            "library_ms": _library_ms(q, k, v, _sdpa_kwargs(
                fa, q, k, False, period, None, None))[0],
            **_attn_bounds(fa, b, 3, s, s, 64, False, period, None)["fwd"]})
    return cases


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
    every mode takes from the same prefill; the replay's max |logit|; per
    request the replay's greedy token at each of those positions)."""
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
        argmax = logits.argmax(-1).cpu()
    return ([gaps[i, :len(t) - 1].tolist() for i, t in enumerate(tokens)],
            top, [argmax[i, :len(t) - 1].tolist()
                  for i, t in enumerate(tokens)])


def _tie_check(tag, got, want, gaps, bound, first=1):
    """``got`` (tokens per request) equal to the greedy step's ``want`` up
    to each request's first position whose plain-replay top-2 gap is below
    ``bound`` (``gaps[i][j]`` is position ``j + first``'s); prints those
    near-tie positions and every divergence."""
    compared, ties, diverged = 0, [], []
    for i, (g, w, gap) in enumerate(zip(got, want, gaps)):
        near = [j + first for j, x in enumerate(gap) if x < bound]
        stop = near[0] if near else len(w)
        div = next((j for j in range(max(len(g), len(w)))
                    if j >= len(g) or j >= len(w) or g[j] != w[j]), None)
        if near:
            ties.append((i, near[:4]))
        if div is not None:
            diverged.append((i, div, round(gap[div - first], 4)
                             if 0 <= div - first < len(gap) else None))
            if div < stop:
                fail(f"{tag}: request {i} leaves the greedy tokens at "
                     f"position {div}, before its first near-tie "
                     f"({stop}; bound {bound:.4g}): {g[:div + 2]} vs "
                     f"{w[:div + 2]}")
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
    key = ("K5-int8" if int8 else
           "K5-d128" if cfg.model.text.head_dim == 128 else "K5")
    per_step = _per_step(report, path, engine.decode_steps,
                         {key: layers, "K6": layers})
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


def phase_teacher_forced(cfg, model, tag="teacher-forced", clips=None,
                         logit_rel_tol=None):
    """The caption model's query features and FORCED_STEPS decode steps,
    with the kernels and again with the plain versions of K1, K4 and K5
    with K6 (bf16 or int8) patched in, fed the same inputs and tokens;
    on 8 synthetic clips, or ``clips`` (uint8 [8, T, H, W, 3]).  The
    logits within LOGIT_TOL, or with ``logit_rel_tol`` within that times
    the plain logits' largest magnitude (the large decoders' gate)."""
    from youku_mplug_tpu_torch.data.datasets import SyntheticVideoDataset
    from youku_mplug_tpu_torch.models import gpt3, vision
    from youku_mplug_tpu_torch.ops import decode_attention as dec
    from youku_mplug_tpu_torch.ops import flash_attention as fa
    from youku_mplug_tpu_torch.ops.preprocess import normalize_clip

    from youku_mplug_tpu_torch.models.generation import GenerationConfig

    if clips is None:
        ds = SyntheticVideoDataset(8, cfg.num_frames, cfg.image_res)
        clips = torch.stack([torch.from_numpy(ds[i]["video"])
                             for i in range(8)])
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
    top = max(x.abs().max().item() for x in logits_plain)
    tol = LOGIT_TOL if logit_rel_tol is None else logit_rel_tol * top
    print(f"[{tag}] query features max err {e_q:.4g} (tol "
          f"{QUERY_TOL}) | logits over {FORCED_STEPS} steps max err "
          f"{e_l:.4g} of max |plain| {top:.4g} (tol "
          + (f"{LOGIT_TOL}" if logit_rel_tol is None else
             f"{logit_rel_tol:.4g} x max |plain| = {tol:.4g}")
          + f") | greedy agreement {agree}/{total}", flush=True)
    if not finite or e_q > QUERY_TOL or e_l > tol:
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


FLASH_COUNTERS = ("launches", "d80_launches", "d88_launches",
                  "d96_launches", "d128_launches", "alibi_launches")


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
    sa, sb = a.optimizer.leaf_state(), b.optimizer.leaf_state()
    for k in set(a.trainable) & set(b.trainable):
        ma, mb = sa.get(k, {}), sb.get(k, {})
        if set(ma) != set(mb) or not ma or any(
                not torch.equal(ma[x], mb[x].to(ma[x].device)) for x in ma):
            bad.append(f"optimizer state {k}")
    if a.optimizer.scalars() != b.optimizer.scalars():
        bad.append("optimizer scalars")
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


def _owl_jsonl(out_dir):
    """The OWL_REQUESTS instruct rows (the questions, then again with
    trailing spaces, so the prompts differ in length) as a jsonl file."""
    jsonl = os.path.join(out_dir, "requests.jsonl")
    with open(jsonl, "w") as f:
        for i in range(OWL_REQUESTS):
            f.write(json.dumps({
                "video": f"clip{i}.mp4",
                "question": OWL_QUESTIONS[i % len(OWL_QUESTIONS)]
                + " " * (i // len(OWL_QUESTIONS))}) + "\n")
    return jsonl


def _owl_tokenizer(directory):
    """A tokenizer.json in BloomZ's form, trained here with ``tokenizers``
    on OWL_TOKENIZER_CORPUS: Bloom's pre-tokenizer split and byte-level
    BPE, ids 0-3 <unk>, <s>, </s>, <pad> (eos 2, pad 3 as the Bloom
    config), at most OWL_TOKENIZER_VOCAB trained entries, then word pieces
    " w<id>" that no merge reaches up to the Bloom config's vocabulary
    (250880), so every id a seeded model emits decodes to text; with
    tokenizer_config.json and special_tokens_map.json naming
    BloomTokenizerFast's specials.  Returns ``directory``."""
    from tokenizers import (Regex, Tokenizer, decoders, models,
                            pre_tokenizers, trainers)

    from youku_mplug_tpu_torch.config import load_owl_config

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(" ?[^(\\s|[.,!?…。，、।۔،])]+"),
                             "isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(OWL_TOKENIZER_CORPUS * 8, trainers.BpeTrainer(
        vocab_size=OWL_TOKENIZER_VOCAB,
        special_tokens=["<unk>", "<s>", "</s>", "<pad>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    tree = json.loads(tok.to_str())
    vocab = tree["model"]["vocab"]
    # "\u0120" is the byte-level alphabet's space
    vocab.update({f"\u0120w{i}": i for i in range(
        len(vocab), load_owl_config(OWL_YAML)[0].text.vocab_size)})
    with open(os.path.join(directory, "tokenizer.json"), "w") as f:
        json.dump(tree, f, ensure_ascii=False)
    specials = {"bos_token": "<s>", "eos_token": "</s>",
                "unk_token": "<unk>", "pad_token": "<pad>"}
    for name, extra in (("tokenizer_config.json", {
            "tokenizer_class": "BloomTokenizerFast",
            "add_prefix_space": False, "padding_side": "left"}),
            ("special_tokens_map.json", {})):
        with open(os.path.join(directory, name), "w") as f:
            json.dump({**specials, **extra}, f)
    return directory


def _owl_beam_rows(tok_dir):
    """The instruct beam step's cache rows as phase 26 gives them: the
    16 prompts through the tokenizer of ``tok_dir`` (media expanded) are
    P wide, sample b front-padded from P - len_b; each of its OWL_BEAM
    beams writes at P + t - 1 for its t-th new token.  Returns (P, the
    rows' write positions, their valid_from), t spread over 1..63."""
    from youku_mplug_tpu_torch.config import load_owl_config
    from youku_mplug_tpu_torch.data.instruct import (
        build_instruct_batch,
        format_prompt,
    )
    from youku_mplug_tpu_torch.models.hf_tokenizer import HFTokenizer

    cfg, raw = load_owl_config(OWL_YAML)
    prompts = [format_prompt(OWL_QUESTIONS[i % len(OWL_QUESTIONS)]
                             + " " * (i // len(OWL_QUESTIONS)))
               for i in range(OWL_REQUESTS)]
    batch = build_instruct_batch(prompts, HFTokenizer(tok_dir),
                                 cfg.num_media_tokens, cfg.text.pad_id)
    p = batch["input_ids"].shape[1]
    new = int(raw["max_new_tokens"])
    rows = OWL_REQUESTS * OWL_BEAM
    return (p, [p + i % (new - 1) for i in range(rows)],
            [p - int(batch["prompt_len"][i // OWL_BEAM])
             for i in range(rows)])


def _owl_launches(report, path, steps, cfg, int8):
    """The launches of an instruct run on ``path`` (one encode of every
    request, ``steps`` decode steps): K5 ALiBi (int8 ALiBi on an int8
    cache) with its K6 write once per Bloom layer a decode step, K1 once
    per ViT block, no other kernel.  Returns the decode launches per
    step."""
    layers = cfg.text.num_hidden_layers
    per_step = _per_step(report, path, steps,
                         {"K5-int8-ALiBi" if int8 else "K5-ALiBi": layers,
                          "K6": layers})
    flash = {r["key"]: r["launches_by_path"][path] for r in report
             if not r["key"].startswith(("K5", "K6"))}
    if any(n != (cfg.vision.depth if k == "K1" else 0)
           for k, n in flash.items()):
        fail(f"{path}: flash launches {flash}, expected K1 {cfg.vision.depth}"
             " and no other")
    return per_step


def phase_instruct(report, out_dir, yaml=OWL_YAML, path="instruct",
                   int8=False, extra=()):
    """The run_instruct CLI's serving path on ``yaml`` at full width and
    depth (``int8``: with --int8, the decoder's kernels and tied embedding
    quantized after the seeded init; ``extra``: more CLI arguments); the
    decode kernels' launches per decode step checked (one a Bloom layer:
    K5 ALiBi, or K5 int8 ALiBi with an int8 cache, each launch with its
    K6 write), and K1 launched once per ViT block (one encode of every
    request) and no other flash kernel.  Returns (model, instruct batch,
    clips, generation config)."""
    from youku_mplug_tpu_torch.cli import run_instruct
    from youku_mplug_tpu_torch.ops import kv_cache as kvc

    args = run_instruct.parser().parse_args([
        "--config", yaml, "--synthetic_data", "--engine",
        "--input_jsonl", _owl_jsonl(out_dir), "--num_slots", str(OWL_SLOTS),
        "--device", "cuda", "--output_dir", out_dir, *extra]
        + (["--int8"] if int8 else []))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, raw, model, device = run_instruct.build(args)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in model.parameters())
    _, batch, clips = run_instruct.prepare(
        args, cfg, raw, device, model.policy.compute_dtype,
        run_instruct.build_tokenizer(args, cfg))
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
    per_step = _owl_launches(report, path, engine.decode_steps, cfg,
                             kvc.is_quantized(engine.cache))
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
    import argparse

    from youku_mplug_tpu_torch.cli import serve
    from youku_mplug_tpu_torch.ops.preprocess import normalize_clip

    prompt_vec, _, gen_cfg = serve._prompt(cfg)
    requests = []
    synthetic = argparse.Namespace(synthetic_data=True, seed=0)
    for clips, _ in serve.clip_batches(synthetic, cfg):
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
    gaps, _, _ = _plain_gaps(
        lambda: serve.make_engine(args16, cfg, model.text_decoder)[0],
        requests, greedy)
    for k, draft, path in ((4, "twin", "speculative_twin"),
                           (8, "ngram", "speculative_ngram")):
        args = _serve_args(FLAGSHIP_YAML, 8, "--speculative", str(k),
                           "--draft", draft)
        _reset_counts(report)
        torch.cuda.synchronize()
        stats, out, _ = serve.run_speculative(args, cfg, model,
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

    gaps, top, _ = _plain_gaps(
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
    others for another, and a K5-ALiBi launch a layer per decode step."""
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
            layers = cfg.text.num_hidden_layers
            per_step = _per_step(report, "instruct_sample",
                                 eng.decode_steps, {"K5-ALiBi": layers,
                                                    "K6": layers})
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


def phase_sampling_full_depth(report, batch, clips):
    """Phase 8a's sampling on its own BloomZ-7B1 at full depth (seeded as
    phase 7's, built from SAMPLE_YAML), fed phase 7's requests: a seeded
    Bloom cut to OWL_SERVE_LAYERS puts nearly all the mass on one token,
    so top-p 0.9 keeps one and another seed draws the same tokens."""
    from youku_mplug_tpu_torch.cli import run_instruct

    with tempfile.TemporaryDirectory() as out_dir:
        args = run_instruct.parser().parse_args([
            "--config", SAMPLE_YAML, "--synthetic_data", "--engine",
            "--device", "cuda", "--output_dir", out_dir])
        _, _, model, _ = run_instruct.build(args)
    phase_sampling(report, model, batch, clips)
    del model
    gc.collect()
    torch.cuda.empty_cache()


def _owl_inputs(model, yaml, tok_dir, out_dir, **yaml_keys):
    """run_instruct's serving inputs without --engine, on a copy of
    ``yaml`` with ``yaml_keys`` (``_owl_yaml``): the OWL_REQUESTS rows,
    the prompts through the tokenizer of ``tok_dir`` (--tokenizer), the
    synthetic clips.  Returns (rows, batch, clips, tokenizer, generation
    config)."""
    from youku_mplug_tpu_torch.cli import run_instruct
    from youku_mplug_tpu_torch.config import load_owl_config

    copy = _owl_yaml(yaml, out_dir, {}, **yaml_keys)
    args = run_instruct.parser().parse_args([
        "--config", copy, "--synthetic_data", "--input_jsonl",
        _owl_jsonl(out_dir), "--tokenizer", tok_dir, "--device", "cuda",
        "--output_dir", out_dir])
    cfg, raw = load_owl_config(copy)
    if cfg != model.cfg:
        fail(f"{copy} reads to another model than the one served")
    tok = run_instruct.build_tokenizer(args, cfg)
    rows, batch, clips = run_instruct.prepare(
        args, cfg, raw, torch.device("cuda"), model.policy.compute_dtype,
        tok)
    return rows, batch, clips, tok, run_instruct.generation_config(
        args, cfg, raw)


def _owl_answers(tag, rows, seqs, tok, text):
    """run_instruct's results of ``seqs``: every answer the tokenizer's
    decode of the ids its kept tokens hold inside the vocabulary (the CPU
    tests hold the decode of ids past it to transformers': nothing), no
    pad or eos kept.  Returns (results, share of kept ids inside the
    vocabulary)."""
    from youku_mplug_tpu_torch.cli import run_instruct

    results = run_instruct.answers(rows, seqs, tok, text)
    kept = inside = 0
    for r in results:
        ids = [i for i in r["tokens"] if i < tok.vocab_size]
        if text.pad_id in r["tokens"] or text.eos_id in r["tokens"] \
                or r["answer"] != tok.decode(ids).strip():
            fail(f"[{tag}] answer {r['answer']!r} is not the decode of its "
                 f"kept tokens {r['tokens'][:16]}")
        kept += len(r["tokens"])
        inside += len(ids)
    print(f"[{tag}] text: {inside} of {kept} kept ids inside the "
          f"{tok.vocab_size}-entry vocabulary (the rest decode to nothing); "
          "answers: " + " | ".join(repr(r["answer"][:60])
                                   for r in results[:3]), flush=True)
    return results, inside / max(kept, 1)


def _batched_replay(lm, ids, plen, embeds, tokens, steps):
    """generate's geometry, teacher-forced: the prefill of every prompt
    together (``_build_prefix`` on ``embeds``, the prompts' embeddings
    [B, P, H] right-padded) into a cache of P + steps + 1 rows, then
    ``steps`` S = 1 decode steps fed ``tokens[:, t]``.  Returns the fp32
    logits of each position, the prefill's first."""
    from youku_mplug_tpu_torch.models import generation

    b, p = ids.shape
    with torch.inference_mode():
        pre, vf, off = generation._build_prefix(lm, ids, plen, None,
                                                lm.cfg.pad_id, embeds)
        cache = lm.init_cache(b, p + steps + 1, device=ids.device)
        logits, cache = lm.decode_step(pre, cache, 0, vf, off)
        out = [logits.float()]
        for t in range(steps):
            logits, cache = lm.decode_step(
                lm.embed(tokens[:, t:t + 1].long()), cache, p + t, vf, off)
            out.append(logits.float())
    return out


def _batched_forced(model, batch, clips, seqs, tag):
    """The batched path's prefill and its first FORCED_STEPS decode steps
    (``_build_prefix`` on the spliced prompts, then ``decode_step`` fed
    ``seqs``' tokens), with the kernels and again with the plain versions
    of K1 (the ViT) and K5 with its K6 write patched in: logits within
    OWL_REL_TOL x max |plain|; each step's argmax with the kernels is the
    token the batched run picked."""
    from youku_mplug_tpu_torch.models import bloom, vision
    from youku_mplug_tpu_torch.ops import decode_attention as dec
    from youku_mplug_tpu_torch.ops import flash_attention as fa

    dev = clips.device
    ids = torch.as_tensor(batch["input_ids"], device=dev).long()
    mask = torch.as_tensor(batch["media_mask"], device=dev)
    plen = torch.as_tensor(batch["prompt_len"], device=dev)

    def run():
        with torch.inference_mode():
            embeds = model.spliced_embeds(ids, mask,
                                          model.encode_video(clips))
        return _batched_replay(model.text_decoder, ids, plen, embeds, seqs,
                               FORCED_STEPS)

    got = run()
    counts = [fa.flash_attention_packed.launches] + _decode_kernel_counts()
    with mock.patch.object(vision, "flash_attention_packed",
                           fa.flash_attention_packed_plain), \
            mock.patch.object(bloom, "write_decode_attention",
                              dec.write_decode_attention_plain):
        want = run()
    if counts != [fa.flash_attention_packed.launches] \
            + _decode_kernel_counts():
        fail(f"the {tag} plain replay launched a kernel")
    e = max(err(a, b) for a, b in zip(got, want))
    top = max(x.abs().max().item() for x in want)
    live = torch.ones(seqs.shape[0], dtype=torch.bool, device=dev)
    picked = True
    for t, lg in enumerate(got):
        picked &= bool((lg.argmax(-1)[live] == seqs[live, t]).all())
        live &= seqs[:, t] != model.cfg.text.eos_id
    print(f"[{tag}] logits over the prefill and {FORCED_STEPS} steps max "
          f"err {e:.4g} of max |plain| {top:.4g} (tol {OWL_REL_TOL:.4g} x "
          f"max |plain|); the kernels' argmax the batched run's tokens: "
          f"{picked}", flush=True)
    if not all(torch.isfinite(x).all() for x in got + want) \
            or e > OWL_REL_TOL * top or not picked:
        fail(f"{tag} check out of tolerance")
    return {"max_abs_err": e, "max_abs_plain": top}


def _engine_agreement(model, batch, requests, seqs, gen_cfg, tag):
    """The batched path against the engine, teacher-forced on the batched
    path's tokens ``seqs`` at every position: the batched geometry (the
    16 prompts prefilled together at their width, then S = 1 steps) and
    the engine's (``ServingEngine._admit``: one request a prefill in its
    bucket, its first logits read at the engine's pick; then S = 1 steps
    over its cache), both on the kernels.  Gates: the two logits within
    OWL_REL_TOL x max |engine|; each batched token the engine's argmax
    wherever the engine's top-2 gap exceeds twice the measured max
    difference (the only positions where the two roundings cannot swap
    the order).  Returns the counts and the measured difference."""
    from youku_mplug_tpu_torch.serving.engine import ServingEngine

    lm = model.text_decoder
    dev = seqs.device
    text = model.cfg.text
    ids = torch.as_tensor(batch["input_ids"], device=dev).long()
    b, p = ids.shape
    t_max = seqs.shape[1]
    is_eos = (seqs == text.eos_id).int()
    length = torch.where(is_eos.any(1), is_eos.argmax(1) + 1,
                         torch.full((b,), t_max, device=dev))
    pe = torch.zeros(b, p, lm.cfg.hidden_size, dtype=requests[0][1][
        "prompt_embeds"].dtype, device=dev)
    for i, (r_ids, kw) in enumerate(requests):
        pe[i, :len(r_ids)] = kw["prompt_embeds"]
    batched = _batched_replay(lm, ids, torch.as_tensor(
        batch["prompt_len"], device=dev), pe, seqs, t_max - 1)
    with torch.inference_mode():
        bucket = 8
        while bucket < p:
            bucket *= 2
        eng = ServingEngine(lm, num_slots=b, max_len=bucket + t_max + 2,
                            prefill_buckets=(bucket,), config=gen_cfg)
        firsts, pick = [], eng._pick
        eng._pick = lambda logits: (firsts.append(logits.float()),
                                    pick(logits))[1]
        for r_ids, kw in requests:
            eng.submit(r_ids, **kw)
        eng._admit()
        eng._pick = pick
        engine = [torch.cat(firsts)]
        cl, vfe, offe = (torch.from_numpy(x).to(dev) for x in (
            eng.cache_len, eng.valid_from, eng.pos_offset))
        for t in range(t_max - 1):
            lg, _ = lm.decode_step(lm.embed(seqs[:, t:t + 1].long()),
                                   eng.cache, cl + t, vfe, offe)
            engine.append(lg.float())
        del eng
    live = [torch.arange(b, device=dev)[length > t] for t in range(t_max)]
    diff = max((batched[t][r] - engine[t][r]).abs().max().item()
               for t, r in enumerate(live) if len(r))
    top = max(x.abs().max().item() for x in engine)
    bound = 2 * diff
    compared = ties = 0
    for t, r in enumerate(live):
        top2 = engine[t][r].topk(2, dim=-1)
        clear = (top2.values[:, 0] - top2.values[:, 1]) > bound
        ties += int((~clear).sum())
        compared += int(clear.sum())
        bad = clear & (top2.indices[:, 0] != seqs[r, t].long())
        if bool(bad.any()):
            i = int(r[bad.nonzero()[0, 0]])
            fail(f"[{tag}] request {i} position {t}: batched token "
                 f"{int(seqs[i, t])}, the engine's argmax "
                 f"{int(engine[t][i].argmax())} clear of the bound "
                 f"{bound:.4g}")
    out = {"max_abs_diff": diff, "max_abs_engine": top,
           "tie_bound": bound, "positions_compared": compared,
           "near_ties": ties}
    print(f"[{tag}] against the engine, teacher-forced on the batched "
          f"tokens: logits max diff {diff:.4g} of max |engine| {top:.4g} "
          f"(tol {OWL_REL_TOL:.4g} x max); {compared} positions clear of "
          f"twice that, each the engine's argmax; {ties} near-ties",
          flush=True)
    if not math.isfinite(diff) or diff > OWL_REL_TOL * top:
        fail(f"[{tag}] the batched path's logits against the engine's out "
             "of tolerance")
    return out


def phase_instruct_batched(report, model, tok_dir, out_dir, yaml=OWL_YAML):
    """Phase 25: run_instruct's batched path (no --engine) greedy on the
    bf16 model of phase 7, the prompts through a built tokenizer.json
    (--tokenizer): K1 once per ViT block, K5 ALiBi with its K6 write once
    per layer a decode step, no other kernel; the tokens the engine's
    choice on the same requests wherever that is clear of twice the max
    of the two paths' measured logit disagreement, every position compared
    teacher-forced (``_engine_agreement``); the batched prefill and first
    steps replayed with the plain versions; every answer the tokenizer's
    text."""
    from youku_mplug_tpu_torch.cli import run_instruct

    t_phase = time.perf_counter()
    rows, batch, clips, tok, gen_cfg = _owl_inputs(model, yaml, tok_dir,
                                                   out_dir)
    cfg = model.cfg
    requests = _instruct_requests(model, batch, clips)

    def make(slots):
        return run_instruct.make_engine(model.text_decoder,
                                        batch["prompt_len"], gen_cfg, slots)

    greedy, engine_s, _ = _engine_run(lambda: make(OWL_SLOTS), requests, 1)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(report)
    seqs, stats, out = run_instruct.generate_batched(model, clips, batch,
                                                     gen_cfg)
    torch.cuda.synchronize()
    _read_counts(report, "instruct_batched")
    per_step = _owl_launches(report, "instruct_batched", out["decode_steps"],
                             cfg, False)
    if stats["nonfinite_logits"] or stats["requests"] != OWL_REQUESTS:
        fail(f"instruct_batched: {stats}")
    same = [next((j for j, (a, b) in enumerate(zip(row.tolist(), w))
                  if a != b), min(len(w), len(row))) for row, w in
            zip(seqs, greedy)]
    forced = _batched_forced(model, batch, clips, out["sequences"],
                             "instruct_batched teacher-forced")
    agree = _engine_agreement(model, batch, requests, out["sequences"],
                              gen_cfg, "instruct_batched")
    _, share = _owl_answers("instruct_batched", rows, seqs, tok, cfg.text)
    stats.update({"prompt_width": int(batch["input_ids"].shape[1]),
                  "engine_s_same_requests": engine_s,
                  "free_running_equal_prefix": same, "engine": agree,
                  "launches_per_step": per_step, "forced": forced,
                  "kept_ids_in_vocabulary": share,
                  "phase_s": time.perf_counter() - t_phase})
    print(f"[instruct_batched] {json.dumps(stats)} | {CARD}", flush=True)


def _owl_rescore(model, batch, clips, seqs, eos):
    """Each sequence's sum of log-probs teacher-forced with the plain
    versions of K1 and K5 (with its write) patched in: the encode, then
    ``_batched_replay``.  A row's targets are its tokens before the first
    pad, then the eos that closed it where pads follow (a finished beam's
    sequence holds no eos), all of it without a pad.  Returns (scores
    [B], target counts [B])."""
    from youku_mplug_tpu_torch.models import bloom, vision
    from youku_mplug_tpu_torch.ops import decode_attention as dec
    from youku_mplug_tpu_torch.ops import flash_attention as fa

    dev = clips.device
    ids = torch.as_tensor(batch["input_ids"], device=dev).long()
    b, t_max = seqs.shape
    is_pad = seqs == model.cfg.text.pad_id
    n = torch.where(is_pad.any(1), is_pad.int().argmax(1),
                    torch.full((b,), t_max, device=dev))
    steps = torch.arange(t_max, device=dev)[None]
    targets = torch.where(steps == n[:, None], eos, seqs).long()
    count = torch.minimum(n + 1, torch.full_like(n, t_max))
    with mock.patch.object(vision, "flash_attention_packed",
                           fa.flash_attention_packed_plain), \
            mock.patch.object(bloom, "write_decode_attention",
                              dec.write_decode_attention_plain):
        with torch.inference_mode():
            embeds = model.spliced_embeds(
                ids, torch.as_tensor(batch["media_mask"], device=dev),
                model.encode_video(clips))
        logits = _batched_replay(
            model.text_decoder, ids,
            torch.as_tensor(batch["prompt_len"], device=dev), embeds,
            targets, t_max - 1)
    logp = torch.stack([torch.log_softmax(x, -1).gather(
        1, targets[:, t:t + 1])[:, 0] for t, x in enumerate(logits)], 1)
    return torch.where(steps < count[:, None], logp, 0.0).sum(1), count


def phase_instruct_beam(report, model, yaml, path, tok_dir, out_dir):
    """Phase 26: run_instruct's batched path with beam_size OWL_BEAM (a
    copy of ``yaml`` the script writes) on ``model`` (bf16, or int8 with
    --int8 and an int8 cache), the requests of phase 25: K1
    once per ViT block, K5 ALiBi (int8 ALiBi) with its K6 write once per
    layer a decode step over the 80 rows, no other kernel; every returned
    sequence's beam score against its plain rescore within
    RESCORE_TOL_PER_TOKEN a token; every answer the tokenizer's text;
    host ms a beam step (read at each reorder) and, traced in a second
    run, the device ms a step by category, the reorder's, launches and
    idle share."""
    from youku_mplug_tpu_torch.cli import run_instruct
    from youku_mplug_tpu_torch.models import generation
    from youku_mplug_tpu_torch.ops import kv_cache as kvc

    t_phase = time.perf_counter()
    rows, batch, clips, tok, gen_cfg = _owl_inputs(
        model, yaml, tok_dir, out_dir, beam_size=OWL_BEAM)
    if gen_cfg.beam_size != OWL_BEAM or gen_cfg.do_sample:
        fail(f"{path}: generation config {gen_cfg}")
    cfg = model.cfg
    stamps = []
    gather = generation._gather_beams

    def stamped(*a, **kw):
        out = gather(*a, **kw)
        stamps.append(time.perf_counter())
        return out

    torch.cuda.reset_peak_memory_stats()
    _reset_counts(report)
    with mock.patch.object(generation, "_gather_beams", stamped):
        seqs, stats, out = run_instruct.generate_batched(model, clips, batch,
                                                         gen_cfg)
    torch.cuda.synchronize()
    _read_counts(report, path)
    int8 = cfg.text.kv_cache_dtype == "int8"
    per_step = _owl_launches(report, path, out["decode_steps"], cfg, int8)
    if stats["nonfinite_logits"] or len(stamps) != out["decode_steps"]:
        fail(f"{path}: {stats}, {len(stamps)} reorders")
    host = sorted(b - a for a, b in zip(stamps, stamps[1:]))

    def spanned(*a, **kw):
        with torch.profiler.record_function("gather_beams"):
            return gather(*a, **kw)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with mock.patch.object(generation, "_gather_beams", spanned), \
            torch.profiler.profile(activities=acts) as prof:
        traced, _, _ = run_instruct.generate_batched(model, clips, batch,
                                                     gen_cfg)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "beam_trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
    gather_ms, n_gathers, step_trace = _beam_trace(events)
    if n_gathers != out["decode_steps"] or not (traced == seqs).all():
        fail(f"{path}: the traced run made {n_gathers} reorders over "
             f"{out['decode_steps']} steps; same tokens "
             f"{bool((traced == seqs).all())}")

    want, count = _owl_rescore(model, batch, clips, out["sequences"],
                               gen_cfg.eos_id)
    errs = ((out["scores"] - want).abs() / count).tolist()
    worst = max(range(len(errs)), key=errs.__getitem__)
    if not (torch.isfinite(out["scores"]).all() and torch.isfinite(
            want).all()) or errs[worst] > RESCORE_TOL_PER_TOKEN:
        fail(f"{path}: beam scores against the plain rescore: request "
             f"{worst} err {errs[worst]:.4g} a token over {int(count[worst])}"
             f" tokens, beam {out['scores'][worst].item():.4f} plain "
             f"{want[worst].item():.4f} (tol {RESCORE_TOL_PER_TOKEN})")
    _, share = _owl_answers(path, rows, seqs, tok, cfg.text)
    text = cfg.text
    prefix = batch["input_ids"].shape[1]
    m = kvc.cache_width(model.text_decoder.init_cache(
        1, prefix + gen_cfg.max_new_tokens, device="meta"))
    row_bytes = (2 * text.hidden_size + 8 * text.num_attention_heads
                 if int8 else 4 * text.hidden_size)
    tail = (text.num_hidden_layers * OWL_REQUESTS * OWL_BEAM * (m - prefix)
            * row_bytes)
    stats.update({
        "beam_size": gen_cfg.beam_size, "cache_rows": OWL_REQUESTS * OWL_BEAM,
        "cache_width": m, "prompt_width": prefix,
        "host_ms_per_decode_step_median": 1e3 * host[len(host) // 2],
        "host_ms_per_decode_step_max": 1e3 * host[-1],
        "gather_device_ms_per_step": gather_ms / n_gathers,
        "gather_tail_bytes": tail,
        "gather_bound_ms": 2 * tail / PEAK_HBM_BYTES * 1e3,
        "traced_decode_step": step_trace, "launches_per_step": per_step,
        "rescore_max_err_per_token": errs[worst],
        "rescore_tol_per_token": RESCORE_TOL_PER_TOKEN,
        "kept_ids_in_vocabulary": share,
        "phase_s": time.perf_counter() - t_phase})
    print(f"[{path}] {json.dumps(stats)} | {CARD}", flush=True)


def _yaml_key(path, key):
    """The ``key`` block of a YAML (empty where it has none)."""
    import yaml

    with open(path) as f:
        return dict(yaml.safe_load(f).get(key) or {})


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
                     kind=None, want=None, geometry=None):
    """One downstream recipe through its CLI's functions at full width and
    depth: prepare (setup) on the reference YAML with the cuts,
    DOWNSTREAM_STEPS train steps, the plain replay of the first step with
    the same dropout generator and the dropout law on the decoder's
    input, the evaluation, and one evaluation call replayed plain.
    ``tag`` names the run's paths (``<tag>_train``, ``<tag>_eval``) and
    lines, ``kind`` the recipe (cls, itm, retrieval, or pretrain, which
    has no evaluation; default ``tag``), ``want`` the launches (per train
    step, per evaluation call) to check (default the 1.3B decoder's),
    ``geometry`` the recipe's (decoder width, depth, heads, head dim,
    attention dropout, batch, frames) to check where given."""
    kind = kind or tag
    from youku_mplug_tpu_torch.cli import common, run_cls
    from youku_mplug_tpu_torch.data.datasets import SyntheticRetrievalSplit
    from youku_mplug_tpu_torch.train.trainer import dropout_generator

    cfg_path = _downstream_yaml(yaml_path, overrides, out_dir)
    parser = module.base_parser if kind == "pretrain" else module.parser
    args = parser().parse_args([
        "--config", cfg_path, "--synthetic_data", "--max_steps",
        str(DOWNSTREAM_STEPS), "--device", "cuda", "--output_dir",
        os.path.join(out_dir, tag)])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prepared = ((module.setup(args),) if kind == "pretrain"
                else module.prepare(args))
    runner = prepared[0]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cfg, state = runner.cfg, runner.state
    layers = cfg.model.text.num_hidden_layers
    text = cfg.model.text
    got_geometry = (text.hidden_size, layers, text.num_attention_heads,
                    text.head_dim, text.attention_dropout, cfg.batch_size,
                    cfg.num_frames)
    if geometry is not None and got_geometry != geometry:
        fail(f"[{tag}] geometry {got_geometry}, expected {geometry}")
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

    step_ms = [h["step_time"] * 1e3 for h in history]
    out = {"yaml": os.path.relpath(yaml_path, REPO), "cuts": overrides,
           "geometry": got_geometry, "setup_s": setup_s,
           "steps": len(history),
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
           "replay": replay}
    if kind == "pretrain":
        print(f"[{tag}] {json.dumps(out, ensure_ascii=False)}", flush=True)
        return out

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
    out |= {"eval_s": eval_s, "eval_calls": calls,
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
          f"({DOWNSTREAM_SPLITS}); the decoder at {GPT13_CUT_LAYERS} of "
          "its 24 layers (the script's budget)", flush=True)
    out = {}
    cut = {"text_overrides": {"num_hidden_layers": GPT13_CUT_LAYERS}}
    for tag, module, path, cuts in (
            ("cls", run_cls, CLS_YAML,
             {"eval_video_batch": DOWNSTREAM_EVAL_CLIPS,
              "synthetic_length": 64, **cut}),
            ("itm", run_retrieval_itm, ITM_YAML,
             {"num_classes": 2, "eval_video_batch": DOWNSTREAM_EVAL_CLIPS,
              "batch_size": 32, "synthetic_length": 64, **cut}),
            ("retrieval", run_retrieval, RETRIEVAL_YAML,
             {"synthetic_length": 192, **cut})):
        out[tag] = _downstream_task(report, tag, module, path, cuts,
                                    out_dir)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[downstream] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


def phase_gpt3_27b(report, out_dir):
    """Phase 14, the GPT-3 2.7B decoder (2560 wide, 32 heads of 80, vocab
    51200; seeded weights; GPT27_LAYERS of its 32 layers) on two
    reference recipes at full width, with clip-b16: the caption recipe
    through
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
        if json.load(f)["num_hidden_layers"] != 32:
            fail("config_gpt3_2.7B.json is not the 32-layer decoder")
    layers = GPT27_LAYERS
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


# phase 44: the GPT-3 13B decoder (configs/models/config_gpt3_13B.json:
# hidden 5120, 40 heads of 128, 40 layers, vocab 51200) at JAX's compile
# configuration (tools/compile_13b.py:54-140): the flagship pretrain
# step with the 13B decoder frozen, no dropout, remat, ce_chunk 32, the
# ViT-B/16 at 8 frames, batch 4 and 80 text tokens (128 queries + 80 =
# 208 decoder tokens), GPT13B_STEPS steps through run_pretrain; and the
# flagship caption serving with the 13B decoder, 16 requests on 8 slots
GPT13B_JSON = os.path.join(REPO, "configs", "models", "config_gpt3_13B.json")
GPT13B_LAYERS = 40   # of its 40: no cut
GPT13B_STEPS = 3
GPT13B_BATCH = 4
# the 13B caption model's teacher-forced logits, kernels against plain,
# relative to the plain logits' largest magnitude, not LOGIT_TOL's 0.1
# absolute, which the 1.3B holds at max |logit| ~4.4 (reading 0.065).
# On the H100 the 13B read 0.1198 at max |logit| 6.66, 0.018 of
# it; a diagnostic replay split that into the vision kernels' query
# features (1-2 bf16 ulps off plain) moving the logits 0.14 with the
# decoder's kernels in both runs, and the decode kernel alone 0.11-0.12
# on shared query features: bf16 noise over 40 layers of 5120.  2^-5 of
# max |logit| (0.21 there) leaves 1.7x over that reading and half the
# instruct replays' OWL_REL_TOL
GPT13B_LOGIT_REL_TOL = 2.0 ** -5
# launches a pretrain step, written in PERF.md before the first chip
# run: the decoder's 40 layers, each K1 at d 128 forward and again in
# its recompute (remat), dq and dk/dv at d 128 once; the vision tower's
# 12 blocks x 2 K1 (d 64) and blocks 0 and 6 again (remat sixth), 24
# dq / dk/dv and AttentionPool's K4 and its K4b; the delta kernel once a
# backward
GPT13B_TRAIN_LAUNCHES = {"K1-d128": 2 * GPT13B_LAYERS,
                         "dq-d128": GPT13B_LAYERS,
                         "dkv-d128": GPT13B_LAYERS,
                         "K1": 28, "K4": 1, "dq": 25, "dkv": 25,
                         "delta": GPT13B_LAYERS + 25}


def _gpt13b_yaml(src, out_dir, name, **keys):
    """A copy of a flagship YAML with the 13B decoder (``text_cfg``, its
    model JSONs named by absolute path) and ``keys`` over it."""
    import yaml

    with open(src) as f:
        raw = yaml.safe_load(f)
    raw["visual_cfg"] = os.path.join(REPO, raw["visual_cfg"])
    raw["text_cfg"] = GPT13B_JSON
    if GPT13B_LAYERS != 40:
        raw.setdefault("text_overrides", {})["num_hidden_layers"] = \
            GPT13B_LAYERS
    raw.update(keys)
    dst = os.path.join(out_dir, name)
    with open(dst, "w") as f:
        yaml.safe_dump(raw, f, allow_unicode=True)
    return dst


def _frozen_sums(frozen):
    """Each frozen leaf's fp64 sum, a slab of its leading dim at a time
    (no fp32 or fp64 copy of a 13B leaf at once)."""
    out = {}
    with torch.no_grad():
        for k, p in frozen.items():
            out[k] = sum(float(part.double().sum())
                         for part in (p.split(1) if p.dim() else (p,)))
    return out


def phase_gpt3_13b(report, out_dir):
    """Phase 44 (see the constants above).  Serving: the serve CLI's path
    on the flagship serve YAML with the 13B decoder (``phase_slice``: 16
    requests, 8 slots, 32 tokens, each decode step a replay of the k = 1
    CUDA graph, 40 launches of K5 at d 128 with its K6 write a step),
    the teacher-forced replay with the plain versions (query features
    within QUERY_TOL, logits within GPT13B_LOGIT_REL_TOL x the plain
    logits' largest magnitude), and the served tokens against a plain
    replay of them (plain attention over the cache) up to each request's
    first near-tie (CAPTION_TIE_GAP).  Training: run_pretrain's setup
    (the frozen decoder built in bf16, ``common.build_train_model``) and
    GPT13B_STEPS steps, their launches a step exactly
    GPT13B_TRAIN_LAUNCHES, finite losses, the trainable leaves moved and
    the frozen ones unchanged, and the plain replay of one step (loss
    within REPLAY_LOSS_TOL, leaves REPLAY_GRAD_TOL); peak memory of
    each, the decode step's device ms (a replay of the k = 1 graph of 8
    slots) and the train steps' ms."""
    from youku_mplug_tpu_torch.cli import common, run_pretrain, serve

    t_phase = time.perf_counter()
    with open(GPT13B_JSON) as f:
        j = json.load(f)
    if (j["hidden_size"], j["num_hidden_layers"], j["num_attention_heads"],
            j["vocab_size"]) != (5120, 40, 40, 51200):
        fail(f"config_gpt3_13B.json is not the 13B decoder: {j}")
    # caption serving
    serve_yaml = _gpt13b_yaml(FLAGSHIP_YAML, out_dir, "serve_13b.yaml")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, model, stats = phase_slice(report, out_dir, serve_yaml,
                                    "gpt3_13b_serve")
    text = cfg.model.text
    if (text.hidden_size, text.num_hidden_layers, text.num_attention_heads,
            text.head_dim) != (5120, GPT13B_LAYERS, 40, 128):
        fail(f"13B serve geometry {text}")
    serve_peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    phase_teacher_forced(cfg, model, "gpt3-13B teacher-forced",
                         logit_rel_tol=GPT13B_LOGIT_REL_TOL)
    forced_s = time.perf_counter() - t0
    args16 = _serve_args(serve_yaml, 16)
    requests = _caption_requests(cfg, model)
    make = lambda: serve.make_engine(args16, cfg, model.text_decoder)[0]  # noqa: E731
    eng = make()
    for ids, kw in requests:
        eng.submit(ids, **kw)
    served = [f.tokens for f in sorted(eng.run_to_completion(),
                                       key=lambda f: f.rid)]
    # a decode step of the 8 slots: one replay of the k = 1 graph (its
    # staging copy included), device ms from CUDA events
    step_ms = time_ms(lambda: eng._launch(1), 20)
    del eng
    gaps, top, picks = _plain_gaps(make, requests, served)
    _tie_check("gpt3-13B served vs plain replay", served,
               [t[:1] + p for t, p in zip(served, picks)], gaps,
               CAPTION_TIE_GAP)
    weight_gb = sum(p.numel() * p.element_size() for p in
                    model.text_decoder.parameters()) / 1e9
    del model, requests
    gc.collect()
    torch.cuda.empty_cache()
    serve_s = time.perf_counter() - t_phase
    # the pretrain step
    train_yaml = _gpt13b_yaml(TRAIN_YAML, out_dir, "pretrain_13b.yaml",
                              batch_size=GPT13B_BATCH)
    args = run_pretrain.base_parser().parse_args([
        "--config", train_yaml, "--output_dir",
        os.path.join(out_dir, "pretrain13b"), "--synthetic_data",
        "--max_steps", str(GPT13B_STEPS), "--device", "cuda"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = run_pretrain.setup(args)
    train_step = run_pretrain.build_train_step(runner)
    state = runner.state
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated()
    rt = runner.cfg.model.text
    if (rt.hidden_size, rt.num_hidden_layers, rt.head_dim, rt.remat,
            rt.ce_chunk, rt.hidden_dropout, rt.attention_dropout,
            runner.cfg.batch_size) != (5120, GPT13B_LAYERS, 128, True, 32,
                                       0.0, 0.0, GPT13B_BATCH):
        fail(f"the 13B pretrain configuration {rt}, batch "
             f"{runner.cfg.batch_size}")
    frozen_gb = sum(p.numel() * p.element_size()
                    for p in state.frozen.values()) / 1e9
    if any(p.dtype != torch.bfloat16 for p in state.frozen.values()):
        fail("the 13B's frozen decoder is not bf16")
    sums0 = _frozen_sums(state.frozen)
    trainable0 = {k: p.detach().clone() for k, p in state.trainable.items()}
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(report)
    history = common.train_one_epoch(runner, train_step, 0,
                                     run_pretrain.make_batch)
    torch.cuda.synchronize()
    _read_counts(report, "gpt3_13b_train")
    train_peak = torch.cuda.max_memory_allocated()
    per_step = {r["key"]: r["launches_by_path"]["gpt3_13b_train"]
                / max(len(history), 1) for r in report
                if r["launches_by_path"]["gpt3_13b_train"]}
    if per_step != GPT13B_TRAIN_LAUNCHES:
        fail(f"13B pretrain launches a step {per_step}, predicted "
             f"{GPT13B_TRAIN_LAUNCHES}")
    if len(history) != GPT13B_STEPS or any(
            not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]))
            or h["skipped_nonfinite"] for h in history):
        fail(f"13B pretrain steps {history}")
    moved = sum(not torch.equal(p.detach(), trainable0[k])
                for k, p in state.trainable.items())
    if moved == 0 or _frozen_sums(state.frozen) != sums0:
        fail(f"13B pretrain: {moved} trainable leaves moved, the frozen "
             f"decoder changed: {_frozen_sums(state.frozen) != sums0}")
    del trainable0
    loss_k, loss_p, finite, _, rows = _replay(
        runner, run_pretrain.make_batch, run_pretrain.make_loss_fn,
        "gpt3-13B replay")
    if not finite or abs(loss_k - loss_p) > REPLAY_LOSS_TOL \
            or rows[0][0] > REPLAY_GRAD_TOL:
        fail("the 13B plain replay out of tolerance")
    train_ms = [h["step_time"] * 1e3 for h in history]
    summary = {
        "serve_tokens_per_sec": stats["tokens_per_sec"],
        "decode_step_ms": step_ms, "serve_peak_gib": serve_peak / 2**30,
        "decoder_weights_gb": weight_gb, "near_tie_top_logit": top,
        "train_setup_s": setup_s, "train_setup_peak_gib": setup_peak / 2**30,
        "frozen_gb": frozen_gb, "train_step_ms": train_ms,
        "loss": [h["loss"] for h in history],
        "grad_norm": [h["grad_norm"] for h in history],
        "train_peak_gib": train_peak / 2**30, "launches_per_step": per_step,
        "trainable_moved": f"{moved}/{len(state.trainable)}",
        "teacher_forced_s": forced_s, "serve_s": serve_s}
    print(f"[gpt3-13B] {json.dumps(summary)} | {GPT13B_LAYERS} of 40 "
          f"layers | {CARD}", flush=True)
    del runner, state, history
    gc.collect()
    torch.cuda.empty_cache()


def phase_shipped_yamls(report, out_dir):
    """Phase 27, the shipped recipes no phase above runs, through their
    CLIs' functions at full width as phase 13 runs its three, the 1.3B
    decoder at GPT13_CUT_LAYERS and the 2.7B at GPT27_LAYERS layers:
    the reference pretrain recipe at GPT-3 1.3B and 2.7B (clip-b16 at 4
    frames, batch 48, the decoders under their 0.1 dropouts: one K4, dq
    and dk/dv at head dim 96 and one delta a step, the decoder on plain
    attention), dual-encoder retrieval at 2.7B (batch 96; its 80-token
    text tower runs plain attention, as JAX's dispatch does at 32 heads
    of 80, and the clip-b16 tower einsum attention: no kernel) and ITM
    rerank at 2.7B (a K4 d 96 backward a step; its evaluation's
    208-position passes run K4 at head dim 80, twice a layer a call).
    The routes are the JAX package's rule (tests/test_torch_dispatch.py,
    tests/test_torch_shipped_yamls.py)."""
    from youku_mplug_tpu_torch.cli import run_pretrain, run_retrieval
    from youku_mplug_tpu_torch.cli import run_retrieval_itm

    t_phase = time.perf_counter()
    d96 = {"K4-d96": 1, "dq-d96": 1, "dkv-d96": 1, "delta": 1}
    cut13 = {"text_overrides": {"num_hidden_layers": GPT13_CUT_LAYERS}}
    cut27 = {"text_overrides": {"num_hidden_layers": GPT27_LAYERS}}
    runs = (
        ("pretrain13", run_pretrain, PRETRAIN13_REF_YAML, "pretrain",
         {"synthetic_length": 48 * DOWNSTREAM_STEPS, **cut13},
         (2048, GPT13_CUT_LAYERS, 32, 64, 0.1, 48, 4), (d96, None)),
        ("pretrain27", run_pretrain, PRETRAIN27_YAML, "pretrain",
         {"synthetic_length": 48 * DOWNSTREAM_STEPS, **cut27},
         (2560, GPT27_LAYERS, 32, 80, 0.1, 48, 4), (d96, None)),
        ("retrieval27", run_retrieval, RETRIEVAL27_YAML, "retrieval",
         {"synthetic_length": 96 * DOWNSTREAM_STEPS, **cut27},
         (2560, GPT27_LAYERS, 32, 80, 0.1, 96, 4), ({}, {})),
        ("itm27", run_retrieval_itm, ITM27_YAML, "itm",
         {"num_classes": 2, "eval_video_batch": DOWNSTREAM_EVAL_CLIPS,
          "batch_size": ITM27_BATCH,
          "synthetic_length": ITM27_BATCH * DOWNSTREAM_STEPS, **cut27},
         (2560, GPT27_LAYERS, 32, 80, 0.1, ITM27_BATCH, 4),
         (d96, {"K4-d96": 1, "K4-d80": 2 * GPT27_LAYERS})))
    print("[shipped] cuts: " + "; ".join(f"{tag} {cuts}" for tag, _, _, _,
                                         cuts, _, _ in runs)
          + f" (the ITM batch is {ITM27_BATCH} clips, not the YAML's 96: "
          "3 x 96 rows of 208 positions through the 2.7B decoder would hold "
          "~270 GB of activations; its match head has num_classes 2, "
          "ROADMAP Queue 3; an evaluation call scores "
          f"{DOWNSTREAM_EVAL_CLIPS} clips); synthetic clips, seeded "
          f"weights, the evaluation splits {DOWNSTREAM_SPLITS}", flush=True)
    out = {}
    for tag, module, path, kind, cuts, geometry, want in runs:
        out[tag] = _downstream_task(report, tag, module, path, cuts, out_dir,
                                    kind=kind, want=want, geometry=geometry)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[shipped] phase {time.perf_counter() - t_phase:.1f} s | {CARD}",
          flush=True)
    return out


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
    if raw.get("bloom_model_json"):
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
    moments = st.optimizer.leaf_state()
    bad += [f"optimizer state {k}" for k in st.trainable
            if set(moments.get(k, {})) != set(raw["optim"].get(k, {})) or any(
                not torch.equal(moments[k][m].to(v.device), v)
                for m, v in raw["optim"].get(k, {}).items())]
    if bad or (st.optimizer.count, st.step) != (raw["count"], raw["step"]):
        fail(f"instruct_hf_train --resume differs from step {step}: "
             f"{bad[:8]}, count/step {(st.optimizer.count, st.step)}")
    print(f"[instruct_hf_train] --resume in {resume_s:.2f} s, import "
          f"included: {len(st.trainable)} trainable and {len(st.frozen)} "
          f"frozen leaves, {len(raw['optim'])} AdamW moment pairs, count "
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


# ---------------------------------------------------------------------------
# phases 20-24: the runners on video files


CARD = ""  # nvidia-smi's name and power limit, set by main
START = time.perf_counter()  # the script's start (the module's import)


class _TimedLoader:
    """A loader whose consumer's waits are timed: ``waits`` holds the
    seconds each ``next`` took, ``rows`` each batch's fields but the
    clips."""

    def __init__(self, loader):
        self.loader, self.waits, self.rows = loader, [], []

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                self.waits.append(time.perf_counter() - t0)
                self.rows.append({k: v for k, v in batch.items()
                                  if k != "video"})
                yield batch
        finally:
            it.close()


def _file_texture(k):
    """Clip k's smooth texture, 4 px wider a frame than the frame."""
    import numpy as np

    w, h = FILE_SIZE
    x = np.arange(w + 4 * FILE_SECONDS * FILE_FPS)[None, :, None]
    y = np.arange(h)[:, None, None]
    c = np.arange(3)[None, None, :]
    return (128 + 60 * np.sin(x / 23.0 + c + k)
            * np.cos(y / 17.0 + k)).astype(np.uint8)


def _file_frame(texture, i):
    """Frame i (BGR, as cv2 writes it): the texture drifted 4 px a frame
    under two bands, i mod 16 (left) and i // 16 (right), each digit d
    at grey level 16 d + 8."""
    import numpy as np

    w = FILE_SIZE[0]
    f = np.ascontiguousarray(texture[:, 4 * i:4 * i + w])
    f[:FILE_BAND_ROWS, :w // 2] = (i % 16) * 16 + 8
    f[:FILE_BAND_ROWS, w // 2:] = (i // 16) * 16 + 8
    return f


def _frame_index(rgb):
    """The index a decoded RGB frame's bands encode (their centres)."""
    w = FILE_SIZE[0]
    lo = rgb[4:FILE_BAND_ROWS - 4, 40:w // 2 - 40].mean()
    hi = rgb[4:FILE_BAND_ROWS - 4, w // 2 + 40:w - 40].mean()
    return int(round((lo - 8) / 16)) + 16 * int(round((hi - 8) / 16))


def _write_clip(path, fourcc, k):
    import cv2

    tex = _file_texture(k)
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), FILE_FPS,
                        FILE_SIZE)
    if not w.isOpened():
        return False
    for i in range(FILE_SECONDS * FILE_FPS):
        w.write(_file_frame(tex, i))
    w.release()
    return True


def phase_files_written(root):
    """Phase 20: FILE_CLIPS clips written under ``root`` on as many
    threads as cores, mp4v in .mp4 (MJPG in .avi where cv2 cannot read
    the first back), and one annotation file per format (ids without an
    extension: the datasets find .mp4, then .avi).  Gates: for every clip
    the frames ``read_frames(sample="middle")`` returns are the ones
    ``get_frame_indices`` names (their bands), each within FILE_MAE_TOL
    of the frame written.  Returns the annotation paths and facts."""
    from concurrent.futures import ThreadPoolExecutor

    import cv2
    import numpy as np

    from youku_mplug_tpu_torch.data.samplers import get_frame_indices
    from youku_mplug_tpu_torch.data.video_decode import read_frames

    t_phase = time.perf_counter()
    n_frames = FILE_SECONDS * FILE_FPS
    for ext, fourcc in ((".mp4", "mp4v"), (".avi", "MJPG")):
        probe = os.path.join(root, "probe" + ext)
        cap = (cv2.VideoCapture(probe) if _write_clip(probe, fourcc, 0)
               else None)
        ok = cap is not None and cap.isOpened() and int(
            cap.get(cv2.CAP_PROP_FRAME_COUNT)) == n_frames
        backend = cap.getBackendName() if ok else None
        if cap is not None:
            cap.release()
        os.remove(probe) if os.path.exists(probe) else None
        if ok:
            break
    else:
        fail("cv2 reads back neither an mp4v .mp4 nor an MJPG .avi clip")
    names = [f"clip{k:02d}" for k in range(FILE_CLIPS)]
    workers = os.cpu_count() or 1
    t0 = time.perf_counter()
    with ThreadPoolExecutor(workers) as pool:
        written = list(pool.map(
            lambda k: _write_clip(os.path.join(root, names[k] + ext),
                                  fourcc, k), range(FILE_CLIPS)))
    write_s = time.perf_counter() - t0
    if not all(written):
        fail(f"cv2 failed to write {written.count(False)} clips")
    mb = sum(os.path.getsize(os.path.join(root, n + ext))
             for n in names) / 2 ** 20

    want = get_frame_indices(8, n_frames, "middle")
    maes, bad = [], []
    t0 = time.perf_counter()
    decoded = [read_frames(os.path.join(root, n + ext), num_frames=8,
                           sample="middle") for n in names]
    decode_s = time.perf_counter() - t0
    for k, frames in enumerate(decoded):
        tex = _file_texture(k)
        got = [_frame_index(f) for f in frames]
        if got != want or frames.shape != (8, FILE_SIZE[1], FILE_SIZE[0],
                                           3):
            bad.append((names[k], got, frames.shape))
        maes += [float(np.abs(f.astype(np.int16)
                              - _file_frame(tex, i)[..., ::-1]).mean())
                 for f, i in zip(frames, want)]
    if bad or max(maes) > FILE_MAE_TOL:
        fail(f"[files_written] decoded frames: wrong indices {bad[:3]} "
             f"(want {want}); max mean abs err {max(maes):.3f} (tol "
             f"{FILE_MAE_TOL})")

    def ann(name, text):
        path = os.path.join(root, name)
        with open(path, "w") as f:
            f.write(text)
        return path

    def jsonl(name, rows):
        return ann(name, "".join(json.dumps(r, ensure_ascii=False) + "\n"
                                 for r in rows))
    files = {
        "root": root, "ext": ext, "names": names,
        # the pretrain CSV lists every clip twice (FILES_TRAIN_STEPS
        # batches of 16)
        "pretrain_csv": ann("pretrain.csv", "video_id:FILE,title\n" + "".join(
            f"{n},第{k % FILE_CLIPS}段 视频 的标题\n"
            for k, n in enumerate(names * 2))),
        "caption_jsonl": jsonl("caption_test.jsonl", [
            {"video_id": n, "golden_caption": [f"片段{k}的描述",
                                               f"第{k}段视频"]}
            for k, n in enumerate(names[:16])]),
        "cls_csv": ann("cls.csv", "video_id:FILE,video_title,category_id\n"
                       + "".join(f"{n},视频{k}的标题,{k % 45}\n"
                                 for k, n in enumerate(names))),
        "cls_test_csv": ann("cls_test.csv",
                            "video_id:FILE,video_title,category_id\n"
                            + "".join(f"{n},测试{k},{(7 * k) % 45}\n"
                                      for k, n in enumerate(names[:32]))),
        "retrieval_jsonl": jsonl("retrieval.jsonl", [
            {"clip_name": n, "caption": f"第{k}段视频"}
            for k, n in enumerate(names)]),
        "instruct_jsonl": jsonl("instruct.jsonl", [
            {"video": os.path.join(root, n + ext),
             "question": OWL_QUESTIONS[k % len(OWL_QUESTIONS)],
             "answer": f"The clip numbered {k} shows a drifting pattern."}
            for k, n in enumerate(names[:2 * FILES_OWL_ROWS])]),
    }
    print(f"[files_written] {FILE_CLIPS} clips of {FILE_SECONDS} s at "
          f"{FILE_FPS} fps, {FILE_SIZE[0]}x{FILE_SIZE[1]}, container {ext} "
          f"codec {fourcc}, read back by cv2 {cv2.__version__} through "
          f"{backend}; {mb:.1f} MiB written in {write_s:.2f} s on "
          f"{workers} threads | read_frames(8, middle) on one thread "
          f"{decode_s / FILE_CLIPS * 1e3:.1f} ms a clip (it decodes up to "
          f"frame {want[-1]} of {n_frames}); every clip's frames are "
          f"{want}, mean abs err max {max(maes):.3f} mean "
          f"{sum(maes) / len(maes):.3f} (tol {FILE_MAE_TOL}) | phase "
          f"{time.perf_counter() - t_phase:.1f} s | {CARD}", flush=True)
    return files


def _loader_rate(ds, batch_size, workers):
    """Clips a second of one pass of a Loader over ``ds`` in order."""
    from youku_mplug_tpu_torch.data.loader import Loader

    t0 = time.perf_counter()
    n = sum(len(b["index"]) for b in Loader(
        ds, batch_size, shuffle=False, num_workers=workers))
    return n / (time.perf_counter() - t0)


def phase_serve_files(report, model, files, out_dir):
    """Phase 21 (on phase 3's model): the serve CLI's path with
    serve_gpt3_1.3B_flagship.yaml's test_file and video_root pointed at
    the written clips, 16 requests, 8 slots.  Gates: every batch of the
    YAML's threaded loader equal, bitwise, to a one-thread pass, and each
    sample the index asked for (no decode walked past); K5 and K6 launches
    a decode step exact; every result a caption; phase 4's teacher-forced
    gate on the first 8 clips."""
    import numpy as np

    from youku_mplug_tpu_torch.cli import common, run_caption, serve
    from youku_mplug_tpu_torch.config import load_config
    from youku_mplug_tpu_torch.data.loader import Loader

    t_phase = time.perf_counter()
    yaml = _downstream_yaml(FLAGSHIP_YAML, {
        "test_file": files["caption_jsonl"], "video_root": files["root"]},
        out_dir)
    args = serve.serve_parser().parse_args([
        "--config", yaml, "--num_requests", "16", "--num_slots", "8",
        "--device", "cuda", "--output_dir", out_dir])
    cfg = load_config(yaml)
    ds = run_caption.dataset(args, cfg, train=False)
    threaded = common.make_loader(args, cfg, ds, shuffle=False)
    single = Loader(ds, cfg.batch_size, shuffle=False)
    for got, want, idx in zip(threaded, single, single.batch_indices()):
        if not (np.array_equal(got["video"], want["video"])
                and got["video_id"] == want["video_id"]
                and got["index"].tolist() == want["index"].tolist()
                == idx.tolist()):
            fail(f"serve_files: the threaded loader's batch {idx.tolist()} "
                 f"differs from the one-thread pass or from the indices")
    cores = os.cpu_count() or 1
    rates = {w: _loader_rate(ds, cfg.batch_size, w)
             for w in sorted({cfg.num_workers, 1, cores})}

    _reset_counts(report)
    stats, out, engine = serve.run(args, cfg, model,
                                   next(model.parameters()).device)
    torch.cuda.synchronize()
    _read_counts(report, "serve_files")
    layers = cfg.model.text.num_hidden_layers
    per_step = _per_step(report, "serve_files", engine.decode_steps,
                         {"K5": layers, "K6": layers})
    names = files["names"][:16]
    if [o["video_id"] for o in out] != names or any(
            not o["tokens"] or not o["caption"] for o in out):
        fail(f"serve_files results: {out}")
    if engine.nonfinite_logits:
        fail(f"{engine.nonfinite_logits} logit rows were not finite")
    clips = torch.from_numpy(next(iter(single))["video"])
    rates = {str(w): round(r, 2) for w, r in rates.items()}
    print(f"[serve_files] {json.dumps(stats)} | loader clips/s by decode "
          f"threads {json.dumps(rates)} (YAML num_workers "
          f"{cfg.num_workers}, {cores} cores) | "
          f"{engine.decode_steps} decode steps, launches per step {per_step}"
          f" | first caption {out[0]['caption'][:24]!r} | {CARD}", flush=True)
    phase_teacher_forced(cfg, model, "serve_files teacher-forced", clips)
    print(f"[serve_files] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return stats


def phase_pretrain_files(report, runner, files, out_dir, synthetic):
    """Phase 22 (on phase 5's runner: its setup, weights and optimizer
    state): ``run_pretrain.build_loader`` on the pretrain CSV under the
    flagship pretrain YAML (batch 16, its num_workers decoding with the
    train transform), FILES_TRAIN_STEPS steps through ``train_one_epoch``
    with the workers as threads (the YAML's default), then as many with
    them as forked processes (``workers_impl: process``).  Gates: finite,
    no skipped step; launches per step equal to phase 5's on synthetic
    clips.  Prints step ms beside phase 5's and the ms each step waited on
    the loader."""
    from youku_mplug_tpu_torch.cli import common, run_pretrain
    from youku_mplug_tpu_torch.config import load_config

    want = {k: v / synthetic["steps"]
            for k, v in synthetic["launches"].items()}
    for impl in ("thread", "process"):
        t_phase = time.perf_counter()
        yaml = _downstream_yaml(TRAIN_YAML, {
            "train_file": files["pretrain_csv"],
            "train_video_root": files["root"], "workers_impl": impl},
            out_dir)
        args = run_pretrain.base_parser().parse_args([
            "--config", yaml, "--output_dir", out_dir, "--max_steps",
            str(FILES_TRAIN_STEPS), "--device", "cuda"])
        cfg = load_config(yaml)
        timed = _TimedLoader(run_pretrain.build_loader(args, cfg))
        if len(timed) != FILES_TRAIN_STEPS:
            fail(f"pretrain_files: {len(timed)} batches in the CSV")
        saved = runner.loader, runner.args
        runner.loader, runner.args = timed, args
        try:
            _reset_counts(report)
            t0 = time.perf_counter()
            history = common.train_one_epoch(
                runner, run_pretrain.build_train_step(runner), 0,
                run_pretrain.make_batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            runner.loader, runner.args = saved
        _read_counts(report, "pretrain_files")
        if len(history) != FILES_TRAIN_STEPS or any(
                not (math.isfinite(h["loss"])
                     and math.isfinite(h["grad_norm"]))
                or h["skipped_nonfinite"] for h in history):
            fail(f"pretrain_files ({impl}) steps: {history}")
        per_step = _launches_per(report, "pretrain_files", len(history),
                                 want)
        step_ms = [h["step_time"] * 1e3 for h in history]
        wait_ms = [w * 1e3 for w in timed.waits]
        print(f"[pretrain_files] workers_impl {impl}: {len(history)} steps "
              f"of {cfg.batch_size} clips from the CSV ({cfg.num_workers} "
              f"decode workers, {os.cpu_count()} cores) in {wall:.2f} s, "
              f"{len(history) * cfg.batch_size / wall:.2f} clips/s: step "
              f"ms {[round(x, 1) for x in step_ms]} (phase 5 on synthetic "
              f"clips, same run: "
              f"{[round(x, 1) for x in synthetic['step_ms_each']]}); ms "
              f"waited on the loader before each step "
              f"{[round(x, 1) for x in wait_ms]}; loss "
              f"{[round(h['loss'], 4) for h in history]}; launches per step "
              f"{per_step} (= phase 5's) | phase "
              f"{time.perf_counter() - t_phase:.1f} s | {CARD}", flush=True)


def phase_cls_files(report, files, out_dir):
    """Phase 23: run_cls on cls_gpt3_1.3B_youku_v0_sharp_2.yaml with its
    files pointed at the three-column CSVs (train and val: 64 clips;
    test: 32), phase 13's cuts (eval_video_batch 4): DOWNSTREAM_STEPS
    train steps and the evaluation of one test batch.  Gates: every
    title and label the loaders yield the file's (no -1: the CSV repair),
    finite, launches per train step and per evaluation call as phase
    13's cls."""
    from youku_mplug_tpu_torch.cli import common, run_cls
    from youku_mplug_tpu_torch.data.datasets import pre_caption

    t_phase = time.perf_counter()
    yaml = _downstream_yaml(CLS_YAML, {
        "eval_video_batch": DOWNSTREAM_EVAL_CLIPS,
        "train_file": files["cls_csv"], "val_file": files["cls_csv"],
        "test_file": files["cls_test_csv"], "video_root": files["root"]},
        out_dir)
    args = run_cls.parser().parse_args([
        "--config", yaml, "--max_steps", str(DOWNSTREAM_STEPS), "--device",
        "cuda", "--output_dir", os.path.join(out_dir, "cls_files")])
    t0 = time.perf_counter()
    runner, _, test_loader, classnames = run_cls.prepare(args)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cfg = runner.cfg
    layers = cfg.model.text.num_hidden_layers
    train, test = _TimedLoader(runner.loader), _TimedLoader(test_loader)
    runner.loader = train
    _reset_counts(report)
    history = common.train_one_epoch(
        runner, run_cls.build_train_step(runner), 0,
        run_cls.make_batch_factory(classnames, cfg.max_length))
    torch.cuda.synchronize()
    _read_counts(report, "cls_files_train")
    if len(history) != DOWNSTREAM_STEPS or any(
            not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]))
            or h["skipped_nonfinite"] for h in history):
        fail(f"cls_files train steps: {history}")
    per_step = _launches_per(report, "cls_files_train", len(history),
                             {"K4-d96": 1, "dq-d96": 1, "dkv-d96": 1,
                              "delta": 1})
    _reset_counts(report)
    t0 = time.perf_counter()
    metrics = run_cls.evaluation(runner, test, classnames)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    _read_counts(report, "cls_files_eval")
    calls = -(-cfg.batch_size // DOWNSTREAM_EVAL_CLIPS)
    per_call = _launches_per(report, "cls_files_eval", calls,
                             {"K4-d96": 1, "K1": 2 * layers})
    if not all(math.isfinite(v) for v in metrics.values()):
        fail(f"cls_files evaluation metrics {metrics}")
    rows = {}
    for path, sep in ((files["cls_csv"], "视频"), (files["cls_test_csv"],
                                                    "测试")):
        with open(path) as f:
            rows[path] = [line.rstrip("\n").split(",")
                          for line in f.readlines()[1:]]
    seen, bad = 0, []
    for loader, path in ((train, files["cls_csv"]),
                         (test, files["cls_test_csv"])):
        for batch in loader.rows:
            for i, text, label in zip(batch["index"], batch["text"],
                                      batch["label"]):
                _, title, cat = rows[path][int(i)]
                seen += 1
                if text != pre_caption(title, 80) or int(label) != int(cat):
                    bad.append((int(i), text, int(label)))
    if bad or seen != (DOWNSTREAM_STEPS + 1) * cfg.batch_size:
        fail(f"cls_files: {seen} rows seen, titles or labels not the "
             f"file's: {bad[:5]}")
    print(f"[cls_files] setup {setup_s:.2f} s; {len(history)} steps of "
          f"{cfg.batch_size} clips x {cfg.num_frames} frames from the CSV, "
          f"step ms {[round(h['step_time'] * 1e3, 1) for h in history]}, "
          f"loss {[round(h['loss'], 4) for h in history]}, ms waited on the "
          f"loader {[round(w * 1e3, 1) for w in train.waits]}; launches per "
          f"step {per_step} | evaluation of {cfg.batch_size} test clips in "
          f"{eval_s:.2f} s ({calls} calls, launches per call {per_call}), "
          f"metrics {json.dumps(metrics)} | {seen} rows: every title and "
          f"label the file's, none -1 | phase "
          f"{time.perf_counter() - t_phase:.1f} s | {CARD}", flush=True)


def phase_instruct_files(report, files, out_dir):
    """Phase 24: ``run_instruct --engine --input_jsonl`` over
    FILES_OWL_ROWS rows of the written clips, then ``--train
    --train_jsonl`` for FILES_OWL_TRAIN_STEPS LoRA steps, both with Bloom
    cut to OWL_CUT (as phases 17-19).  Gates: K1 once per ViT block a
    serving call and K5-ALiBi (with K6) once per layer a decode step, no
    other kernel; phase 8's teacher-forced gate on the decoded clips;
    per train step K1, dq, dk/dv with ALiBi and the delta kernel once per
    layer and K1 once per ViT block."""
    from youku_mplug_tpu_torch.cli import run_instruct

    t_phase = time.perf_counter()
    serve_yaml = _owl_yaml(OWL_YAML, out_dir, OWL_CUT)
    jsonl = os.path.join(out_dir, "requests.jsonl")
    with open(files["instruct_jsonl"]) as f:
        rows = f.readlines()
    with open(jsonl, "w") as f:
        f.writelines(rows[:FILES_OWL_ROWS])
    args = run_instruct.parser().parse_args([
        "--config", serve_yaml, "--engine", "--input_jsonl", jsonl,
        "--num_slots", str(OWL_SLOTS), "--device", "cuda", "--output_dir",
        out_dir])
    t0 = time.perf_counter()
    cfg, raw, model, device = run_instruct.build(args)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, batch, clips = run_instruct.prepare(
        args, cfg, raw, device, model.policy.compute_dtype,
        run_instruct.build_tokenizer(args, cfg))
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    gen_cfg = run_instruct.generation_config(args, cfg, raw)
    run_instruct.serve_instruct(  # warm-up
        model, clips[:2], {k: v[:2] for k, v in batch.items()},
        dataclasses.replace(gen_cfg, max_new_tokens=4), num_slots=2)
    torch.cuda.synchronize()
    _reset_counts(report)
    seqs, stats, engine = run_instruct.serve_instruct(
        model, clips, batch, gen_cfg, num_slots=args.num_slots)
    torch.cuda.synchronize()
    _read_counts(report, "instruct_files")
    layers = cfg.text.num_hidden_layers
    per_step = _per_step(report, "instruct_files", engine.decode_steps,
                         {"K5-ALiBi": layers, "K6": layers})
    flash = {r["key"]: r["launches_by_path"]["instruct_files"]
             for r in report if not r["key"].startswith(("K5", "K6"))}
    if any(n != (cfg.vision.depth if k == "K1" else 0)
           for k, n in flash.items()):
        fail(f"instruct_files: flash launches {flash}, expected K1 "
             f"{cfg.vision.depth} and no other")
    if stats["requests"] != FILES_OWL_ROWS or engine.nonfinite_logits \
            or not (seqs != gen_cfg.pad_id).any(1).all():
        fail(f"instruct_files served {stats['requests']} requests, "
             f"{engine.nonfinite_logits} non-finite logit rows")
    shown = {k: stats[k] for k in ("requests", "new_tokens",
                                   "tokens_per_sec", "latency_p50_s",
                                   "latency_p95_s", "wall_s")}
    print(f"[instruct_files] Bloom cut to {layers} layers; build "
          f"{build_s:.2f} s; {FILES_OWL_ROWS} clips decoded (middle, "
          f"{raw.get('num_frames', 8)} frames, resized to "
          f"{raw.get('image_res', 224)}) in {decode_s:.2f} s on one thread; "
          f"{json.dumps(shown)}"
          f" | launches per decode step {per_step}, K1 {flash['K1']} | "
          f"{CARD}", flush=True)
    phase_instruct_forced(model, batch, clips, "instruct_files teacher-forced")
    del model, batch, clips, engine
    gc.collect()
    torch.cuda.empty_cache()

    train_yaml = _owl_yaml(OWL_TRAIN_YAML, out_dir, OWL_CUT, epochs=1,
                           video_root="")
    targs = run_instruct.parser().parse_args([
        "--config", train_yaml, "--train", "--train_jsonl",
        files["instruct_jsonl"], "--max_steps", str(FILES_OWL_TRAIN_STEPS),
        "--device", "cuda", "--output_dir", os.path.join(out_dir, "train")])
    _reset_counts(report)
    t0 = time.perf_counter()
    runner = run_instruct.train_main(targs)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    _read_counts(report, "instruct_files_train")
    history = runner.history
    if len(history) != FILES_OWL_TRAIN_STEPS or any(
            not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]))
            or h["skipped_nonfinite"] for h in history):
        fail(f"instruct_files_train steps: {history}")
    per_step = _launches_per(
        report, "instruct_files_train", len(history),
        {"K1-ALiBi": layers, "dq-ALiBi": layers, "dkv-ALiBi": layers,
         "delta": layers, "K1": runner.model.cfg.vision.depth})
    print(f"[instruct_files_train] {len(history)} LoRA steps of "
          f"{runner.cfg.batch_size} rows from the jsonl in {train_s:.2f} s "
          f"(setup included): step ms "
          f"{[round(h['step_time'] * 1e3, 1) for h in history]}, loss "
          f"{[round(h['loss'], 4) for h in history]}; launches per step "
          f"{per_step} | phase {time.perf_counter() - t_phase:.1f} s | "
          f"{CARD}", flush=True)
    del runner, history
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------
# phases 28-32: the training knobs (GPT-3 and vision LoRA, connect_ln,
# vision and decoder dropout and drop-path, Bloom remat and ce_chunk, the
# optimizer zoo, asynchronous checkpoints) on the paths users already run

KNOBS_STEPS = 3            # phase 28: the async save after step 2
KNOBS_DROPOUT_STEPS = 2    # phase 29
KNOBS_OWL_STEPS = 2        # phase 31
# phase 28's knobs on the flagship pretrain YAML
KNOBS_PRETRAIN = {"lora_rank": 8, "connect_ln": True, "freeze_vit": True}
KNOBS_VISION = {"lora_rank": 4, "drop_path": 0.1}
KNOBS_OPT = {"opt": "adamp"}
# phase 29's launches per step, predicted from JAX's rule before the
# first run: attention dropout takes every vision and decoder attention
# off the flash kernels (K1 none), AttentionPool keeps its head-major
# forward and backward (one K4, one dq and one dk/dv, one delta a step)
KNOBS_DROPOUT_LAUNCHES = {"K4": 1, "dq": 1, "dkv": 1, "delta": 1}
# phase 31: the chunked LM loss against the dense one on the same batch
# and dropout masks (relative): the same fp32 logits summed in another
# grouping
CE_CHUNK_TOL = 1e-5
# phase 32: every zoo name (lookahead_adamw past its first sync at 6)
# over the flagship's trainable leaves, fp32 on the card against the same
# updates in fp64 on the CPU, each leaf's relative L2 after the updates.
# The leaves differ by their fp32 rounding (~6e-8 relative); the updates'
# own sums are printed (the bias corrections 1 - b^t, taken in float32
# as JAX takes them, move the Adam family's by ~1e-5)
ZOO_UPDATES, ZOO_LOOKAHEAD_UPDATES = 3, 6
ZOO_TOL = 1e-5
ZOO_SEED = 32


def _knobs_yaml(src, out_dir, name, visual=None, text=None, optimizer=None,
                **top):
    """A copy of a pretrain or serve YAML with its model JSONs by absolute
    path, ``visual`` / ``text`` merged into its visual_overrides /
    text_overrides, ``optimizer`` into its optimizer block and ``top``
    set."""
    import yaml

    with open(src) as f:
        raw = yaml.safe_load(f)
    for key in ("text_cfg", "visual_cfg"):
        if raw.get(key):
            raw[key] = os.path.join(REPO, raw[key])
    raw["visual_overrides"] = {**(raw.get("visual_overrides") or {}),
                               **(visual or {})}
    raw["text_overrides"] = {**(raw.get("text_overrides") or {}),
                             **(text or {})}
    raw["optimizer"] = {**(raw.get("optimizer") or {}), **(optimizer or {})}
    raw.update(top)
    dst = os.path.join(out_dir, name)
    with open(dst, "w") as f:
        yaml.safe_dump(raw, f)
    return dst


def _snapshot(state):
    """Clones of everything a checkpoint holds, for bitwise checks."""
    opt = state.optimizer
    return {"trainable": {k: p.detach().clone()
                          for k, p in state.trainable.items()},
            "frozen": {k: p.detach().clone() for k, p in state.frozen.items()},
            "optim": {k: {n: v.detach().clone() for n, v in leaf.items()}
                      for k, leaf in opt.leaf_state().items()},
            "scalars": dict(opt.scalars()), "count": opt.count,
            "step": state.step}


def _snapshot_diff(state, snap):
    """Leaves and optimizer state of ``state`` not bitwise equal to
    ``snap``."""
    now = _snapshot(state)
    bad = [k for part in ("trainable", "frozen")
           for k, v in snap[part].items()
           if now[part][k].dtype != v.dtype or not torch.equal(now[part][k],
                                                               v)]
    bad += [f"optim {k}" for k, leaf in snap["optim"].items()
            if set(now["optim"].get(k, {})) != set(leaf) or any(
                not torch.equal(now["optim"][k][n], v.to(
                    now["optim"][k][n].device)) for n, v in leaf.items())]
    bad += [f"{k} {now[k]} vs {snap[k]}" for k in ("scalars", "count",
                                                   "step")
            if now[k] != snap[k]]
    return bad


def _per_step_counts(report, path, steps):
    return {r["key"]: r["launches_by_path"][path] / steps for r in report}


def phase_knobs_pretrain(report, out_dir, train_stats):
    """Phase 28: the pretrain path with GPT-3 and vision LoRA,
    ``connect_ln``, ``freeze_vit``, vision drop-path and adamp, async
    checkpoints (see the module docstring).  Returns (run directory,
    YAML)."""
    from youku_mplug_tpu_torch.cli import run_pretrain
    from youku_mplug_tpu_torch.train.trainer import dropout_generator

    t_phase = time.perf_counter()
    yaml_path = _knobs_yaml(TRAIN_YAML, out_dir, "knobs_pretrain.yaml",
                            visual=KNOBS_VISION, optimizer=KNOBS_OPT,
                            async_checkpointing=True, **KNOBS_PRETRAIN)
    run_dir = os.path.join(out_dir, "knobs_pretrain")
    args = run_pretrain.base_parser().parse_args([
        "--config", yaml_path, "--output_dir", run_dir, "--synthetic_data",
        "--max_steps", str(KNOBS_STEPS), "--device", "cuda"])
    t0 = time.perf_counter()
    runner = run_pretrain.setup(args)
    state = runner.state
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    lora_b = sorted(k for k in state.trainable
                    if "lora_" in k and k.endswith("_b"))
    towers = {k.split("/")[0] for k in lora_b}
    if (type(state.optimizer).__name__ != "ZooOptimizer"
            or not runner.ckpt.async_save
            or towers != {"text_decoder", "visual_encoder"}
            or "visual_norm/scale" not in state.trainable
            or any("lora_" in k for k in state.frozen)):
        fail(f"knobs_pretrain: optimizer {type(state.optimizer).__name__}, "
             f"async {runner.ckpt.async_save}, adapters in {towers}, "
             f"visual_norm trainable {'visual_norm/scale' in state.trainable}")
    frozen0 = {k: p.detach().clone() for k, p in state.frozen.items()}
    b0 = {k: state.trainable[k].detach().clone() for k in lora_b}
    train_step = run_pretrain.build_train_step(runner)
    runner.loader.set_epoch(0)
    batches = iter(runner.loader)
    history, snap, save_s, wait_s = [], None, None, None
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(report)
    for i in range(KNOBS_STEPS):
        if i == KNOBS_STEPS - 1:  # save the state of step 2 asynchronously
            snap = _snapshot(state)
            t0 = time.perf_counter()
            if not runner.ckpt.save(state.step, state,
                                    metadata={"epoch": 0}):
                fail("knobs_pretrain: the async save wrote nothing")
            save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        metrics = train_step(state, run_pretrain.make_batch(runner,
                                                            next(batches)))
        torch.cuda.synchronize()
        metrics["step_time"] = time.perf_counter() - t0
        history.append(metrics)
    t0 = time.perf_counter()
    runner.ckpt.wait_until_finished()
    wait_s = time.perf_counter() - t0
    _read_counts(report, "knobs_pretrain")
    peak = torch.cuda.max_memory_allocated()
    if any(not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]))
           or h["skipped_nonfinite"] for h in history):
        fail(f"knobs_pretrain steps: {history}")
    per_step = _per_step_counts(report, "knobs_pretrain", KNOBS_STEPS)
    phase5 = {k: v / train_stats["steps"]
              for k, v in train_stats["launches"].items()}
    keys = ("K1", "K4", "dq", "dkv", "delta")
    if any(per_step[k] != phase5[k] for k in keys) or any(
            v for k, v in per_step.items() if k not in keys):
        fail(f"knobs_pretrain: launches per step {per_step}, phase 5's "
             f"{ {k: phase5[k] for k in keys} }")
    changed = [k for k, p in state.frozen.items()
               if not torch.equal(p.detach(), frozen0[k])]
    still = [k for k in lora_b if torch.equal(state.trainable[k].detach(),
                                              b0[k])]
    if changed or still:
        fail(f"knobs_pretrain: frozen leaves changed {changed[:5]}; "
             f"adapters b that did not move {still[:5]}")
    # the optimizer's share of a step: one more update on zero gradients,
    # timed alone (the restore below undoes it)
    for p in state.trainable.values():
        p.grad = torch.zeros_like(p)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state.optimizer.step()
    torch.cuda.synchronize()
    opt_ms = (time.perf_counter() - t0) * 1e3
    for p in state.trainable.values():
        p.grad = None
    # resume: the step-2 checkpoint into the trained state, bitwise
    step2 = snap["step"]
    t0 = time.perf_counter()
    runner.ckpt.restore(step2, state)
    restore_s = time.perf_counter() - t0
    bad = _snapshot_diff(state, snap)
    if bad:
        fail(f"knobs_pretrain: the async checkpoint of step {step2} differs "
             f"from the state before step 3: {bad[:8]}")
    loss_k, loss_p, finite, _, rows = _replay(
        runner, run_pretrain.make_batch, run_pretrain.make_loss_fn,
        "knobs_pretrain replay",
        make_gen=lambda: dropout_generator(args.seed, 0, runner.device))
    if not finite or abs(loss_k - loss_p) > REPLAY_LOSS_TOL \
            or rows[0][0] > REPLAY_GRAD_TOL:
        fail("knobs_pretrain plain replay out of tolerance")
    stats = {"setup_s": setup_s,
             "step_ms_each": [h["step_time"] * 1e3 for h in history],
             "phase5_step_ms": train_stats["step_ms"],
             "adamp_update_ms": opt_ms,
             "loss": [h["loss"] for h in history],
             "grad_norm": [h["grad_norm"] for h in history],
             "async_save_return_s": save_s, "write_wait_after_step3_s": wait_s,
             "restore_s": restore_s, "peak_memory_gib": peak / 2 ** 30,
             "launches_per_step": {k: v for k, v in per_step.items() if v},
             "adapters_moved": len(lora_b),
             "frozen_leaves_unchanged": len(frozen0),
             "trainable_leaves": len(state.trainable)}
    print(f"[knobs_pretrain] {json.dumps(stats)} | phase "
          f"{time.perf_counter() - t_phase:.1f} s | {CARD}", flush=True)
    runner.ckpt.close()
    del runner, state, snap, frozen0, b0
    gc.collect()
    torch.cuda.empty_cache()
    return run_dir, yaml_path


def phase_knobs_dropout(report, out_dir):
    """Phase 29: phase 28's YAML with vision dropout and attention
    dropout and the decoder's 0.1 dropouts: KNOBS_DROPOUT_STEPS finite
    steps whose launches per step are KNOBS_DROPOUT_LAUNCHES exactly."""
    from youku_mplug_tpu_torch.cli import common, run_pretrain

    t_phase = time.perf_counter()
    yaml_path = _knobs_yaml(
        TRAIN_YAML, out_dir, "knobs_dropout.yaml",
        visual={**KNOBS_VISION, "drop_rate": 0.1, "attn_drop_rate": 0.1},
        text={"hidden_dropout": 0.1, "attention_dropout": 0.1},
        optimizer=KNOBS_OPT, **KNOBS_PRETRAIN)
    args = run_pretrain.base_parser().parse_args([
        "--config", yaml_path, "--output_dir",
        os.path.join(out_dir, "knobs_dropout"), "--synthetic_data",
        "--max_steps", str(KNOBS_DROPOUT_STEPS), "--device", "cuda"])
    runner = run_pretrain.setup(args)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(report)
    history = common.train_one_epoch(runner,
                                     run_pretrain.build_train_step(runner),
                                     0, run_pretrain.make_batch)
    torch.cuda.synchronize()
    _read_counts(report, "knobs_dropout")
    if len(history) != KNOBS_DROPOUT_STEPS or any(
            not math.isfinite(h["loss"]) or h["skipped_nonfinite"]
            for h in history):
        fail(f"knobs_dropout steps: {history}")
    per_step = _launches_per(report, "knobs_dropout", len(history),
                             KNOBS_DROPOUT_LAUNCHES)
    print(f"[knobs_dropout] {len(history)} steps: step ms "
          f"{[round(h['step_time'] * 1e3, 1) for h in history]}, loss "
          f"{[round(h['loss'], 4) for h in history]}; launches per step "
          f"{per_step} (predicted {KNOBS_DROPOUT_LAUNCHES}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB | phase "
          f"{time.perf_counter() - t_phase:.1f} s | {CARD}", flush=True)
    del runner
    gc.collect()
    torch.cuda.empty_cache()


def phase_knobs_lora_serve(report, out_dir, run_dir):
    """Phase 30: ``serve --resume`` on phase 28's run, its adapters
    unmerged inside the decode graph; ``cli/export_serving.py`` merges
    them and the merged model serves; launches a decode step as phase
    3's, teacher-forced logits of the two within LOGIT_TOL, greedy tokens
    equal up to near-ties (CAPTION_TIE_GAP)."""
    from youku_mplug_tpu_torch import bridge
    from youku_mplug_tpu_torch.cli import export_serving, serve
    from youku_mplug_tpu_torch.models.tasks import MPLUGVideo
    from youku_mplug_tpu_torch.runtime.precision import DEFAULT_POLICY
    from youku_mplug_tpu_torch.train.checkpoint import CheckpointManager

    t_phase = time.perf_counter()
    serve_yaml = _knobs_yaml(FLAGSHIP_YAML, out_dir, "knobs_serve.yaml",
                             visual=KNOBS_VISION, optimizer=KNOBS_OPT,
                             **KNOBS_PRETRAIN)
    cfg, model, stats_u = phase_slice(report, out_dir, serve_yaml,
                                      "knobs_lora_serve",
                                      extra=("--resume", run_dir))
    adapters = [n for n, _ in model.named_parameters() if "lora_" in n]
    if not adapters:
        fail("knobs_lora_serve: the resumed model holds no adapters")
    t0 = time.perf_counter()
    dest = os.path.join(out_dir, "knobs_serving")
    export_serving.main(["--run_dir", run_dir, "--config", serve_yaml,
                         "--dest", dest, "--device", "cuda"])
    export_s = time.perf_counter() - t0
    ckpt = CheckpointManager(dest)
    merged_tree = ckpt.restore_raw(ckpt.latest_step(),
                                   map_location="cuda")["params"]
    rank0 = dataclasses.replace(
        cfg.model, text=dataclasses.replace(cfg.model.text, lora_rank=0),
        vision=dataclasses.replace(cfg.model.vision, lora_rank=0))
    with torch.device("cuda"):
        merged = MPLUGVideo(rank0, DEFAULT_POLICY)
    bridge.load_jax_params(merged, merged_tree).eval()
    del merged_tree
    if any("lora_" in n for n, _ in merged.named_parameters()):
        fail("knobs_lora_serve: the export left adapters")
    args = _serve_args(serve_yaml, 8)
    _reset_counts(report)
    stats_m, out, engine = serve.run(args, cfg, merged, torch.device("cuda"))
    torch.cuda.synchronize()
    _read_counts(report, "knobs_lora_serve_merged")
    if stats_m["requests"] != 16 or any(not o["tokens"] for o in out):
        fail(f"knobs_lora_serve merged served {stats_m['requests']}")
    layers = cfg.model.text.num_hidden_layers
    _per_step(report, "knobs_lora_serve_merged", engine.decode_steps,
              {"K5": layers, "K6": layers})
    # teacher-forced: each model's own query features, the unmerged
    # model's greedy tokens fed to both; the 16 requests in 16 slots
    args16 = _serve_args(serve_yaml, 16)
    make = {name: (lambda m=m: serve.make_engine(args16, cfg,
                                                 m.text_decoder)[0])
            for name, m in (("unmerged", model), ("merged", merged))}
    reqs = {name: _caption_requests(cfg, m)
            for name, m in (("unmerged", model), ("merged", merged))}
    eng = make["unmerged"]()
    forced = dict(max_len=eng.max_len, bucket=eng.buckets[0],
                  gen_cfg=eng.config)
    del eng
    logits_u, fed = _forced_decode(model.text_decoder,
                                   reqs["unmerged"][:8], **forced)
    logits_m, _ = _forced_decode(merged.text_decoder, reqs["merged"][:8],
                                 **forced, tokens=fed)
    e_q = max(err(a[1]["query_embeds"], b[1]["query_embeds"])
              for a, b in zip(reqs["unmerged"], reqs["merged"]))
    e_l = max(err(a, b) for a, b in zip(logits_m, logits_u))
    if e_q > QUERY_TOL or e_l > LOGIT_TOL:
        fail(f"knobs_lora_serve: merged against unmerged: query features "
             f"{e_q:.4g} (tol {QUERY_TOL}), logits {e_l:.4g} (tol "
             f"{LOGIT_TOL})")
    tok_u, _, _ = _engine_run(make["unmerged"], reqs["unmerged"], 1)
    tok_m, _, _ = _engine_run(make["merged"], reqs["merged"], 1)
    # the two models prefill differently: their first tokens are held to
    # the unmerged prefill's top-2 gap too
    gaps, _, _ = _plain_gaps(make["unmerged"], reqs["unmerged"], tok_u)
    gaps = [[g0] + g for g0, g in zip(
        _prefill_gaps(make["unmerged"], reqs["unmerged"]), gaps)]
    _tie_check("knobs_lora_serve merged vs unmerged", tok_m, tok_u, gaps,
               CAPTION_TIE_GAP, first=0)
    print(f"[knobs_lora_serve] {len(adapters)} adapter leaves unmerged in "
          f"the decode graph: {json.dumps(stats_u)}; merged by "
          f"export_serving in {export_s:.2f} s: {json.dumps(stats_m)}; "
          f"teacher-forced merged vs unmerged: query features max err "
          f"{e_q:.4g} (tol {QUERY_TOL}), logits over {FORCED_STEPS} steps "
          f"{e_l:.4g} (tol {LOGIT_TOL}) | phase "
          f"{time.perf_counter() - t_phase:.1f} s | {CARD}", flush=True)
    del model, merged
    gc.collect()
    torch.cuda.empty_cache()


def _prefill_gaps(make, requests):
    """Each request's top-1 minus top-2 logit of its prefill on a fresh
    engine from ``make()`` (the engine's first pick, spied on)."""
    eng = make()
    picks = []
    pick = eng._pick

    def spy(logits):
        picks.append(logits.float().topk(2, dim=-1).values)
        return pick(logits)
    eng._pick = spy
    for ids, kw in requests:
        eng.submit(ids, **kw)
    eng._admit()
    return [(t[..., 0] - t[..., 1]).reshape(-1)[0].item()
            for t in picks[:len(requests)]]


def _instruct_chunk(yaml_path, out_dir):
    """The first training batch's sequence length S (the loader and the
    tokenizer alone) and the ce_chunk phase 31 takes: S's largest divisor
    at most S / 2."""
    import types

    from youku_mplug_tpu_torch.cli import run_instruct
    from youku_mplug_tpu_torch.config import (
        instruct_train_config,
        load_owl_config,
    )

    args = run_instruct.parser().parse_args([
        "--config", yaml_path, "--train", "--synthetic_data", "--device",
        "cuda", "--output_dir", out_dir])
    cfg, raw = load_owl_config(yaml_path)
    tcfg = instruct_train_config(raw)
    loader = run_instruct.build_train_loader(args, tcfg, raw,
                                             cfg.vision.img_size)
    loader.set_epoch(0)
    runner = types.SimpleNamespace(
        model=types.SimpleNamespace(cfg=cfg), cfg=tcfg,
        tokenizer=run_instruct.build_tokenizer(args, cfg),
        device=torch.device("cpu"))
    s = run_instruct.make_instruct_batch(runner, next(iter(loader)))[
        "input_ids"].shape[1]
    chunk = max((d for d in range(2, s // 2 + 1) if s % d == 0), default=0)
    if not chunk:
        fail(f"knobs_instruct_train: S {s} has no divisor for ce_chunk")
    return s, chunk


def phase_knobs_instruct_train(report, out_dir, phase9_stats):
    """Phase 31: instruct training on the Owl YAML with Bloom cut to
    OWL_CUT, hidden dropout, remat "names" and ce_chunk, vision LoRA and
    drop-path, lamb with layer decay and an lr-scale rule: launches per
    step and layer as phase 9's, phase 10's replays, the chunked loss
    against the dense one."""
    import yaml as yaml_mod

    from youku_mplug_tpu_torch.cli import common, run_instruct
    from youku_mplug_tpu_torch.train.trainer import dropout_generator

    t_phase = time.perf_counter()
    with open(OWL_TRAIN_YAML) as f:
        raw = yaml_mod.safe_load(f)
    text = {**OWL_CUT, "hidden_dropout": 0.1, "remat": True,
            "remat_policy": "names"}
    vision = {**raw["vision_overrides"], "lora_rank": 4, "drop_path": 0.1}
    # layer decay over the ViT-L's 24 blocks (the default 12 stops short
    # of them and raises, in JAX too)
    opt = {**raw["optimizer"], "opt": "lamb", "layer_decay": 0.9,
           "layer_decay_num_layers": raw["vision_overrides"]["depth"],
           "lr_scale_rules": [["abstractor", 0.5]]}
    probe = _owl_yaml(OWL_TRAIN_YAML, out_dir, text,
                      vision_overrides=vision, optimizer=opt)
    s, chunk = _instruct_chunk(probe, out_dir)
    yaml_path = _owl_yaml(OWL_TRAIN_YAML, out_dir, {**text,
                                                    "ce_chunk": chunk},
                          vision_overrides=vision, optimizer=opt)
    args = run_instruct.parser().parse_args([
        "--config", yaml_path, "--train", "--synthetic_data", "--max_steps",
        str(KNOBS_OWL_STEPS), "--device", "cuda", "--output_dir",
        os.path.join(out_dir, "knobs_instruct")])
    t0 = time.perf_counter()
    runner = run_instruct.train_setup(args)
    setup_s = time.perf_counter() - t0
    state = runner.state
    tcfg = runner.model.cfg.text
    if (type(state.optimizer).__name__ != "ZooOptimizer"
            or (tcfg.remat, tcfg.remat_policy, tcfg.ce_chunk) != (
                True, "names", chunk)
            or runner.model.cfg.vision.lora_rank != 4):
        fail(f"knobs_instruct_train: the YAML's knobs did not reach the "
             f"model: {tcfg}")
    frozen0 = {k: p.detach().clone() for k, p in state.frozen.items()}
    trainable0 = {k: p.detach().clone() for k, p in state.trainable.items()}
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(report)
    history = common.train_one_epoch(runner,
                                     run_instruct.build_train_step(runner),
                                     0, run_instruct.make_instruct_batch)
    torch.cuda.synchronize()
    _read_counts(report, "knobs_instruct_train")
    peak = torch.cuda.max_memory_allocated()
    if len(history) != KNOBS_OWL_STEPS or any(
            not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]))
            or h["skipped_nonfinite"] for h in history):
        fail(f"knobs_instruct_train steps: {history}")
    changed = [k for k, p in state.frozen.items()
               if not torch.equal(p.detach(), frozen0[k])]
    still = [k for k, p in state.trainable.items()
             if torch.equal(p.detach(), trainable0[k])]
    lora = [k for k in state.trainable if "lora_" in k]
    if changed or still or not any(k.startswith("visual_encoder")
                                   for k in lora):
        fail(f"knobs_instruct_train: frozen leaves changed {changed[:5]}, "
             f"trainable leaves still {still[:5]}, adapters {lora[:4]}")
    layers = tcfg.num_hidden_layers
    depth = runner.model.cfg.vision.depth
    per_step = _per_step_counts(report, "knobs_instruct_train", len(history))
    p9 = phase9_stats["launches_per_step"]
    p9_layers = phase9_stats["layers"]
    per_unit = {k: (per_step[k] / layers, p9[k] / p9_layers)
                for k in ("K1-ALiBi", "dq-ALiBi", "dkv-ALiBi")}
    per_unit["K1"] = (per_step["K1"] / depth, p9["K1"] / depth)
    if any(a != b for a, b in per_unit.values()):
        fail(f"knobs_instruct_train: launches per step and layer "
             f"(this run, phase 9) {per_unit}")
    # phase 10's replays on the same dropout masks
    fns = (run_instruct.make_instruct_batch, run_instruct.make_loss_fn)

    def gen():
        return dropout_generator(args.seed, 0, runner.device)
    loss_k, loss_p, finite, _, _ = _replay(
        runner, *fns, "knobs_instruct_train replay, every wrapper plain",
        make_gen=gen)
    if not finite or abs(loss_k - loss_p) > REPLAY_LOSS_TOL:
        fail("knobs_instruct_train plain replay out of tolerance")
    loss_k, loss_p, finite, _, rows = _replay(
        runner, *fns, "knobs_instruct_train replay, Bloom attention plain",
        plain_when=lambda t: t.shape[-1] == 128, make_gen=gen)
    if not finite or abs(loss_k - loss_p) > REPLAY_LOSS_TOL \
            or rows[0][0] > REPLAY_GRAD_TOL:
        fail("knobs_instruct_train replay of Bloom's attention out of "
             "tolerance")
    # the chunked loss against the dense one: one batch, the same masks
    runner.loader.set_epoch(0)
    batch = run_instruct.make_instruct_batch(runner,
                                             next(iter(runner.loader)))
    lm = runner.model.text_decoder
    loss_fn = run_instruct.make_loss_fn(runner.model)
    with torch.no_grad():
        chunked = loss_fn(batch, gen())["loss"].item()
        lm.cfg = dataclasses.replace(lm.cfg, ce_chunk=0)
        try:
            dense = loss_fn(batch, gen())["loss"].item()
        finally:
            lm.cfg = dataclasses.replace(lm.cfg, ce_chunk=chunk)
    rel = abs(chunked - dense) / abs(dense)
    if batch["input_ids"].shape[1] % chunk or rel > CE_CHUNK_TOL:
        fail(f"knobs_instruct_train: ce_chunk {chunk} loss {chunked} vs "
             f"dense {dense} (relative {rel:.3g}, tol {CE_CHUNK_TOL}) at S "
             f"{batch['input_ids'].shape[1]}")
    stats = {"setup_s": setup_s, "S": s, "ce_chunk": chunk,
             "step_ms_each": [h["step_time"] * 1e3 for h in history],
             "loss": [h["loss"] for h in history],
             "grad_norm": [h["grad_norm"] for h in history],
             "peak_memory_gib": peak / 2 ** 30,
             "launches_per_step": {k: v for k, v in per_step.items() if v},
             "per_layer_vs_phase9": per_unit,
             "ce_chunk_loss": chunked, "dense_loss": dense,
             "ce_chunk_rel_diff": rel, "adapters": len(lora)}
    print(f"[knobs_instruct_train] {json.dumps(stats)} | phase "
          f"{time.perf_counter() - t_phase:.1f} s | {CARD}", flush=True)
    del runner, state, frozen0, trainable0
    gc.collect()
    torch.cuda.empty_cache()


def _zoo_leaves():
    """The flagship pretrain model's trainable leaves (JAX path -> shape),
    from a model on the meta device, the vision tower's cut to its first
    ZOO_BLOCKS blocks (the script's budget: the fp64 references run on
    the CPU)."""
    from youku_mplug_tpu_torch.bridge import jax_path
    from youku_mplug_tpu_torch.config import load_config
    from youku_mplug_tpu_torch.models.tasks import MPLUGVideo
    from youku_mplug_tpu_torch.optim.factory import freeze_mask

    cfg = load_config(TRAIN_YAML)
    with torch.device("meta"):
        model = MPLUGVideo(cfg.model)
    named = {jax_path(n): p for n, p in model.named_parameters()}
    frozen = freeze_mask(named, cfg.optimizer.freeze_text_decoder,
                         cfg.optimizer.freeze_vit)
    cut = tuple(f"visual_encoder/blocks_{i}/"
                for i in range(ZOO_BLOCKS, cfg.model.vision.depth))
    return cfg.optimizer, {k: tuple(p.shape) for k, p in named.items()
                           if not frozen[k] and not k.startswith(cut)}


def _zoo_values(shapes):
    """The leaf values of phase 32, fp32 on the CPU: draw 0 the
    parameters (std 0.02), draws 1 .. ZOO_LOOKAHEAD_UPDATES the gradients
    of each update, one generator a (draw, leaf)."""
    draws = []
    for t in range(ZOO_LOOKAHEAD_UPDATES + 1):
        out = {}
        for i, (k, shape) in enumerate(sorted(shapes.items())):
            g = torch.Generator().manual_seed(ZOO_SEED * 1_000_003
                                              + t * 10_007 + i)
            x = torch.randn(shape, generator=g)
            out[k] = x * 0.02 if t == 0 else x
        draws.append(out)
    return draws


def _zoo_run(name, opt_cfg, draws, dtype):
    """``name`` over the leaves of ``draws`` (on their device):
    ZOO_UPDATES updates (ZOO_LOOKAHEAD_UPDATES with the lookahead prefix)
    in ``dtype``, the schedule of the YAML's optimizer over those updates.
    Returns (final leaves, sum of the updates, ms an update)."""
    from youku_mplug_tpu_torch.optim import factory, zoo

    n = (ZOO_LOOKAHEAD_UPDATES if zoo.is_lookahead(name) else ZOO_UPDATES)
    cfg = dataclasses.replace(opt_cfg, opt=name, warmup_steps=0, epochs=1,
                              niter_per_ep=n)
    params = {k: v.to(dtype=dtype, copy=True) for k, v in draws[0].items()}
    cuda = next(iter(params.values())).is_cuda
    decay = factory.decay_mask(params)
    upd = zoo.ZooUpdate(name, params,
                        {k: cfg.weight_decay if decay[k] else 0.0
                         for k in params}, factory.schedule_of(cfg),
                        momentum=cfg.momentum, betas=tuple(cfg.opt_betas),
                        eps=cfg.opt_eps)
    total = {k: torch.zeros_like(v) for k, v in params.items()}
    ms = []
    for t in range(1, n + 1):
        grads = {k: v.to(dtype) for k, v in draws[t].items()}
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = upd.apply(params, grads)
        for k in params:
            params[k].add_(out[k])
            total[k].add_(out[k])
        if cuda:
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return params, total, ms


def _zoo_canonical(name):
    """The first zoo name building the same rule as ``name`` (the fused*
    aliases and sgd's spellings share one); a lookahead name is its
    own."""
    from youku_mplug_tpu_torch.optim import zoo

    if zoo.is_lookahead(name):
        return name
    rule = zoo.create_rule(name)
    return next(other for other in zoo.ZOO_NAMES
                if type(zoo.create_rule(other)) is type(rule)
                and vars(zoo.create_rule(other)) == vars(rule))


def phase_optim_zoo():
    """Phase 32: every zoo name, and lookahead_adamw, on the card in fp32
    against the same updates in fp64 on the CPU (one reference a distinct
    rule; the aliases, listed beside their rule, reuse it)."""
    from youku_mplug_tpu_torch.optim import zoo

    t_phase = time.perf_counter()
    opt_cfg, shapes = _zoo_leaves()
    draws = _zoo_values(shapes)
    on_card = [{k: v.cuda() for k, v in d.items()} for d in draws]
    n_params = sum(math.prod(s) for s in shapes.values())
    rows, ref, ref_name = {}, None, None
    for name in zoo.ZOO_NAMES + ("lookahead_adamw",):
        canon = _zoo_canonical(name)
        if canon != ref_name:
            ref = None
            gc.collect()
            t0 = time.perf_counter()
            ref, ref_name = _zoo_run(canon, opt_cfg, draws,
                                     torch.float64), canon
            ref_s = time.perf_counter() - t0
        params, total, ms = _zoo_run(name, opt_cfg, on_card, torch.float32)
        want_p, want_u, _ = ref

        def rel(got, want):
            return (got.cpu().double() - want).norm().item() / max(
                want.norm().item(), 1e-300)
        leaf = max(rel(params[k], want_p[k]) for k in params)
        upd = max(rel(total[k], want_u[k]) for k in params)
        rows[name] = {"rule_of": canon, "ms_per_update": ms,
                      "leaf_rel_l2_max": leaf, "update_rel_l2_max": upd,
                      "cpu_fp64_reference_s": ref_s}
        del params, total
        print(f"[optim_zoo] {name}: {json.dumps(rows[name])}", flush=True)
        if leaf > ZOO_TOL or not math.isfinite(leaf):
            fail(f"optim_zoo {name}: a leaf's relative L2 {leaf:.3g} "
                 f"against fp64 (tol {ZOO_TOL})")
    del on_card, ref
    print(f"[optim_zoo] {len(rows)} names over {len(shapes)} trainable "
          f"leaves ({n_params / 1e6:.1f}M values) of {TRAIN_YAML}, fp32 on "
          f"the card against fp64 on the CPU: worst leaf relative L2 "
          f"{max(r['leaf_rel_l2_max'] for r in rows.values()):.3g} (tol "
          f"{ZOO_TOL}) | phase {time.perf_counter() - t_phase:.1f} s | "
          f"{CARD}", flush=True)


# ---------------------------------------------------------------------------
# phases 33-35: the BERT family (mPLUG, ALPRO) at full width


def _vision_launches(vcfg, ema: bool = False) -> dict:
    """A train step's launches by JAX's dispatch rule for the TimeSformer
    at heads of 64 (``packed_supported``): one K1 per block for the
    temporal and one for the spatial attention in the forward; the blocks
    ``grad_ckpt`` rematerializes (every ``remat_stride``-th) run their two
    again in the backward, which takes one dq, one dk/dv and one delta a
    call; the EMA twin's forward (no gradient: no remat) 2 x depth K1
    more.  The BERT's attention is plain, as in JAX."""
    from youku_mplug_tpu_torch.ops.flash_attention import packed_supported

    d = vcfg.embed_dim // vcfg.num_heads
    if not packed_supported(vcfg.num_heads, d):
        fail(f"the vision tower's {vcfg.num_heads} heads of {d} take no "
             "kernel")
    calls = 2 * vcfg.depth
    remat = len(range(0, vcfg.depth, vcfg.remat_stride)) \
        if vcfg.grad_ckpt else 0
    return {"K1": calls + 2 * remat + (calls if ema else 0), "dq": calls,
            "dkv": calls, "delta": calls}


def _bert_geometry(tag, cfg, bert, want_layers):
    """The run's geometry (BERT width, heads, head dim, layers, vocab,
    dropout; vision heads, head dim, depth, frames, remat; batch) printed,
    and checked against the shipped JSONs' full width."""
    v = cfg.model.vision
    got = {"bert_hidden": bert.hidden_size,
           "bert_heads": bert.num_attention_heads,
           "bert_head_dim": bert.head_dim, "bert_layers": want_layers,
           "vocab": bert.vocab_size, "dropout": bert.hidden_dropout_prob,
           "vision_heads": v.num_heads,
           "vision_head_dim": v.embed_dim // v.num_heads,
           "vision_depth": v.depth, "frames": cfg.num_frames,
           "image_res": cfg.image_res, "remat": v.remat_policy,
           "batch": cfg.batch_size}
    if (bert.hidden_size, bert.num_attention_heads, bert.vocab_size,
            v.num_heads, v.embed_dim, v.depth, cfg.num_frames,
            cfg.batch_size) != (768, 12, 21128, 12, 768, 12, 8, 16):
        fail(f"[{tag}] not the full width: {got}")
    return got


def _pinned_negatives(make_loss_fn):
    """``make_loss_fn`` whose loss takes, from its second call on, the
    hard negatives its first call drew (``neg_idx`` in the batch): the
    replay's kernels and plain runs fuse the same pairs."""
    def make(model):
        inner = make_loss_fn(model)

        def loss_fn(batch, generator=None):
            out = inner(batch, generator)
            if "neg_img_idx" in out and "neg_idx" not in batch:
                batch["neg_idx"] = (out["neg_img_idx"].detach(),
                                    out["neg_txt_idx"].detach())
            return out
        return loss_fn
    return make


def _train_steps(report, tag, runner, train_step, make_batch, steps, want,
                 frozen=False, check=None):
    """``steps`` train steps through ``common.train_one_epoch`` on the
    ``tag`` path: finite, none skipped, leaves moved, launches per step
    exactly ``want``; no frozen leaf, or with ``frozen`` some, each
    bitwise unchanged; ``check(history)`` adds the path's own gates.
    Returns (history, stats; the rate, clips or images a second, as
    ``samples_per_s``)."""
    from youku_mplug_tpu_torch.cli import common

    state = runner.state
    trainable0 = {k: p.detach().clone() for k, p in state.trainable.items()}
    frozen0 = {k: p.detach().clone() for k, p in state.frozen.items()}
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(report)
    history = common.train_one_epoch(runner, train_step, 0, make_batch)
    torch.cuda.synchronize()
    _read_counts(report, tag)
    peak = torch.cuda.max_memory_allocated()
    if len(history) != steps or any(
            not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]))
            or h["skipped_nonfinite"] != 0 for h in history):
        fail(f"[{tag}] train steps: {history}")
    moved = sum(not torch.equal(p.detach(), trainable0[k])
                for k, p in state.trainable.items())
    changed = [k for k, p in state.frozen.items()
               if not torch.equal(p.detach(), frozen0[k])]
    del trainable0, frozen0
    if moved == 0 or bool(state.frozen) != frozen or changed:
        fail(f"[{tag}] {moved} leaves moved, {len(state.frozen)} frozen, "
             f"changed: {changed[:4]}")
    if check is not None:
        check(history)
    step_ms = [h["step_time"] * 1e3 for h in history]
    rest = step_ms[1:] or step_ms
    return history, {
        "steps": len(history), "step_ms_first": step_ms[0],
        "step_ms_rest": sum(rest) / len(rest), "step_ms_each": step_ms,
        "samples_per_s": runner.loader.batch_size * 1e3 * len(rest)
        / sum(rest),
        "peak_memory_gib": peak / 2 ** 30,
        **{k: [h[k] for h in history] for k in history[0]
           if k.startswith("loss") or k == "grad_norm"},
        "trainable_leaves_moved": f"{moved}/{len(state.trainable)}",
        "frozen_leaves": len(state.frozen),
        "launches_per_step": _launches_per(report, tag, len(history), want)}


def _without_ita(make_loss_fn, seen):
    """``make_loss_fn`` whose loss is ITM + MLM: ALPRO's ITA (JAX's
    features divided by their batch's matrix norm of order -1, ROADMAP
    Queue 3 item 10) is recorded in ``seen`` and left out.  Its min over
    columns routes the whole ITA gradient through one feature column, and
    a bf16 rounding apart can pick another column, while its logits reach
    ~75 (the L2 form's 1 / temp ~14): no tolerance of plain against
    kernels holds it."""
    def make(model):
        inner = make_loss_fn(model)

        def loss_fn(batch, generator=None):
            out = dict(inner(batch, generator))
            seen.append(out["loss_ita"].item())
            out["loss"] = out["loss_itm"] + out["loss_mlm"]
            return out
        return loss_fn
    return make


def _train_replay(tag, runner, make_batch, make_loss_fn):
    """The first batch's loss and gradients with the kernels and plain,
    the same dropout and drop-path masks both times (and for the BERT
    family the same MLM masks, twin features and hard negatives); gated
    as phase 6."""
    from youku_mplug_tpu_torch.train.trainer import dropout_generator

    loss_k, loss_p, finite, _, rows = _replay(
        runner, make_batch, _pinned_negatives(make_loss_fn),
        f"{tag} replay, every wrapper plain",
        make_gen=lambda: dropout_generator(runner.args.seed, 0,
                                           runner.device))
    if not finite or abs(loss_k - loss_p) > REPLAY_LOSS_TOL \
            or rows[0][0] > REPLAY_GRAD_TOL:
        fail(f"[{tag}] plain replay out of tolerance")
    rel = sorted(r[1] for r in rows)
    return {"loss_kernels": loss_k, "loss_plain": loss_p,
            "grad_rel_l2_median": rel[len(rel) // 2],
            "worst_gated_grad_err": rows[0][0], "worst_leaf": rows[0][3]}


def phase_mplug_pretrain(report, out_dir):
    """Phase 33: run_mplug_pretrain's setup, train step and momentum update
    at full width (configs/mplug/mplug_vitb16_zh.yaml), MPLUG_PRETRAIN_STEPS
    steps of 16 clips; the queue pointer, the EMA's law and the launches
    per step gated; the first batch replayed plain."""
    from youku_mplug_tpu_torch.cli import run_mplug_pretrain as mp

    tag = "mplug_pretrain"
    cfg_path = _bert_yaml(MPLUG_YAML, out_dir,
                          synthetic_length=MPLUG_PRETRAIN_STEPS * 16)
    args = mp.parser().parse_args([
        "--config", cfg_path, "--synthetic_data", "--max_steps",
        str(MPLUG_PRETRAIN_STEPS), "--device", "cuda", "--output_dir",
        os.path.join(out_dir, tag)])
    t0 = time.perf_counter()
    pt = mp.setup(args)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    runner, mcfg, ms = pt.runner, pt.mcfg, pt.mstate
    geometry = _bert_geometry(tag, runner.cfg, mcfg.bert,
                              (mcfg.bert.text_encoder_layers,
                               mcfg.bert.fusion_layer,
                               mcfg.bert.text_decoder_layers))
    queue = ms.image_queue.shape[1]
    geometry |= {"queue": queue, "embed_dim": mcfg.embed_dim,
                 "momentum": mcfg.momentum}
    if (queue, mcfg.embed_dim, mcfg.momentum) != (65536, 256, 0.995):
        fail(f"[{tag}] not the YAML's momentum state: {geometry}")
    inner, ptr0, ema = mp.build_train_step(pt), ms.ptr, {}

    def train_step(state, batch):
        if state.step == MPLUG_PRETRAIN_STEPS - 1:  # the last step's law
            ema["before"] = [p.detach().clone()
                             for p in ms.ema.parameters()]
        metrics = inner(state, batch)
        if "before" in ema:
            params = [p.detach() for p in runner.model.parameters()]
            want = torch._foreach_add(
                torch._foreach_mul(ema["before"], mcfg.momentum),
                torch._foreach_mul(params, 1.0 - mcfg.momentum))
            got = list(ms.ema.parameters())
            ema["err"] = max((g - w).abs().max().item()
                             for g, w in zip(got, want))
            ema["moved"] = sum(not torch.equal(g, b) for g, b in
                               zip(got, ema.pop("before")))
            ema["leaves"] = len(got)
        return metrics
    history, stats = _train_steps(
        report, tag, runner, train_step, mp.make_batch_fn(pt),
        MPLUG_PRETRAIN_STEPS, _vision_launches(mcfg.vision, ema=True))
    want_ptr = (ptr0 + MPLUG_PRETRAIN_STEPS * runner.cfg.batch_size) % queue
    if ms.ptr != want_ptr or not torch.isfinite(ms.image_queue).all() \
            or not torch.isfinite(ms.text_queue).all():
        fail(f"[{tag}] queue pointer {ms.ptr}, expected {want_ptr}, or a "
             "non-finite queue")
    if "err" not in ema or ema["err"] > EMA_TOL or ema["moved"] == 0:
        fail(f"[{tag}] the EMA against e * m + p * (1 - m): {ema}")
    replay = _train_replay(tag, runner, mp.make_batch_fn(pt),
                          mp.make_loss_fn)
    out = {"yaml": os.path.relpath(MPLUG_YAML, REPO), "geometry": geometry,
           "setup_s": setup_s, **stats, "queue": queue, "ptr": ms.ptr,
           "ema_err": ema["err"],
           "ema_leaves_moved": f"{ema['moved']}/{ema['leaves']}",
           "alpha": [pt.alpha * min(1.0, s / pt.niter)
                     for s in range(len(history))],
           "replay": replay}
    print(f"[{tag}] {json.dumps(out)} | {CARD}", flush=True)
    return out


def _bert_yaml(path, out_dir, **overrides):
    """A copy of ``path`` with ``overrides`` and its model JSONs named by
    absolute path."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    for key in ("visual_cfg", "bert_config"):
        raw[key] = os.path.join(REPO, raw[key])
    raw.update(overrides)
    dst = os.path.join(out_dir, f"{len(os.listdir(out_dir))}_"
                       + os.path.basename(path))
    with open(dst, "w") as f:
        yaml.safe_dump(raw, f)
    return dst


def _beam_score(model, enc, enc_mask, seqs, bos, eos, alpha=0.6):
    """Each sequence's beam score under ``model``, teacher-forced: its
    log-probs summed up to and including its first eos, over the Wu
    penalty of that length (all of it without one)."""
    b, n = seqs.shape
    ids = torch.cat([torch.full((b, 1), bos, dtype=torch.long,
                                device=seqs.device), seqs.long()], 1)
    with torch.inference_mode():
        out = model.text_decoder(ids, torch.ones_like(ids),
                                 encoder_hidden_states=enc,
                                 encoder_attention_mask=enc_mask)
        logp = torch.log_softmax(out["logits"][:, :-1].float(), -1)
        tok = logp.gather(-1, seqs.long()[..., None])[..., 0]
    is_eos = (seqs == eos).long()
    before = is_eos.cumsum(1) - is_eos  # eos tokens before each position
    live = before == 0
    length = live.sum(1).clamp_min(1).float()
    return (tok * live).sum(1) / ((5.0 + length) / 6.0) ** alpha


def _caption_redecode(tag, runner, video):
    """The caption evaluation's first batch decoded again with the plain
    K1: every clip's tokens equal, or where they differ a near-tie: both
    sequences' beam scores under the plain encoder within
    RESCORE_TOL_PER_TOKEN a token."""
    from youku_mplug_tpu_torch.models.mplug import mplug_generate

    model, cfg, tok = runner.model, runner.cfg, runner.tokenizer.tokenizer
    kw = dict(bos_id=tok.bos_id, eos_id=tok.eos_id,
              max_new_tokens=int(cfg.get("max_new_tokens", 20)),
              beam_size=int(cfg.get("beam_size", 1)),
              min_length=int(cfg.get("min_length", 0)))
    model.eval()
    try:
        got = mplug_generate(model, video, **kw)
        want = _plain(lambda: mplug_generate(model, video, **kw))
        differ = (got != want).any(1)
        out = {"clips": int(got.shape[0]),
               "clips_equal": int((~differ).sum())}
        if differ.any():
            enc, enc_mask = _plain(lambda: model.encode_for_decoder(video))
            sk, sp = (_beam_score(model, enc, enc_mask, seqs, tok.bos_id,
                                  tok.eos_id) for seqs in (got, want))
            gap = (sk - sp).abs()[differ]
            bound = RESCORE_TOL_PER_TOKEN * kw["max_new_tokens"]
            out |= {"score_gaps": gap.tolist(), "bound": bound}
            if not bool((gap <= bound).all()):
                fail(f"[{tag}] plain re-decode: {out}")
    finally:
        model.train()
    return out


def _bert_eval(report, tag, runner, task, module, num_classes):
    """The task's evaluation over BERT_EVAL_CLIPS synthetic clips (one
    call): launches per call exactly 24 K1, finite metrics, ms a call;
    caption: beam tokens/s and the plain re-decode."""
    from youku_mplug_tpu_torch.cli import run_mplug_downstream as md
    from youku_mplug_tpu_torch.ops.preprocess import normalize_clip

    cfg = runner.cfg
    split = md.synthetic_test_split(dataclasses.replace(
        cfg, raw={**cfg.raw, "synthetic_length": BERT_EVAL_CLIPS}), task)
    calls = -(-BERT_EVAL_CLIPS // cfg.batch_size)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(report)
    t0 = time.perf_counter()
    metrics = md.evaluation(runner, split, task, num_classes)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    _read_counts(report, tag)
    per_call = _launches_per(report, tag, calls,
                             {"K1": 2 * cfg.model.vision.depth})
    if not metrics or not all(math.isfinite(v) for v in metrics.values()):
        fail(f"[{tag}] metrics {metrics}")
    out = {"clips": BERT_EVAL_CLIPS, "calls": calls, "eval_s": eval_s,
           "ms_per_call": eval_s / calls * 1e3,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches_per_call": per_call, "metrics": metrics}
    if task == "caption":
        new = int(cfg.get("max_new_tokens", 20))
        out["beam"] = int(cfg.get("beam_size", 1))
        out["beam_tokens_per_s"] = BERT_EVAL_CLIPS * new / eval_s
        raw = next(iter(md._test_batches(runner, split, capped=True)))[0]
        video = normalize_clip(torch.from_numpy(raw["video"]).cuda(),
                               dtype=runner.model.policy.compute_dtype)
        out["plain_redecode"] = _caption_redecode(tag, runner, video)
    return out


def phase_mplug_downstream(report, out_dir):
    """Phase 34: run_mplug_downstream's cls (45 classes), retrieval and
    caption (beam 5, 20 new tokens) at full width: BERT_STEPS train steps
    of 16 clips each and the evaluation over BERT_EVAL_CLIPS clips."""
    from youku_mplug_tpu_torch.cli import run_mplug_downstream as md

    for task in ("cls", "retrieval", "caption"):
        tag = f"mplug_{task}"
        cfg_path = _bert_yaml(MPLUG_YAML, out_dir,
                              synthetic_length=BERT_STEPS * 16)
        args = md.parser().parse_args([
            "--config", cfg_path, "--synthetic_data", "--max_steps",
            str(BERT_STEPS), "--device", "cuda", "--task", task,
            "--output_dir", os.path.join(out_dir, tag)])
        t0 = time.perf_counter()
        runner, _ = md.prepare(args)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        mcfg = runner.model.cfg
        out = {"setup_s": setup_s, "geometry": _bert_geometry(
            tag, runner.cfg, mcfg.bert, (mcfg.bert.text_encoder_layers,
                                         mcfg.bert.fusion_layer,
                                         mcfg.bert.text_decoder_layers)),
               "num_classes": mcfg.num_classes}
        _, out["train"] = _train_steps(
            report, f"{tag}_train", runner,
            md.build_train_step(runner, task), md.make_batch_fn(task),
            BERT_STEPS,
            _vision_launches(mcfg.vision))
        out["eval"] = _bert_eval(report, f"{tag}_eval", runner, task, md,
                                 mcfg.num_classes)
        print(f"[{tag}] {json.dumps(out, ensure_ascii=False)} | {CARD}",
              flush=True)
        del runner
        gc.collect()
        torch.cuda.empty_cache()


def phase_alpro(report, out_dir):
    """Phase 35: run_alpro's pretrain, cls and retrieval at full width
    (configs/alpro/alpro_vitb16_zh.yaml): BERT_STEPS train steps of 16
    clips each, the evaluations over BERT_EVAL_CLIPS clips, the pretrain
    batch replayed plain (ITM + MLM gated, ITA printed: ``_without_ita``).
    """
    from youku_mplug_tpu_torch.cli import run_alpro as ra

    for task in ("pretrain", "cls", "retrieval"):
        tag = f"alpro_{task}"
        cfg_path = _bert_yaml(ALPRO_YAML, out_dir,
                              synthetic_length=BERT_STEPS * 16)
        args = ra.parser().parse_args([
            "--config", cfg_path, "--synthetic_data", "--max_steps",
            str(BERT_STEPS), "--device", "cuda", "--task", task,
            "--output_dir", os.path.join(out_dir, tag)])
        t0 = time.perf_counter()
        runner, _ = ra.prepare(args)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        mcfg = runner.model.cfg
        out = {"setup_s": setup_s, "geometry": _bert_geometry(
            tag, runner.cfg, mcfg.bert,
            (mcfg.bert.fusion_layer,
             mcfg.bert.num_hidden_layers - mcfg.bert.fusion_layer)),
               "num_classes": mcfg.num_classes}
        train_tag = tag if task == "pretrain" else f"{tag}_train"
        _, out["train"] = _train_steps(
            report, train_tag, runner, ra.build_train_step(runner, task),
            ra.make_batch_fn(task), BERT_STEPS,
            _vision_launches(mcfg.vision))
        if task == "pretrain":  # ITM + MLM gated, ITA printed
            ita = []
            out["replay"] = _train_replay(
                tag, runner, ra.make_batch_fn(task),
                _without_ita(ra.make_loss_fn_for(task), ita))
            out["replay"]["loss_ita_kernels_plain_ungated"] = ita
        else:
            out["eval"] = _bert_eval(report, f"{tag}_eval", runner, task,
                                     ra, mcfg.num_classes)
        print(f"[{tag}] {json.dumps(out, ensure_ascii=False)} | {CARD}",
              flush=True)
        del runner
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 36-39: the image-era family at full width


def phase_images_written(root):
    """The image phases' input: IMAGE_FILES JPEGs of IMAGE_SIZE written
    with cv2.imwrite on as many threads as cores, and a JSON of captions
    (one list-valued); every image read back by ``read_image`` at its
    size and within IMAGE_MAE_TOL of the pixels written (JPEG's loss).
    Returns the annotation path."""
    from concurrent.futures import ThreadPoolExecutor

    import cv2
    import numpy as np

    from youku_mplug_tpu_torch.data.image_datasets import read_image

    w, h = IMAGE_SIZE

    def picture(k):
        yy, xx = np.mgrid[:h, :w]
        return np.stack([(xx // 3 + 29 * k) % 256, (yy // 2 + 11 * k) % 256,
                         ((xx + yy) // 4 + 53 * k) % 256], -1).astype(
            np.uint8)

    def write(k):
        return cv2.imwrite(os.path.join(root, f"im{k:02d}.jpg"), picture(k))

    t0 = time.perf_counter()
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        ok = list(pool.map(write, range(IMAGE_FILES)))
    write_s = time.perf_counter() - t0
    if not all(ok):
        fail(f"cv2 wrote {ok.count(True)} of {IMAGE_FILES} JPEGs")
    t0 = time.perf_counter()
    maes = []
    for k in range(IMAGE_FILES):
        img = read_image(os.path.join(root, f"im{k:02d}.jpg"))
        if img.shape != (h, w, 3):
            fail(f"im{k:02d}.jpg reads back as {img.shape}")
        maes.append(float(np.abs(img.astype(np.int16)
                                 - picture(k)[..., ::-1]).mean()))
    read_ms = (time.perf_counter() - t0) * 1e3 / IMAGE_FILES
    if max(maes) > IMAGE_MAE_TOL:
        fail(f"JPEGs read back off by up to {max(maes):.2f} a channel (tol "
             f"{IMAGE_MAE_TOL})")
    ann = [{"image": f"im{k:02d}.jpg",
            "caption": (["a picture", f"image number {k}"] if k == 5 else
                        f"a photo of striped image {k} with "
                        + "colour " * (k % 7))}
           for k in range(IMAGE_FILES)]
    path = os.path.join(root, "captions.json")
    with open(path, "w") as f:
        json.dump(ann, f)
    print(f"[images_written] {IMAGE_FILES} JPEGs of {w}x{h}, "
          f"{sum(os.path.getsize(os.path.join(root, a['image'])) for a in ann) / 2 ** 20:.2f} MiB in {write_s:.2f} s; read_image "
          f"{read_ms:.2f} ms an image; mean abs error max {max(maes):.2f} "
          f"(tol {IMAGE_MAE_TOL}) | {CARD}", flush=True)
    return path


def _image_batch(runner, raw):
    from youku_mplug_tpu_torch.cli import common

    text = runner.tokenizer(raw["text"])
    return common.to_device(runner, {"image": raw["image"], **text})


def _normalize_images(images_u8, dtype):
    """uint8 [B, H, W, C] -> normalized [B, C, H, W] (the clip
    normalization on one-frame clips)."""
    from youku_mplug_tpu_torch.ops.preprocess import normalize_clip

    return normalize_clip(images_u8[:, None], dtype=dtype)[:, :, 0]


def _image_loss_fn(model):
    def loss_fn(batch, generator=None):
        return model.image_pretrain_loss(
            _normalize_images(batch["image"], model.policy.compute_dtype),
            batch["input_ids"], batch["attention_mask"], generator=generator)
    return loss_fn


def _image_runner(tag, out_dir, ann, vision, steps):
    """The flagship pretrain YAML's run (its frozen GPT-3 1.3B, optimizer,
    batch 16 and 80 tokens) with an image model on ``vision`` (the
    image tower only, ``MPLUGVideo(..., image=True)``), jax_init'd from
    the seed, over ImageTextDataset on the JPEGs (the train transform at
    224 px) through the YAML's threaded Loader."""
    from youku_mplug_tpu_torch.cli import common
    from youku_mplug_tpu_torch.config import load_config
    from youku_mplug_tpu_torch.data.image_datasets import ImageTextDataset
    from youku_mplug_tpu_torch.data.transforms import train_transform
    from youku_mplug_tpu_torch.models.tasks import MPLUGVideo

    args = common.base_parser(tag).parse_args([
        "--config", TRAIN_YAML, "--output_dir", os.path.join(out_dir, tag),
        "--max_steps", str(steps), "--device", "cuda"])
    cfg = load_config(TRAIN_YAML)
    cfg.model = dataclasses.replace(cfg.model, vision=vision)
    ds = ImageTextDataset(ann, os.path.dirname(ann),
                          transform=train_transform(cfg.image_res),
                          seed=args.seed)
    loader = common.make_loader(args, cfg, ds)
    t0 = time.perf_counter()
    runner = common.setup(args, cfg, loader, model_fn=lambda policy:
                          MPLUGVideo(cfg.model, policy, image=True))
    torch.cuda.synchronize()
    return runner, time.perf_counter() - t0


def _tower_geometry(tag, vcfg, tower, want):
    """The image tower's geometry, checked against ``want``."""
    got = {"width": vcfg.embed_dim, "depth": len(tower.blocks),
           "heads": vcfg.num_heads,
           "head_dim": vcfg.embed_dim // vcfg.num_heads,
           "patch": vcfg.patch_size, "tokens": vcfg.num_patches + 1,
           "mlp": tower.blocks[0].mlp.fc1_kernel.shape[1],
           "drop_path": vcfg.drop_path, "grad_ckpt": vcfg.grad_ckpt,
           "parameters": sum(p.numel() for p in tower.parameters())}
    if {k: got[k] for k in want} != want:
        fail(f"[{tag}] not the full geometry: {got}, expected {want}")
    return got


def phase_image_pretrain(report, out_dir, ann):
    """Phase 36: image_pretrain_loss on the flagship (the TimeSformer's
    ViT-B/16 as a plain image tower, 12 heads of 64, 197 tokens; 128
    queries; the frozen GPT-3 1.3B), IMAGE_STEPS steps of 16 JPEGs."""
    from youku_mplug_tpu_torch.config import load_config
    from youku_mplug_tpu_torch.models.tasks import MPLUGVideo
    from youku_mplug_tpu_torch.train.trainer import make_train_step

    tag = "image_pretrain"
    vision = load_config(TRAIN_YAML).model.vision
    runner, setup_s = _image_runner(tag, out_dir, ann, vision, IMAGE_STEPS)
    if hasattr(runner.model, "visual_encoder") or not isinstance(
            runner.model, MPLUGVideo):
        fail(f"[{tag}] the image model holds a video tower")
    geometry = _tower_geometry(tag, vision, runner.model.image_encoder,
                               {"width": 768, "depth": 12, "heads": 12,
                                "head_dim": 64, "tokens": 197})
    _, stats = _train_steps(report, tag, runner, make_train_step(
        _image_loss_fn(runner.model), dropout_seed=runner.args.seed),
        _image_batch, IMAGE_STEPS, IMAGE_PRETRAIN_LAUNCHES, frozen=True)
    replay = _train_replay(tag, runner, _image_batch, _image_loss_fn)
    out = {"yaml": os.path.relpath(TRAIN_YAML, REPO), "geometry": geometry,
           "queries": runner.model.cfg.num_learnable_token,
           "setup_s": setup_s, **stats, "replay": replay}
    print(f"[{tag}] {json.dumps(out)} | {CARD}", flush=True)


def phase_eva_pretrain(report, out_dir, ann):
    """Phase 37: image_pretrain_loss on EVA-ViT-g at full width and depth
    (1408 x 40, 16 heads of 88, patch 14: 257 tokens, MLP 6144, drop-path
    0.4, every block checkpointed, trainable) under the frozen GPT-3
    1.3B, EVA_STEPS steps of 16 JPEGs; AttentionPool's 128 queries over
    258 keys take K4 / K4b at head dim 88."""
    from youku_mplug_tpu_torch.models.vision import EVA_VIT_G
    from youku_mplug_tpu_torch.train.trainer import make_train_step

    tag = "eva_pretrain"
    runner, setup_s = _image_runner(tag, out_dir, ann, EVA_VIT_G, EVA_STEPS)
    geometry = _tower_geometry(
        tag, EVA_VIT_G, runner.model.image_encoder,
        {"width": 1408, "depth": 40, "heads": 16, "head_dim": 88,
         "patch": 14, "tokens": 257, "mlp": 6144, "drop_path": 0.4,
         "grad_ckpt": True})
    if not 0.95e9 < geometry["parameters"] < 1.05e9:
        fail(f"[{tag}] {geometry['parameters']} tower parameters")
    _, stats = _train_steps(report, tag, runner, make_train_step(
        _image_loss_fn(runner.model), dropout_seed=runner.args.seed),
        _image_batch, EVA_STEPS, EVA_PRETRAIN_LAUNCHES, frozen=True)
    replay = _train_replay(tag, runner, _image_batch, _image_loss_fn)
    out = {"geometry": geometry, "setup_s": setup_s,
           "trainable_parameters": sum(p.numel() for p in
                                       runner.state.trainable.values()),
           **stats, "replay": replay}
    print(f"[{tag}] {json.dumps(out)} | {CARD}", flush=True)


def phase_coca(report, out_dir, ann):
    """Phase 38: MPLUGCOCA at its default config (a ViT-B/16 tower, 12
    heads of 64; two GPT-2 small decoders, 12 x 768, vocab 50257), seeded
    weights, every leaf trainable, COCA_STEPS AdamW steps of 16 JPEGs
    through ImageTextDataset with MIMPretrainTransform (224 px, the second
    stream at 112, 75 of 196 patches masked), 40 tokens, seeded MIM
    targets [16, 196, 512]; the first batch replayed plain."""
    from youku_mplug_tpu_torch import bridge
    from youku_mplug_tpu_torch.cli import common
    from youku_mplug_tpu_torch.data.image_datasets import ImageTextDataset
    from youku_mplug_tpu_torch.data.loader import Loader
    from youku_mplug_tpu_torch.data.pretrain_transforms import (
        MIMPretrainTransform,
    )
    from youku_mplug_tpu_torch.models import gpt2_multimodal as g2
    from youku_mplug_tpu_torch.models.tokenizer import (
        BatchTokenizer,
        load_tokenizer,
    )
    from youku_mplug_tpu_torch.optim.factory import OptimizerConfig
    from youku_mplug_tpu_torch.runtime.precision import DEFAULT_POLICY
    from youku_mplug_tpu_torch.train.state import create_train_state
    from youku_mplug_tpu_torch.train.trainer import make_train_step

    tag, seed, dev = "coca", 0, torch.device("cuda")
    cfg = g2.COCAConfig()
    t0 = time.perf_counter()
    with dev:
        model = g2.MPLUGCOCA(cfg, DEFAULT_POLICY)
    bridge.seeded_init(model, seed)
    opt = OptimizerConfig(lr=1e-4, weight_decay=0.05, opt_eps=1e-6,
                          warmup_steps=0, epochs=1, niter_per_ep=COCA_STEPS,
                          freeze_text_decoder=False)
    state, _, schedule = create_train_state(model.train(), opt)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    mim = MIMPretrainTransform(224, second_size=112)
    ds = ImageTextDataset(ann, os.path.dirname(ann), mim_transform=mim,
                          seed=seed)
    args = common.base_parser(tag).parse_args([
        "--config", "", "--output_dir", os.path.join(out_dir, tag),
        "--max_steps",
        str(COCA_STEPS), "--device", "cuda", "--seed", str(seed)])
    runner = common.Runner(
        args=args, cfg=None, device=dev, model=model,
        tokenizer=BatchTokenizer(load_tokenizer("", cfg.gpt2.vocab_size),
                                 max_length=COCA_TOKENS),
        state=state, schedule=schedule,
        loader=Loader(ds, 16, seed=seed, num_workers=4))
    grid = cfg.vision.img_size // cfg.vision.patch_size

    def make_batch(runner, raw):
        text = runner.tokenizer(raw["text"])
        batch = common.to_device(runner, {
            "image": raw["image"], "bool_masked_pos": raw["bool_masked_pos"],
            **text})
        g = torch.Generator(device=dev).manual_seed(int(raw["index"][0]))
        batch["image_target"] = torch.randn(
            len(raw["index"]), grid * grid, cfg.predict_feature_dim,
            generator=g, device=dev)
        return batch

    def make_loss_fn(model):
        def loss_fn(batch, generator=None):
            return model(_normalize_images(batch["image"],
                                           model.policy.compute_dtype),
                         batch["input_ids"], batch["attention_mask"],
                         bool_masked_pos=batch["bool_masked_pos"],
                         image_target=batch["image_target"],
                         generator=generator)
        return loss_fn

    def check(history):
        bad = [h for h in history if not (math.isfinite(h["loss_caption"])
                                          and 0 < h["loss_mim"] < 2.1)]
        if bad:
            fail(f"[{tag}] loss_caption / loss_mim out of range: {bad}")

    sample = ds[0]
    if (sample["image"].shape, sample["image_target"].shape,
            int(sample["bool_masked_pos"].sum())) != (
            (224, 224, 3), (112, 112, 3), 75):
        fail(f"[{tag}] the MIM sample: {sample['image'].shape}, "
             f"{sample['image_target'].shape}, "
             f"{int(sample['bool_masked_pos'].sum())} masked")
    _, stats = _train_steps(report, tag, runner, make_train_step(
        make_loss_fn(model), dropout_seed=seed), make_batch, COCA_STEPS,
        COCA_LAUNCHES, check=check)
    replay = _train_replay(tag, runner, make_batch, make_loss_fn)
    out = {"vision": {"width": cfg.vision.embed_dim,
                      "heads": cfg.vision.num_heads,
                      "depth": cfg.vision.depth},
           "gpt2": {"width": cfg.gpt2.n_embd, "layers": cfg.gpt2.n_layer,
                    "vocab": cfg.gpt2.vocab_size},
           "parameters": sum(p.numel() for p in model.parameters()),
           "tokens": COCA_TOKENS, "masked_patches": 75,
           "setup_s": setup_s, **stats, "replay": replay}
    print(f"[{tag}] {json.dumps(out)} | {CARD}", flush=True)


def phase_clip(report, ann):
    """Phase 39: CLIP at its default config (ViT-B/16 image tower, the
    12-layer text tower) on 16 of the JPEGs and 16 x 77 seeded ids, and
    XCLIP over 16 clips of 8 frames at 224 (frames of the JPEGs): the bf16
    forward (DEFAULT_POLICY) against the same weights in fp32 on the card,
    features and logits within CLIP_BF16_TOL relative L2; the inflate
    contract: CLIP's weights inflated into the VideoFormer (MHRA's
    ``expand`` zero, as the reference inits it) give a clip of one
    repeated frame equal per-frame tokens, each CLIP's tokens for that
    frame (after ln_post), within CLIP_INFLATE_TOL.  Attention runs plain
    (no kernel), as in JAX."""
    import numpy as np

    from youku_mplug_tpu_torch import bridge
    from youku_mplug_tpu_torch.data.image_datasets import ImageTextDataset
    from youku_mplug_tpu_torch.data.transforms import test_transform
    from youku_mplug_tpu_torch.models import clip as tclip
    from youku_mplug_tpu_torch.models import clip_video as tcv
    from youku_mplug_tpu_torch.runtime.precision import (
        DEFAULT_POLICY,
        FP32_POLICY,
    )

    tag, dev = "clip", torch.device("cuda")
    ds = ImageTextDataset(ann, os.path.dirname(ann),
                          transform=test_transform(224))
    frames = torch.from_numpy(np.stack([ds[k]["image"] for k in range(
        IMAGE_FILES)])).to(dev)
    images = _normalize_images(frames[:16], torch.float32)
    order = torch.tensor([[(4 * c + f) % IMAGE_FILES for f in range(8)]
                          for c in range(16)])
    video = _normalize_images(frames[order.reshape(-1)], torch.float32
                              ).reshape(16, 8, 3, 224, 224).transpose(1, 2)
    g = torch.Generator().manual_seed(39)
    ids = torch.zeros(16, 77, dtype=torch.long)
    for r, n in enumerate(torch.randint(3, 70, (16,), generator=g).tolist()):
        ids[r, 0] = 49406
        ids[r, 1:n] = torch.randint(1, 49405, (n - 1,), generator=g)
        ids[r, n] = 49407
    ids = ids.to(dev)
    out, models = {}, {}
    _reset_counts(report)
    for name, ctor, cfg in (("clip", tclip.CLIP, tclip.CLIPConfig()),
                            ("xclip", tcv.XCLIP, tcv.VideoFormerConfig(
                                num_frames=8))):
        with dev:
            bf16, fp32 = ctor(cfg, DEFAULT_POLICY), ctor(cfg, FP32_POLICY)
        bridge.seeded_init(fp32, 39)
        if name == "xclip":  # the reference's zero-init MHRA expand
            for n_, p in fp32.named_parameters():
                if ".expand." in n_:
                    p.data.zero_()
        bf16.load_state_dict(fp32.state_dict())
        models[name] = fp32
        x = images if name == "clip" else video
        enc = "encode_image" if name == "clip" else "encode_video"
        with torch.no_grad():
            res = {}
            for pol, m in (("bf16", bf16), ("fp32", fp32)):
                getattr(m, enc)(x)  # warm
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                feat = getattr(m, enc)(x)
                torch.cuda.synchronize()
                res[pol] = {"ms": (time.perf_counter() - t0) * 1e3,
                            "feat": feat.float(), "logits": m(x, ids)}
            errs = {"features": rel_l2(res["bf16"]["feat"],
                                     res["fp32"]["feat"]),
                    "logits": max(rel_l2(a, b) for a, b in zip(
                        res["bf16"]["logits"], res["fp32"]["logits"]))}
        finite = all(torch.isfinite(t).all() for r in res.values()
                     for t in (r["feat"], *r["logits"]))
        if not finite or max(errs.values()) > CLIP_BF16_TOL:
            fail(f"[{tag}] {name} bf16 against fp32 (relative L2 tol "
                 f"{CLIP_BF16_TOL}): {errs}, finite {finite}")
        n_in = x.shape[0] * (1 if name == "clip" else x.shape[2])
        out[name] = {"batch": list(x.shape), "rel_l2_bf16_vs_fp32": errs,
                     "ms_bf16": res["bf16"]["ms"],
                     "ms_fp32": res["fp32"]["ms"],
                     "images_per_s_bf16": n_in * 1e3 / res["bf16"]["ms"],
                     "parameters": sum(p.numel() for p in fp32.parameters())}
        del bf16, res
    # the inflate contract, on the fp32 models
    xclip, clip = models["xclip"], models["clip"]
    tree = bridge.flatten(bridge.to_jax_tree(xclip.visual))
    tree.update(bridge.flatten(tcv.inflate_clip_to_videoformer(
        bridge.to_jax_tree(clip), xclip.cfg)))
    bridge.load_jax_params(xclip.visual, bridge.unflatten(tree))
    one = images[:1, :, None].expand(1, 3, 8, 224, 224)
    with torch.no_grad():
        toks = xclip.visual(one)
        _, raw = clip.visual(images[:1])
        want = clip.visual.ln_post(raw)[0]
    spread = max(rel_l2(toks[f], toks[0]) for f in range(1, 8))
    to_clip = rel_l2(toks[0], want)
    if max(spread, to_clip) > CLIP_INFLATE_TOL:
        fail(f"[{tag}] inflate: frames differ by {spread}, CLIP's tokens "
             f"by {to_clip} (tol {CLIP_INFLATE_TOL})")
    out["inflate"] = {"frames_rel_l2_max": spread,
                      "clip_tokens_rel_l2": to_clip}
    out["launches"] = {r["key"]: sum(getattr(r["wrapper"], c)
                                     for c in _counters(r))
                       for r in report if any(getattr(r["wrapper"], c)
                                              for c in _counters(r))}
    if out["launches"]:
        fail(f"[{tag}] a kernel launched: {out['launches']}")
    print(f"[{tag}] {json.dumps(out)} | {CARD}", flush=True)
    del models, xclip, clip


# phase 40: the serve CLI under (data, model) splits, each a
# torch.distributed.run of its own; the gloo ranks share card 0 (their
# collectives copy through the host), NCCL takes one rank a card
MESH_SPLITS = (("1x1", "nccl"), ("1x2", "gloo"), ("2x2", "gloo"))
MESH_REQUESTS = 16
MESH_LAUNCH_S = 600  # one torch.distributed.run call's deadline
# launches per rank serving the 16 requests, written in PERF.md before the
# first chip run: the (1,1) run replays k = 1 CUDA graphs, its first
# capture after one eager warm-up step (65 + 1 decode steps of the
# decoder's SERVE_MESH_LAYERS layers, its depth here for the time
# budget); a model shard steps eagerly (65); a data rank of (2, 2)
# serves 8 of the requests (34 steps)
MESH_LAUNCHES = {"1x1": {"K1": 48, "K4": 2, "K5": 66 * SERVE_MESH_LAYERS},
                 "1x2": {"K1": 48, "K4": 2, "K5": 65 * SERVE_MESH_LAYERS},
                 "2x2": {"K1": 24, "K4": 1, "K5": 34 * SERVE_MESH_LAYERS}}
MESH_COUNTERS = {"K1": "flash_attention_packed.launches",
                 "K4": "flash_attention.launches",
                 "K5": "write_decode_attention.launches"}
# the serve CLI's --speculative on the model shards of the (1,2) and (2,2)
# calls: (draft, k) on the first SPEC_MESH_REQUESTS requests; each data
# rank encodes its share of them in one batch (K1 24 and K4 1 a rank,
# counted from zero); the twin draft (the CLI's default depth, a quarter
# of SERVE_MESH_LAYERS and at least 1: one layer)
# runs K5 on its proposal steps, prompt lookup no decode kernel
SPEC_MESH_REQUESTS = 8
SPEC_MESH_RUNS = (("twin", 4), ("ngram", 4))
SPEC_MESH_LAUNCHES = {"K1": 24, "K4": 1}
# where a split's served tokens leave (1,1)'s, (1,1)'s top-1 logit may lead
# its top-2 at that first divergence by at most this: the two replays of
# the same tokens agree within LOGIT_TOL, so greedy picks can part only
# where the lead is within twice that
MESH_TIE_BOUND = 2 * LOGIT_TOL
# phase 41: the flagship pretrain through run_pretrain under (1,1) NCCL
# (the reference), (1,2) and (2,1) gloo on card 0; TRAIN_MESH_STEPS steps
# of the same global batches in each; (1,1) takes one step more, of its
# next epoch, which the (2,1) run resumed from the (1,2) run's checkpoint
# takes too.  Launches per rank a step, written in PERF.md before the
# first chip run: the vision tower's 12 blocks x 2 K1 and blocks 0 and 6
# again in the backward (remat sixth), the 24 decoder layers' K1 and
# again in their recompute (remat), AttentionPool's K4; a backward (dq,
# dk/dv, delta) a vision attention, a decoder layer and AttentionPool.  A
# model = 2 rank holds 6 vision heads and 16 decoder heads (the packed
# kernel still takes both), a data rank 8 of the 16 clips: the counts
# stay
TRAIN_MESH_STEPS = 3
TRAIN_MESH_SPLITS = (("1x1", "nccl"), ("1x2", "gloo"), ("2x1", "gloo"))
TRAIN_MESH_LAUNCHES = {"K1": 28 + 2 * TRAIN_MESH_LAYERS, "K4": 1,
                       "dq": 25 + TRAIN_MESH_LAYERS,
                       "dkv": 25 + TRAIN_MESH_LAYERS,
                       "delta": 25 + TRAIN_MESH_LAYERS}
# the counters a training rank reads, {report key: (wrapper, attribute)}
TRAIN_MESH_COUNTERS = {"K1": ("flash_attention_packed", "launches"),
                       "K4": ("flash_attention", "launches"),
                       "dq": ("flash_bwd_dq_cuda", "launches"),
                       "dkv": ("flash_bwd_dkv_cuda", "launches"),
                       "delta": ("flash_bwd_delta_cuda", "launches")}
# a split's grad_norm against (1,1)'s, relative: two bf16 ulps (2^-8
# each) of a norm whose terms round in another order and on other ranks
TRAIN_MESH_NORM_TOL = 2.0 ** -7
# a split's moves (its leaves after the steps less the common initial
# ones) against (1,1)'s, per leaf as ``_leaf_rel_l2`` reads them
# (REPLAY_GRAD_FLOOR x the whole move's norm as the floor): the leaves
# barely move in 3 steps, so a gate on their values cannot see a wrong
# update.  Adam's first updates are about +-lr an element whatever the
# gradient's size: bf16 noise read 0.046-0.074 (LN scales), a gradient
# cut to one rank's share (a vision MLP or attention input without f)
# 0.98-1.02 (PERF.md §6).  AttentionPool's k_bias moves as its bias_k
# does: its gradient is -dk of the appended bias key (models/vision.py)
TRAIN_MESH_MOVE_TOL = 0.2
# leaves whose gradient is zero in exact arithmetic, kept out of the
# move gate (their values stay gated, their moves printed): the Owl
# abstractor's k_bias adds q . b
# to every score of a query alike, which the softmax cancels, so what
# reaches it is the bf16 rounding of the probabilities' gradient, which
# Adam turns into lr-sized moves of either sign on every rank alike in
# size but not in sign (phase 42's first chip run: gated 0.34 at (1,2))
ZERO_GRADIENT_LEAVES = r".*abstractor/layers_\d+/k_bias$"

# phase 45: run_cls, run_retrieval and run_retrieval_itm on their shipped
# YAMLs under (1,1) NCCL, (1,2) and (2,1) gloo on card 0 (phase 41's
# splits, in phase 40's calls): full width (clip-b16 768 wide, 8 heads of
# 96; the 1.3B 2048 wide, 32 heads of 64), the decoder at
# DOWNSTREAM_MESH_LAYERS of 24 layers and clip-b16 at
# DOWNSTREAM_MESH_BLOCKS of 12 blocks, the shipped 0.1 decoder dropouts
# on (and run_cls's vision rates set to 0.1), DOWNSTREAM_MESH_STEPS train
# steps of the same global batches, then one evaluation: a test batch of
# cls (eval_video_batch 4 clips a call), DOWNSTREAM_MESH_SPLIT clips and
# texts of retrieval and ITM; ITM at phase 13's batch of 32 clips
DOWNSTREAM_MESH_LAYERS = 2
DOWNSTREAM_MESH_BLOCKS = 2
DOWNSTREAM_MESH_STEPS = 2
DOWNSTREAM_MESH_SPLIT = {"itm": 8, "retrieval": 96}
DOWNSTREAM_MESH_KINDS = ("cls", "retrieval", "itm")
# launches per rank, written in PERF.md before the first chip run: a
# cls / ITM train step runs AttentionPool's K4 at d 96 and its backward
# (dq, the short-query dk/dv, delta) once (the decoder trains under
# attention dropout on the plain path, clip-b16 on einsum), a retrieval
# step the text tower's K1 once a layer (the frozen decoder takes no
# backward); an evaluation call of cls / ITM one K4 at d 96 and K1 twice a
# layer (the pairs, the head's prompts), a retrieval text call K1 once a
# layer; a model = 2 rank runs every kernel once as (1,1) does (16 of the
# decoder's 32 heads, AttentionPool replicated), a data rank of (2,1) its
# half of the evaluation calls (every text call of retrieval: the texts
# stay whole on every rank)
DOWNSTREAM_MESH_LAUNCHES = {
    "cls": ({"K4-d96": 1, "dq-d96": 1, "dkv-d96": 1, "delta": 1},
            {"K4-d96": 1, "K1": 2 * DOWNSTREAM_MESH_LAYERS}),
    "itm": ({"K4-d96": 1, "dq-d96": 1, "dkv-d96": 1, "delta": 1},
            {"K4-d96": 1, "K1": 2 * DOWNSTREAM_MESH_LAYERS}),
    "retrieval": ({"K1": DOWNSTREAM_MESH_LAYERS},
                  {"K1": DOWNSTREAM_MESH_LAYERS})}
# the counters a phase 45 rank reads, {report key: (wrapper, attribute)}:
# every flash kernel its paths could reach, the unpredicted ones at zero
DOWNSTREAM_MESH_COUNTERS = {
    **TRAIN_MESH_COUNTERS,
    "K4-d96": ("flash_attention", "d96_launches"),
    "dq-d96": ("flash_bwd_dq_cuda", "d96_launches"),
    "dkv-d96": ("flash_bwd_dkv_cuda", "d96_short_launches")}
# AttentionPool's k_bias gradient from K4 / K4b on a (2,1) cls rank's
# (B, heads, queries, head dim, keys + the bias key), bf16 inputs of unit
# variance: the port's form, -dk of the appended bias key summed over the
# batch, against an fp64 plain reference within the kernels' gradient
# gate; the sum of every other key's dk rows (the same gradient in exact
# arithmetic, a k_bias on every key) is printed beside it
POOL_BIAS_SHAPE = (16, 8, 128, 96, 1570)
POOL_BIAS_TOL = 2.0 ** -7


def _torchrun(n, argv, log_path):
    """``python -m torch.distributed.run --standalone --nproc_per_node=n
    argv`` from the repository's root, its output into ``log_path``;
    fails on a non-zero exit, or (every process of the call killed) past
    MESH_LAUNCH_S.  Returns its seconds."""
    import signal

    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p)}
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc_per_node={n}", *argv], cwd=REPO, env=env,
            stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
        try:
            rc = proc.wait(timeout=MESH_LAUNCH_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = None
    if rc != 0:
        with open(log_path) as f:
            tail = f.read()[-4000:]
        fail(f"{' '.join(argv[:2])} on {n} ranks: "
             + (f"past {MESH_LAUNCH_S} s" if rc is None else f"exit {rc}")
             + f":\n{tail}")
    return time.perf_counter() - t0


def _mesh_replay(args, cfg, model, tokens):
    """Phase 40's teacher-forced replay on this rank's model: the serve's
    clips encoded in batches of its 8 slots (query features), and each
    served sequence (``tokens``, then the eos where it stopped short of
    max_new_tokens) fed back through an engine of 8 slots built as the
    serve builds it: the prefill's logits, then one decode step a
    position (fp32 logits [requests, positions, vocab], zero past a
    sequence's end).  Then a decode step of that engine's 8 slots, timed:
    host ms over its dispatches and, traced on rank 0, device ms,
    launches and idle share.  Returns the record rank 0 saves."""
    from youku_mplug_tpu_torch.cli import serve
    from youku_mplug_tpu_torch.ops.preprocess import normalize_clip

    t0 = time.perf_counter()
    lm, slots = model.text_decoder, args.num_slots
    dev = lm.word_embeddings.embedding.device
    ds = serve.run_caption.dataset(args, cfg, train=False)
    max_new = int(cfg.get("max_new_tokens", 32))
    qes, logits, seqs = [], None, None
    for b0 in range(0, len(tokens), slots):
        idx = range(b0, min(b0 + slots, len(tokens)))
        clips = torch.stack([torch.from_numpy(ds[i]["video"]) for i in idx])
        with torch.inference_mode():
            qe = model.encode_queries(normalize_clip(
                clips.to(dev), dtype=model.policy.compute_dtype))
        qes.append(qe.float().cpu())
        engine, prompt = serve.make_engine(args, cfg, lm, model.mesh)
        eos = engine.config.eos_id
        seqs = seqs or [list(t) + ([eos] if len(t) < max_new else [])
                        for t in tokens]
        pick, first = engine._pick, []

        def recording(lg, pick=pick, first=first):
            first.append(lg.float().cpu())
            return pick(lg)
        engine._pick = recording  # the prefill's logits, slot by slot
        for j in range(len(idx)):
            engine.submit(prompt, query_embeds=qe[j])
        engine._admit()
        del engine._pick
        if logits is None:
            logits = torch.zeros(len(tokens), max_new, first[0].shape[-1])
        for j, i in enumerate(idx):
            logits[i, 0] = first[j][0]
        vf = torch.from_numpy(engine.valid_from).to(dev)
        po = torch.from_numpy(engine.pos_offset).to(dev)
        with torch.inference_mode():
            for step in range(max(len(seqs[i]) for i in idx) - 1):
                tok = torch.full((slots,), eos, dtype=torch.long)
                for j, i in enumerate(idx):
                    if step < len(seqs[i]):
                        tok[j] = seqs[i][step]
                cl = torch.from_numpy(engine.cache_len + step).to(dev)
                lg, _ = lm.decode_step(lm.embed(tok.to(dev)[:, None]),
                                       engine.cache, cl, vf, po)
                lg = lg.float().cpu()
                for j, i in enumerate(idx):
                    if step + 1 < len(seqs[i]):
                        logits[i, step + 1] = lg[j]
    replay_s = time.perf_counter() - t0

    def dispatch():
        return engine._launch(1).cpu()
    # an eager step on a model shard takes ~0.1 s under gloo, and one
    # traced step holds its ~1000 launches
    timed, traced = (10, 1) if engine.eager else (20, 3)
    for _ in range(3):
        dispatch()
    t1 = time.perf_counter()
    for _ in range(timed):
        dispatch()
    host = (time.perf_counter() - t1) / timed * 1e3
    t1 = time.perf_counter()
    if model.mesh.rank == 0:  # the other ranks dispatch alike, untraced
        trace = _trace_decode(dispatch, traced, 1)
    else:
        trace = {}
        for _ in range(traced):
            dispatch()
    return {"qe": torch.cat(qes), "logits": logits,
            "lengths": [len(t) for t in seqs], "seqs": seqs,
            "host_ms": host, "eager": engine.eager, **trace,
            "replay_s": replay_s, "trace_s": time.perf_counter() - t1}


def mesh_rank(yaml_path, backend, device, out_dir, ref_path,
              train_specs="[]", owl_spec="{}", parallel_dir="",
              downstream_specs="[]"):
    """One rank of phases 40-42 (``chip_smoke.py --mesh-rank`` under
    torch.distributed.run): the serve CLI's ``build`` and ``serve_built``
    (all ``python -m youku_mplug_tpu_torch.cli.serve`` runs) on the
    split's YAML, 16 requests on 8 slots; then, on the same model and on
    data rank 0's ranks only, ``_mesh_replay`` of ``ref_path``'s served
    tokens ((1,1)'s ``serve_results.json``, for (1,1) its own); rank 0
    saves the replay's record as ``out_dir/forced.pt``.  The same process
    then runs, on the same process group, each training spec of
    ``train_specs`` (a JSON list: phase 41's splits of this world, in
    order, ``train_mesh_rank``), phase 45's downstream recipes of
    ``downstream_specs`` (``downstream_mesh_rank``), phase 42's serving
    and training of ``owl_spec`` (JSON, ``_owl_mesh_specs``'s), each
    model freed first, and with ``parallel_dir`` phase 43's parts
    (``parallel_rank``) last."""
    from youku_mplug_tpu_torch.runtime import mesh as mesh_lib

    try:
        _serve_mesh_rank(yaml_path, backend, device, out_dir, ref_path)
        for spec in json.loads(train_specs):
            gc.collect()
            torch.cuda.empty_cache()
            train_mesh_rank(json.dumps(spec))
        for spec in json.loads(downstream_specs):
            gc.collect()
            torch.cuda.empty_cache()
            downstream_mesh_rank(json.dumps(spec))
        owl = json.loads(owl_spec)
        if owl:
            gc.collect()
            torch.cuda.empty_cache()
            _owl_mesh_serve(owl["serve"])
            for spec in owl.get("train", []):
                train_mesh_rank(json.dumps(spec))
        if parallel_dir:
            gc.collect()
            torch.cuda.empty_cache()
            parallel_rank(parallel_dir, device)
    finally:
        mesh_lib.distributed_shutdown()


def _serve_mesh_rank(yaml_path, backend, device, out_dir, ref_path):
    from youku_mplug_tpu_torch.cli import serve

    args = serve.serve_parser().parse_args([
        "--config", yaml_path, "--synthetic_data", "--num_requests",
        str(MESH_REQUESTS), "--num_slots", "8", "--output_dir", out_dir,
        "--device", device, "--dist_backend", backend])
    cfg, model, dev = serve.build(args)
    serve.serve_built(args, cfg, model, dev)
    if model.mesh.data_index == 0:
        with open(ref_path) as f:
            tokens = [r["tokens"] for r in json.load(f)]
        record = _mesh_replay(args, cfg, model, tokens)
        if model.mesh.rank == 0:
            torch.save(record, os.path.join(out_dir, "forced.pt"))
    if model.mesh.model > 1:
        _spec_mesh_rank(cfg, model, dev, out_dir, yaml_path, backend,
                        device)


def _spec_mesh_rank(cfg, model, dev, out_dir, yaml_path, backend, device):
    """Phase 40's speculative serving on this rank's model shard: the
    plain replay's top-2 gaps of the split's own greedy tokens (this
    rank's results of the greedy serve) for its data rank's share of the
    first SPEC_MESH_REQUESTS requests, then ``serve_built`` once a
    SPEC_MESH_RUNS draft on those requests (counters from zero, each
    run's files under ``out_dir/spec_<draft>``); the record as
    ``spec_rank<r>.json``."""
    from youku_mplug_tpu_torch.cli import serve
    from youku_mplug_tpu_torch.ops.preprocess import normalize_clip
    from youku_mplug_tpu_torch.serving.engine import COUNTERS
    from youku_mplug_tpu_torch.serving.speculative import (
        speculative_generate,
        twin_draft,
    )

    mesh = model.mesh
    with open(os.path.join(out_dir, "ranks", f"rank{mesh.rank}.json")) as f:
        greedy = {r["index"]: r["tokens"] for r in json.load(f)["results"]
                  if r["index"] < SPEC_MESH_REQUESTS}
    idx = sorted(greedy)

    def argv(*extra):
        return serve.serve_parser().parse_args([
            "--config", yaml_path, "--synthetic_data", "--num_requests",
            str(SPEC_MESH_REQUESTS), "--num_slots", "8", "--device", device,
            "--dist_backend", backend, *extra])
    args = argv("--output_dir", out_dir)
    ds = serve.run_caption.dataset(args, cfg, train=False)
    clips = torch.stack([torch.from_numpy(ds[i]["video"]) for i in idx])
    with torch.inference_mode():
        qe = model.encode_queries(normalize_clip(
            clips.to(dev), dtype=model.policy.compute_dtype))
    prompt_vec, prompt_len, gen = serve._prompt(cfg)
    requests = [(prompt_vec, {"query_embeds": qe[j],
                              "max_new_tokens": gen.max_new_tokens})
                for j in range(len(idx))]
    gaps, _, _ = _plain_gaps(
        lambda: serve.make_engine(args, cfg, model.text_decoder, mesh)[0],
        requests, [greedy[i] for i in idx])
    rec = {"rank": mesh.rank, "coord": list(mesh.coord), "index": idx,
           "greedy": [greedy[i] for i in idx], "gaps": gaps}
    # the twin of the whole cut decoder on the text prompt alone (the twin
    # never reads the visual prefix, so the caption runs below commit one
    # token a round): its rounds commit accepted drafts on the shard
    lm = model.text_decoder
    b = len(idx)
    t0 = time.perf_counter()
    with torch.inference_mode():
        whole = speculative_generate(
            lm, twin_draft(lm, SERVE_MESH_LAYERS),
            torch.tensor([prompt_vec] * b, device=dev),
            torch.full((b,), max(prompt_len, 1), device=dev),
            config=dataclasses.replace(gen, eos_id=-1), speculate_len=4)
    rec["whole_twin"] = {
        "tokens": whole["sequences"].tolist(), "rounds": whole["rounds"],
        "tokens_per_round": whole["tokens_per_round"],
        "s": time.perf_counter() - t0}
    for draft, k in SPEC_MESH_RUNS:
        for fn, attr in COUNTERS:
            setattr(fn, attr, 0)
        t0 = time.perf_counter()
        rec[draft] = serve.serve_built(argv(
            "--speculative", str(k), "--draft", draft, "--output_dir",
            os.path.join(out_dir, f"spec_{draft}")), cfg, model, dev)
        rec[draft + "_s"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"spec_rank{mesh.rank}.json"), "w") as f:
        json.dump(rec, f)


def _train_cli(kind):
    """(set-up, its build_train_step, batch maker, counters, launches a
    step) of the training CLI phase 41 (``kind`` "pretrain":
    run_pretrain) or 42 ("instruct": run_instruct --train) runs under a
    split."""
    from youku_mplug_tpu_torch.cli import run_instruct, run_pretrain

    if kind == "instruct":
        return (run_instruct.train_setup, run_instruct.build_train_step,
                run_instruct.make_instruct_batch, OWL_TRAIN_MESH_COUNTERS,
                OWL_TRAIN_MESH_LAUNCHES)
    return (run_pretrain.setup, run_pretrain.build_train_step,
            run_pretrain.make_batch, TRAIN_MESH_COUNTERS,
            TRAIN_MESH_LAUNCHES)


def _train_mesh_run(kind, args, epoch, steps, init_to=None):
    """The ``kind`` CLI's training set-up (``common.init_mesh``, the block
    loader, the shard, the state, the resume) and ``common.
    train_one_epoch`` of ``steps`` steps of ``epoch``, with this rank's
    launch counters, peak memory and ``all_reduce`` calls over them;
    ``init_to``: the trainable leaves before the steps saved there (an
    unsplit run's).  Returns (runner, record)."""
    import torch.distributed as dist

    from youku_mplug_tpu_torch.cli import common
    from youku_mplug_tpu_torch.ops import flash_attention as fa

    setup, build_step, make_batch, counters, _ = _train_cli(kind)
    t0 = time.perf_counter()
    runner = setup(args)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    runner.args.max_steps = steps  # the schedule was set at setup
    if init_to:
        torch.save({k: p.detach().cpu() for k, p in
                    runner.state.trainable.items()}, init_to)
    wrappers = {k: (getattr(fa, n), a) for k, (n, a) in counters.items()}
    for fn, attr in wrappers.values():
        setattr(fn, attr, 0)
    calls = []
    reduce = dist.all_reduce

    def counted(*a, **k):
        calls.append(a[0].numel() * a[0].element_size())
        return reduce(*a, **k)
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(dist, "all_reduce", counted):
        history = common.train_one_epoch(runner, build_step(runner), epoch,
                                         make_batch)
    torch.cuda.synchronize()
    mesh = runner.mesh
    return runner, {
        "rank": mesh.rank, "coord": list(mesh.coord), "setup_s": setup_s,
        "history": history,
        "launches": {k: getattr(fn, attr)
                     for k, (fn, attr) in wrappers.items()},
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "all_reduces": len(calls), "all_reduce_bytes": sum(calls),
        "partial": len(runner.state.partial)}


def train_mesh_rank(spec_json):
    """One rank of phase 41's or 42's training: TRAIN_MESH_STEPS
    steps of ``spec["kind"]``'s CLI on the split of ``spec["yaml"]``;
    rank 0 saves the trainable leaves unsharded (``leaves.pt``); with
    ``spec["save"]`` the state is saved as ``save_epoch`` does (every rank
    gathers, rank 0 writes), with ``spec["next"]`` (1,1)'s next step is
    taken (one step of epoch 1; its leaves ``leaves_next.pt``); with
    ``spec["resume"]`` a second runner restores that directory's
    checkpoint and takes that step (``leaves_resumed.pt``).  Each rank
    writes its record as ``rank<r>.json``."""
    from youku_mplug_tpu_torch.cli import common, run_instruct, run_pretrain
    from youku_mplug_tpu_torch.parallel.sharding import gather_split

    spec = json.loads(spec_json)
    out, kind = spec["out"], spec["kind"]
    _, build_step, make_batch, _, _ = _train_cli(kind)

    def argv(out_dir, *extra):
        parse, flags = ((run_instruct.parser().parse_args,
                         ["--train", "--tokenizer", spec["tok"]])
                        if kind == "instruct" else
                        (run_pretrain.base_parser().parse_args, []))
        return parse([
            "--config", spec["yaml"], "--output_dir", out_dir,
            "--synthetic_data", "--max_steps", str(TRAIN_MESH_STEPS),
            "--device", spec["device"], "--dist_backend", spec["backend"],
            *flags, *extra])

    def save_leaves(runner, name):  # every rank gathers, rank 0 writes
        state = runner.state
        leaves = {k: (gather_split(p, state.split[k], runner.mesh)
                      if k in state.split else p.detach().cpu())
                  for k, p in state.trainable.items()}
        if runner.mesh.rank == 0:
            torch.save(leaves, os.path.join(out, name))

    t0 = time.perf_counter()
    runner, rec = _train_mesh_run(kind, argv(out), 0, TRAIN_MESH_STEPS,
                                  init_to=os.path.join(out, "init.pt")
                                  if spec.get("init") else None)
    save_leaves(runner, "leaves.pt")
    if spec.get("save"):
        t1 = time.perf_counter()
        common.save_epoch(runner, 0)
        runner.ckpt.close()
        rec["save_s"] = time.perf_counter() - t1
    if spec.get("next"):
        runner.args.max_steps = 1
        rec["next"] = common.train_one_epoch(runner, build_step(runner), 1,
                                             make_batch)
        save_leaves(runner, "leaves_next.pt")
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    if spec.get("resume"):
        t1 = time.perf_counter()
        resumed, rrec = _train_mesh_run(
            kind, argv(os.path.join(out, "resumed"), "--resume",
                       spec["resume"]), 1, 1)
        save_leaves(resumed, "leaves_resumed.pt")
        rec["resumed"] = {"start_epoch": resumed.start_epoch,
                          "step": resumed.state.step - 1,
                          "history": rrec["history"],
                          "launches": rrec["launches"],
                          "seconds": time.perf_counter() - t1}
        del resumed
        gc.collect()
        torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    with open(os.path.join(out, f"rank{rec['rank']}.json"), "w") as f:
        json.dump(rec, f)


def _downstream_mesh_specs(out_dir, tag, backend, device):
    """Phase 45's specs of one split (written before its ranks start):
    each recipe's shipped YAML with the split's mesh block and the
    phase's cuts, its rank directory."""
    data, model = map(int, tag.split("x"))
    specs = []
    for kind in DOWNSTREAM_MESH_KINDS:
        d = os.path.join(out_dir, f"downstream_{kind}_{tag}")
        os.makedirs(d)
        path = {"cls": CLS_YAML, "itm": ITM_YAML,
                "retrieval": RETRIEVAL_YAML}[kind]
        vision = {"depth": DOWNSTREAM_MESH_BLOCKS}
        cuts = {"mesh": {"data": data, "model": model},
                "text_overrides": {"num_hidden_layers":
                                   DOWNSTREAM_MESH_LAYERS},
                "eval_video_batch": DOWNSTREAM_EVAL_CLIPS}
        if kind == "cls":  # its vision rates on too
            vision.update(drop_rate=0.1, attn_drop_rate=0.1, drop_path=0.1)
            cuts["synthetic_length"] = 64
        elif kind == "itm":
            cuts.update(num_classes=2, batch_size=32, synthetic_length=64)
        else:
            cuts["synthetic_length"] = 192
        cuts["visual_overrides"] = vision
        specs.append({"kind": kind, "tag": tag, "out": d,
                      "yaml": _downstream_yaml(path, cuts, d),
                      "backend": backend, "device": device})
    return specs


def downstream_mesh_rank(spec_json):
    """One rank of phase 45: ``spec["kind"]``'s CLI on the split of
    ``spec["yaml"]`` through its own functions (``prepare``,
    ``build_train_step``, ``make_batch``; ``common.train_one_epoch`` of
    DOWNSTREAM_MESH_STEPS steps, then ``evaluation`` of one test batch
    (cls) or of a synthetic split of DOWNSTREAM_MESH_SPLIT clips and
    texts), with this rank's launches, every dropout mask's kept count
    and blocks in order, and the evaluation's scores; rank 0 saves the
    trainable leaves unsharded after the steps (``leaves.pt``; (1,1)
    also before them, ``init.pt``).  Each rank writes ``rank<r>.json`` and
    ``scores_rank<r>.pt``."""
    import numpy as np

    from youku_mplug_tpu_torch.cli import common, run_cls, run_retrieval
    from youku_mplug_tpu_torch.cli import run_retrieval_itm
    from youku_mplug_tpu_torch.data.datasets import SyntheticRetrievalSplit
    from youku_mplug_tpu_torch.ops import attention
    from youku_mplug_tpu_torch.ops import flash_attention as fa
    from youku_mplug_tpu_torch.parallel.sharding import gather_split

    spec = json.loads(spec_json)
    kind, out = spec["kind"], spec["out"]
    module = {"cls": run_cls, "itm": run_retrieval_itm,
              "retrieval": run_retrieval}[kind]
    t0 = time.perf_counter()
    args = module.parser().parse_args([
        "--config", spec["yaml"], "--output_dir", out, "--synthetic_data",
        "--max_steps", str(DOWNSTREAM_MESH_STEPS), "--device",
        spec["device"], "--dist_backend", spec["backend"]])
    prepared = module.prepare(args)
    runner = prepared[0]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    mesh, state = runner.mesh, runner.state

    def save_leaves(name):  # every rank gathers, rank 0 writes
        leaves = {k: (gather_split(p, state.split[k], mesh)
                      if k in state.split else p.detach().cpu())
                  for k, p in state.trainable.items()}
        if mesh.rank == 0:
            torch.save(leaves, os.path.join(out, name))
    if spec["tag"] == "1x1":
        save_leaves("init.pt")
    wrappers = {k: (getattr(fa, n), a)
                for k, (n, a) in DOWNSTREAM_MESH_COUNTERS.items()}

    def counts():
        return {k: getattr(fn, attr) for k, (fn, attr) in wrappers.items()}

    def zero():
        for fn, attr in wrappers.values():
            setattr(fn, attr, 0)
    kept, keep_mask = [], attention._keep_mask

    def counted(shape, rate, generator, device, blocks=()):
        keep = keep_mask(shape, rate, generator, device, blocks)
        kept.append([[list(b) for b in blocks], int(keep.sum())])
        return keep
    make_batch = (run_cls.make_batch_factory(prepared[3],
                                             runner.cfg.max_length)
                  if kind == "cls" else module.make_batch)
    zero()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    with mock.patch.object(attention, "_keep_mask", counted):
        history = common.train_one_epoch(runner,
                                         module.build_train_step(runner), 0,
                                         make_batch)
    torch.cuda.synchronize()
    rec = {"rank": mesh.rank, "coord": list(mesh.coord), "setup_s": setup_s,
           "train_s": time.perf_counter() - t1, "history": history,
           "launches_train": counts(), "kept": kept,
           "train_peak_memory_bytes": torch.cuda.max_memory_allocated()}
    save_leaves("leaves.pt")

    # the evaluation: its scores as the merge hands them to the metrics
    scores, calls = [], []
    runner.args.max_steps = 1  # one test batch (cls)
    if kind == "cls":
        score_batch = run_cls.score_batch

        def scored(runner_, raw, classnames):
            res = score_batch(runner_, raw, classnames)
            text = runner_.tokenizer(
                [(run_cls._title(t, runner_.cfg.max_length), c)
                 for t in raw["text"] for c in classnames])
            scores.append({
                "index": np.asarray(raw["index"]),
                "label": np.asarray(raw["label"]), **res,
                "scored": int((text["attention_mask"].sum(1) - 1
                               - text["prompt_lengths"]).max())})
            calls.append(-(-len(raw["text"]) // DOWNSTREAM_EVAL_CLIPS))
            return res
        patch = mock.patch.object(run_cls, "score_batch", scored)
        split = prepared[2]
    else:
        split = SyntheticRetrievalSplit(DOWNSTREAM_MESH_SPLIT[kind],
                                        num_frames=runner.cfg.num_frames,
                                        size=runner.cfg.image_res)
        rank_of = module.itm_eval

        def ranked(matrix, *a, **k):
            scores.append(np.asarray(matrix))
            return rank_of(matrix, *a, **k)
        patch = mock.patch.object(module, "itm_eval", ranked)
    zero()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    with patch:
        metrics = (module.evaluation(runner, split, prepared[3])
                   if kind == "cls" else module.evaluation(runner, split))
    torch.cuda.synchronize()
    if kind == "itm":  # its calls: this rank's clips x the text calls
        clips = len(range(mesh.data_index, len(split), mesh.data))
        calls = [-(-clips // DOWNSTREAM_EVAL_CLIPS)
                 * -(-len(split) // module.TEXTS_PER_CALL)]
    elif kind == "retrieval":  # the text calls: every text on every rank
        calls = [-(-len(split.text) // runner.cfg.batch_size)]
    rec |= {"eval_s": time.perf_counter() - t1, "metrics": metrics,
            "launches_eval": counts(), "eval_calls": sum(calls),
            "eval_peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "seconds": time.perf_counter() - t0}
    torch.save(scores, os.path.join(out, f"scores_rank{mesh.rank}.pt"))
    with open(os.path.join(out, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(rec, f)
    runner.ckpt.close()


def _mesh_forced_check(tag, forced, ref, toks):
    """A split's replay of (1,1)'s served tokens against (1,1)'s replay:
    the query features within QUERY_TOL and the logits at every position
    of every sequence within LOGIT_TOL, all finite; where the split's
    served tokens leave (1,1)'s, (1,1)'s top-1 - top-2 lead at that
    first divergence within MESH_TIE_BOUND.  Returns the printed
    verdict."""
    want = ref["forced"]
    valid = torch.zeros(want["logits"].shape[:2], dtype=torch.bool)
    for i, n in enumerate(want["lengths"]):
        valid[i, :n] = True
    got_l, want_l = forced["logits"][valid], want["logits"][valid]
    e_q = err(forced["qe"], want["qe"])
    e_l = err(got_l, want_l)
    finite = bool(torch.isfinite(got_l).all())
    agree = int((got_l.argmax(-1) == want_l.argmax(-1)).sum())
    divergences, too_wide = [], []
    for i, (a, b) in enumerate(zip(toks, ref["tokens"])):
        if a == b:
            continue
        t = next(j for j in range(max(len(a), len(b)) + 1)
                 if j >= len(a) or j >= len(b) or a[j] != b[j])
        lead = [float(x[0] - x[1]) for x in (
            want["logits"][i, t].topk(2).values,
            forced["logits"][i, t].topk(2).values)]
        divergences.append((i, t, round(lead[0], 5), round(lead[1], 5)))
        if lead[0] > MESH_TIE_BOUND:
            too_wide.append(divergences[-1])
    vs = (f"teacher-forced on (1,1)'s {int(valid.sum())} served positions "
          f"of {len(toks)} requests: query features max err {e_q:.4g} (tol "
          f"{QUERY_TOL}), logits {e_l:.4g} (tol {LOGIT_TOL}), greedy "
          f"agreement {agree}/{int(valid.sum())}; served tokens equal to "
          f"(1,1)'s on {len(toks) - len(divergences)}/{len(toks)} requests; "
          f"first divergences (request, position, (1,1)'s top-1 - top-2 "
          f"lead, this split's) {divergences} (bound {MESH_TIE_BOUND})")
    if not finite or e_q > QUERY_TOL or e_l > LOGIT_TOL or too_wide:
        fail(f"serve_mesh {tag}: {vs}")
    return vs


def _mesh_check_split(tag, data, merged, ranks, ref_peak):
    """Phase 40's gates on one split's files: the 16 requests once each;
    per rank the predicted launches, no graph replay on a model shard, a
    serve peak below (1,1)'s; each data rank its stride of the requests,
    the model ranks of a data rank the same tokens."""
    ids = sorted(int(r["video_id"]) for r in merged)
    if ids != list(range(MESH_REQUESTS)) or any(not r["tokens"]
                                               for r in merged):
        fail(f"serve_mesh {tag}: merged requests {ids}")
    by_data = {}
    for rk in ranks:
        got = {k: rk["launches"][c] for k, c in MESH_COUNTERS.items()}
        if got != MESH_LAUNCHES[tag] \
                or rk["decode_steps"] * SERVE_MESH_LAYERS != got["K5"]:
            fail(f"serve_mesh {tag} rank {rk['rank']}: launches {got}, "
                 f"{rk['decode_steps']} decode steps; predicted "
                 f"{MESH_LAUNCHES[tag]}")
        if rk["split"]["model"] > 1 and rk["graph_replays"] != 0:
            fail(f"serve_mesh {tag}: {rk['graph_replays']} graph replays on "
                 f"a model shard")
        if ref_peak is not None and rk["peak_memory_bytes"] >= ref_peak:
            fail(f"serve_mesh {tag} rank {rk['rank']}: peak "
                 f"{rk['peak_memory_bytes']} B, not below (1,1)'s {ref_peak}")
        by_data.setdefault(rk["coord"][0], []).append(rk)
    for d, rks in sorted(by_data.items()):
        index = [r["index"] for r in rks[0]["results"]]
        if index != list(range(d, MESH_REQUESTS, data)):
            fail(f"serve_mesh {tag}: data rank {d} served {index}")
        toks = [[r["tokens"] for r in rk["results"]] for rk in rks]
        if any(t != toks[0] for t in toks):
            fail(f"serve_mesh {tag}: the model ranks of data rank {d} "
                 f"decoded different tokens")


def _spec_mesh_check(report, tag, d, data, n):
    """Phase 40's speculative gates on a model-shard split's files: for
    each SPEC_MESH_RUNS draft every one of the first SPEC_MESH_REQUESTS
    requests served once, each data rank its stride of them, the model
    ranks of a data rank the same tokens, each rank's K1 and K4 launches
    SPEC_MESH_LAUNCHES (K5 on the twin's proposal steps alone), and the
    merged tokens the split's greedy ones up to each request's first
    near-tie (CAPTION_TIE_GAP) in the split's plain replay of them; the
    launches into the report (path ``speculative_<draft>_mesh_<tag>``).
    Returns the printed summaries."""
    recs = []
    for r in range(n):
        with open(os.path.join(d, f"spec_rank{r}.json")) as f:
            recs.append(json.load(f))
    want, gaps = {}, {}
    for rec in recs:
        if rec["coord"][1] == 0:
            want.update(zip(rec["index"], rec["greedy"]))
            gaps.update(zip(rec["index"], rec["gaps"]))
    order = sorted(want)
    if order != list(range(SPEC_MESH_REQUESTS)):
        fail(f"speculative mesh {tag}: greedy requests {order}")
    lines = []
    for draft, k in SPEC_MESH_RUNS:
        path = f"speculative_{draft}_mesh_{tag}"
        rd = os.path.join(d, f"spec_{draft}")
        with open(os.path.join(rd, "serve_results.json")) as f:
            merged = json.load(f)
        ranks = []
        for r in range(n):
            with open(os.path.join(rd, "ranks", f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        ids = sorted(int(r["video_id"]) for r in merged)
        if ids != order or any(not r["tokens"] for r in merged):
            fail(f"{path}: merged requests {ids}")
        by_data = {}
        for rk in ranks:
            got = {key: rk["launches"][c] for key, c in MESH_COUNTERS.items()}
            if {key: got[key] for key in SPEC_MESH_LAUNCHES} \
                    != SPEC_MESH_LAUNCHES or bool(got["K5"]) != (
                        draft == "twin"):
                fail(f"{path} rank {rk['rank']}: launches {got}, predicted "
                     f"{SPEC_MESH_LAUNCHES} and K5 only for the twin")
            by_data.setdefault(rk["coord"][0], []).append(rk)
        for dd, rks in sorted(by_data.items()):
            index = [r["index"] for r in rks[0]["results"]]
            if index != list(range(dd, SPEC_MESH_REQUESTS, data)):
                fail(f"{path}: data rank {dd} served {index}")
            toks = [[r["tokens"] for r in rk["results"]] for rk in rks]
            if any(t != toks[0] for t in toks):
                fail(f"{path}: the model ranks of data rank {dd} committed "
                     f"different tokens")
        by_id = {int(r["video_id"]): r["tokens"] for r in merged}
        compared, diverged = _tie_check(
            path, [by_id[i] for i in order], [want[i] for i in order],
            [gaps[i] for i in order], CAPTION_TIE_GAP)
        for r in report:
            r.setdefault("launches_by_path", {})[path] = sum(
                rk["launches"].get(f"{r['wrapper'].__name__}.{c}", 0)
                for rk in ranks for c in _counters(r))
        missing = [r["name"] for r in report if path in r["paths"]
                   and r["launches_by_path"][path] == 0]
        if missing:
            fail(f"the {path} path never launched: {missing}")
        if draft == "twin":
            _whole_twin_check(tag, recs, lines)
        st = recs[0][draft]
        lines.append(
            f"{draft} k {k}: {json.dumps(st)}, K5 a rank "
            f"{[rk['launches'][MESH_COUNTERS['K5']] for rk in ranks]}, "
            f"tokens equal to the split's greedy ones on {compared} "
            f"positions before the first near-tie, divergences {diverged}, "
            f"{max(rec[draft + '_s'] for rec in recs):.1f} s")
    return lines


def _whole_twin_check(tag, recs, lines):
    """Phase 40's whole-decoder twin on the text prompt alone: more than
    one token a round committed (accepted drafts on the shard), the model
    ranks of a data rank the same tokens."""
    by_data = {}
    for rec in recs:
        by_data.setdefault(rec["coord"][0], []).append(rec["whole_twin"])
    for dd, ws in sorted(by_data.items()):
        if any(w["tokens"] != ws[0]["tokens"] for w in ws):
            fail(f"whole-decoder twin {tag}: the model ranks of data rank "
                 f"{dd} committed different tokens")
        if not ws[0]["tokens_per_round"] > 1:
            fail(f"whole-decoder twin {tag}: {ws[0]['tokens_per_round']} "
                 f"tokens a round, no accepted draft committed")
    w = recs[0]["whole_twin"]
    lines.append(f"whole-decoder twin k 4 on the text prompt alone: "
                 f"{w['tokens_per_round']:.3f} tokens a round over "
                 f"{w['rounds']} rounds, the model ranks alike, "
                 f"{max(r['whole_twin']['s'] for r in recs):.1f} s")


def phase_serve_mesh(report, out_dir, tok_dir):
    """Phase 40 (see the module docstring); the gloo numbers measure host
    copies, not NCCL.  Each split's torch.distributed.run then runs, in
    the same processes, phase 41's training splits of its world ((1,1);
    (1,2), then (2,1) resuming it) and phase 42's serving and training
    of its split, under ``out_dir/owl`` (their gates are those phases'
    own; its ``serve.log`` holds them all), and the (1,2) call phase 43's
    parts under ``out_dir/parallel``.  Returns the seconds of each
    call."""
    t_phase = time.perf_counter()
    ref_path = os.path.join(out_dir, "1x1", "serve_results.json")
    owl = _owl_mesh_specs(os.path.join(out_dir, "owl"), tok_dir)
    ref = None
    calls = {}
    for tag, backend in MESH_SPLITS:
        data, model = map(int, tag.split("x"))
        n = data * model
        d = os.path.join(out_dir, tag)
        os.makedirs(d)
        yaml_path = _downstream_yaml(FLAGSHIP_YAML, {
            "mesh": {"data": data, "model": model},
            "text_overrides": {"num_hidden_layers": SERVE_MESH_LAYERS}}, d)
        device = "cuda:0" if backend == "gloo" else "cuda"
        trained = {"1x1": ["1x1"], "1x2": ["1x2", "2x1"]}.get(tag, [])
        train = [_train_spec(out_dir, t, backend, device)[1]
                 for t in trained]
        downstream = [s for t in trained for s in _downstream_mesh_specs(
            out_dir, t, backend, device)]
        run_s = calls[tag] = _torchrun(n, [
            os.path.join(REPO, "chip_smoke.py"), "--mesh-rank", yaml_path,
            backend, device, d, ref_path, json.dumps(train),
            json.dumps(owl[tag]),
            os.path.join(out_dir, "parallel") if tag == "1x2" else "",
            json.dumps(downstream)], os.path.join(d, "serve.log"))
        with open(os.path.join(d, "serve.log")) as f:
            stats = json.loads(next(line.split("* Serve stats:", 1)[1]
                                    for line in f if "* Serve stats:" in
                                    line))
        with open(os.path.join(d, "serve_results.json")) as f:
            merged = json.load(f)
        ranks = []
        for r in range(n):
            with open(os.path.join(d, "ranks", f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        _mesh_check_split(tag, data, merged, ranks,
                          None if ref is None else ref["peak"])
        spec = (_spec_mesh_check(report, tag, d, data, n) if model > 1
                else [])
        path = f"serve_mesh_{tag}"
        for r in report:
            r.setdefault("launches_by_path", {})[path] = sum(
                rk["launches"].get(f"{r['wrapper'].__name__}.{c}", 0)
                for rk in ranks for c in _counters(r))
        missing = [r["name"] for r in report if path in r["paths"]
                   and r["launches_by_path"][path] == 0]
        if missing:
            fail(f"the {path} path never launched: {missing}")
        forced = torch.load(os.path.join(d, "forced.pt"))
        toks = [r["tokens"] for r in merged]
        if ref is None:
            ref = {"peak": ranks[0]["peak_memory_bytes"], "forced": forced,
                   "tokens": toks}
            same = sum(int(forced["logits"][i, j].argmax()) == t
                       for i, seq in enumerate(forced["seqs"])
                       for j, t in enumerate(seq))
            vs = (f"the reference: its replay's greedy picks equal its "
                  f"served tokens on {same}/{sum(forced['lengths'])} "
                  f"positions")
        else:
            vs = _mesh_forced_check(tag, forced, ref, toks)
        per_rank = " ; ".join(
            f"rank {rk['rank']} {tuple(rk['coord'])}: "
            + " ".join(f"{k} {rk['launches'][c]}"
                       for k, c in MESH_COUNTERS.items())
            + f", {rk['decode_steps']} decode steps, {rk['graph_replays']} "
            f"graph replays, serve peak "
            f"{rk['peak_memory_bytes'] / 2**30:.3f} GiB (build "
            f"{rk['build_peak_memory_bytes'] / 2**30:.3f})" for rk in ranks)
        note = ("" if backend == "nccl" else
                f", {n} ranks on card 0: gloo copies through the host, no "
                f"measure of NCCL")
        print(f"[serve_mesh {tag}] split (data {data}, model {model}), "
              f"{backend}{note} | {json.dumps(stats)} | {per_rank} | decode "
              f"step (8 slots, rank 0): host {forced['host_ms']:.3f} ms, "
              f"device {forced['kernel_ms_per_step']:.3f} ms, "
              f"{forced['launches_per_step']:.0f} launches, idle "
              f"{forced['idle_share']:.3f}, "
              f"{'eager' if forced['eager'] else 'k = 1 graph'} | {vs} | "
              f"torch.distributed.run {run_s:.1f} s, phases 41 and 42's "
              f"runs in it (replay {forced['replay_s']:.1f}, trace "
              f"{forced['trace_s']:.1f}) | {CARD}", flush=True)
        if spec:
            print(f"[speculative_mesh {tag}] the serve CLI's --speculative "
                  f"on the model shards, {SPEC_MESH_REQUESTS} requests | "
                  + " | ".join(spec) + f" | {CARD}", flush=True)
        del forced
    _nccl_shared_card(out_dir)
    print(f"[serve_mesh] phases 40-42's calls in "
          f"{time.perf_counter() - t_phase:.1f} s ({json.dumps(calls)}) | "
          f"{CARD}", flush=True)
    return calls


def _nccl_shared_card(out_dir):
    """Two NCCL ranks on card 0 (the serve CLI, a (2, 1) split of the tiny
    YAML): the run must fail with NCCL's own error, not serve."""
    import signal

    import yaml

    d = os.path.join(out_dir, "nccl_shared")
    os.makedirs(d)
    with open(os.path.join(REPO, "configs", "pretrain_tiny.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["mesh"] = {"data": 2, "model": 1}
    yaml_path = os.path.join(d, "pretrain_tiny.yaml")
    with open(yaml_path, "w") as f:
        yaml.safe_dump(raw, f)
    log_path = os.path.join(d, "serve.log")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node=2", "-m", "youku_mplug_tpu_torch.cli.serve",
             "--config", yaml_path, "--synthetic_data", "--num_requests",
             "2", "--output_dir", d, "--device", "cuda:0",
             "--dist_backend", "nccl"], cwd=REPO,
            env={**os.environ, "PYTHONPATH": REPO}, stdout=log,
            stderr=subprocess.STDOUT, start_new_session=True)
        try:
            rc = proc.wait(timeout=MESH_LAUNCH_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = None
    with open(log_path) as f:
        lines = f.read().splitlines()
    said = next((line.strip() for line in lines
                 if "duplicate gpu" in line.lower()), None) or next(
        (line.strip() for line in lines if "nccl error" in line.lower()),
        None)
    if rc in (0, None) or said is None or os.path.exists(
            os.path.join(d, "serve_results.json")):
        fail(f"two NCCL ranks on one card: exit {rc}, NCCL said {said!r}:\n"
             + "\n".join(lines[-30:]))
    print(f"[serve_mesh nccl_shared] two NCCL ranks on card 0 refused: exit "
          f"{rc}, {said[:300]} | {CARD}", flush=True)


def _train_spec(out_dir, tag, backend, device, kind="pretrain",
                tok=None):
    """(tag, the training spec of a split): phase 41's flagship pretrain
    YAML, or (``kind`` "instruct", its tokenizer ``tok``) phase 42's cut
    instruct-train YAML, with its mesh block, the rank's output
    directory; (1,1) saves its first leaves and takes the next step,
    (1,2) saves its state, (2,1) resumes it."""
    data, model = map(int, tag.split("x"))
    d = os.path.join(out_dir, f"train_{tag}")
    os.makedirs(d, exist_ok=True)
    yaml_path = (_owl_mesh_yaml(OWL_TRAIN_YAML, d, tag) if kind == "instruct"
                 else _downstream_yaml(TRAIN_YAML, {
                     "mesh": {"data": data, "model": model},
                     "text_overrides": {**_yaml_key(TRAIN_YAML,
                                                    "text_overrides"),
                                        "num_hidden_layers":
                                        TRAIN_MESH_LAYERS}}, d))
    spec = {"kind": kind, "yaml": yaml_path, "out": d, "backend": backend,
            "device": device, "tok": tok, "init": tag == "1x1",
            "next": tag == "1x1", "save": tag == "1x2"}
    if tag == "2x1":
        spec["resume"] = os.path.join(out_dir, "train_1x2")
    return tag, spec


def _leaf_rel_l2(got, want):
    """Per leaf of ``want``, worst first: (|got - want| over max(|want|,
    REPLAY_GRAD_FLOOR x the whole tree's norm), the plain relative L2,
    the leaf), as the replay gates a gradient (L2 norms): a leaf that
    is tiny against the whole (AttentionPool's k_bias) is held to the
    absolute floor."""
    whole = torch.stack([w.float().norm() for w in want.values()]
                        ).norm().item()
    rows = []
    for k, w in want.items():
        diff = (got[k].float() - w.float()).norm().item()
        norm = w.float().norm().item()
        rows.append((diff / max(norm, REPLAY_GRAD_FLOOR * whole),
                     diff / max(norm, 1e-30), k))
    return sorted(rows, reverse=True)


def _move_check(got, got_start, want, want_start):
    """A run's moves from ``got_start`` against the reference's from
    ``want_start``, every leaf but ZERO_GRADIENT_LEAVES held to
    TRAIN_MESH_MOVE_TOL (theirs printed): (the worst gated error, the
    printed verdict)."""
    rows = _leaf_rel_l2(
        {k: v.float() - got_start[k].float() for k, v in got.items()},
        {k: v.float() - want_start[k].float() for k, v in want.items()})
    plain = sorted((r[1], r[2]) for r in rows)
    held = [r for r in rows if not re.match(ZERO_GRADIENT_LEAVES, r[2])]
    noise = [(round(r[0], 4), r[2]) for r in rows
             if re.match(ZERO_GRADIENT_LEAVES, r[2])]
    return held[0][0], (
        f"{len(held)} leaves' moves: gated max {held[0][0]:.4g} "
        f"({held[0][2]}, plain {held[0][1]:.4g}; tol {TRAIN_MESH_MOVE_TOL}, "
        f"floor {REPLAY_GRAD_FLOOR} x the whole move), next "
        f"{[(round(r[0], 4), r[2]) for r in held[1:3]]}, plain max "
        f"{plain[-1][0]:.4g} ({plain[-1][1]}), plain median "
        f"{plain[len(plain) // 2][0]:.4g}" + (
            f"; not gated (a zero gradient but for rounding) {noise}"
            if noise else ""))


def phase_train_mesh(report, out_dir):
    """Phase 41's gates (see the module docstring): its splits ran inside
    phase 40's calls, (2,1) after (1,2) in the same two ranks.  The gloo
    splits measure host copies, not NCCL scaling."""
    ranks = _train_mesh_gates(report, out_dir, "pretrain")
    inside = sum(ranks[t][0]["seconds"] for t in ("1x1", "1x2", "2x1"))
    print(f"[train_mesh] phase 41: its splits' ranks {inside:.1f} s inside "
          f"phase 40's calls | {CARD}", flush=True)


def _kept_check(tag, kept, ref):
    """Every dropout site's kept elements at a split against (1,1)'s: the
    same sites in the same order, the ranks that hold one block of a
    site alike, the blocks' counts summing to (1,1)'s count exactly (the
    masks are (1,1)'s).  Returns the number of sites."""
    sites = len(ref)
    if any(len(k) != sites for k in kept):
        fail(f"{tag}: {[len(k) for k in kept]} dropout draws on the ranks, "
             f"(1,1) drew {sites}")
    for i, (_, want) in enumerate(ref):
        blocks = {}
        for rank in kept:
            blk, n = rank[i]
            key = tuple(tuple(b) for b in blk)
            if blocks.setdefault(key, n) != n:
                fail(f"{tag}: draw {i}: ranks holding block {key} kept "
                     f"{blocks[key]} and {n}")
        if sum(blocks.values()) != want:
            fail(f"{tag}: draw {i}: the blocks {blocks} kept "
                 f"{sum(blocks.values())} elements, (1,1) {want}")
    return sites


def _near_tie_rows(got, want, gt_of, tol):
    """Rows of score matrices whose ground truth ranks differently at a
    split (``got``) than at (1,1) (``want``); each must be a near tie in
    (1,1)'s row (another item within ``tol`` of the ground truth's
    score).  Returns (rows differing, rows not explained)."""
    import numpy as np

    differ, unexplained = 0, 0
    for i, (g, w) in enumerate(zip(got, want)):
        t = gt_of(i)
        rank_g = int((g > g[t]).sum())
        rank_w = int((w > w[t]).sum())
        if rank_g != rank_w:
            differ += 1
            others = np.delete(w, t)
            if np.abs(others - w[t]).min() > tol:
                unexplained += 1
    return differ, unexplained


def _eval_check(kind, tag, got, want, scores, ref_scores):
    """A split's evaluation against (1,1)'s: the scores within the phase
    13 plain-replay bounds (cls: log-probabilities twice
    RESCORE_TOL_PER_TOKEN a scored token, head logits LOGIT_TOL; ITM:
    generative scores RESCORE_TOL_PER_TOKEN a token of 2, P(match)
    LOGIT_TOL / 2; retrieval: similarities 2 x FEATURE_TOL), and the
    metrics (1,1)'s, or where one differs, every decision that moved a
    near tie in (1,1)'s scores (within twice the error read).  Returns
    the verdict."""
    import numpy as np

    if kind == "cls":
        def merged(parts):
            index = np.concatenate([p["index"] for p in parts])
            order = np.argsort(index, kind="stable")
            return {k: np.concatenate([p[k] for p in parts])[order]
                    for k in ("index", "label", "generation_logits",
                              "cls_logits")}
        g, w = merged(scores), merged(ref_scores)
        if not np.array_equal(g["index"], w["index"]):
            fail(f"cls_mesh {tag}: scored clips {g['index']} against "
                 f"(1,1)'s {w['index']}")
        scored = max(p["scored"] for p in ref_scores)
        lg, lw = (np.log(np.maximum(x["generation_logits"], 1e-30))
                  for x in (g, w))
        live = (lg > -69) & (lw > -69)
        errs = {"gen": (float(np.abs(lg - lw)[live].max()),
                        2 * RESCORE_TOL_PER_TOKEN * scored),
                "cls": (float(np.abs(g["cls_logits"]
                                     - w["cls_logits"]).max()), LOGIT_TOL)}
        moved = {}
        for name, key, err_key in (("gen", "generation_logits", "gen"),
                                   ("cls", "cls_logits", "cls")):
            label = w["label"]
            sg = lg if name == "gen" else g[key]
            sw = lw if name == "gen" else w[key]
            moved[name] = _near_tie_rows(sg, sw, lambda i: label[i],
                                         2 * errs[err_key][0])
    else:
        g, w = scores, ref_scores
        if len(g) != len(w) or any(a.shape != b.shape for a, b in zip(g, w)):
            fail(f"{kind}_mesh {tag}: matrices {[a.shape for a in g]} "
                 f"against (1,1)'s {[b.shape for b in w]}")
        names = ("gen", "cls") if kind == "itm" else ("sims",)
        bounds = ({"gen": RESCORE_TOL_PER_TOKEN * 2, "cls": LOGIT_TOL / 2}
                  if kind == "itm" else {"sims": 2 * FEATURE_TOL})
        errs = {n: (float(np.abs(a - b).max()), bounds[n])
                for n, a, b in zip(names, g, w)}
        moved = {}
        for n, a, b in zip(names, g, w):
            rows = _near_tie_rows(a, b, lambda i: i, 2 * errs[n][0])
            cols = _near_tie_rows(a.T, b.T, lambda i: i, 2 * errs[n][0])
            moved[n] = (rows[0] + cols[0], rows[1] + cols[1])
    vs = (f"scores against (1,1)'s: "
          + ", ".join(f"{n} max err {e:.4g} (tol {b:.4g})"
                      for n, (e, b) in errs.items())
          + f"; metrics {'equal' if got == want else 'differ'}"
          + ("" if got == want else f" ({got} against {want})")
          + f"; decisions moved (near ties in (1,1)'s scores) "
          + json.dumps(moved))
    if any(not math.isfinite(e) or e > b for e, b in errs.values()) or any(
            unexplained for _, unexplained in moved.values()) or (
            got != want and not any(d for d, _ in moved.values())):
        fail(f"{kind}_mesh {tag}: evaluation {vs}")
    return vs


def _pool_bias_witness():
    """AttentionPool's k_bias gradient on the card (POOL_BIAS_SHAPE):
    (the port's form's relative L2 error, the every-key sum's, the fp64
    forms' disagreement), each against the fp64 bias-key form."""
    from youku_mplug_tpu_torch.ops.attention import dot_product_attention

    b, h, sq, d, skv = POOL_BIAS_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(45)
    q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device="cuda"
                               ).to(torch.bfloat16)
                   for s in (sq, skv, skv, sq))

    def dk_of(dtype, attend):
        leaves = [t.detach().to(dtype).requires_grad_() for t in (q, k, v)]
        attend(*leaves).backward(do.to(dtype))
        return leaves[1].grad.double()

    def plain(q_, k_, v_):
        p = torch.softmax(q_ @ k_.transpose(-1, -2) * d ** -0.5, dim=-1)
        return p @ v_

    def forms(dk):  # (bias key, every other key): [heads, head dim] each
        return -dk[:, :, -1].sum(0), dk[:, :, :-1].sum((0, 2))

    got_bias, got_sum = forms(dk_of(torch.bfloat16, dot_product_attention))
    want, want_sum = forms(dk_of(torch.float64, plain))
    norm = want.norm().item()
    return tuple((g - want).norm().item() / norm
                 for g in (got_bias, got_sum, want_sum))


def phase_downstream_mesh(report, out_dir):
    """Phase 45's gates on the files its ranks wrote inside phase 40's
    calls: per recipe and split, the launches a rank exactly
    DOWNSTREAM_MESH_LAUNCHES a step and an evaluation call, each step
    finite and its loss within REPLAY_LOSS_TOL and grad_norm within
    TRAIN_MESH_NORM_TOL (relative) of (1,1)'s, the unsharded trainable
    leaves after the steps against (1,1)'s (REPLAY_GRAD_TOL with its
    floor) and their moves (TRAIN_MESH_MOVE_TOL), every dropout site's
    kept count (``_kept_check``) and the evaluation (``_eval_check``).
    The gloo splits measure host copies, not NCCL."""
    t_phase = time.perf_counter()
    e_bias, e_sum, e_exact = _pool_bias_witness()
    print(f"[downstream_mesh pool_bias] AttentionPool's k_bias gradient "
          f"from K4 / K4b at {list(POOL_BIAS_SHAPE)} (B, heads, queries, "
          f"head dim, keys) bf16 against fp64 plain: as -dk of the bias key "
          f"(the port's) rel L2 {e_bias:.4g} (tol {POOL_BIAS_TOL:.4g}); as "
          f"the sum of the other {POOL_BIAS_SHAPE[-1] - 1} keys' dk rows "
          f"{e_sum:.4g}; the two forms in fp64 {e_exact:.3g} | {CARD}",
          flush=True)
    if not e_bias <= POOL_BIAS_TOL:
        fail(f"AttentionPool's k_bias gradient: rel L2 {e_bias:.4g} > "
             f"{POOL_BIAS_TOL:.4g}")
    inside = 0.0
    for kind in DOWNSTREAM_MESH_KINDS:
        ref = ref_leaves = init = ref_scores = None
        for tag, backend in TRAIN_MESH_SPLITS:
            d = os.path.join(out_dir, f"downstream_{kind}_{tag}")
            data, model = map(int, tag.split("x"))
            ranks, scores = [], []
            for r in range(data * model):
                with open(os.path.join(d, f"rank{r}.json")) as f:
                    ranks.append(json.load(f))
                scores.append(torch.load(os.path.join(
                    d, f"scores_rank{r}.pt"), weights_only=False))
            inside += max(rk["seconds"] for rk in ranks)
            per_step, per_call = DOWNSTREAM_MESH_LAUNCHES[kind]
            for part in ("train", "eval"):
                path = f"{kind}_mesh_{tag}_{part}"
                for r in report:
                    key = (r["key"] if r["key"] in DOWNSTREAM_MESH_COUNTERS
                           else None)
                    r.setdefault("launches_by_path", {})[path] = sum(
                        rk[f"launches_{part}"][key] for rk in ranks) \
                        if key else 0
                missing = [r["name"] for r in report if path in r["paths"]
                           and r["launches_by_path"][path] == 0]
                if missing:
                    fail(f"the {path} path never launched: {missing}")
            for rk in ranks:
                want_train = {k: per_step.get(k, 0) * DOWNSTREAM_MESH_STEPS
                              for k in DOWNSTREAM_MESH_COUNTERS}
                want_eval = {k: per_call.get(k, 0) * rk["eval_calls"]
                             for k in DOWNSTREAM_MESH_COUNTERS}
                hist = rk["history"]
                if (rk["launches_train"] != want_train
                        or rk["launches_eval"] != want_eval
                        or len(hist) != DOWNSTREAM_MESH_STEPS):
                    fail(f"{kind}_mesh {tag} rank {rk['rank']}: launches "
                         f"{rk['launches_train']} over {len(hist)} steps, "
                         f"{rk['launches_eval']} over {rk['eval_calls']} "
                         f"evaluation calls; predicted {want_train}, "
                         f"{want_eval}")
                if any(not (math.isfinite(h["loss"])
                            and math.isfinite(h["grad_norm"]))
                       or h["skipped_nonfinite"] != 0 for h in hist):
                    fail(f"{kind}_mesh {tag} rank {rk['rank']}: steps "
                         f"{hist}")
            leaves = torch.load(os.path.join(d, "leaves.pt"))
            if ref is None:
                ref, ref_leaves, ref_scores = ranks[0], leaves, scores[0]
                init = torch.load(os.path.join(d, "init.pt"))
                sites = len(ref["kept"])
                kept_share = (sum(n for _, n in ref["kept"]), sites)
                vs = (f"the reference: {sites} dropout draws over the "
                      f"steps (kept {kept_share[0]} elements), evaluation "
                      f"{json.dumps(ref['metrics'])}")
            else:
                losses = [[h["loss"] for h in rk["history"]] for rk in ranks]
                ref_loss = [h["loss"] for h in ref["history"]]
                e_loss = max(abs(a - b) for row in losses
                             for a, b in zip(row, ref_loss))
                e_norm = max(abs(h["grad_norm"] - b["grad_norm"])
                             / b["grad_norm"] for rk in ranks
                             for h, b in zip(rk["history"], ref["history"]))
                if set(leaves) != set(ref_leaves):
                    fail(f"{kind}_mesh {tag}: leaves differ: "
                         f"{sorted(set(leaves) ^ set(ref_leaves))[:8]}")
                rows = _leaf_rel_l2(leaves, ref_leaves)
                e_move, moves = _move_check(leaves, init, ref_leaves, init)
                sites = _kept_check(f"{kind}_mesh {tag}",
                                    [rk["kept"] for rk in ranks],
                                    ref["kept"])
                ev = _eval_check(kind, tag, ranks[0]["metrics"],
                                 ref["metrics"],
                                 [p for rk_scores in scores[::model]
                                  for p in rk_scores]
                                 if kind == "cls" else scores[0],
                                 ref_scores)
                vs = (f"losses {losses[0]} against (1,1)'s {ref_loss}: "
                      f"max err {e_loss:.4g} (tol {REPLAY_LOSS_TOL}); "
                      f"grad_norm max rel err {e_norm:.4g} (tol "
                      f"{TRAIN_MESH_NORM_TOL:.4g}); {len(rows)} trainable "
                      f"leaves against (1,1)'s: values gated max "
                      f"{rows[0][0]:.4g} ({rows[0][2]}; tol "
                      f"{REPLAY_GRAD_TOL}); moves {moves}; {sites} dropout "
                      f"draws, each block's kept count (1,1)'s exactly; "
                      f"evaluation {ev}")
                if (e_loss > REPLAY_LOSS_TOL or e_norm > TRAIN_MESH_NORM_TOL
                        or rows[0][0] > REPLAY_GRAD_TOL
                        or e_move > TRAIN_MESH_MOVE_TOL):
                    fail(f"{kind}_mesh {tag}: {vs}")
            per_rank = " ; ".join(
                f"rank {rk['rank']} {tuple(rk['coord'])}: setup "
                f"{rk['setup_s']:.1f} s, step ms "
                + ", ".join(f"{h['step_time'] * 1e3:.1f}"
                            for h in rk["history"])
                + f", train peak {rk['train_peak_memory_bytes'] / 2**30:.3f}"
                f" GiB, {rk['eval_calls']} evaluation calls in "
                f"{rk['eval_s']:.2f} s (peak "
                f"{rk['eval_peak_memory_bytes'] / 2**30:.3f} GiB), rank "
                f"total {rk['seconds']:.1f} s" for rk in ranks)
            note = ("" if backend == "nccl" else
                    f", {len(ranks)} ranks on card 0: gloo copies through "
                    f"the host, no measure of NCCL")
            print(f"[downstream_mesh {kind} {tag}] split (data {data}, "
                  f"model {model}), {backend}{note} | launches a rank: "
                  f"train {ranks[0]['launches_train']} over "
                  f"{DOWNSTREAM_MESH_STEPS} steps, evaluation "
                  f"{ranks[0]['launches_eval']} over "
                  f"{ranks[0]['eval_calls']} calls | {vs} | {per_rank} | "
                  f"{CARD}", flush=True)
    print(f"[downstream_mesh] phase 45: its ranks {inside:.1f} s inside "
          f"phase 40's calls, gates {time.perf_counter() - t_phase:.1f} s "
          f"| {CARD}", flush=True)


def _train_mesh_gates(report, out_dir, kind):
    """The training gates of phase 41 (``kind`` "pretrain") or 42
    ("instruct") on the splits' files under ``out_dir``: launches a rank
    exactly as predicted, each step's loss and grad_norm against (1,1)'s,
    every unsharded trainable leaf and its move over the steps against
    (1,1)'s, and (2,1)'s resume of (1,2)'s checkpoint against (1,1)'s
    next step.  Returns the ranks' records by split."""
    _, _, _, counters, per_step = _train_cli(kind)
    prefix = "instruct_train_mesh" if kind == "instruct" else "train_mesh"
    ranks = {}
    for tag, _ in TRAIN_MESH_SPLITS:
        d = os.path.join(out_dir, f"train_{tag}")
        n = int(tag[0]) * int(tag[2])
        ranks[tag] = []
        for r in range(n):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                ranks[tag].append(json.load(f))
    ref = ranks["1x1"][0]
    ref_leaves = torch.load(os.path.join(out_dir, "train_1x1", "leaves.pt"))
    init = torch.load(os.path.join(out_dir, "train_1x1", "init.pt"))
    want = {k: v * TRAIN_MESH_STEPS for k, v in per_step.items()}
    for tag, backend in TRAIN_MESH_SPLITS:
        path = f"{prefix}_{tag}"
        for r in report:
            key = r["key"] if r["key"] in counters else None
            r.setdefault("launches_by_path", {})[path] = sum(
                rk["launches"][key] for rk in ranks[tag]) if key else 0
        missing = [r["name"] for r in report if path in r["paths"]
                   and r["launches_by_path"][path] == 0]
        if missing:
            fail(f"the {path} path never launched: {missing}")
        for rk in ranks[tag]:
            hist = rk["history"]
            if rk["launches"] != want or len(hist) != TRAIN_MESH_STEPS:
                fail(f"{path} rank {rk['rank']}: launches {rk['launches']} "
                     f"over {len(hist)} steps; predicted {want}")
            bad = [h for h in hist
                   if not (math.isfinite(h["loss"])
                           and math.isfinite(h["grad_norm"]))
                   or h["skipped_nonfinite"] != 0]
            if bad:
                fail(f"{path} rank {rk['rank']}: non-finite or skipped "
                     f"steps {bad}")
        losses = [[h["loss"] for h in rk["history"]] for rk in ranks[tag]]
        norms = [[h["grad_norm"] for h in rk["history"]]
                 for rk in ranks[tag]]
        ref_loss = [h["loss"] for h in ref["history"]]
        ref_norm = [h["grad_norm"] for h in ref["history"]]
        e_loss = max(abs(a - b) for row in losses
                     for a, b in zip(row, ref_loss))
        e_norm = max(abs(a - b) / b for row in norms
                     for a, b in zip(row, ref_norm))
        vs = (f"losses {losses[0]} against (1,1)'s {ref_loss}: max err "
              f"{e_loss:.4g} (tol {REPLAY_LOSS_TOL}); grad_norm max rel "
              f"err {e_norm:.4g} (tol {TRAIN_MESH_NORM_TOL:.4g})")
        if e_loss > REPLAY_LOSS_TOL or e_norm > TRAIN_MESH_NORM_TOL:
            fail(f"{path}: {vs}")
        if tag != "1x1":
            leaves = torch.load(os.path.join(out_dir, f"train_{tag}",
                                             "leaves.pt"))
            if set(leaves) != set(ref_leaves):
                fail(f"{path}: leaves differ: "
                     f"{sorted(set(leaves) ^ set(ref_leaves))[:8]}")
            rows = _leaf_rel_l2(leaves, ref_leaves)
            e_move, moves = _move_check(leaves, init, ref_leaves, init)
            vs += (f"; {len(rows)} trainable leaves unsharded against "
                   f"(1,1)'s: values gated max {rows[0][0]:.4g} "
                   f"({rows[0][2]}; tol {REPLAY_GRAD_TOL}, floor "
                   f"{REPLAY_GRAD_FLOOR} x whole); moves over the "
                   f"{TRAIN_MESH_STEPS} steps: {moves}")
            if rows[0][0] > REPLAY_GRAD_TOL or e_move > TRAIN_MESH_MOVE_TOL:
                fail(f"{path}: {vs}")
        if tag == "2x1":
            res, nxt = ranks[tag][0]["resumed"], ref["next"]
            e_res = max(abs(rk["resumed"]["history"][0]["loss"]
                            - nxt[0]["loss"]) for rk in ranks[tag])
            # the resumed step's update against (1,1)'s step 4: it is
            # where the restored moments act
            e_step, step_moves = _move_check(
                torch.load(os.path.join(out_dir, "train_2x1",
                                        "leaves_resumed.pt")),
                torch.load(os.path.join(out_dir, "train_1x2", "leaves.pt")),
                torch.load(os.path.join(out_dir, "train_1x1",
                                        "leaves_next.pt")), ref_leaves)
            vs += (f"; resumed from (1,2)'s checkpoint at step "
                   f"{res['step']} (epoch {res['start_epoch']}): next loss "
                   f"{res['history'][0]['loss']:.6f} against the unbroken "
                   f"(1,1)'s {nxt[0]['loss']:.6f} (err {e_res:.4g}, tol "
                   f"{REPLAY_LOSS_TOL}); that step's update against (1,1)'s "
                   f"step {TRAIN_MESH_STEPS + 1}: {step_moves}; "
                   f"{res['seconds']:.1f} s")
            one = dict(per_step)
            if (e_res > REPLAY_LOSS_TOL or e_step > TRAIN_MESH_MOVE_TOL
                    or res["step"] != TRAIN_MESH_STEPS
                    or res["start_epoch"] != 1 or any(
                        rk["resumed"]["launches"] != one
                        for rk in ranks[tag])):
                fail(f"{path}: {vs}")
        per_rank = " ; ".join(
            f"rank {rk['rank']} {tuple(rk['coord'])}: peak "
            f"{rk['peak_memory_bytes'] / 2**30:.3f} GiB, step ms "
            + ", ".join(f"{h['step_time'] * 1e3:.1f}"
                        for h in rk["history"])
            + f", {rk['all_reduces'] / TRAIN_MESH_STEPS:.0f} all_reduces ("
            f"{rk['all_reduce_bytes'] / TRAIN_MESH_STEPS / 2**20:.1f} MiB) "
            f"a step, {rk['partial']} adapters summed over the model group, "
            f"setup {rk['setup_s']:.1f} s, rank total "
            f"{rk['seconds']:.1f} s"
            + (f", save {rk['save_s']:.1f} s" if "save_s" in rk else "")
            for rk in ranks[tag])
        note = ("" if backend == "nccl" else
                f", {len(ranks[tag])} ranks on card 0: gloo copies through "
                f"the host, no measure of NCCL")
        print(f"[{prefix} {tag}] split (data {tag[0]}, model {tag[2]}), "
              f"{backend}{note} | launches a rank "
              f"{ranks[tag][0]['launches']} over {TRAIN_MESH_STEPS} steps "
              f"(predicted {want}) | {vs} | {per_rank} | {CARD}",
              flush=True)
    return ranks


# phase 42: run_instruct (mPLUG-Owl, BloomZ-7B1) under (data, model)
# splits at full width, Bloom at OWL_MESH_LAYERS of 30 layers and the ViT
# at OWL_MESH_VIT of 24 blocks (the time limit's cuts), in phase 40's
# torch.distributed.run calls: serving at (1,1) NCCL, (1,2) and (2,2)
# gloo on card 0, OWL_MESH_REQUESTS requests of OWL_MESH_NEW new tokens
# (the YAML's 64, cut), greedy, once a run of OWL_MESH_RUNS on one build
# (the int8 cache: the text config's kv_cache_dtype swapped on the same
# weights); then, on data rank 0's ranks, the teacher-forced replay of
# (1,1)'s batched tokens.  Training: the LoRA instruct-train YAML through
# phase 41's path (train_mesh_rank, _train_mesh_gates), TRAIN_MESH_STEPS
# steps at (1,1) NCCL, (1,2) gloo and (2,1) gloo in the (1,2) call, which
# resumes (1,2)'s checkpoint and takes the step (1,1) takes next.
# Launches a rank, written in PERF.md before the first chip run: a serving
# run K1 OWL_MESH_VIT (one encode of the rank's requests), K5 ALiBi (int8
# ALiBi on the int8 cache) once a Bloom layer a decode step, no other
# kernel; a train step K1 OWL_MESH_VIT (the frozen ViT's forward), K1 /
# dq / dk/dv ALiBi and delta once a Bloom layer
OWL_MESH_SPLITS = (("1x1", "nccl"), ("1x2", "gloo"), ("2x2", "gloo"))
OWL_MESH_REQUESTS = 8
OWL_MESH_LAYERS = 2    # of Bloom's 30
OWL_MESH_VIT = 2       # of the ViT's 24 blocks
OWL_MESH_NEW = 16      # new tokens a request (the serving YAML's 64)
# (run, --engine, int8 cache, --lookup_k): the last prompt-lookup
# speculation through the engine, held to the engine run's greedy tokens
# of the same split up to near-ties (phase_lookup's gate)
OWL_MESH_RUNS = (("batched", False, False, 0), ("engine", True, False, 0),
                 ("batched_int8kv", False, True, 0),
                 ("engine_lookup", True, False, 4))
OWL_MESH_COUNTERS = {"K1": "flash_attention_packed.launches",
                     "K5-ALiBi": "write_decode_attention.alibi_launches",
                     "K5-int8-ALiBi":
                     "write_decode_attention.int8_alibi_launches"}
OWL_TRAIN_MESH_COUNTERS = {
    "K1": ("flash_attention_packed", "launches"),
    "K1-ALiBi": ("flash_attention_packed", "alibi_launches"),
    "dq-ALiBi": ("flash_bwd_dq_cuda", "alibi_launches"),
    "dkv-ALiBi": ("flash_bwd_dkv_cuda", "alibi_launches"),
    "delta": ("flash_bwd_delta_cuda", "launches")}
OWL_TRAIN_MESH_LAUNCHES = {"K1": OWL_MESH_VIT, "K1-ALiBi": OWL_MESH_LAYERS,
                           "dq-ALiBi": OWL_MESH_LAYERS,
                           "dkv-ALiBi": OWL_MESH_LAYERS,
                           "delta": OWL_MESH_LAYERS}


def _owl_mesh_yaml(src, out_dir, tag, **extra):
    """A copy of an instruct YAML at phase 42's cuts with the split
    ``tag`` as its ``mesh:`` block."""
    import yaml

    with open(src) as f:
        vision = dict(yaml.safe_load(f)["vision_overrides"])
    vision["depth"] = OWL_MESH_VIT
    data, model = map(int, tag.split("x"))
    return _owl_yaml(src, out_dir, {"num_hidden_layers": OWL_MESH_LAYERS},
                     vision_overrides=vision,
                     mesh={"data": data, "model": model}, **extra)


def _owl_mesh_counts():
    """{key: count} of the wrappers phase 42 gates."""
    from youku_mplug_tpu_torch.ops import decode_attention as dec
    from youku_mplug_tpu_torch.ops import flash_attention as fa

    wrappers = {"flash_attention_packed": fa.flash_attention_packed,
                "write_decode_attention": dec.write_decode_attention}
    return {k: getattr(wrappers[c.split(".")[0]], c.split(".")[1])
            for k, c in OWL_MESH_COUNTERS.items()}


def _owl_mesh_replay(args, cfg, raw, model, tokens):
    """(1,1)'s batched tokens (``tokens``, one list a request) fed back
    through this rank's model: the media features of every request and,
    per request, the fp32 logits of its full causal forward over the
    prompt and the tokens (the rows that predict each token and the one
    after).  Returns the record rank 0 saves."""
    from youku_mplug_tpu_torch.cli import run_instruct

    t0 = time.perf_counter()
    dev = model.text_decoder.word_embeddings.embedding.device
    _, batch, clips = run_instruct.prepare(
        args, cfg, raw, dev, model.policy.compute_dtype,
        run_instruct.build_tokenizer(args, cfg))
    lm = model.text_decoder
    logits = []
    with torch.inference_mode():
        qf = model.encode_video(clips)
        emb = model.spliced_embeds(
            torch.as_tensor(batch["input_ids"], device=dev).long(),
            torch.as_tensor(batch["media_mask"], device=dev), qf)
        for i, toks in enumerate(tokens):
            n = int(batch["prompt_len"][i])
            e = torch.cat([emb[i, :n], lm.embed(torch.tensor(
                toks, device=dev, dtype=torch.long))])[None]
            h = lm(input_embeds=e)["last_hidden_state"]
            logits.append(lm.logits(h[0, n - 1:]).float().cpu())
    return {"qf": qf.float().cpu(), "logits": logits,
            "replay_s": time.perf_counter() - t0}


def _owl_mesh_serve(spec):
    """Phase 42's serving on this rank: ``run_instruct.build`` on the
    split's YAML, then ``serve_built`` once a run of OWL_MESH_RUNS (each
    run's rank file holds its results and launches, counted from zero),
    and on data rank 0's ranks the replay of (1,1)'s batched tokens
    (``spec["ref"]``; for (1,1) its own), saved by rank 0 as
    ``forced.pt``."""
    import dataclasses

    from youku_mplug_tpu_torch.cli import run_instruct

    out = spec["out"]
    args = run_instruct.parser().parse_args([
        "--config", spec["yaml"], "--synthetic_data", "--input_jsonl",
        spec["jsonl"], "--tokenizer", spec["tok"], "--num_slots", "8",
        "--device", spec["device"], "--dist_backend", spec["backend"],
        "--output_dir", out])
    t0 = time.perf_counter()
    cfg, raw, model, dev = run_instruct.build(args)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    text = model.text_decoder.cfg
    for name, engine, int8, lookup in OWL_MESH_RUNS:
        args.engine, args.output_dir = engine, os.path.join(out, name)
        args.lookup_k = lookup
        model.text_decoder.cfg = dataclasses.replace(
            text, kv_cache_dtype="int8" if int8 else "auto")
        for fn, attr in run_instruct.COUNTERS:
            setattr(fn, attr, 0)
        t1 = time.perf_counter()
        run_instruct.serve_built(args, cfg, raw, model, dev)
        torch.cuda.synchronize()
        with open(os.path.join(args.output_dir, "ranks",
                               f"rank{model.mesh.rank}.json")) as f:
            rec = json.load(f)
        rec["seconds"], rec["build_s"] = time.perf_counter() - t1, build_s
        with open(os.path.join(args.output_dir, "ranks",
                               f"rank{model.mesh.rank}.json"), "w") as f:
            json.dump(rec, f)
    model.text_decoder.cfg = text
    args.engine, args.lookup_k = True, 0
    _owl_mesh_gaps(args, cfg, raw, model, out)
    if model.mesh.data_index == 0:
        with open(os.path.join(spec["ref"], "batched",
                               "instruct_results.json")) as f:
            tokens = [r["tokens"] for r in json.load(f)]
        record = _owl_mesh_replay(args, cfg, raw, model, tokens)
        if model.mesh.rank == 0:
            torch.save(record, os.path.join(out, "forced.pt"))
    del model
    gc.collect()
    torch.cuda.empty_cache()


def _owl_mesh_gaps(args, cfg, raw, model, out):
    """The plain replay's top-2 gaps (and max |logit|) of this rank's
    greedy tokens of the engine run, for its data rank's requests
    (phase_lookup's replay on the shard), written by the data rank's
    model-index-0 rank as ``gaps_rank<r>.json``."""
    from youku_mplug_tpu_torch.cli import run_instruct

    mesh = model.mesh
    with open(os.path.join(out, "engine", "ranks",
                           f"rank{mesh.rank}.json")) as f:
        local = json.load(f)["results"]
    dev = model.text_decoder.word_embeddings.embedding.device
    _, batch, clips = run_instruct.prepare(
        args, cfg, raw, dev, model.policy.compute_dtype,
        run_instruct.build_tokenizer(args, cfg, mesh), mesh)
    if [r["index"] for r in local] != [int(i) for i in batch["index"]]:
        fail(f"instruct_mesh rank {mesh.rank}: engine results "
             f"{[r['index'] for r in local]}, batch {batch['index']}")
    gen_cfg = run_instruct.generation_config(args, cfg, raw)
    requests = _instruct_requests(model, batch, clips)
    gaps, top, _ = _plain_gaps(
        lambda: run_instruct.make_engine(model.text_decoder,
                                         batch["prompt_len"], gen_cfg,
                                         len(requests)),
        requests, [r["tokens"] for r in local])
    if mesh.model_index == 0:
        with open(os.path.join(out, f"gaps_rank{mesh.rank}.json"), "w") as f:
            json.dump({"index": [r["index"] for r in local], "gaps": gaps,
                       "top": top}, f)


def _owl_lookup_check(tag, d, got, want):
    """The lookup run's merged tokens against the engine run's of the
    same split, up to each request's first position whose top-2 gap in
    the split's plain replay (``gaps_rank<r>.json``) is below OWL_TIE_REL
    x that replay's max |logit| (``_tie_check``).  Returns the
    divergences."""
    gaps, top = {}, 0.0
    for name in os.listdir(d):
        if name.startswith("gaps_rank"):
            with open(os.path.join(d, name)) as f:
                rec = json.load(f)
            gaps.update(zip(rec["index"], rec["gaps"]))
            top = max(top, rec["top"])
    if sorted(gaps) != list(range(len(want))):
        fail(f"instruct_mesh {tag}: the replay's gaps cover {sorted(gaps)}")
    _, diverged = _tie_check(f"instruct_lookup_mesh {tag}", got, want,
                             [gaps[i] for i in range(len(want))],
                             OWL_TIE_REL * top)
    return diverged


def _owl_tie_check(tag, run, got, want, base, forced):
    """A split's merged tokens of ``run`` against (1,1)'s: equal, or
    parting first where (1,1)'s replay (of its batched tokens ``base``,
    which must agree with ``want`` up to there) leads its top-2 by at most
    OWL_TIE_REL x its largest |logit|.  Returns the divergences."""
    top = max(x.abs().max().item() for x in forced["logits"])
    out = []
    for i, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        t = next(j for j in range(max(len(a), len(b)) + 1)
                 if j >= len(a) or j >= len(b) or a[j] != b[j])
        lead = None
        if b[:t] == base[i][:t] and t < forced["logits"][i].shape[0]:
            two = forced["logits"][i][t].topk(2).values
            lead = float(two[0] - two[1])
        out.append((i, t, None if lead is None else round(lead, 4)))
        if lead is None or lead > OWL_TIE_REL * top:
            fail(f"instruct_mesh {tag} {run}: request {i} parts from (1,1)'s "
                 f"tokens at {t} ((1,1)'s lead there {lead}, bound "
                 f"{OWL_TIE_REL:.4g} x {top:.4g})")
    return out


def _owl_mesh_check(tag, d, ref):
    """Phase 42's serving gates on one split's files (``ref``: (1,1)'s
    replay and tokens, None for (1,1) itself): every request served once,
    each data rank its stride of them, the model ranks of a data rank the
    same tokens, no graph replay on a model shard, a rank's launches as
    predicted, the merged tokens (1,1)'s up to near-ties
    (``_owl_tie_check``).  Returns the printed summaries and the launches
    by key, every rank summed."""
    data, model = map(int, tag.split("x"))
    n = data * model
    sums = {k: 0 for k in OWL_MESH_COUNTERS}
    lines, by_run = [], {}
    for name, engine, int8, lookup in OWL_MESH_RUNS:
        rd = os.path.join(d, name)
        with open(os.path.join(rd, "instruct_results.json")) as f:
            merged = by_run[name] = [r["tokens"] for r in json.load(f)]
        ranks = []
        for r in range(n):
            with open(os.path.join(rd, "ranks", f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        if len(merged) != OWL_MESH_REQUESTS or not all(merged):
            fail(f"instruct_mesh {tag} {name}: merged {merged}")
        by_data = {}
        key = "K5-int8-ALiBi" if int8 else "K5-ALiBi"
        other = "K5-ALiBi" if int8 else "K5-int8-ALiBi"
        for rk in ranks:
            got = {k: rk["launches"][c] for k, c in OWL_MESH_COUNTERS.items()}
            steps = rk["decode_steps"]
            if got["K1"] != OWL_MESH_VIT or got[other] \
                    or got[key] != steps * OWL_MESH_LAYERS:
                fail(f"instruct_mesh {tag} {name} rank {rk['rank']}: "
                     f"launches {got}, {steps} decode steps; predicted K1 "
                     f"{OWL_MESH_VIT}, {key} {OWL_MESH_LAYERS} a step")
            if model > 1 and rk["graph_replays"]:
                fail(f"instruct_mesh {tag} {name}: graph replays on a model "
                     f"shard")
            for k in sums:
                sums[k] += got[k]
            by_data.setdefault(rk["coord"][0], []).append(rk)
        for dd, rks in sorted(by_data.items()):
            index = [r["index"] for r in rks[0]["results"]]
            if index != list(range(dd, OWL_MESH_REQUESTS, data)):
                fail(f"instruct_mesh {tag} {name}: data rank {dd} served "
                     f"{index}")
            toks = [[r["tokens"] for r in rk["results"]] for rk in rks]
            if any(t != toks[0] for t in toks):
                fail(f"instruct_mesh {tag} {name}: the model ranks of data "
                     f"rank {dd} picked different tokens")
        if lookup:
            div = _owl_lookup_check(tag, d, merged, by_run["engine"])
        elif ref is None:
            div = []
        else:
            div = _owl_tie_check(tag, name, merged, ref["tokens"][name],
                                 ref["tokens"]["batched"], ref["forced"])
        st = ranks[0]["stats"]
        lines.append(
            f"{name}: {st.get('kv_cache_dtype')} cache, tokens/s (rank 0's "
            f"data rank) {st.get('tokens_per_sec', 0):.2f}, "
            f"{[rk['decode_steps'] for rk in ranks]} decode steps a rank, "
            f"serve peak "
            f"{max(rk['peak_memory_bytes'] for rk in ranks) / 2**30:.3f} "
            f"GiB, {sum(len(t) for t in merged)} tokens, divergences from "
            f"(1,1)'s (request, position, (1,1)'s lead) {div}, "
            f"{max(rk['seconds'] for rk in ranks):.1f} s")
    return lines, sums


def _owl_forced_check(tag, forced, ref):
    """A split's replay of (1,1)'s batched tokens against (1,1)'s replay:
    media features and every position's logits within OWL_REL_TOL of
    (1,1)'s largest magnitude, all finite."""
    want = ref["forced"]
    e_q = err(forced["qf"], want["qf"])
    top_q = want["qf"].abs().max().item()
    e_l = max(err(a, b) for a, b in zip(forced["logits"], want["logits"]))
    top_l = max(x.abs().max().item() for x in want["logits"])
    finite = all(torch.isfinite(x).all() for x in forced["logits"])
    agree = sum(int((a.argmax(-1) == b.argmax(-1)).sum())
                for a, b in zip(forced["logits"], want["logits"]))
    total = sum(x.shape[0] for x in want["logits"])
    vs = (f"teacher-forced on (1,1)'s {total} batched positions: media "
          f"features max err {e_q:.4g} of {top_q:.4g}, logits {e_l:.4g} of "
          f"{top_l:.4g} (tol {OWL_REL_TOL:.4g} x), greedy agreement "
          f"{agree}/{total}")
    if not finite or e_q > OWL_REL_TOL * top_q or e_l > OWL_REL_TOL * top_l:
        fail(f"instruct_mesh {tag}: {vs}")
    return vs


def _owl_mesh_specs(out_dir, tok_dir):
    """{split: phase 42's spec of that split's ranks} under ``out_dir``:
    the serving (its cut YAML, the requests, (1,1)'s directory as the
    replay's reference) and the training splits of its world ((1,1);
    (1,2), then (2,1) resuming it)."""
    os.makedirs(out_dir)
    jsonl = os.path.join(out_dir, "requests.jsonl")
    with open(jsonl, "w") as f:
        for i in range(OWL_MESH_REQUESTS):
            f.write(json.dumps({"video": f"clip{i}.mp4",
                                "question": OWL_QUESTIONS[i]}) + "\n")
    specs = {}
    for tag, backend in OWL_MESH_SPLITS:
        d = os.path.join(out_dir, tag)
        os.makedirs(d)
        device = "cuda:0" if backend == "gloo" else "cuda"
        specs[tag] = {
            "serve": {"yaml": _owl_mesh_yaml(OWL_YAML, d, tag,
                                             max_new_tokens=OWL_MESH_NEW),
                      "out": d, "backend": backend, "device": device,
                      "jsonl": jsonl, "tok": tok_dir,
                      "ref": os.path.join(out_dir, "1x1")},
            "train": [_train_spec(out_dir, t, backend, device, "instruct",
                                  tok_dir)[1]
                      for t in {"1x1": ["1x1"],
                                "1x2": ["1x2", "2x1"]}.get(tag, [])]}
    return specs


def phase_instruct_mesh(report, out_dir):
    """Phase 42's gates (see the constants above) on the files its runs
    wrote under ``out_dir`` inside phase 40's calls.  The gloo numbers
    measure host copies, not NCCL."""
    ref = None
    for tag, backend in OWL_MESH_SPLITS:
        data, model = map(int, tag.split("x"))
        d = os.path.join(out_dir, tag)
        forced = torch.load(os.path.join(d, "forced.pt"))
        lines, sums = _owl_mesh_check(tag, d, ref)
        if ref is None:
            ref = {"forced": forced, "tokens": {}}
            for name, _, _, _ in OWL_MESH_RUNS:
                with open(os.path.join(d, name,
                                       "instruct_results.json")) as f:
                    ref["tokens"][name] = [r["tokens"] for r in json.load(f)]
            same = sum(int((lg.argmax(-1)[:len(t)] == torch.tensor(t)).sum())
                       for lg, t in zip(forced["logits"],
                                        ref["tokens"]["batched"]))
            vs = (f"the reference: its replay's greedy picks equal its "
                  f"batched tokens on {same}/"
                  f"{sum(len(t) for t in ref['tokens']['batched'])} "
                  f"positions")
        else:
            vs = _owl_forced_check(tag, forced, ref)
        path = f"instruct_mesh_{tag}"
        for r in report:
            key = r["key"] if r["key"] in sums else None
            if r["key"] == "K6":
                r.setdefault("launches_by_path", {})[path] = \
                    sums["K5-ALiBi"] + sums["K5-int8-ALiBi"]
            else:
                r.setdefault("launches_by_path", {})[path] = \
                    sums[key] if key else 0
        missing = [r["name"] for r in report if path in r["paths"]
                   and r["launches_by_path"][path] == 0]
        if missing:
            fail(f"the {path} path never launched: {missing}")
        note = ("" if backend == "nccl" else
                f", {data * model} ranks on card 0: gloo copies through the "
                f"host, no measure of NCCL")
        print(f"[instruct_mesh {tag}] split (data {data}, model {model}), "
              f"{backend}{note} | launches, every rank summed: "
              f"{json.dumps(sums)} | " + " | ".join(lines)
              + f" | {vs} | replay {forced['replay_s']:.1f} s | {CARD}",
              flush=True)
        del forced
    ranks = _train_mesh_gates(report, out_dir, "instruct")
    inside = sum(ranks[t][0]["seconds"] for t in ("1x1", "1x2", "2x1"))
    print(f"[instruct_mesh] phase 42's training ranks {inside:.1f} s inside "
          f"phase 40's calls | {CARD}", flush=True)


# phase 43: context, pipeline and expert parallelism (the port's
# parallel/ring_attention.py, pipeline.py, moe.py) on phase 40's (1,2)
# ranks, two gloo ranks on card 0, each part against the same code at one
# rank (no group) in the same processes.  The sequence of the ring and
# Ulysses: [B, H, S, D] at the GPT-3 1.3B's attention width (32 heads of
# 64), 4096 tokens a rank
SP_SHAPE = (2, 32, 8192, 64)
# GPipe over the 1.3B decoder's layer stack at full width and depth (12
# layers a stage): PIPE_MICRO microbatches of PIPE_ROWS rows at
# PIPE_TOKENS tokens, the flagship pretrain batch of 16
PIPE_MICRO, PIPE_ROWS, PIPE_TOKENS = 4, 4, 208
GPT13_JSON = os.path.join(REPO, "configs", "models", "config_gpt3_1.3B.json")
# the MoE at the 1.3B's FFN width: E experts, top-k, capacity factor, on
# [MOE_ROWS, MOE_TOKENS, 2048]; its loss adds MOE_AUX_WEIGHT x aux
MOE_EXPERTS, MOE_K, MOE_CF = 8, 2, 1.25
MOE_ROWS, MOE_TOKENS, MOE_AUX_WEIGHT = 16, 208, 0.01
PARALLEL_ITERS = 3  # timed calls of each part (forward and backward)
# the ring's output and gradients against one rank's, relative L2: what
# its fp32 partials read on the H100 (forward 1.88e-3 / 2.16e-3,
# gradients at most 1.15e-3) with room, below what bf16 partials read
# (forward 2.95e-3 / 3.06e-3, gradients ~2.9e-3; PERF.md §6)
RING_FWD_TOL = 2.0 ** -8.5
RING_GRAD_TOL = 2.0 ** -9
# the parts a rank runs: {part: (kind, causal, path)}
PARALLEL_PARTS = {"ring_causal": ("ring", True, "ring_sp2"),
                  "ring_full": ("ring", False, "ring_sp2"),
                  "ulysses_causal": ("ulysses", True, "ulysses_sp2"),
                  "ulysses_full": ("ulysses", False, "ulysses_sp2"),
                  "gpipe": ("gpipe", False, "gpipe_pipe2"),
                  "moe": ("moe", False, "moe_ep2")}
PARALLEL_PATHS = ("ring_sp2", "ulysses_sp2", "gpipe_pipe2", "moe_ep2")
def _parallel_counters():
    """The counters a phase 43 rank reads: {report key: (wrapper,
    attribute)}; K4-ring-f32 is the ring's own count of its K4 launches
    (the fp32-output build), dq- and dkv-ring-f32 the backward's
    fp32-output builds'."""
    from youku_mplug_tpu_torch.ops import flash_attention as fa
    from youku_mplug_tpu_torch.parallel import ring_attention as ra

    return {"K4-ring-f32": (ra.ring_attention, "launches"),
            "K4": (fa.flash_attention, "launches"),
            "K1": (fa.flash_attention_packed, "launches"),
            "dq": (fa.flash_bwd_dq_cuda, "launches"),
            "dkv": (fa.flash_bwd_dkv_cuda, "launches"),
            "dq-ring-f32": (fa.flash_bwd_dq_cuda, "f32_launches"),
            "dkv-ring-f32": (fa.flash_bwd_dkv_cuda, "f32_launches"),
            "delta": (fa.flash_bwd_delta_cuda, "launches")}


def _parallel_counts(reset=False):
    """{report key: launches} since the last reset (and reset them)."""
    out = {}
    for key, (fn, attr) in _parallel_counters().items():
        out[key] = getattr(fn, attr)
        if reset:
            setattr(fn, attr, 0)
    return {k: v for k, v in out.items() if v}


def parallel_launches(kind, causal, rank, world):
    """Launches a rank of ``world`` (1: the one-rank reference) makes in
    one forward and backward of a phase 43 part, written in PERF.md before
    the first chip run: the ring's K4 once a K/V block it attends (under
    causal its own and the earlier ranks', i + 1; else all P) and K4b's dq
    and dk/dv as often, all three their fp32-output builds, one delta;
    Ulysses one K4 and one K4b over its H/P heads of the whole sequence;
    GPipe's every tick on every stage (M + P - 1 ticks of L/P layers, K1
    forward, K2/K3 and delta backward, the bubble ticks' zero gradients
    included); the MoE none."""
    if kind == "ring":
        blocks = rank + 1 if causal else world
        return {"K4-ring-f32": blocks, "dq-ring-f32": blocks,
                "dkv-ring-f32": blocks, "delta": 1}
    if kind == "ulysses":
        return {"K4": 1, "dq": 1, "dkv": 1, "delta": 1}
    if kind == "gpipe":
        n = (PIPE_MICRO + world - 1) * (24 // world)
        return {"K1": n, "dq": n, "dkv": n, "delta": n}
    return {}


class _MoEHolder(torch.nn.Module):
    """The MoE under a ``moe`` path, where the expert rules match it."""

    def __init__(self, moe_mod):
        super().__init__()
        self.moe = moe_mod


def _no_plain():
    """Patches under which a plain attention or the library's raises:
    the parallel paths run the kernels alone."""
    import contextlib

    from youku_mplug_tpu_torch.ops import attention
    from youku_mplug_tpu_torch.ops import flash_attention as fa

    def refuse(*a, **k):
        raise AssertionError("a plain or library attention ran")
    stack = contextlib.ExitStack()
    for mod, name in ((fa, "flash_fwd_plain"), (fa, "flash_bwd_plain"),
                      (fa, "flash_attention_plain"),
                      (fa, "flash_attention_packed_plain"),
                      (attention, "mha_reference"),
                      (torch.nn.functional, "scaled_dot_product_attention")):
        stack.enter_context(mock.patch.object(mod, name, refuse))
    return stack


def _split_run(run, iters):
    """One run of ``run`` counted (launches, exchanges and all_to_alls,
    all_reduces, peak memory), then ``iters`` timed with both ranks (host
    clock between barriers, synchronized).  Returns (its result, the
    record)."""
    import torch.distributed as dist

    from youku_mplug_tpu_torch.parallel import collectives

    calls = []
    reduce = dist.all_reduce

    def counted(*a, **k):
        calls.append(a[0].numel() * a[0].element_size())
        return reduce(*a, **k)
    _parallel_counts(reset=True)
    collectives.Counts.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _no_plain(), mock.patch.object(dist, "all_reduce", counted):
        result = run()
        torch.cuda.synchronize()
    rec = {"launches": _parallel_counts(),
           "exchanges": collectives.Counts.calls,
           "exchange_bytes": collectives.Counts.bytes_sent,
           "all_reduces": len(calls), "all_reduce_bytes": sum(calls),
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    torch.cuda.synchronize()
    rec["ms"] = (time.perf_counter() - t0) / iters * 1e3
    dist.barrier()
    return result, rec


def _ref_run(run, iters, rank):
    """The one-rank reference: one run counted (launches, peak), then
    ``iters`` timed on rank 0 alone (the other ranks wait at a barrier,
    so it has the card to itself)."""
    import torch.distributed as dist

    _parallel_counts(reset=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _no_plain():
        result = run()
        torch.cuda.synchronize()
    rec = {"launches": _parallel_counts(),
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    dist.barrier()
    if rank == 0:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        rec["ms"] = (time.perf_counter() - t0) / iters * 1e3
    dist.barrier()
    return result, rec


def _grad_errs(got, want):
    return {k: rel_l2(got[k], want[k]) for k in want}


def _fwd_errs(got, want):
    """A part's output against its one-rank reference: elementwise
    (``within``), relative L2, and the reference's mean |value| (what
    the elementwise limit compares with)."""
    return {"fwd_err": err(got, want), "fwd_ok": within(got, want),
            "fwd_rel_l2": rel_l2(got, want),
            "ref_mean_abs": want.float().abs().mean().item()}


def _sp_part(kind, causal, sp, dev):
    """Ring or Ulysses attention of SP_SHAPE's bf16 q, k, v over ``sp``
    against the same function at one rank: the output (elementwise) and
    dq, dk, dv (relative L2) of this rank's sequence block."""
    from youku_mplug_tpu_torch.parallel import ring_attention as ra

    fn = ra.ring_attention if kind == "ring" else ra.ulysses_attention
    b, h, s, d = SP_SHAPE
    g = torch.Generator(device=dev).manual_seed(43)
    q, k, v, do = (torch.randn(b, h, s, d, generator=g, device=dev).to(
        torch.bfloat16) for _ in range(4))
    n = s // sp.size
    cut = slice(sp.index * n, (sp.index + 1) * n)

    def run(axis, rows):
        leaves = [t[:, :, rows].clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves, axis=axis, causal=causal)
        out.backward(do[:, :, rows])
        return out.detach(), dict(zip(("dq", "dk", "dv"),
                                      (t.grad for t in leaves)))
    (ref_out, ref_g), ref = _ref_run(lambda: run(None, slice(None)),
                                     PARALLEL_ITERS, sp.index)
    (out, grads), rec = _split_run(lambda: run(sp, cut), PARALLEL_ITERS)
    return {**rec, "ref": ref, **_fwd_errs(out, ref_out[:, :, cut]),
            "grad_rel_l2": _grad_errs(grads, {k: t[:, :, cut]
                                               for k, t in ref_g.items()}),
            "finite": all(bool(torch.isfinite(t).all())
                          for t in [out, *grads.values()])}


def _pipe_part(pipe, dev):
    """GPipe over the 1.3B decoder's 24 layers (L/P a stage, each the
    port's layer loop through ``functional_call``) against the same
    ``gpipe`` at one rank over the whole stack: the output
    (elementwise), every stage leaf's gradient and the microbatches'
    (relative L2)."""
    from youku_mplug_tpu_torch import bridge
    from youku_mplug_tpu_torch.models.gpt3 import GPT3Config, GPT3Layer
    from youku_mplug_tpu_torch.parallel import pipeline

    cfg = GPT3Config.from_json_file(GPT13_JSON, hidden_dropout=0.0,
                                    attention_dropout=0.0)
    n_layers = cfg.num_hidden_layers
    with torch.device(dev):
        full = bridge.seeded_init(GPT3Layer(cfg, n_layers, torch.bfloat16),
                                  43)
    with torch.device("meta"):
        stage_mod = GPT3Layer(cfg, n_layers // pipe.size, torch.bfloat16)

    def stage_fn(module, layers):
        def fn(params, x):
            for lidx in range(layers):
                x = torch.func.functional_call(module, params, (x, lidx))
            return x
        return fn
    g = torch.Generator(device=dev).manual_seed(44)
    shape = (PIPE_MICRO, PIPE_ROWS, PIPE_TOKENS, cfg.hidden_size)
    xs, w = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
             for _ in range(2))
    whole = {k: p.detach() for k, p in full.named_parameters()}

    def run(params, axis, fn):
        leaves = {k: p.clone().requires_grad_() for k, p in params.items()}
        x = xs.clone().requires_grad_()
        out = pipeline.gpipe(fn, leaves, x, axis=axis)
        (out.float() * w).sum().backward()
        return out.detach(), {k: p.grad for k, p in leaves.items()}, x.grad
    (ref_out, ref_g, ref_dx), ref = _ref_run(
        lambda: run(whole, None, stage_fn(full, n_layers)), PARALLEL_ITERS,
        pipe.index)
    local = pipeline.stack_to_stages(whole, pipe)
    (out, grads, dx), rec = _split_run(
        lambda: run(local, pipe, stage_fn(stage_mod, n_layers // pipe.size)),
        PARALLEL_ITERS)
    del full
    want_g = pipeline.stack_to_stages(ref_g, pipe)
    errs = _grad_errs(grads, want_g)
    errs["microbatches"] = rel_l2(dx, ref_dx)
    return {**rec, "ref": ref, **_fwd_errs(out, ref_out),
            "bitwise": bool(torch.equal(out, ref_out)),
            "grad_rel_l2": errs,
            "finite": all(bool(torch.isfinite(t).all())
                          for t in [out, dx, *grads.values()])}


def _moe_part(dev):
    """MoEMLP at the 1.3B's FFN width, its experts cut over a (1, 2)
    mesh's model axis (``shard_params`` with the expert rules), against
    the whole module in the same process: y (elementwise), aux, and the
    gradients of x and of all five leaves, the router's included
    (relative L2; an expert leaf against its slice of the whole)."""
    from youku_mplug_tpu_torch import bridge
    from youku_mplug_tpu_torch.parallel import moe, sharding
    from youku_mplug_tpu_torch.runtime import mesh as mesh_lib

    with open(GPT13_JSON) as f:
        hidden = json.load(f)["hidden_size"]
    ffn = 4 * hidden

    def make():
        return _MoEHolder(moe.MoEMLP(hidden, MOE_EXPERTS, ffn, k=MOE_K,
                                     capacity_factor=MOE_CF).to(dev))
    whole = bridge.seeded_init(make(), 45)
    split = make()
    split.load_state_dict(whole.state_dict())
    mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(data=1, model=2))
    sharding.shard_params(split, mesh, sharding.MOE_SHARDING_RULES
                          + ((r".*", ()),))
    g = torch.Generator(device=dev).manual_seed(46)
    x, w = (torch.randn(MOE_ROWS, MOE_TOKENS, hidden, generator=g,
                        device=dev).to(torch.bfloat16) for _ in range(2))

    def run(model):
        model.zero_grad(set_to_none=True)
        xl = x.clone().requires_grad_()
        y, aux = model.moe(xl)
        ((y.float() * w).sum() + MOE_AUX_WEIGHT * aux).backward()
        return (y.detach(), aux.detach(), xl.grad,
                {k: p.grad for k, p in model.moe.named_parameters()})
    (ref_y, ref_aux, ref_dx, ref_g), ref = _ref_run(
        lambda: run(whole), PARALLEL_ITERS, mesh.model_index)
    (y, aux, dx, grads), rec = _split_run(lambda: run(split), PARALLEL_ITERS)
    want = {k: (sharding.local_slice(t, 0, mesh) if k in ("w1", "b1", "w2",
                                                          "b2") else t)
            for k, t in ref_g.items()}
    errs = _grad_errs(grads, want)
    errs["x"] = rel_l2(dx, ref_dx)
    return {**rec, "ref": ref, **_fwd_errs(y, ref_y),
            "aux": float(aux), "aux_err": abs(float(aux) - float(ref_aux)),
            "grad_rel_l2": errs,
            "local_shapes": {k: list(p.shape)
                             for k, p in split.moe.named_parameters()},
            "finite": all(bool(torch.isfinite(t).all())
                          for t in [y, dx, *grads.values()])}


def parallel_rank(out_dir, device):
    """Phase 43 on this rank of phase 40's (1, 2) call (see the module
    docstring): each part's record as ``out_dir/rank<r>.json``."""
    import torch.distributed as dist

    from youku_mplug_tpu_torch.runtime import mesh as mesh_lib

    dev = torch.device(device)
    torch.cuda.set_device(dev)
    world = dist.get_world_size()
    t0 = time.perf_counter()
    sp = mesh_lib.named_axes([("sp", world)])["sp"]
    record = {"rank": dist.get_rank()}
    for kind in ("ring", "ulysses"):
        for causal in (True, False):
            record[f"{kind}_{'causal' if causal else 'full'}"] = _sp_part(
                kind, causal, sp, dev)
            gc.collect()
            torch.cuda.empty_cache()
    pipe = mesh_lib.named_axes([("data", 1), ("pipe", world)])["pipe"]
    record["gpipe"] = _pipe_part(pipe, dev)
    gc.collect()
    torch.cuda.empty_cache()
    record["moe"] = _moe_part(dev)
    record["seconds"] = time.perf_counter() - t0
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"rank{record['rank']}.json"),
              "w") as f:
        json.dump(record, f)


def phase_parallel(report, out_dir):
    """Phase 43's gates on its ranks' records (see the module docstring):
    launches a rank of each part and of its one-rank reference exactly as
    ``parallel_launches`` predicts, outputs within KERNEL_TOL
    (elementwise) and BWD_TOL (relative L2), every gradient within
    BWD_TOL (relative L2), MoE's aux equal; each path's launches into the
    report."""
    ranks = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    paths = {}
    for part, (kind, causal, path) in PARALLEL_PARTS.items():
        for rk in ranks:
            rec = rk[part]
            tag = f"{part} rank {rk['rank']}"
            want = parallel_launches(kind, causal, rk["rank"], 2)
            ref_want = parallel_launches(kind, causal, 0, 1)
            if rec["launches"] != want or rec["ref"]["launches"] != ref_want:
                fail(f"{tag}: launches {rec['launches']}, its one-rank "
                     f"reference {rec['ref']['launches']}; predicted {want}, "
                     f"{ref_want}")
            worst = max(rec["grad_rel_l2"].values())
            fwd_tol, grad_tol = ((RING_FWD_TOL, RING_GRAD_TOL)
                                 if kind == "ring" else (BWD_TOL, BWD_TOL))
            if not (rec["fwd_ok"] and rec["fwd_rel_l2"] <= fwd_tol
                    and rec["finite"] and worst <= grad_tol):
                fail(f"{tag}: forward max err {rec['fwd_err']} (tol "
                     f"{KERNEL_TOL} x (1 + |ref|)), relative L2 "
                     f"{rec['fwd_rel_l2']} (tol {fwd_tol}), gradients' "
                     f"relative L2 "
                     f"{rec['grad_rel_l2']} (tol {grad_tol}), finite "
                     f"{rec['finite']}")
            if kind == "moe" and rec["aux_err"] > 1e-6 * abs(rec["aux"]):
                fail(f"{tag}: aux {rec['aux']} off the whole module's by "
                     f"{rec['aux_err']}")
            for key, n in rec["launches"].items():
                paths.setdefault(path, {}).setdefault(key, 0)
                paths[path][key] += n
        r0, r1 = (rk[part] for rk in ranks)
        print(f"[parallel {part}] 2 gloo ranks on card 0 (host copies, no "
              f"NCCL) | launches rank 0 {r0['launches']}, rank 1 "
              f"{r1['launches']}, one rank {r0['ref']['launches']} | "
              f"forward max err {max(r0['fwd_err'], r1['fwd_err']):.4g} "
              f"(tol {KERNEL_TOL:.4g} x (1 + |ref|)), relative L2 "
              f"{max(r0['fwd_rel_l2'], r1['fwd_rel_l2']):.4g} (tol "
              f"{fwd_tol:.4g}), the reference's mean |value| "
              f"{r0['ref_mean_abs']:.4g} / {r1['ref_mean_abs']:.4g}"
              + (f", bitwise {r0['bitwise'] and r1['bitwise']}"
                 if "bitwise" in r0 else "")
              + (f", aux {r0['aux']:.6g}" if kind == "moe" else "")
              + " | gradients' relative L2, worst of the ranks: "
              + json.dumps({k: max(r0["grad_rel_l2"][k],
                                   r1["grad_rel_l2"][k])
                            for k in r0["grad_rel_l2"]})
              + f" (tol {grad_tol:.4g}) | a call (forward and backward) "
              f"{r0['ms']:.2f} ms at P = 2, {r0['ref']['ms']:.2f} ms at one "
              f"rank alone | exchanges {r0['exchanges']} "
              f"({r0['exchange_bytes'] / 2**20:.1f} MiB sent), all_reduces "
              f"{r0['all_reduces']} ({r0['all_reduce_bytes'] / 2**20:.1f} "
              f"MiB) a rank | peak {r0['peak_memory_bytes'] / 2**30:.3f} / "
              f"{r1['peak_memory_bytes'] / 2**30:.3f} GiB (one rank "
              f"{r0['ref']['peak_memory_bytes'] / 2**30:.3f})"
              + (f" | local shapes {r0['local_shapes']}" if kind == "moe"
                 else "") + f" | {CARD}", flush=True)
    counted = _parallel_counters()
    for path in PARALLEL_PATHS:
        for r in report:
            key = r["key"] if r["key"] in counted else None
            r.setdefault("launches_by_path", {})[path] = (
                paths.get(path, {}).get(key, 0) if key else 0)
        missing = [r["name"] for r in report if path in r["paths"]
                   and r["launches_by_path"][path] == 0]
        if missing:
            fail(f"the {path} path never launched: {missing}")
    print(f"[parallel] phase 43 in its ranks: "
          f"{max(rk['seconds'] for rk in ranks):.1f} s | {CARD}", flush=True)


def _mark(what):
    """The script's seconds so far, after ``what``."""
    print(f"[time] {what} done at {time.perf_counter() - START:.1f} s",
          flush=True)


def _phases(report, files_root, tok_dir):
    """Phases 3-44 in their order (see the module docstring); ``tok_dir``
    holds the instruct tokenizer files of phases 25-26 and 42.  ``_mark`` prints
    the script's seconds after each group of phases (the budget's
    breakdown)."""
    from youku_mplug_tpu_torch.cli import run_instruct, run_pretrain

    files = phase_files_written(files_root)
    _mark("20 files_written")
    with tempfile.TemporaryDirectory() as out_dir:
        cfg, model, _ = phase_slice(report, out_dir)
    phase_teacher_forced(cfg, model)
    requests, greedy = phase_caption_modes(report, cfg, model,
                                           FLAGSHIP_YAML, "serve")
    phase_speculative(report, cfg, model, requests, greedy)
    del requests
    with tempfile.TemporaryDirectory() as out_dir:
        phase_serve_files(report, model, files, out_dir)
    with tempfile.TemporaryDirectory() as out_dir:
        phase_serve_imported(report, model, out_dir)
        _mark("3-4c, 21, 15 serve")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        cfg, model, _ = phase_slice(report, out_dir, INT8KV_YAML,
                                    "serve_int8kv")
    phase_teacher_forced(cfg, model, "int8-KV teacher-forced")
    phase_caption_modes(report, cfg, model, INT8KV_YAML, "serve_int8kv")
    _mark("4b serve_int8kv")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        runner, train_stats = phase_train(report, out_dir)
        phase_replay(runner, run_pretrain.make_batch,
                     run_pretrain.make_loss_fn)
        phase_pretrain_files(report, runner, files, out_dir, train_stats)
        # phase 12 saves phase 5's state and frees it; the directory with
        # its checkpoint goes when the block ends
        holder = [runner]
        del runner
        cap_dir = phase_caption(report, holder, out_dir)
        gc.collect()
        torch.cuda.empty_cache()
        phase_serve_resumed(report, cap_dir, out_dir)
        _mark("5-6, 22, 12, 16 train and caption")
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        phase_downstream(report, out_dir)
        _mark("13 downstream")
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        phase_cls_files(report, files, out_dir)
        _mark("23 cls_files")
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        phase_gpt3_27b(report, out_dir)
        _mark("14 gpt3_27b")
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        phase_gpt3_13b(report, out_dir)
        _mark("44 gpt3_13b")
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        phase_shipped_yamls(report, out_dir)
        _mark("27 shipped")
    gc.collect()
    torch.cuda.empty_cache()
    # phases 7-8b and 25-26 with Bloom at OWL_SERVE_LAYERS (the budget;
    # 8a's sampling at full depth)
    cut_dir = tempfile.TemporaryDirectory()
    owl_yaml, owl_int8_yaml = (
        _owl_yaml(p, cut_dir.name, {"num_hidden_layers": OWL_SERVE_LAYERS})
        for p in (OWL_YAML, OWL_INT8_YAML))
    with tempfile.TemporaryDirectory() as out_dir:
        model, batch, clips, gen_cfg = phase_instruct(report, out_dir,
                                                      owl_yaml)
    bf16 = phase_instruct_forced(model, batch, clips)
    requests, greedy = phase_instruct_modes(report, model, batch, clips,
                                            gen_cfg, "instruct", "K5-ALiBi")
    phase_lookup(report, model, batch, clips, gen_cfg, requests, greedy)
    del requests
    phase_sampling_full_depth(report, batch, clips)
    del batch, clips
    with tempfile.TemporaryDirectory() as out_dir:
        phase_instruct_batched(report, model, tok_dir, out_dir, owl_yaml)
        phase_instruct_beam(report, model, owl_yaml, "instruct_beam",
                            tok_dir, out_dir)
        _mark("7-8a, 25-26 instruct")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        model, batch, clips, gen_cfg = phase_instruct(
            report, out_dir, owl_int8_yaml, "instruct_int8", int8=True)
    phase_instruct_forced(model, batch, clips,
                          "instruct int8 teacher-forced", reference=bf16)
    phase_instruct_modes(report, model, batch, clips, gen_cfg,
                         "instruct_int8", "K5-int8-ALiBi")
    with tempfile.TemporaryDirectory() as out_dir:
        phase_instruct_beam(report, model, owl_int8_yaml,
                            "instruct_beam_int8", tok_dir, out_dir)
        _mark("8b, 26 instruct_int8")
    del model, batch, clips, bf16
    cut_dir.cleanup()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        runner, instruct_stats = phase_instruct_train(report, out_dir)
        instruct_stats["layers"] = runner.model.cfg.text.num_hidden_layers
        phase_instruct_replay(runner)
        _mark("9-10 instruct_train")
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        hf_dir = phase_instruct_hf(report, out_dir)
        run_dir, train_yaml, dest = phase_instruct_hf_train(report, out_dir,
                                                            hf_dir)
        phase_instruct_serving_int8(report, out_dir, run_dir, train_yaml,
                                    dest)
        _mark("17-19 instruct_hf")
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        phase_instruct_files(report, files, out_dir)
        _mark("24 instruct_files")
    gc.collect()
    torch.cuda.empty_cache()
    # phases 28-32, the training knobs
    t_knobs = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        run_dir, _ = phase_knobs_pretrain(report, out_dir, train_stats)
        phase_knobs_dropout(report, out_dir)
        phase_knobs_lora_serve(report, out_dir, run_dir)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        phase_knobs_instruct_train(report, out_dir, instruct_stats)
    phase_optim_zoo()
    print(f"[knobs] phases 28-32 in {time.perf_counter() - t_knobs:.1f} s "
          f"| {CARD}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    # phases 33-35, the BERT family
    t_bert = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        phase_mplug_pretrain(report, out_dir)
        gc.collect()
        torch.cuda.empty_cache()
        phase_mplug_downstream(report, out_dir)
        phase_alpro(report, out_dir)
    print(f"[bert_family] phases 33-35 in "
          f"{time.perf_counter() - t_bert:.1f} s | {CARD}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    # phases 36-39, the image-era family
    t_image = time.perf_counter()
    with tempfile.TemporaryDirectory() as img_dir, \
            tempfile.TemporaryDirectory() as out_dir:
        ann = phase_images_written(img_dir)
        for phase in (phase_image_pretrain, phase_eva_pretrain, phase_coca):
            phase(report, out_dir, ann)
            gc.collect()
            torch.cuda.empty_cache()
        phase_clip(report, ann)
    print(f"[image_family] phases 36-39 in "
          f"{time.perf_counter() - t_image:.1f} s | {CARD}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        phase_serve_mesh(report, out_dir, tok_dir)
        _mark("40 serve_mesh (with the runs of 41, 42 and 43)")
        phase_train_mesh(report, out_dir)
        phase_downstream_mesh(report, out_dir)
        phase_instruct_mesh(report, os.path.join(out_dir, "owl"))
        phase_parallel(report, os.path.join(out_dir, "parallel"))
        _mark("41-43, 45 gates")


def main():
    global CARD
    if sys.argv[1:2] == ["--mesh-rank"]:  # a rank of phases 40-43
        sys.path.insert(0, REPO)
        torch.backends.cuda.matmul.allow_tf32 = False
        mesh_rank(*sys.argv[2:])
        return
    # one card: the first visible one (set before CUDA initializes)
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ("0" if visible is None
                                          else visible.split(",")[0])
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    card, builds = phase_device_and_build()
    _mark("1 device and build")
    CARD = card
    dev = torch.device("cuda")
    # the clips of phases 20-24, the tokenizer files of phases 25-26
    files_dir, tok_dir = (tempfile.TemporaryDirectory() for _ in range(2))
    try:
        _owl_tokenizer(tok_dir.name)
        report = phase_kernels(dev, builds, _owl_beam_rows(tok_dir.name))
        _mark("2 kernels")
        _phases(report, files_dir.name, tok_dir.name)
    finally:
        files_dir.cleanup()
        tok_dir.cleanup()
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
