"""Smoke check of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line or a few; any failure exits nonzero before
the last line is printed):

1. device and build: require CUDA (one card: the first visible one),
   print the card's name and power limit, build the hand-written kernels
   from youku_mplug_tpu_torch/csrc/ (one nvcc per source, in parallel);
2. each kernel against its plain PyTorch version, in bf16, at the shapes
   the serving, training and instruct paths give it, with both times from
   CUDA events: the forward (K1 none / period / causal, K4) at the
   serving shapes and K1 at the CLIP ViT-L/14 frame shape, then at each
   of the four training shapes (vision spatial, grouped temporal with
   period 8, decoder causal, AttentionPool head-major, plus a small
   kv_len case) the forward's o and lse and the backward's dq and dk/dv
   kernels on that forward's output, and decode (K5: head dim 64; head
   dim 128 with the ALiBi ladder at BloomZ-7B1's cache, at a head count
   past a power of two, and without ALiBi);
3. the serve slice: the serve CLI's path at the flagship model's full
   width (configs/caption/serve_gpt3_1.3B_flagship.yaml, seeded weights),
   16 requests over synthetic clips, 8 slots, 32 new tokens, greedy;
   the forward and decode kernels' launch counters must rise and every
   logit be finite;
4. teacher-forced check: the video encoder and the first decode steps
   again with the plain versions in place of the kernels, fed the same
   inputs and tokens; query features and logits within a stated
   tolerance, greedy agreement printed;
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
   tokens, greedy; the K1 and K5-ALiBi launch counters must rise and
   every logit be finite; tokens/s, p50/p95, peak memory and the decode
   step's time;
8. instruct teacher-forced check: the clips' media features and the
   first decode steps again with the plain versions of K1 and K5 fed the
   same inputs and tokens, within the stated tolerances;
9. a JSON line describing each kernel, the card's line, then the result
   line.
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
WARMUP_STEPS, TIMED_STEPS = 2, 5
OWL_YAML = os.path.join(REPO, "configs", "instruct",
                        "serve_bloomz_7b_flagship.yaml")
OWL_REQUESTS, OWL_SLOTS = 16, 8
# instruct teacher-forced check, max |kernels - plain| over max |plain|,
# for the media features (24 ViT-L blocks, 6 abstractor layers and
# visual_fc) and the fp32 logits (30 Bloom layers), all in bf16: each
# attention call's output differs by a few bf16 ulps (2^-8 relative) as
# the two versions round at different points; ~30 such independent flips
# through residual streams and LayerNorms add up to about sqrt(30) x 2^-8
# ~ 2% of the largest value, and the bound leaves three times that
OWL_REL_TOL = 2.0 ** -4
SPIN_CYCLES = 200_000_000  # >= 0.1 s at the H100's 1.98 GHz boost clock


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
    usage = " ; ".join(line.split("info    : ")[-1]
                       for line in log.splitlines() if "registers" in line)
    print(f"[build] {os.path.relpath(so, REPO)} in {seconds:.1f} s "
          f"(sm_90a) | {usage}", flush=True)
    return card


def _bwd_case(rand, fa, b, sq, sk, n, causal, period, kv_len, layout):
    """One training-shape check, in the layouts the model hands the
    kernels (packed slices of one qkv projection, or head views of
    AttentionPool's projections): the forward kernel's o and lse against
    flash_fwd_plain, then the dq and dk/dv kernels against
    flash_bwd_plain on the same (q, k, v, o, lse, dO); all with both
    times."""
    nd = n * 64
    if layout == "packed":
        qkv = rand(b, sq, 3 * nd)
        parts = (qkv[..., :nd], qkv[..., nd:2 * nd], qkv[..., 2 * nd:])
    else:
        parts = (rand(b, sq, nd), rand(b, sk, nd), rand(b, sk, nd))
    q, k, v = (t.unflatten(-1, (n, 64)).transpose(1, 2) for t in parts)
    kw = dict(scale=0.125, causal=causal, period=period, kv_len=kv_len)
    shape = (f"[{b},{sq},{n}x64] kv {sk}"
             + (" causal" if causal else "")
             + (f" period {period}" if period else "")
             + (f" kv_len {kv_len}" if kv_len is not None else "")
             + f" {layout}")
    o = fa._head_major_empty(q)
    lse = fa.flash_fwd_cuda(q, k, v, o, **kw)
    want_o, want_lse = fa.flash_fwd_plain(q, k, v, **kw)
    fwd_err, lse_err = err(o, want_o), err(lse, want_lse)
    if not (within(o, want_o) and lse_err <= LSE_TOL):
        fail(f"forward {shape}: max err {fwd_err} (tol {KERNEL_TOL}), lse "
             f"{lse_err} (tol {LSE_TOL})")
    fwd = {"shape": shape + " (train)", "max_abs_err": fwd_err,
           "lse_err": lse_err,
           "ms": time_ms(lambda: fa.flash_fwd_cuda(q, k, v, o, **kw), 20),
           "plain_ms": time_ms(lambda: fa.flash_fwd_plain(q, k, v, **kw),
                               20)}
    do = fa._head_major_empty(q).copy_(rand(b, n, sq, 64))
    delta = (do.float() * o.float()).sum(-1).contiguous()
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
    return {"shape": shape, "layout": layout, "fwd": fwd, "rel_l2": errs,
            "max_abs_err": abs_err, "dq_ms": dq_ms, "dkv_ms": dkv_ms,
            "plain_ms": plain_ms}


# (rows, Sq, Sk, heads, causal, period, kv_len, layout); the first four
# are the flagship train step's shapes (16 clips x 8 frames; 16 clips x
# 14 temporal groups; 16 x (128 queries + 80 tokens); AttentionPool's 128
# queries over 1 + 8 x 196 tokens and the bias key)
BWD_SHAPES = [(128, 197, 197, 12, False, 0, None, "packed"),
              (224, 112, 112, 12, False, 8, None, "packed"),
              (16, 208, 208, 32, True, 0, None, "packed"),
              (16, 128, 1570, 12, False, 0, None, "heads"),
              (2, 65, 130, 1, False, 0, 70, "heads")]


def _decode_case(dec, q, ckv, n, clen, vfrom, slopes, shape):
    """One K5 check on the last layer of ``ckv``: the kernel against
    decode_attention_plain on the same inputs, slot 3 (no live key)
    reading zeros; both times over 200 calls."""
    lidx = ckv.shape[0] - 1
    kw = dict(alibi_slopes=slopes)
    got = dec.decode_attention(q, ckv, n, lidx, clen, vfrom, **kw)
    want = dec.decode_attention_plain(q, ckv, n, lidx, clen, vfrom, **kw)
    e, empty = err(got, want), got[3].abs().max().item()
    if not within(got, want) or empty != 0:
        fail(f"K5 {shape}: max err {e} (tol {KERNEL_TOL}); empty slot max "
             f"{empty}")
    return {"shape": shape, "max_abs_err": e,
            "ms": time_ms(lambda: dec.decode_attention(
                q, ckv, n, lidx, clen, vfrom, **kw), 200),
            "plain_ms": time_ms(lambda: dec.decode_attention_plain(
                q, ckv, n, lidx, clen, vfrom, **kw), 200)}


def phase_kernels(dev):
    from youku_mplug_tpu_torch.ops import decode_attention as dec
    from youku_mplug_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    report = []
    # K1: vision spatial [B*T, 197, 12*64], temporal [B*14, 112, 12*64]
    # period 8 (B = 8 clips serving, 16 training), decoder training
    # [16, 208, 32*64] causal, the instruct path's CLIP ViT-L/14 frames
    # [16 clips x 8 frames, 1 + 16*16, 16*64]; q/k/v as views of one qkv
    # projection
    per_shape = []
    for rows, s, n, period, causal, path in (
            (64, 197, 12, 0, False, "serve"),
            (112, 112, 12, 8, False, "serve"),
            (16, 208, 32, 0, True, "train"),
            (128, 257, 16, 0, False, "instruct")):
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
        shape = (f"[{rows},{s},{n}x64] period {period}"
                 + (" causal" if causal else "") + f" ({path})")
        if not (within(got, want) and e_lse <= LSE_TOL):
            fail(f"K1 {shape}: max err {e} (tol {KERNEL_TOL}), lse {e_lse} "
                 f"(tol {LSE_TOL})")
        ms = time_ms(lambda: fa.flash_attention_packed(q, k, v, n, **kw), 20)
        plain_ms = time_ms(lambda: fa.flash_attention_packed_plain(
            q, k, v, n, **kw), 20)
        per_shape.append({"shape": shape, "max_abs_err": e, "lse_err": e_lse,
                          "ms": ms, "plain_ms": plain_ms})
    report.append({
        "name": "K1 flash_attention_packed (vision spatial + temporal, "
                "decoder causal, CLIP ViT-L frames)",
        "route": "cuda", "source": "youku_mplug_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "youku_mplug_tpu/ops/flash_attention.py:426",
        "wrapper": fa.flash_attention_packed,
        "paths": ("serve", "train", "instruct"),
        "key": "K1",
        "max_abs_err": max(p["max_abs_err"] for p in per_shape),
        "ms": sum(p["ms"] for p in per_shape),
        "plain_ms": sum(p["plain_ms"] for p in per_shape),
        "per_shape": per_shape})

    # K4: AttentionPool, q [8,12,128,64], k/v [8,12,1570,64] (head views)
    q = rand(8, 128, 768).unflatten(-1, (12, 64)).transpose(1, 2)
    k, v = (rand(8, 1570, 768).unflatten(-1, (12, 64)).transpose(1, 2)
            for _ in range(2))
    got = fa.flash_attention(q, k, v)
    want = fa.flash_attention_plain(q, k, v)
    lse = fa.flash_fwd_cuda(q, k, v, torch.empty_like(q), scale=0.125)
    e, e_lse = err(got, want), err(lse, fa.flash_fwd_plain(q, k, v,
                                                           scale=0.125)[1])
    if not (within(got, want) and e_lse <= LSE_TOL):
        fail(f"K4 AttentionPool: max err {e}, lse {e_lse}")
    report.append({
        "name": "K4 flash_attention (AttentionPool)", "route": "cuda",
        "source": "youku_mplug_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "youku_mplug_tpu/ops/flash_attention.py:59",
        "wrapper": fa.flash_attention, "paths": ("serve", "train"),
        "key": "K4",
        "per_shape": [{
            "shape": "[8,128,12x64] kv 1570 heads (serve)",
            "max_abs_err": e, "lse_err": e_lse,
            "ms": time_ms(lambda: fa.flash_attention(q, k, v), 20),
            "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, k, v),
                                20)}]})

    # the forward again, then K2/K3 and K4b (the backward), at the
    # training shapes: K1's packed cases, K4's head-major ones
    cases = [_bwd_case(rand, fa, *c) for c in BWD_SHAPES]
    train_cases = cases[:4]
    for entry, layout in ((report[0], "packed"), (report[1], "heads")):
        entry["per_shape"] += [c["fwd"] for c in cases
                               if c["layout"] == layout]
        entry["max_abs_err"] = max(p["max_abs_err"]
                                   for p in entry["per_shape"])
        entry["ms"] = sum(p["ms"] for p in entry["per_shape"])
        entry["plain_ms"] = sum(p["plain_ms"] for p in entry["per_shape"])
    for kind, wrapper, line, key in (
            ("dq", fa.flash_bwd_dq_cuda, 723, "dq_ms"),
            ("dkv", fa.flash_bwd_dkv_cuda, 791, "dkv_ms")):
        grads = ("dq",) if kind == "dq" else ("dk", "dv")
        report.append({
            "name": f"K2/K3 + K4b backward {kind} kernel "
                    f"(flash_bwd_{kind}_cuda; also replaces "
                    f"flash_attention.py:{148 if kind == 'dq' else 195})",
            "route": "cuda",
            "source": "youku_mplug_tpu_torch/csrc/flash_bwd.cu",
            "replaces": f"youku_mplug_tpu/ops/flash_attention.py:{line}",
            "wrapper": wrapper, "paths": ("train",), "key": kind,
            "max_abs_err": max(c["max_abs_err"][gname] for c in cases
                               for gname in grads),
            "ms": sum(c[key] for c in train_cases),
            # the plain backward computes dq, dk and dv together
            "plain_ms": sum(c["plain_ms"] for c in train_cases),
            "per_shape": [{"shape": c["shape"],
                           "rel_l2": {gn: c["rel_l2"][gn] for gn in grads},
                           "max_abs_err": max(c["max_abs_err"][gn]
                                              for gn in grads),
                           "ms": c[key], "plain_ms": c["plain_ms"]}
                          for c in cases]})

    # K5: decode, q [8, 32*64] (view of a qkv row), cache [24,8,256,4096],
    # mixed lengths; slot 3 has no live key and must read zeros
    qkv = rand(8, 3 * 2048)
    q = qkv[:, :2048]
    ckv = rand(24, 8, 256, 4096)
    clen = torch.tensor([0, 17, 136, 150, 200, 255, 100, 60],
                        dtype=torch.int32, device=dev)
    vfrom = torch.tensor([0, 0, 5, 151, 0, 100, 99, 3], dtype=torch.int32,
                         device=dev)
    k5 = [_decode_case(dec, q, ckv, 32, clen, vfrom, None,
                       "[24,8,256,2x32x64] d 64 (serve)")]
    # K5 at head dim 128: BloomZ-7B1's decode step (32 heads with the
    # ALiBi ladder, cache [30, 8, 256, 2*32*128]; q a head-strided view of
    # the head-major fused row [B, n, 3, d], as models/bloom.py passes it),
    # 40 heads (the ladder's half steps past 32) and the d = 128 build
    # without ALiBi; same lengths
    alibi = []
    for n, layers, slopes in ((32, 30, True), (40, 2, True),
                              (32, 2, False)):
        qh = rand(8, n, 3, 128)[:, :, 0, :]
        cache = rand(layers, 8, 256, 2 * n * 128)
        case = _decode_case(
            dec, qh, cache, n, clen, vfrom,
            dec.alibi_slopes(n) if slopes else None,
            f"[{layers},8,256,2x{n}x128] d 128"
            + (" ALiBi" if slopes else "")
            + (" (instruct)" if (n, slopes) == (32, True) else ""))
        (alibi if slopes else k5).append(case)
        del cache
    report.append({
        "name": "K5 decode_attention (decoder decode step)", "route": "cuda",
        "source": "youku_mplug_tpu_torch/csrc/decode_attention.cu",
        "replaces": "youku_mplug_tpu/ops/decode_attention.py:56",
        "wrapper": dec.decode_attention, "paths": ("serve",), "key": "K5",
        "max_abs_err": max(c["max_abs_err"] for c in k5),
        "ms": k5[0]["ms"], "plain_ms": k5[0]["plain_ms"], "per_shape": k5})
    report.append({
        "name": "K5 decode_attention, ALiBi ladder, head dim 128 (Bloom "
                "decode step)", "route": "cuda",
        "source": "youku_mplug_tpu_torch/csrc/decode_attention.cu",
        "replaces": "youku_mplug_tpu/ops/decode_attention.py:56",
        "wrapper": dec.decode_attention, "counter": "alibi_launches",
        "paths": ("instruct",), "key": "K5-ALiBi",
        "max_abs_err": max(c["max_abs_err"] for c in alibi),
        "ms": alibi[0]["ms"], "plain_ms": alibi[0]["plain_ms"],
        "per_shape": alibi})
    for r in report:
        print(f"[kernel] {r['name']}: max_abs_err {r['max_abs_err']:.3g} | "
              f"kernel {r['ms']:.4f} ms | plain {r['plain_ms']:.4f} ms",
              flush=True)
        for p in r.get("per_shape", []):
            print(f"[kernel]   {p['shape']}: "
                  + json.dumps({k: v for k, v in p.items() if k != "shape"}),
                  flush=True)
    print(f"[kernel] tolerances: forward elementwise {KERNEL_TOL:.3g} x "
          f"(1 + |plain|), lse {LSE_TOL}, backward relative L2 "
          f"{BWD_TOL:.3g} per gradient", flush=True)
    return report


def _reset_counts(report):
    for r in report:
        setattr(r["wrapper"], r.get("counter", "launches"), 0)


def _read_counts(report, path):
    for r in report:
        r.setdefault("launches_by_path", {})[path] = getattr(
            r["wrapper"], r.get("counter", "launches"))
    missing = [r["name"] for r in report
               if path in r["paths"] and r["launches_by_path"][path] == 0]
    if missing:
        fail(f"the {path} path never launched: {missing}")


def phase_slice(report, out_dir):
    from youku_mplug_tpu_torch.cli import serve

    def args_for(n):
        return serve.serve_parser().parse_args([
            "--config", FLAGSHIP_YAML, "--synthetic_data",
            "--num_requests", str(n), "--num_slots", "8", "--device", "cuda",
            "--output_dir", out_dir])

    args = args_for(16)
    cfg, model, device = serve.build(args)
    serve.run(args_for(2), cfg, model, device)  # warm-up (cuBLAS, caches)
    torch.cuda.synchronize()
    _reset_counts(report)
    stats, out, engine = serve.run(args, cfg, model, device)
    torch.cuda.synchronize()
    _read_counts(report, "serve")
    if stats["requests"] != 16 or any(not o["tokens"] for o in out):
        fail(f"slice served {stats['requests']} requests: {out}")
    if engine.nonfinite_logits:
        fail(f"{engine.nonfinite_logits} logit rows were not finite")
    n_tok = sum(o["n_tokens"] for o in out)
    print(f"[slice] {json.dumps(stats)} | {n_tok} tokens | launches "
          f"{[r['launches_by_path']['serve'] for r in report]} | peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
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


def phase_teacher_forced(cfg, model):
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
    plain = (mock.patch.object(vision, "flash_attention_packed",
                               fa.flash_attention_packed_plain),
             mock.patch.object(fa, "flash_attention",
                               fa.flash_attention_plain),
             mock.patch.object(gpt3, "decode_attention",
                               dec.decode_attention_plain))
    for p in plain:
        p.start()
    try:
        with torch.inference_mode():
            qe_plain = model.encode_queries(video)
        logits_plain, _ = _forced_decode(**forced, tokens=tokens)
    finally:
        for p in plain:
            p.stop()
    e_q = err(qe, qe_plain)
    e_l = max(err(a, b) for a, b in zip(logits, logits_plain))
    agree = sum(int((a.argmax(-1) == b.argmax(-1)).sum())
                for a, b in zip(logits, logits_plain))
    total = FORCED_STEPS * 8
    finite = all(torch.isfinite(x).all() for x in logits + logits_plain)
    print(f"[teacher-forced] query features max err {e_q:.4g} (tol "
          f"{QUERY_TOL}) | logits over {FORCED_STEPS} steps max err "
          f"{e_l:.4g} (tol {LOGIT_TOL}) | greedy agreement {agree}/{total}",
          flush=True)
    if not finite or e_q > QUERY_TOL or e_l > LOGIT_TOL:
        fail("teacher-forced check out of tolerance")


def phase_train(report, out_dir):
    """The pretrain CLI's path at full width; returns its runner."""
    from youku_mplug_tpu_torch.cli import run_pretrain

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
    history = run_pretrain.train_one_epoch(runner, train_step, 0)
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


def phase_replay(runner):
    """Loss and trainable gradients of one batch with the kernels, then
    with the wrappers taking their plain versions on the card."""
    from youku_mplug_tpu_torch.cli import run_pretrain
    from youku_mplug_tpu_torch.ops import flash_attention as fa

    runner.loader.set_epoch(0)
    batch = run_pretrain.make_batch(runner, next(iter(runner.loader)))
    loss_fn = run_pretrain.make_loss_fn(runner.model)
    params = runner.state.trainable

    def loss_and_grads():
        for p in params.values():
            p.grad = None
        out = loss_fn(batch)
        out["loss"].backward()
        grads = {k: p.grad for k, p in params.items() if p.grad is not None}
        for p in params.values():
            p.grad = None
        return out["loss"].item(), grads

    loss_k, grads_k = loss_and_grads()
    counts = (fa.flash_bwd_dq_cuda.launches, fa.flash_bwd_dkv_cuda.launches,
              fa.flash_attention_packed.launches, fa.flash_attention.launches)
    with mock.patch.object(fa, "_on_cpu", lambda t: True):
        loss_p, grads_p = loss_and_grads()
    if counts != (fa.flash_bwd_dq_cuda.launches,
                  fa.flash_bwd_dkv_cuda.launches,
                  fa.flash_attention_packed.launches,
                  fa.flash_attention.launches):
        fail("the plain replay launched a kernel")
    if set(grads_k) != set(grads_p):
        fail(f"gradient leaves differ: {set(grads_k) ^ set(grads_p)}")
    whole = torch.stack([g.float().norm() for g in grads_p.values()]).norm()
    rows = []
    for k in grads_k:
        diff = (grads_k[k].float() - grads_p[k].float()).norm().item()
        norm = grads_p[k].float().norm().item()
        bound = max(norm, REPLAY_GRAD_FLOOR * whole.item())
        rows.append((diff / bound, diff / max(norm, 1e-30), norm, k))
    rows.sort(reverse=True)
    finite = math.isfinite(loss_k) and all(
        torch.isfinite(g).all() for g in grads_k.values())
    rel = sorted(r[1] for r in rows)
    print(f"[replay] loss kernels {loss_k:.6f} plain {loss_p:.6f} (tol "
          f"{REPLAY_LOSS_TOL}) | {len(rows)} leaves, whole gradient norm "
          f"{whole.item():.4g}: relative L2 median {rel[len(rel) // 2]:.4g}"
          f", max {rel[-1]:.4g} | gated error max {rows[0][0]:.4g} (tol "
          f"{REPLAY_GRAD_TOL}, floor {REPLAY_GRAD_FLOOR} x whole) | worst: "
          + ", ".join(f"{k} gated {g:.3g} rel {r:.3g} norm {n:.3g}"
                      for g, r, n, k in rows[:4]), flush=True)
    if not finite or abs(loss_k - loss_p) > REPLAY_LOSS_TOL \
            or rows[0][0] > REPLAY_GRAD_TOL:
        fail("plain replay out of tolerance")


OWL_QUESTIONS = ("What is in the video?", "What happens next?",
                 "Describe the scene in detail.", "Who is speaking?",
                 "Is it day or night?", "What colour is the car?",
                 "How many people are there?", "Where was this filmed?")


def phase_instruct(report, out_dir):
    """The run_instruct CLI's serving path at full width and depth;
    returns (model, instruct batch, clips)."""
    from youku_mplug_tpu_torch.cli import run_instruct

    jsonl = os.path.join(out_dir, "requests.jsonl")
    with open(jsonl, "w") as f:
        for i in range(OWL_REQUESTS):
            f.write(json.dumps({
                "video": f"clip{i}.mp4",
                "question": OWL_QUESTIONS[i % len(OWL_QUESTIONS)]
                + " " * (i // len(OWL_QUESTIONS))}) + "\n")
    args = run_instruct.parser().parse_args([
        "--config", OWL_YAML, "--synthetic_data", "--engine",
        "--input_jsonl", jsonl, "--num_slots", str(OWL_SLOTS),
        "--device", "cuda", "--output_dir", out_dir])
    t0 = time.perf_counter()
    cfg, raw, model, device = run_instruct.build(args)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
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
    _read_counts(report, "instruct")
    if stats["requests"] != OWL_REQUESTS \
            or not (seqs != gen_cfg.pad_id).any(1).all():
        fail(f"instruct slice served {stats['requests']} requests: "
             f"{seqs.tolist()}")
    if engine.nonfinite_logits:
        fail(f"{engine.nonfinite_logits} instruct logit rows were not "
             "finite")

    # one decode step of all 8 slots at the run's last lengths, with the
    # host sync the engine makes per step; the tied logits alone
    state = [engine._dev(a) for a in (engine.cache_len, engine.valid_from,
                                      engine.pos_offset, engine.last_token)]
    for _ in range(3):
        engine._decode_impl(*state).cpu()
    t1 = time.perf_counter()
    for _ in range(20):
        engine._decode_impl(*state).cpu()
    step_ms = (time.perf_counter() - t1) / 20 * 1e3
    lm = model.text_decoder
    hidden = torch.randn(OWL_SLOTS, cfg.text.hidden_size, device=device,
                         dtype=torch.bfloat16)
    with torch.inference_mode():
        logits_ms = time_ms(lambda: lm.logits(hidden), 50)
    stats.update({
        "build_s": build_s, "params": n_params,
        "prompt_len": [int(x) for x in batch["prompt_len"][:2]],
        "decode_step_ms": step_ms, "tied_logits_ms": logits_ms,
        "launches": {r["key"]: r["launches_by_path"]["instruct"]
                     for r in report}})
    print(f"[instruct] {json.dumps(stats)} | first answer "
          f"{seqs[0][:8].tolist()}", flush=True)
    return model, batch, clips


def phase_instruct_forced(model, batch, clips):
    """The first OWL_SLOTS clips' media features, and FORCED_STEPS decode
    steps from their spliced prompts, with the kernels and again with the
    plain versions of K1 (the ViT) and K5 (the Bloom decode step) patched
    in, fed the same inputs and tokens."""
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
    counts = (fa.flash_attention_packed.launches,
              dec.decode_attention.alibi_launches)
    plain = (mock.patch.object(vision, "flash_attention_packed",
                               fa.flash_attention_packed_plain),
             mock.patch.object(bloom, "decode_attention",
                               dec.decode_attention_plain))
    for p in plain:
        p.start()
    try:
        with torch.inference_mode():
            media_plain = model.encode_video(clips[:n])
        logits_plain, _ = _forced_decode(**forced, tokens=tokens)
    finally:
        for p in plain:
            p.stop()
    if counts != (fa.flash_attention_packed.launches,
                  dec.decode_attention.alibi_launches):
        fail("the instruct plain replay launched a kernel")
    e_m = err(media, media_plain)
    e_l = max(err(a, b) for a, b in zip(logits, logits_plain))
    top_m = media_plain.float().abs().max().item()
    top_l = max(x.abs().max().item() for x in logits_plain)
    agree = sum(int((a.argmax(-1) == b.argmax(-1)).sum())
                for a, b in zip(logits, logits_plain))
    finite = all(torch.isfinite(x).all() for x in logits + logits_plain)
    print(f"[instruct teacher-forced] media features max err {e_m:.4g} of "
          f"max |plain| {top_m:.4g} | logits over {FORCED_STEPS} steps max "
          f"err {e_l:.4g} of max |plain| {top_l:.4g} (tol {OWL_REL_TOL:.4g} "
          f"x max |plain|) | greedy agreement {agree}/{FORCED_STEPS * n}",
          flush=True)
    if not finite or e_m > OWL_REL_TOL * top_m or e_l > OWL_REL_TOL * top_l:
        fail("instruct teacher-forced check out of tolerance")


def main():
    # one card: the first visible one (set before CUDA initializes)
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ("0" if visible is None
                                          else visible.split(",")[0])
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    card = phase_device_and_build()
    dev = torch.device("cuda")
    report = phase_kernels(dev)
    with tempfile.TemporaryDirectory() as out_dir:
        cfg, model, _ = phase_slice(report, out_dir)
    phase_teacher_forced(cfg, model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        runner, _ = phase_train(report, out_dir)
        phase_replay(runner)
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        model, batch, clips = phase_instruct(report, out_dir)
    phase_instruct_forced(model, batch, clips)
    kernels = []
    for r in report:
        entry = {k: r[k] for k in ("name", "route", "source", "replaces")}
        entry["launches"] = sum(r["launches_by_path"].values())
        entry |= {k: r[k] for k in ("max_abs_err", "ms", "plain_ms")}
        entry["launches_by_path"] = r["launches_by_path"]
        if "per_shape" in r:
            entry["per_shape"] = r["per_shape"]
        kernels.append(entry)
    print(f"[done] {time.perf_counter() - t0:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
