"""Smoke check of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits nonzero before the last
line is printed):

1. device and build: require CUDA, print the card's name and power limit,
   build the hand-written kernels from youku_mplug_tpu_torch/csrc/;
2. each kernel against its plain PyTorch version, in bf16, at the shapes
   the serving path gives it, with both times from CUDA events;
3. the slice: the serve CLI's path at the flagship model's full width
   (configs/caption/serve_gpt3_1.3B_flagship.yaml, seeded weights),
   16 requests over synthetic clips, 8 slots, 32 new tokens, greedy;
   every kernel's launch counter must rise and every logit be finite;
4. teacher-forced check: the video encoder and the first decode steps
   again with the plain versions in place of the kernels, fed the same
   inputs and tokens; query features and logits within a stated
   tolerance, greedy agreement printed;
5. a JSON line describing each kernel, then the result line.
"""

from __future__ import annotations

import json
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
QUERY_TOL = 0.1          # query features after 12 vision blocks, bf16
LOGIT_TOL = 0.1          # fp32 logits after 24 decoder layers, bf16
FORCED_STEPS = 4
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


def phase_kernels(dev):
    from youku_mplug_tpu_torch.ops import decode_attention as dec
    from youku_mplug_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    report = []
    # K1: vision spatial [B*T, 197, 12*64] and temporal [B*14, 112, 12*64]
    # period 8, q/k/v as views of one qkv projection (B = 8 clips)
    per_shape = []
    for rows, s, period in ((64, 197, 0), (112, 112, 8)):
        qkv = rand(rows, s, 3 * 768)
        q, k, v = qkv[..., :768], qkv[..., 768:1536], qkv[..., 1536:]
        got = fa.flash_attention_packed(q, k, v, 12, period=period)
        want = fa.flash_attention_packed_plain(q, k, v, 12, period=period)
        views = [t.unflatten(-1, (12, 64)).transpose(1, 2)
                 for t in (q, k, v)]
        lse = fa.flash_fwd_cuda(*views, torch.empty_like(views[0]),
                                scale=0.125, period=period)
        _, want_lse = fa.flash_fwd_plain(*views, scale=0.125, period=period)
        e, e_lse = err(got, want), err(lse, want_lse)
        if not (within(got, want) and e_lse <= LSE_TOL):
            fail(f"K1 [{rows},{s},12x64] period {period}: max err {e} "
                 f"(tol {KERNEL_TOL}), lse {e_lse} (tol {LSE_TOL})")
        ms = time_ms(lambda: fa.flash_attention_packed(
            q, k, v, 12, period=period), 20)
        plain_ms = time_ms(lambda: fa.flash_attention_packed_plain(
            q, k, v, 12, period=period), 20)
        per_shape.append({"shape": f"[{rows},{s},12x64] period {period}",
                          "max_abs_err": e, "lse_err": e_lse, "ms": ms,
                          "plain_ms": plain_ms})
    report.append({
        "name": "K1 flash_attention_packed (vision spatial + temporal)",
        "route": "cuda", "source": "youku_mplug_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "youku_mplug_tpu/ops/flash_attention.py:426",
        "wrapper": fa.flash_attention_packed,
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
        "wrapper": fa.flash_attention, "max_abs_err": e, "lse_err": e_lse,
        "ms": time_ms(lambda: fa.flash_attention(q, k, v), 20),
        "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, k, v), 20)})

    # K5: decode, q [8, 32*64] (view of a qkv row), cache [24,8,256,4096],
    # mixed lengths; slot 3 has no live key and must read zeros
    qkv = rand(8, 3 * 2048)
    q = qkv[:, :2048]
    ckv = rand(24, 8, 256, 4096)
    clen = torch.tensor([0, 17, 136, 150, 200, 255, 100, 60],
                        dtype=torch.int32, device=dev)
    vfrom = torch.tensor([0, 0, 5, 151, 0, 100, 99, 3], dtype=torch.int32,
                         device=dev)
    got = dec.decode_attention(q, ckv, 32, 23, clen, vfrom)
    want = dec.decode_attention_plain(q, ckv, 32, 23, clen, vfrom)
    e = err(got, want)
    if not within(got, want) or got[3].abs().max().item() != 0:
        fail(f"K5 decode: max err {e}; empty slot max "
             f"{got[3].abs().max().item()}")
    report.append({
        "name": "K5 decode_attention (decoder decode step)", "route": "cuda",
        "source": "youku_mplug_tpu_torch/csrc/decode_attention.cu",
        "replaces": "youku_mplug_tpu/ops/decode_attention.py:56",
        "wrapper": dec.decode_attention, "max_abs_err": e,
        "ms": time_ms(lambda: dec.decode_attention(q, ckv, 32, 23, clen,
                                                   vfrom), 200),
        "plain_ms": time_ms(lambda: dec.decode_attention_plain(
            q, ckv, 32, 23, clen, vfrom), 200)})
    for r in report:
        print(f"[kernel] {r['name']}: max_abs_err {r['max_abs_err']:.3g} "
              f"(tol {KERNEL_TOL:.3g} x (1 + |plain|)) | kernel "
              f"{r['ms']:.4f} ms | plain {r['plain_ms']:.4f} ms", flush=True)
    return report


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
    for r in report:
        r["wrapper"].launches = 0
    stats, out, engine = serve.run(args, cfg, model, device)
    torch.cuda.synchronize()
    for r in report:
        r["launches"] = r["wrapper"].launches
    if stats["requests"] != 16 or any(not o["tokens"] for o in out):
        fail(f"slice served {stats['requests']} requests: {out}")
    missing = [r["name"] for r in report if r["launches"] == 0]
    if missing:
        fail(f"the serving path never launched: {missing}")
    if engine.nonfinite_logits:
        fail(f"{engine.nonfinite_logits} logit rows were not finite")
    n_tok = sum(o["n_tokens"] for o in out)
    print(f"[slice] {json.dumps(stats)} | {n_tok} tokens | launches "
          f"{[r['launches'] for r in report]} | peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return cfg, model, stats


def _forced_decode(model, cfg, qe, tokens=None):
    """Prefill 8 requests (prompt + query prefix) through the serving
    engine, then FORCED_STEPS decode steps.  Returns (logits per step,
    tokens fed): greedy from these logits, or ``tokens`` when given."""
    from youku_mplug_tpu_torch.models.generation import GenerationConfig
    from youku_mplug_tpu_torch.serving.engine import ServingEngine

    lm = model.text_decoder
    eng = ServingEngine(lm, num_slots=8, max_len=128 + 8 + 33,
                        prefill_buckets=(8,),
                        config=GenerationConfig(max_new_tokens=64, eos_id=2,
                                                pad_id=2))
    for i in range(8):
        eng.submit([1], query_embeds=qe[i])
    eng._admit()
    fed = [torch.from_numpy(eng.last_token.copy()).long()]
    logits = []
    dev = qe.device
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

    ds = SyntheticVideoDataset(8, cfg.num_frames, cfg.image_res)
    clips = torch.stack([torch.from_numpy(ds[i]["video"]) for i in range(8)])
    with torch.inference_mode():
        video = normalize_clip(clips.cuda(), dtype=torch.bfloat16)
        qe = model.encode_queries(video)
    logits, tokens = _forced_decode(model, cfg, qe)
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
        logits_plain, _ = _forced_decode(model, cfg, qe, tokens)
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


def main():
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
    kernels = [{k: r[k] for k in ("name", "route", "source", "replaces",
                                  "launches", "max_abs_err", "ms",
                                  "plain_ms")} | (
        {"per_shape": r["per_shape"]} if "per_shape" in r else {})
        for r in report]
    print(f"[done] {time.perf_counter() - t0:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
