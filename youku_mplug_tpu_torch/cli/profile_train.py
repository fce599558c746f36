"""Where a train step's time goes on the card.

Runs the pretrain CLI's path (``run_pretrain.setup``, its loader, batches
and train step), or with ``--instruct`` the instruct CLI's ``--train``
path (``run_instruct.train_setup``, ``make_instruct_batch`` and its
train step), or with ``--mplug`` the mPLUG pretrain CLI's
(``run_mplug_pretrain.setup``, its batches with the EMA twin's features,
its train step and momentum update): ``WARMUP`` steps, ``TIMED`` steps on the host clock
without the profiler, then ``PROFILED`` steps under ``torch.profiler``.
A step is timed as the CLI times it: batch upload, train step, device
sync; the host makes each batch's clips before.  It prints one JSON
line: the unprofiled step times and the host's time to make each of
those batches, then from the profiled steps' trace the wall time per
step, the device time per kernel category, the share of the window in
which no kernel ran (``idle_share``: the profiler's own host work
stretches the traced steps, so it reads high; ``idle_share_unprofiled``
sets the kernel time against the median unprofiled step), kernel
launches per step and the largest kernels; with ``--mplug`` also the
device time of the BERT's attention (its ``mha_reference`` calls, under
a ``bert_attention`` span in the profiled steps alone: the kernels they
launch).  The gzipped chrome trace
and the summary are written to ``--output_dir``.  Compare
``kernel_ms_per_step`` with the unprofiled step time: where the trace
lost events it reads low.

Usage (GPU):
    python -m youku_mplug_tpu_torch.cli.profile_train \
        --config configs/pretrain/pretrain_gpt3_1.3B_flagship.yaml \
        --synthetic_data --output_dir out
    python -m youku_mplug_tpu_torch.cli.profile_train --instruct \
        --config configs/instruct/train_bloomz_7b_flagship.yaml \
        --synthetic_data --output_dir out
    python -m youku_mplug_tpu_torch.cli.profile_train --mplug \
        --config configs/mplug/mplug_vitb16_zh.yaml --synthetic_data \
        --output_dir out
"""

from __future__ import annotations

import gzip
import json
import os
import time
from collections import Counter
from typing import Dict, List

import numpy as np
import torch

from youku_mplug_tpu_torch.cli import (
    run_instruct,
    run_mplug_pretrain,
    run_pretrain,
)
from youku_mplug_tpu_torch.models import bert

STEP_SPAN = "train_step"
BERT_ATTENTION_SPAN = "bert_attention"
# warm-up, unprofiled and profiled steps: 8 in all, the flagship YAMLs'
# 128 synthetic clips in batches of 16 and 64 in batches of 8
WARMUP, TIMED, PROFILED = 2, 5, 1
# (category, substrings of the kernel name), first match wins
CATEGORIES = (
    ("attention fwd (K1/K4)", ("flash_fwd_kernel", "flash_fwd_merge")),
    ("attention bwd dq", ("flash_bwd_dq_kernel",)),
    ("attention bwd dk/dv", ("flash_bwd_dkv_kernel",)),
    ("gemm fp32 (no tensor cores)", ("sgemm", "f32f32_f32f32", "_ffma")),
    ("gemm", ("gemm", "nvjet", "cutlass", "xmma")),
    ("optimizer (foreach)", ("multi_tensor_apply", "foreach")),
    ("reduce", ("reduce_kernel", "softmax", "norm_kernel")),
    ("copy / cat", ("copy", "CatArray", "cat_")),
    ("elementwise", ("elementwise",)),
)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def category(event: Dict) -> str:
    if event["cat"] != "kernel":
        return event["cat"].replace("gpu_", "")
    for name, keys in CATEGORIES:
        if any(k in event["name"] for k in keys):
            return name
    return "other"


def _busy_us(intervals: List[tuple]) -> float:
    """Length of the union of [start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def summarize(events: List[Dict], n_steps: int, top: int = 12) -> Dict:
    """Chrome-trace events of ``n_steps`` profiled steps (each inside a
    ``train_step`` host span) -> per-step device time by category (ms),
    idle share of the window, launches per step, largest kernels."""
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e.get("name") == STEP_SPAN]
    if len(spans) != n_steps:
        raise ValueError(f"found {len(spans)} {STEP_SPAN} spans, expected "
                         f"{n_steps}")
    t0 = min(e["ts"] for e in spans)
    t1 = max(e["ts"] + e["dur"] for e in spans)
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS and t0 <= e["ts"] < t1]
    by_cat, by_name = Counter(), Counter()
    for e in dev:
        by_cat[category(e)] += e["dur"]
        by_name[e["name"][:90]] += e["dur"]
    busy = _busy_us([(e["ts"], min(e["ts"] + e["dur"], t1)) for e in dev])
    per_step = 1e-3 / n_steps
    return {
        "steps": n_steps,
        "wall_ms_per_step": (t1 - t0) * per_step,
        "kernel_ms_per_step": sum(by_cat.values()) * per_step,
        "idle_share": 1.0 - busy / (t1 - t0),
        "launches_per_step": sum(e["cat"] == "kernel" for e in dev)
        / n_steps,
        "ms_per_step_by_category": {k: v * per_step
                                    for k, v in by_cat.most_common()},
        "top_kernels_ms_per_step": {k: v * per_step
                                    for k, v in by_name.most_common(top)},
    }


def span_device_ms(events: List[Dict], name: str, n_steps: int) -> float:
    """Device ms per step of the kernels launched inside the host spans
    ``name`` (matched to their launch by the trace's correlation ids)."""
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e.get("name") == name]
    ids = {e["args"]["correlation"] for e in events
           if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
           and "correlation" in e.get("args", {})
           and any(s <= e["ts"] < t for s, t in spans)}
    return sum(e["dur"] for e in events if e.get("ph") == "X"
               and e.get("cat") == "kernel"
               and e.get("args", {}).get("correlation") in ids) \
        * 1e-3 / n_steps


def _spanned(fn, name):
    def wrapped(*a, **kw):
        with torch.profiler.record_function(name):
            return fn(*a, **kw)
    return wrapped


def parser():
    p = run_pretrain.base_parser("Profile a train step (PyTorch)")
    p.add_argument("--instruct", action="store_true",
                   help="profile run_instruct --train (an instruct YAML)")
    p.add_argument("--mplug", action="store_true",
                   help="profile run_mplug_pretrain (an mPLUG YAML)")
    return p


def main(args) -> Dict:
    if torch.device(args.device).type != "cuda":
        raise RuntimeError("profile_train needs --device cuda")
    args.max_steps = WARMUP + TIMED + PROFILED
    mplug = getattr(args, "mplug", False)
    if getattr(args, "instruct", False):
        runner = run_instruct.train_setup(args)
        train_step = run_instruct.build_train_step(runner)
        make_batch = run_instruct.make_instruct_batch
    elif mplug:
        pt = run_mplug_pretrain.setup(args)
        runner = pt.runner
        train_step = run_mplug_pretrain.build_train_step(pt)
        make_batch = run_mplug_pretrain.make_batch_fn(pt)
    else:
        runner = run_pretrain.setup(args)
        train_step = run_pretrain.build_train_step(runner)
        make_batch = run_pretrain.make_batch
    dev = runner.device
    runner.loader.set_epoch(0)
    batches = iter(runner.loader)
    if len(runner.loader) < args.max_steps:
        raise ValueError(f"the loader holds {len(runner.loader)} batches; "
                         f"{args.max_steps} steps need more "
                         "(synthetic_length)")

    def step(raw):
        """One step as ``train_one_epoch`` times it: batch upload, train
        step, device sync (the host makes the clips before)."""
        train_step(runner.state, make_batch(runner, raw))
        torch.cuda.synchronize(dev)

    for _ in range(WARMUP):
        step(next(batches))
    step_ms, batch_ms = [], []
    for _ in range(TIMED):
        t = time.perf_counter()
        raw = next(batches)
        batch_ms.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        step(raw)
        step_ms.append((time.perf_counter() - t) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    mha = bert.mha_reference
    if mplug:
        bert.mha_reference = _spanned(mha, BERT_ATTENTION_SPAN)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(PROFILED):
                raw = next(batches)
                with torch.profiler.record_function(STEP_SPAN):
                    step(raw)
    finally:
        bert.mha_reference = mha
    os.makedirs(args.output_dir, exist_ok=True)
    trace = os.path.join(args.output_dir, "train_step_trace.json.gz")
    prof.export_chrome_trace(trace)
    with gzip.open(trace, "rt") as f:
        events = json.load(f)["traceEvents"]
    summary = {"step_ms_unprofiled": step_ms,
               "host_batch_ms_unprofiled": batch_ms,
               **summarize(events, PROFILED)}
    # the profiler's host work stretches the traced steps (its idle share
    # reads high); one stream runs the kernels back to back, so the
    # unprofiled steps' idle share is what their kernel time leaves over
    summary["idle_share_unprofiled"] = 1.0 - summary[
        "kernel_ms_per_step"] / float(np.median(step_ms))
    if mplug:
        ms = span_device_ms(events, BERT_ATTENTION_SPAN, PROFILED)
        summary["bert_attention_ms_per_step"] = ms
        summary["bert_attention_share"] = ms / summary["kernel_ms_per_step"]
    with open(os.path.join(args.output_dir, "profile_summary.json"),
              "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main(parser().parse_args())
