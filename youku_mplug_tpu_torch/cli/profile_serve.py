"""Where a caption serve run's host time goes.

Runs the serve CLI's path (``serve.build`` and ``serve.run``: clips
encoded in batches, requests admitted a trickle a step, one decode step
for all slots at a time) in a process of its own: a two-request
warm-up, then ``REPEATS`` runs on the host clock.  It prints one JSON
line: for each run its wall time and tokens/s, and the host ms it spent
encoding clips, admitting requests (their prefills, ended by the host's
read of the first token) and in decode steps (each ended by the
engine's read of the tokens; ``decode_enqueue_ms`` is the part spent
before that read, issuing the step: on the card staging its inputs and
replaying its CUDA graph).  It runs on the card
unless ``--device cpu`` asks for the CPU; it takes the serve CLI's
arguments.  chip_smoke.py traces the decode step's device time.

Usage (GPU):
    python -m youku_mplug_tpu_torch.cli.profile_serve \
        --config configs/caption/serve_gpt3_1.3B_int8kv.yaml \
        --synthetic_data
"""

from __future__ import annotations

import argparse
import json
import time
import unittest.mock as mock
from collections import defaultdict

import numpy as np
import torch

from youku_mplug_tpu_torch.cli import serve
from youku_mplug_tpu_torch.serving.engine import ServingEngine

REPEATS = 3  # runs of --num_requests requests after the warm-up


def _timed(times, name, fn):
    def wrapper(*args, **kwargs):
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        times[name].append((time.perf_counter() - t) * 1e3)
        return out
    return wrapper


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run(args, cfg, model, device):
    """One serve.run with its host time split by engine phase."""
    times = defaultdict(list)
    patches = [mock.patch.object(ServingEngine, name, _timed(
        times, key, getattr(ServingEngine, name)))
        for name, key in (("_admit", "admit_ms"), ("step", "step_ms"),
                          ("_launch", "decode_enqueue_ms"))]
    patches.append(mock.patch.object(model, "encode_queries", _timed(
        times, "encode_ms", model.encode_queries)))
    for p in patches:
        p.start()
    try:
        stats, _, _ = serve.run(args, cfg, model, device)
        _sync(device)
    finally:
        for p in patches:
            p.stop()
    return {**stats, "decode_steps": len(times["decode_enqueue_ms"]),
            **{k: {"sum": float(np.sum(v)), "median": float(np.median(v)),
                   "max": float(np.max(v))}
               for k, v in times.items() if v}}


def main(args) -> dict:
    cfg, model, device = serve.build(args)
    serve.run(argparse.Namespace(**{**vars(args), "num_requests": 2}), cfg,
              model, device)  # warm-up (cuBLAS, caches)
    _sync(device)
    runs = [_run(args, cfg, model, device) for _ in range(REPEATS)]
    summary = {"config": args.config, "runs": runs}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main(serve.serve_parser().parse_args())
