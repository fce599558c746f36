"""Video-text pretraining CLI (caption LM + optional contrastive).

Counterpart of ``youku_mplug_tpu/cli/run_pretrain.py`` with the parts of
``cli/common.py`` it needs (setup, the epoch loop, ``write_log``): fresh
weights drawn by the JAX ``model.init`` rules (``bridge.jax_init``),
synthetic clips, the trainable/frozen split, AdamW, and one
train step per batch; each step prints loss, loss_caption, grad_norm,
lr, skipped_nonfinite and its wall time, and each epoch appends its
averages to ``<output_dir>/log.txt``.  Checkpoints, resume, TensorBoard
and profiling are not ported yet: the run saves no weights.

Usage (GPU):
    python -m youku_mplug_tpu_torch.cli.run_pretrain \
        --config configs/pretrain/pretrain_gpt3_1.3B_flagship.yaml \
        --output_dir out --synthetic_data --max_steps 7 --device cuda
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from youku_mplug_tpu_torch.bridge import jax_init
from youku_mplug_tpu_torch.config import RunConfig, load_config
from youku_mplug_tpu_torch.data.datasets import SyntheticVideoDataset
from youku_mplug_tpu_torch.data.loader import Loader
from youku_mplug_tpu_torch.models.tasks import MPLUGVideo
from youku_mplug_tpu_torch.models.tokenizer import (
    BatchTokenizer,
    load_tokenizer,
)
from youku_mplug_tpu_torch.ops.preprocess import normalize_clip
from youku_mplug_tpu_torch.runtime.precision import (
    DEFAULT_POLICY,
    FP32_POLICY,
)
from youku_mplug_tpu_torch.train.state import TrainState, create_train_state
from youku_mplug_tpu_torch.train.trainer import make_train_step


def base_parser(description: str = "mPLUG-Video pretraining (PyTorch)"):
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", required=True)
    p.add_argument("--output_dir", default="./output")
    p.add_argument("--seed", type=int, default=42,
                   help="seed of the weight init and the data order")
    p.add_argument("--fp32", action="store_true",
                   help="full fp32 (CPU tests)")
    p.add_argument("--max_steps", type=int, default=-1,
                   help="cap steps per epoch (smoke runs)")
    p.add_argument("--synthetic_data", action="store_true",
                   help="procedural videos (the only source ported so far)")
    p.add_argument("--device", default="cuda",
                   help="cuda[:i] (default), or cpu")
    return p


@dataclasses.dataclass
class Runner:
    """What the epoch loop needs; ``run_instruct`` fills it with the Owl
    model, its training config and the instruct tokenizer."""
    args: Any
    cfg: Any  # RunConfig here; config.InstructTrainConfig for instruct
    device: torch.device
    model: Any
    tokenizer: Any
    state: TrainState
    schedule: Callable[[int], float]
    loader: Loader
    history: List[Dict[str, float]] = dataclasses.field(default_factory=list)


def build_loader(args, cfg: RunConfig) -> Loader:
    if not args.synthetic_data:
        raise NotImplementedError("only --synthetic_data is ported yet")
    ds = SyntheticVideoDataset(length=cfg.get("synthetic_length", 64),
                               num_frames=cfg.num_frames, size=cfg.image_res)
    return Loader(ds, cfg.batch_size, seed=args.seed)


def setup(args) -> Runner:
    """Config, loader, the model on the device (``jax_init``), the
    trainable/frozen split (frozen leaves in bf16 unless --fp32) and the
    optimizer, whose schedule spans ``min(len(loader), max_steps)``
    updates per epoch.
    Raises when the requested device is absent: nothing falls back to the
    CPU."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is visible")
    cfg = load_config(args.config)
    loader = build_loader(args, cfg)
    niter = len(loader) if args.max_steps <= 0 else min(len(loader),
                                                        args.max_steps)
    cfg.optimizer = dataclasses.replace(cfg.optimizer,
                                        niter_per_ep=max(niter, 1))
    policy = FP32_POLICY if args.fp32 else DEFAULT_POLICY
    with device:
        model = MPLUGVideo(cfg.model, policy)
    jax_init(model, args.seed)  # the JAX runner's model.init rules
    state, _, schedule = create_train_state(
        model, cfg.optimizer,
        frozen_dtype=None if args.fp32 else policy.compute_dtype)
    os.makedirs(args.output_dir, exist_ok=True)
    print("checkpoints, resume, TensorBoard and profiling are not ported "
          "yet: this run saves no weights", flush=True)
    return Runner(args=args, cfg=cfg, device=device, model=model.train(),
                  tokenizer=BatchTokenizer(
                      load_tokenizer(cfg.get("text_decoder", ""),
                                     cfg.model.text.vocab_size),
                      max_length=cfg.max_length), state=state,
                  schedule=schedule, loader=loader)


def make_batch(runner: Runner, raw) -> Dict[str, torch.Tensor]:
    text = runner.tokenizer(raw["text"])
    dev = runner.device
    return {"video": torch.from_numpy(raw["video"]).to(dev),
            "input_ids": torch.from_numpy(text["input_ids"]).long().to(dev),
            "attention_mask": torch.from_numpy(
                text["attention_mask"]).to(dev)}


def make_loss_fn(model: MPLUGVideo):
    def loss_fn(batch):
        video = normalize_clip(batch["video"],
                               dtype=model.policy.compute_dtype)
        return model.pretrain_loss(video, batch["input_ids"],
                                   batch["attention_mask"])
    return loss_fn


def build_train_step(runner: Runner):
    return make_train_step(make_loss_fn(runner.model),
                           update_freq=runner.cfg.update_freq)


def train_one_epoch(runner: Runner, train_step, epoch: int,
                    make_batch: Callable = make_batch
                    ) -> List[Dict[str, float]]:
    """One pass over the loader (at most --max_steps batches), each raw
    batch turned into the loss's inputs by ``make_batch(runner, raw)``.
    Prints every ``--log_freq``-th step's metrics (every step by default)
    and returns each step's, with ``lr`` (the schedule at the step
    counter, as the JAX loop logs it) and ``step_time`` (host seconds,
    batch upload included, ending in a device sync)."""
    args = runner.args
    log_freq = max(getattr(args, "log_freq", 1), 1)
    runner.loader.set_epoch(epoch)
    history = []
    for it, raw in enumerate(runner.loader):
        if 0 < args.max_steps <= it:
            break
        t0 = time.perf_counter()
        batch = make_batch(runner, raw)
        metrics = train_step(runner.state, batch)
        if runner.device.type == "cuda":
            torch.cuda.synchronize(runner.device)
        metrics["step_time"] = time.perf_counter() - t0
        metrics["lr"] = runner.schedule(runner.state.step)
        history.append(metrics)
        if (it + 1) % log_freq == 0:
            print(f"Epoch [{epoch}] step {runner.state.step}: "
                  + json.dumps({k: round(v, 6)
                                for k, v in metrics.items()}), flush=True)
        if metrics["skipped_nonfinite"] > 0:
            print(f"===== non-finite loss at step {runner.state.step} "
                  f"=====", flush=True)
    return history


def write_log(args, entry: dict):
    with open(os.path.join(args.output_dir, "log.txt"), "a") as f:
        f.write(json.dumps(entry, ensure_ascii=False) + "\n")


def train_epochs(runner: Runner, train_step,
                 make_batch: Callable = make_batch) -> Runner:
    """Every epoch of ``runner.cfg.epochs``, each ending in one
    ``log.txt`` line of its step means."""
    for epoch in range(runner.cfg.epochs):
        t0 = time.time()
        history = train_one_epoch(runner, train_step, epoch, make_batch)
        runner.history.extend(history)
        means = {k: float(np.mean([h[k] for h in history]))
                 for k in (history[0] if history else {})}
        write_log(runner.args, {"epoch": epoch, **means,
                                "epoch_time": time.time() - t0})
    return runner


def main(args) -> Runner:
    runner = setup(args)
    return train_epochs(runner, build_train_step(runner))


if __name__ == "__main__":
    main(base_parser().parse_args())
