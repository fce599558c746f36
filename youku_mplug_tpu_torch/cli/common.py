"""What the training CLIs share: the parser, setup, resume, the epoch
loop with its non-finite watchdog, checkpoints and the log.

Counterpart of ``youku_mplug_tpu/cli/common.py`` on one process and one
device.  ``setup`` builds the model on the device with the JAX
``model.init`` rules (``bridge.jax_init``), imports the checkpoints the
config's ``import_torch_weights`` names (``models/importers.import_all``;
before the split, so a frozen leaf is rounded once, from the file's dtype
to bf16), splits the trainable and
frozen leaves (frozen ones in bf16 unless ``--fp32``), makes AdamW with a
schedule over ``min(len(loader), --max_steps)`` updates per epoch, and
resumes: from ``--resume <dir>`` when given, else from the run's own
``<output_dir>/checkpoints``.  A checkpoint whose vision embeddings have
another size (another image size or frame count) loads with them
interpolated and the optimizer fresh (``restore_with_resize``); any other
mismatch raises.  ``train_one_epoch`` runs the train step on each batch,
logs each step's metrics, and after 3 non-finite steps in a row restores
the second-latest checkpoint.  ``save_epoch`` saves each
``--save_ckpt_freq`` epochs and ``write_log`` appends a JSON line to
``<output_dir>/log.txt``.  ``--device cuda`` (the default) without a
visible card raises: nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from youku_mplug_tpu_torch.bridge import jax_init
from youku_mplug_tpu_torch.config import RunConfig, dump_config
from youku_mplug_tpu_torch.data.loader import Loader
from youku_mplug_tpu_torch.models import importers
from youku_mplug_tpu_torch.models.tasks import MPLUGVideo
from youku_mplug_tpu_torch.models.tokenizer import (
    BatchTokenizer,
    load_tokenizer,
)
from youku_mplug_tpu_torch.runtime.precision import (
    DEFAULT_POLICY,
    FP32_POLICY,
)
from youku_mplug_tpu_torch.train.checkpoint import CheckpointManager
from youku_mplug_tpu_torch.train.metrics import (
    MetricLogger,
    TensorboardLogger,
)
from youku_mplug_tpu_torch.train.state import TrainState, create_train_state

NAN_ROLLBACK_STREAK = 3  # non-finite steps in a row before a rollback


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", required=True)
    p.add_argument("--output_dir", default="./output")
    p.add_argument("--resume", default="",
                   help="run (or checkpoints) directory to resume from")
    p.add_argument("--evaluate_only", action="store_true")
    p.add_argument("--seed", type=int, default=42,
                   help="seed of the weight init and the data order")
    p.add_argument("--bf16", action="store_true", default=True,
                   help="bf16 compute (the default; --fp32 turns it off)")
    p.add_argument("--fp32", action="store_true",
                   help="full fp32 (CPU tests)")
    p.add_argument("--max_steps", type=int, default=-1,
                   help="cap steps (and evaluation batches) per epoch")
    p.add_argument("--synthetic_data", action="store_true",
                   help="procedural videos (the only source ported so far)")
    p.add_argument("--save_ckpt_freq", type=int, default=1)
    p.add_argument("--auto_resume_iter", action="store_true", default=True,
                   help="roll back after 3 non-finite steps in a row")
    p.add_argument("--log_freq", type=int, default=1,
                   help="print every n-th step's metrics")
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
    ckpt: Optional[CheckpointManager] = None
    tb: Optional[TensorboardLogger] = None
    start_epoch: int = 0
    history: List[Dict[str, float]] = dataclasses.field(default_factory=list)


def device_of(args) -> torch.device:
    """``--device``; raises when it names a card that is not there."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is visible")
    return device


def build_tokenizer(cfg: RunConfig) -> BatchTokenizer:
    return BatchTokenizer(load_tokenizer(cfg.get("text_decoder", ""),
                                         cfg.model.text.vocab_size),
                          max_length=cfg.max_length)


def setup(args, cfg: RunConfig, loader: Loader,
          proj_heads: bool = False) -> Runner:
    """The model, its train state, checkpoints and the resume (see the
    module docstring); ``loader`` is the training loader, ``proj_heads``
    the model's (``MPLUGVideo``)."""
    device = device_of(args)
    niter = len(loader) if args.max_steps <= 0 else min(len(loader),
                                                        args.max_steps)
    cfg.optimizer = dataclasses.replace(cfg.optimizer,
                                        niter_per_ep=max(niter, 1))
    policy = FP32_POLICY if args.fp32 else DEFAULT_POLICY
    with device:
        model = MPLUGVideo(cfg.model, policy, proj_heads=proj_heads)
    jax_init(model, args.seed)  # the JAX runner's model.init rules
    if cfg.get("import_torch_weights"):
        importers.import_all(model, cfg, cfg.get("import_torch_weights"))
    state, _, schedule = create_train_state(
        model, cfg.optimizer,
        frozen_dtype=None if args.fp32 else policy.compute_dtype)
    os.makedirs(args.output_dir, exist_ok=True)
    dump_config(cfg, args.output_dir)
    ckpt = CheckpointManager(
        os.path.join(args.output_dir, "checkpoints"),
        async_save=bool(cfg.get("async_checkpointing", False)))
    tb = TensorboardLogger(os.path.join(args.output_dir, "tb"))
    state, start_epoch = resume_state(args, ckpt, state)
    return Runner(args=args, cfg=cfg, device=device, model=model.train(),
                  tokenizer=build_tokenizer(cfg), state=state,
                  schedule=schedule, loader=loader, ckpt=ckpt, tb=tb,
                  start_epoch=start_epoch)


def resume_state(args, ckpt: CheckpointManager, state):
    """``--resume <dir>`` (a run directory or its ``checkpoints``) when it
    names another directory than ``--output_dir``, else the run's own
    checkpoints: restore the latest step.  ``--resume`` or
    ``--evaluate_only`` with no checkpoint found raises.  Returns (state,
    start epoch from the checkpoint's metadata)."""
    src = ckpt
    if args.resume and os.path.abspath(args.resume) != os.path.abspath(
            args.output_dir):
        src_dir = os.path.join(args.resume, "checkpoints")
        if not os.path.isdir(src_dir):
            src_dir = args.resume  # already a checkpoints directory
        src = CheckpointManager(src_dir)
    step = src.latest_step()
    if (args.resume or getattr(args, "evaluate_only", False)) \
            and step is None:
        raise FileNotFoundError(
            f"--resume/--evaluate_only set but no checkpoint found under "
            f"{src.directory}")
    if step is None:
        return state, 0
    state = restore_with_resize(src, step, state)
    start_epoch = int((src.restore_metadata(step) or {}).get("epoch", 0))
    print(f"resumed from step {step} (epoch {start_epoch})", flush=True)
    return state, start_epoch


def _resize_params(raw: Dict[str, torch.Tensor],
                   tmpl: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A checkpoint's leaves (JAX path -> tensor) at the template's
    shapes: ``pos_embed`` and ``temporal_embed`` interpolated where their
    shapes differ; any other difference raises ValueError."""
    if set(raw) != set(tmpl):
        raise ValueError(f"checkpoint/model leaves differ: "
                         f"{sorted(set(raw) ^ set(tmpl))[:8]}")
    out = {}
    for path, v in raw.items():
        shape = tuple(tmpl[path].shape)
        if tuple(v.shape) != shape:
            leaf = path.rsplit("/", 1)[-1]
            a = v.float().numpy()
            if leaf == "pos_embed":
                a = importers.resize_pos_embed(a, shape[1] - 1)
            elif leaf == "temporal_embed":
                a = importers.resize_temporal_embed(a, shape[1])
            else:
                raise ValueError(f"checkpoint/model shape mismatch at "
                                 f"{path}: {tuple(v.shape)} vs {shape}")
            print(f"resume: interpolated {path} -> {a.shape}", flush=True)
            v = torch.from_numpy(np.ascontiguousarray(a))
        out[path] = v
    return out


def restore_with_resize(ckpt: CheckpointManager, step: int,
                        state: TrainState) -> TrainState:
    """Exact restore; where it fails, the weights alone with the vision
    embeddings interpolated to the state's shapes and the optimizer left
    fresh (a finetune from a checkpoint at another image size or frame
    count).  A mismatch the interpolation cannot mend raises the exact
    restore's error."""
    try:
        return ckpt.restore(step, state)
    except ValueError as exact_err:
        try:
            raw = ckpt.restore_raw(step, map_location="cpu")
            parts = {part: _resize_params(raw[part], getattr(state, part))
                     for part in ("trainable", "frozen")}
        except ValueError:
            raise exact_err
    with torch.no_grad():
        for part, leaves in parts.items():
            for path, p in getattr(state, part).items():
                p.copy_(leaves[path])
    print("resume: checkpoint shapes differ from config - vision embeds "
          "interpolated, optimizer state reset", flush=True)
    return state


def collect_records(records: List[dict], dedup_key=None) -> List[dict]:
    """The evaluation's records, with the first of each ``dedup_key``
    kept (one process: nothing to gather)."""
    if dedup_key is None:
        return list(records)
    seen, out = set(), []
    for r in records:
        if r[dedup_key] not in seen:
            seen.add(r[dedup_key])
            out.append(r)
    return out


def train_one_epoch(runner: Runner, train_step, epoch: int,
                    make_batch: Callable) -> List[Dict[str, float]]:
    """One pass over the loader (at most --max_steps batches), each raw
    batch turned into the loss's inputs by ``make_batch(runner, raw)``.
    Prints every ``--log_freq``-th step's metrics and returns each step's,
    with ``lr`` (the schedule at the step counter) and ``step_time`` (host
    seconds, batch upload included, ending in a device sync).  After
    ``NAN_ROLLBACK_STREAK`` non-finite steps in a row the state is restored
    from the second-latest checkpoint, where there is one."""
    args = runner.args
    log_freq = max(getattr(args, "log_freq", 1), 1)
    runner.loader.set_epoch(epoch)
    logger = MetricLogger()
    history, nan_streak = [], 0
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
        logger.update(**metrics)
        step = runner.state.step
        if (it + 1) % log_freq == 0:
            print(f"Epoch [{epoch}] step {step}: "
                  + json.dumps({k: round(v, 6)
                                for k, v in metrics.items()}), flush=True)
        if metrics["skipped_nonfinite"] > 0:
            nan_streak += 1
            print(f"===== non-finite loss at step {step} (streak "
                  f"{nan_streak}) =====", flush=True)
            if (nan_streak >= NAN_ROLLBACK_STREAK and runner.ckpt is not None
                    and getattr(args, "auto_resume_iter", True)):
                target = runner.ckpt.rollback_step()
                if target is not None:
                    print(f"rolling back to checkpoint step {target}",
                          flush=True)
                    runner.ckpt.restore(target, runner.state)
                    nan_streak = 0
        else:
            nan_streak = 0
        if runner.tb is not None:
            runner.tb.set_step(runner.state.step)
            runner.tb.update(head="loss", **{k: v for k, v in metrics.items()
                                             if "loss" in k})
            runner.tb.update(head="opt", lr=metrics["lr"],
                             grad_norm=metrics["grad_norm"])
            runner.tb.update(head="time", step_time=metrics["step_time"])
    if history:
        print(f"Epoch [{epoch}] {len(history)} steps: {logger}", flush=True)
    return history


def save_epoch(runner: Runner, epoch: int):
    """Save the state at its step each ``--save_ckpt_freq`` epochs, with
    the next epoch to run as metadata."""
    freq = max(getattr(runner.args, "save_ckpt_freq", 1), 1)
    if runner.ckpt is not None and (epoch + 1) % freq == 0:
        runner.ckpt.save(runner.state.step, runner.state,
                         metadata={"epoch": epoch + 1})


def write_log(args, entry: dict):
    with open(os.path.join(args.output_dir, "log.txt"), "a") as f:
        f.write(json.dumps(entry, ensure_ascii=False) + "\n")


def train_epochs(runner: Runner, train_step, make_batch: Callable,
                 validate: Optional[Callable[[Runner], dict]] = None
                 ) -> Runner:
    """The epochs from ``runner.start_epoch`` to ``runner.cfg.epochs``,
    each ending in ``save_epoch`` and one ``log.txt`` line of its step
    means (and, with ``validate``, its metrics as ``val_<name>``)."""
    for epoch in range(runner.start_epoch, runner.cfg.epochs):
        t0 = time.time()
        history = train_one_epoch(runner, train_step, epoch, make_batch)
        runner.history.extend(history)
        save_epoch(runner, epoch)
        means = {k: float(np.mean([h[k] for h in history]))
                 for k in (history[0] if history else {})}
        val = validate(runner) if validate is not None else {}
        write_log(runner.args, {"epoch": epoch, **means,
                                **{f"val_{k}": v for k, v in val.items()},
                                "epoch_time": time.time() - t0})
    return runner


def to_device(runner: Runner, arrays: Dict[str, Any]
              ) -> Dict[str, torch.Tensor]:
    """numpy arrays -> tensors on the runner's device: ``input_ids`` and
    ``prompt_ids`` as int64 (the embeddings' index type), the rest in
    their own dtypes."""
    out = {}
    for k, v in arrays.items():
        t = torch.from_numpy(np.asarray(v))
        if k in ("input_ids", "prompt_ids"):
            t = t.long()
        out[k] = t.to(runner.device)
    return out
