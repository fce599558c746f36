"""What the training CLIs share: the parser, setup, resume, the epoch
loop with its non-finite watchdog, checkpoints and the log.

Counterpart of ``youku_mplug_tpu/cli/common.py``.  ``run_pretrain``,
``run_caption``, ``run_cls``, ``run_retrieval``, ``run_retrieval_itm``
and ``run_instruct --train`` train under the YAML's (data, model) split,
one
process a rank under ``python -m torch.distributed.run`` (``init_mesh``:
``--dist_backend``, NCCL on the card by default, gloo for several ranks
on one card or on CPU processes): ``setup`` cuts the model with
``parallel/sharding.shard_params`` and JAX's GPT-3 rules after the
imports and before the train state (JAX ``cli/common.py:127-138``), the
train loader gives each data rank its contiguous block of every global
batch (``put_batch``: JAX's data sharding), the step equals the (1,1)
step on the global batch, dropout included (``train/trainer.py``: the
step's generator is the same on every rank, and every mask is drawn at
the global array's shape, each rank keeping its block,
``ops/attention.py``), checkpoints hold the
unsharded tree and restore at any split (``train/checkpoint.py``), and
only rank 0 writes the config, the log and the prints (``run_instruct``
does the same with the Owl model, JAX's Bloom rules and its own
loader).  The BERT family's training CLIs (``run_mplug_pretrain``,
``run_mplug_downstream``, ``run_alpro``) refuse a training mesh
(``refuse_training_mesh``, ROADMAP Queue 1 item 8).  The evaluations
run on the model shards over their data rank's stride of the split
(``eval_loader``).  Every CLI's ``main`` is ``run_main``: it shuts down
the process group it joined, and ``finish`` has rank 0 write the last
log line.  ``serve`` runs under a (data, model) split,
and the host merges here
(``gather_eval_rows``, ``sum_across_hosts``, ``collect_records``) are
JAX's over the mesh's gloo host group: each data rank's contribution
once (its model-index-0 rank's), in data order, every rank left with
the same merged result.  ``setup`` builds the model on the device with the JAX
``model.init`` rules (``bridge.jax_init``), the leaves the run freezes in
bf16 from the start unless ``--fp32`` (``build_train_model``: the values
the fp32 draw rounded to bf16 gives, without an fp32 copy of the frozen
decoder, 52 GB at the GPT-3 13B's), imports the checkpoints the
config's ``import_torch_weights`` names (``models/importers.import_all``;
before the split, so a frozen leaf is rounded once, from the file's dtype
to bf16), splits the trainable and
frozen leaves (frozen ones in bf16 unless ``--fp32``), makes the YAML's
optimizer (AdamW, or a zoo name through ``optim/factory.py``) with a
schedule over ``min(len(loader), --max_steps)`` updates per epoch, and
resumes: from ``--resume <dir>`` when given, else from the run's own
``<output_dir>/checkpoints``.  A checkpoint whose vision embeddings have
another size (another image size or frame count) loads with them
interpolated and the optimizer fresh (``restore_with_resize``); any other
mismatch raises.  ``train_one_epoch`` runs the train step on each batch,
logs each step's metrics, and after 3 non-finite steps in a row restores
the second-latest checkpoint.  ``save_epoch`` saves each
``--save_ckpt_freq`` epochs (in the background after a host snapshot
under the YAML's ``async_checkpointing``) and ``write_log`` appends a
JSON line to ``<output_dir>/log.txt``.  ``--device cuda`` (the default) without a
visible card raises: nothing falls back to the CPU; under
``torch.distributed.run`` it means ``cuda:$LOCAL_RANK``.
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
import torch.distributed as dist

from youku_mplug_tpu_torch.bridge import jax_init, jax_path
from youku_mplug_tpu_torch.config import RunConfig, dump_config
from youku_mplug_tpu_torch.data.loader import Loader
from youku_mplug_tpu_torch.models import importers
from youku_mplug_tpu_torch.models.tasks import MPLUGVideo
from youku_mplug_tpu_torch.optim.factory import freeze_mask
from youku_mplug_tpu_torch.models.tokenizer import (
    BatchTokenizer,
    load_tokenizer,
)
from youku_mplug_tpu_torch.parallel.sharding import (
    GPT3_SHARDING_RULES,
    shard_params,
)
from youku_mplug_tpu_torch.runtime.mesh import (
    Mesh,
    MeshConfig,
    distributed_init,
    distributed_shutdown,
    local_batch_size,
    local_rank,
    make_mesh,
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
                   help="procedural clips in place of the YAML's annotation "
                        "files and video root")
    p.add_argument("--save_ckpt_freq", type=int, default=1)
    p.add_argument("--auto_resume_iter", action="store_true", default=True,
                   help="roll back after 3 non-finite steps in a row")
    p.add_argument("--log_freq", type=int, default=1,
                   help="print every n-th step's metrics")
    p.add_argument("--device", default="cuda",
                   help="cuda[:i] (default), or cpu")
    p.add_argument("--dist_backend", choices=("nccl", "gloo"), default=None,
                   help="under torch.distributed.run: nccl (the default on "
                        "the card; one rank a card) or gloo (several ranks "
                        "on one card, or CPU processes; the CPU default)")
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
    mesh: Optional[Mesh] = None  # the training split (init_mesh)
    history: List[Dict[str, float]] = dataclasses.field(default_factory=list)


def device_of(args) -> torch.device:
    """``--device``; plain ``cuda`` under ``torch.distributed.run`` is the
    rank's ``cuda:$LOCAL_RANK``.  Raises when it names a card that is not
    there (several ranks on one card name it: ``cuda:0``)."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is visible")
    if device.type == "cuda" and device.index is None \
            and local_rank() is not None:
        device = torch.device("cuda", local_rank())
    if device.type == "cuda" and device.index is not None \
            and device.index >= torch.cuda.device_count():
        raise RuntimeError(f"--device {device}: {torch.cuda.device_count()} "
                           f"CUDA device(s) visible; name one (cuda:0) to "
                           f"put several gloo ranks on a card")
    return device


def decode_kwargs(cfg) -> dict:
    """The decode options every file-backed dataset takes from the YAML:
    ``decode_short_side`` (default 0, off) resizes frames to that short
    side while decoding, so the transforms work on small frames."""
    return {"decode_short_side": int(cfg.get("decode_short_side", 0))}


def make_loader(args, cfg: RunConfig, dataset, shuffle: bool = True,
                batch_size: Optional[int] = None,
                drop_last: bool = True, mesh: Optional[Mesh] = None,
                block: Optional[Mesh] = None) -> Loader:
    """A loader of ``batch_size`` (default the YAML's) in the JAX runners'
    order: files decode on the YAML's ``num_workers`` (``workers_impl``:
    threads, or forked processes), synthetic clips in the consumer's
    thread; with a ``mesh``, this rank's data shard (serving's and the
    evaluations' contract: a stride of the dataset); with ``block``
    (training's), this data rank's contiguous block of every global
    batch, so that the data ranks' rows at step k are the (1,1) run's
    batch k (``put_batch``), and under ``update_freq`` > 1 its block of
    each micro-batch, so that the step's micro-batch u is the (1,1)
    step's."""
    return Loader(dataset, batch_size or cfg.batch_size, seed=args.seed,
                  shuffle=shuffle, drop_last=drop_last,
                  num_workers=0 if args.synthetic_data else cfg.num_workers,
                  workers_impl=cfg.get("workers_impl", "thread"),
                  shard_index=mesh.data_index if mesh else 0,
                  shard_count=mesh.data if mesh else 1,
                  block_index=block.data_index if block else 0,
                  block_count=block.data if block else 1,
                  micro_count=cfg.update_freq
                  if block and block.data > 1 else 1)


def eval_loader(args, cfg: RunConfig, dataset, mesh: Optional[Mesh],
                batch_size: Optional[int] = None,
                drop_last: bool = True) -> Loader:
    """An evaluation's loader (``run_caption``'s, ``run_cls``'s,
    ``run_retrieval``'s): in order, this data rank's stride of the
    dataset at its share of ``batch_size`` (default the YAML's) a batch
    (``local_batch_size``), so that the data ranks read the unsplit run's
    clips wherever the data degree divides the batch."""
    batch_size = batch_size or cfg.batch_size
    return make_loader(args, cfg, dataset, shuffle=False,
                       drop_last=drop_last, mesh=mesh,
                       batch_size=local_batch_size(batch_size, mesh)
                       if mesh else batch_size)


def run_main(body: Callable[[], Any]) -> Any:
    """A CLI's ``main``: ``body()``, then the process group shut down
    if ``body`` joined it (``init_mesh``); a caller's group (a test's, a
    harness's) stays up."""
    owned = not dist.is_initialized()
    try:
        return body()
    finally:
        if owned:
            distributed_shutdown()


def finish(runner: "Runner", entry: dict):
    """A run's end: rank 0 writes ``entry`` to ``log.txt``, and every
    rank closes its checkpoints."""
    if main_rank(runner):
        write_log(runner.args, entry)
    runner.ckpt.close()


def init_mesh(args, mesh_cfg: Optional[MeshConfig]) -> Mesh:
    """Join the run's process group (under ``torch.distributed.run``;
    ``--dist_backend``) and build the YAML's training mesh (``mesh_cfg``,
    ``config.mesh_config``'s); (1, 1) in one process.  Call before the
    loaders: the train loader reads the rank's block of each batch."""
    device = device_of(args)
    backend = getattr(args, "dist_backend", None) or (
        "nccl" if device.type == "cuda" else "gloo")
    distributed_init(backend, device=device)
    return make_mesh(mesh_cfg)


def main_rank(runner: "Runner") -> bool:
    """Whether this rank writes the run's files and prints (rank 0)."""
    return runner.mesh is None or runner.mesh.rank == 0


def refuse_training_mesh(mesh_cfg) -> Mesh:
    """A runner without a training mesh (the BERT family's): raise under
    any split, a launch of more than one process or a process group;
    else the (1, 1) mesh of ``mesh_cfg`` (whose resolve raises for a
    split in one process)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    mesh = make_mesh(mesh_cfg) if world == 1 and \
        not dist.is_initialized() else None
    if mesh is None or mesh.size > 1:
        raise NotImplementedError(
            "a training mesh: run_pretrain, run_caption, run_cls, "
            "run_retrieval, run_retrieval_itm and run_instruct train under "
            "a (data, model) split; this runner's split is not ported "
            "(ROADMAP Queue 1 item 8)")
    return mesh


def build_tokenizer(cfg: RunConfig) -> BatchTokenizer:
    return BatchTokenizer(load_tokenizer(cfg.get("text_decoder", ""),
                                         cfg.model.text.vocab_size),
                          max_length=cfg.max_length)


def build_train_model(cfg: RunConfig, policy, device, *,
                      proj_heads: bool = False,
                      frozen_dtype: Optional[torch.dtype] = None
                      ) -> torch.nn.Module:
    """``MPLUGVideo(cfg.model, policy)`` on ``device``, its parameters
    uninitialized, the leaves ``cfg.optimizer`` freezes
    (``optim/factory.freeze_mask``: the text decoder, with ``freeze_vit``
    the vision backbone) already in ``frozen_dtype`` (default: the
    policy's ``param_dtype``): the model is built on ``meta`` and each
    parameter materialized in its final dtype, so no fp32 copy of a
    frozen leaf is ever allocated (as JAX's compile of the 13B step
    builds its frozen tree in bf16, ``tools/compile_13b.py``).
    ``create_train_state`` later finds those leaves in ``frozen_dtype``
    and casts nothing; an init that draws in fp32 and copies (``jax_init``,
    ``seeded_init``) gives the values a cast after an fp32 build would."""
    frozen_dtype = frozen_dtype or policy.param_dtype
    with torch.device("meta"):
        model = MPLUGVideo(cfg.model, policy, proj_heads=proj_heads)
    frozen = freeze_mask({jax_path(n): p for n, p in model.named_parameters()},
                         cfg.optimizer.freeze_text_decoder,
                         cfg.optimizer.freeze_vit)
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        dtype = (frozen_dtype if frozen[jax_path(name)]
                 and p.is_floating_point() else p.dtype)
        owner = model.get_submodule(owner)
        owner._parameters[leaf] = torch.nn.Parameter(
            torch.empty(p.shape, dtype=dtype, device=device),
            requires_grad=p.requires_grad)
    return model


def setup(args, cfg: RunConfig, loader: Loader,
          proj_heads: bool = False,
          model_fn: Optional[Callable[[Any], torch.nn.Module]] = None,
          tokenizer: Optional[BatchTokenizer] = None,
          resume: bool = True, mesh: Optional[Mesh] = None) -> Runner:
    """The model, its train state, checkpoints and the resume (see the
    module docstring); ``loader`` is the training loader, ``proj_heads``
    the model's (``MPLUGVideo``).  ``model_fn(policy)`` builds another
    model (the BERT family's ``MPLUG`` / ``ALPRO``) with its
    ``tokenizer``; ``resume=False`` starts fresh whatever the output
    directory holds (JAX's mPLUG pretrain runner never restores).
    ``mesh``: the training split of ``init_mesh``; a runner that passes
    none (the BERT family's) refuses any split."""
    device = device_of(args)
    split = mesh is not None
    mesh = mesh if split else refuse_training_mesh(getattr(cfg, "mesh",
                                                           None))
    niter = len(loader) if args.max_steps <= 0 else min(len(loader),
                                                        args.max_steps)
    cfg.optimizer = dataclasses.replace(cfg.optimizer,
                                        niter_per_ep=max(niter, 1))
    policy = FP32_POLICY if args.fp32 else DEFAULT_POLICY
    if model_fn is not None:
        with device:
            model = model_fn(policy)
    else:
        model = build_train_model(
            cfg, policy, device, proj_heads=proj_heads,
            frozen_dtype=None if args.fp32 else policy.compute_dtype)
    jax_init(model, args.seed)  # the JAX runner's model.init rules
    if cfg.get("import_torch_weights"):
        importers.import_all(model, cfg, cfg.get("import_torch_weights"))
    if split:
        shard_params(model, mesh, GPT3_SHARDING_RULES)
    state, _, schedule = create_train_state(
        model, cfg.optimizer,
        frozen_dtype=None if args.fp32 else policy.compute_dtype)
    main = mesh.rank == 0
    os.makedirs(args.output_dir, exist_ok=True)
    if main:
        dump_config(cfg, args.output_dir)
    ckpt = CheckpointManager(
        os.path.join(args.output_dir, "checkpoints"),
        async_save=bool(cfg.get("async_checkpointing", False)), mesh=mesh)
    tb = TensorboardLogger(os.path.join(args.output_dir, "tb"),
                           enabled=main)
    state, start_epoch = (resume_state(args, ckpt, state) if resume
                          else (state, 0))
    return Runner(args=args, cfg=cfg, device=device, model=model.train(),
                  tokenizer=tokenizer or build_tokenizer(cfg), state=state,
                  schedule=schedule, loader=loader, ckpt=ckpt, tb=tb,
                  start_epoch=start_epoch, mesh=mesh if split else None)


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
        src = CheckpointManager(src_dir, mesh=ckpt.mesh)
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
    if state.mesh is None or state.mesh.rank == 0:
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
            raw = ckpt.restore_raw_for(step, state, map_location="cpu")
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


def host_gather(obj, mesh: Optional[Mesh]) -> list:
    """``obj`` of every data rank (its model-index-0 rank's), in data
    order, on every rank (all-gather over the mesh's gloo host group);
    ``[obj]`` in a process without a process group."""
    if mesh is None or not mesh.distributed:
        if dist.is_initialized():
            raise ValueError("a host merge under a process group needs the "
                             "run's mesh")
        return [obj]
    out = [None] * dist.get_world_size(mesh.host_group)
    dist.all_gather_object(out, (mesh.coord, obj), group=mesh.host_group)
    return [o for (_, model), o in sorted(out, key=lambda t: t[0])
            if model == 0]


def gather_eval_rows(rows: np.ndarray, order: np.ndarray,
                     mesh: Optional[Mesh] = None):
    """Each data rank's evaluation rows with their sample indices, merged
    (JAX's): concatenated in data order, the first occurrence of each
    index kept (the loader wrap-pads, so duplicates are expected), sorted
    by index.  Returns (rows, order)."""
    parts = host_gather((np.asarray(rows), np.asarray(order)), mesh)
    rows = np.concatenate([r for r, _ in parts])
    order = np.concatenate([o for _, o in parts])
    _, first = np.unique(order, return_index=True)
    keep = np.sort(first)
    rows, order = rows[keep], order[keep]
    perm = np.argsort(order)
    return rows[perm], order[perm]


def sum_across_hosts(vec: np.ndarray, mesh: Optional[Mesh] = None
                     ) -> np.ndarray:
    """A small metric vector summed over the data ranks (the reference's
    ``dist.all_reduce`` on evaluation counters); itself in one process."""
    return np.sum(np.stack(host_gather(np.asarray(vec), mesh)), axis=0)


def collect_records(records: List[dict], dedup_key=None,
                    mesh: Optional[Mesh] = None) -> List[dict]:
    """The data ranks' records (captions, answers) merged in data order,
    the first of each ``dedup_key`` kept (the loader's wrap-padding
    duplicates); every rank gets the same list."""
    records = [r for part in host_gather(list(records), mesh)
               for r in part]
    if dedup_key is None:
        return records
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
        if (it + 1) % log_freq == 0 and main_rank(runner):
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
    if history and main_rank(runner):
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
        if main_rank(runner):
            write_log(runner.args,
                      {"epoch": epoch, **means,
                       **{f"val_{k}": v for k, v in val.items()},
                       "epoch_time": time.time() - t0})
    return runner


def put_batch(runner: Runner, arrays: Dict[str, Any]
              ) -> Dict[str, torch.Tensor]:
    """A training batch on the runner's device (JAX ``put_batch``): under
    a data split it must be this data rank's block of the global batch,
    which the train loader cuts (``make_loader(block=)``,
    ``parallel/sharding.data_shard``'s rows, micro-batch by micro-batch
    under ``update_freq``); a batch of any other size raises."""
    mesh = getattr(runner, "mesh", None)
    if mesh is not None and mesh.data > 1:
        rows = len(next(iter(arrays.values())))
        if rows != local_batch_size(runner.cfg.batch_size, mesh):
            raise ValueError(f"a batch of {rows} rows under data="
                             f"{mesh.data}: not a data rank's block of the "
                             f"global {runner.cfg.batch_size}")
    return to_device(runner, arrays)


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
