"""Video-text pretraining CLI (caption LM + optional contrastive).

Counterpart of ``youku_mplug_tpu/cli/run_pretrain.py`` on
``cli/common.py``: fresh weights drawn by the JAX ``model.init`` rules
(``bridge.jax_init``), the clips of the YAML's ``train_file`` (a CSV with
``video_id:FILE`` and ``title`` columns, or a JSON list) under
``train_video_root`` with the train transform, or of each group of
``train_file_groups`` interleaved by ``MetaLoader`` (one loader a group),
decoded on ``num_workers`` threads; or with ``--synthetic_data``
procedural clips; the trainable/frozen split,
the YAML's optimizer (``optimizer.opt``: AdamW or a zoo name), and one
train step per batch; each step prints loss,
loss_caption, grad_norm, lr, skipped_nonfinite and its wall time, each
epoch saves a checkpoint (``--save_ckpt_freq``) under
``<output_dir>/checkpoints`` and appends its averages to
``<output_dir>/log.txt``.  A second run on the same ``--output_dir``
resumes from its latest checkpoint; ``--resume <dir>`` resumes from
another run's.  Profiling is ``cli/profile_train.py``.

Under ``python -m torch.distributed.run`` it trains the YAML's ``mesh:``
(data, model) split, one process a rank (``cli/common.py``): each data
rank reads its block of every global batch, the model ranks hold their
heads, MLP columns and vocab rows, and every step is the one an unsplit
run takes on the same global batch; the checkpoint is the unsharded one,
so a run saved at one split resumes at another.  ``--dist_backend nccl``
(the default on the card) wants one card a rank; ``gloo`` runs several
ranks on one card (``--device cuda:0``) or on CPU processes (``--device
cpu``).

Usage (GPU):
    python -m youku_mplug_tpu_torch.cli.run_pretrain \
        --config configs/pretrain/pretrain_gpt3_1.3B_flagship.yaml \
        --output_dir out --synthetic_data --max_steps 7 --device cuda
    python -m youku_mplug_tpu_torch.cli.run_pretrain \
        --config <a pretrain YAML whose train_file and train_video_root
                  name your files> --output_dir out --max_steps 7
    # a YAML with mesh: {data: 2, model: 2}: four ranks on CPU processes
    python -m torch.distributed.run --standalone --nproc_per_node=4 \
        -m youku_mplug_tpu_torch.cli.run_pretrain --config <that YAML> \
        --output_dir out --synthetic_data --device cpu --fp32
"""

from __future__ import annotations

from typing import Dict

import torch

from youku_mplug_tpu_torch.cli import common
from youku_mplug_tpu_torch.config import RunConfig, load_config
from youku_mplug_tpu_torch.data.datasets import (
    PretrainVideoDataset,
    SyntheticVideoDataset,
)
from youku_mplug_tpu_torch.data.loader import MetaLoader
from youku_mplug_tpu_torch.data.transforms import train_transform
from youku_mplug_tpu_torch.models.tasks import MPLUGVideo
from youku_mplug_tpu_torch.ops.preprocess import normalize_clip
from youku_mplug_tpu_torch.train.trainer import make_train_step


def base_parser(description: str = "mPLUG-Video pretraining (PyTorch)"):
    return common.base_parser(description)


def build_loader(args, cfg: RunConfig, mesh=None):
    """The training loader (JAX ``build_loader``): synthetic clips, the
    ``train_file``, or ``train_file_groups`` through ``MetaLoader``; with
    a ``mesh``, this data rank's block of every global batch."""
    if args.synthetic_data:
        ds = SyntheticVideoDataset(length=cfg.get("synthetic_length", 64),
                                   num_frames=cfg.num_frames,
                                   size=cfg.image_res)
        return common.make_loader(args, cfg, ds, block=mesh)

    def loader(ann_file):
        return common.make_loader(args, cfg, PretrainVideoDataset(
            ann_file, cfg.get("train_video_root"),
            transform=train_transform(cfg.image_res),
            num_frames=cfg.num_frames, seed=args.seed,
            **common.decode_kwargs(cfg)), block=mesh)
    groups = cfg.get("train_file_groups")
    if groups:
        return _MetaLoaderAdapter(MetaLoader([loader(g) for g in groups],
                                             seed=args.seed))
    return loader(cfg.get("train_file"))


class _MetaLoaderAdapter:
    """``MetaLoader``'s batches without their source index (the pretrain
    loss is the same for every source)."""

    def __init__(self, meta: MetaLoader):
        self.meta = meta

    def set_epoch(self, epoch):
        self.meta.set_epoch(epoch)

    def __len__(self):
        return len(self.meta)

    def __iter__(self):
        for _, batch in self.meta:
            yield batch


def setup(args) -> common.Runner:
    """Config, the mesh (``common.init_mesh``), loader and
    ``common.setup`` (the model on the device, cut to this rank's shard,
    the train state, checkpoints and the resume).  Raises when the
    requested device is absent: nothing falls back to the CPU."""
    cfg = load_config(args.config)
    mesh = common.init_mesh(args, cfg.mesh)
    return common.setup(args, cfg, build_loader(args, cfg, mesh), mesh=mesh)


def make_batch(runner: common.Runner, raw) -> Dict[str, torch.Tensor]:
    text = runner.tokenizer(raw["text"])
    return common.put_batch(runner, {"video": raw["video"], **text})


def make_loss_fn(model: MPLUGVideo):
    def loss_fn(batch, generator=None):
        video = normalize_clip(batch["video"],
                               dtype=model.policy.compute_dtype)
        return model.pretrain_loss(video, batch["input_ids"],
                                   batch["attention_mask"],
                                   generator=generator)
    return loss_fn


def build_train_step(runner: common.Runner):
    return make_train_step(make_loss_fn(runner.model),
                           update_freq=runner.cfg.update_freq,
                           dropout_seed=runner.args.seed)


def main(args) -> common.Runner:
    def body():
        runner = setup(args)
        common.train_epochs(runner, build_train_step(runner), make_batch)
        runner.ckpt.close()
        return runner
    return common.run_main(body)


if __name__ == "__main__":
    main(base_parser().parse_args())
