"""Video-text pretraining CLI (caption LM + optional contrastive).

Counterpart of ``youku_mplug_tpu/cli/run_pretrain.py`` on
``cli/common.py``: fresh weights drawn by the JAX ``model.init`` rules
(``bridge.jax_init``), synthetic clips, the trainable/frozen split,
AdamW, and one train step per batch; each step prints loss,
loss_caption, grad_norm, lr, skipped_nonfinite and its wall time, each
epoch saves a checkpoint (``--save_ckpt_freq``) under
``<output_dir>/checkpoints`` and appends its averages to
``<output_dir>/log.txt``.  A second run on the same ``--output_dir``
resumes from its latest checkpoint; ``--resume <dir>`` resumes from
another run's.  Profiling is ``cli/profile_train.py``.

Usage (GPU):
    python -m youku_mplug_tpu_torch.cli.run_pretrain \
        --config configs/pretrain/pretrain_gpt3_1.3B_flagship.yaml \
        --output_dir out --synthetic_data --max_steps 7 --device cuda
"""

from __future__ import annotations

from typing import Dict

import torch

from youku_mplug_tpu_torch.cli import common
from youku_mplug_tpu_torch.config import RunConfig, load_config
from youku_mplug_tpu_torch.data.datasets import SyntheticVideoDataset
from youku_mplug_tpu_torch.data.loader import Loader
from youku_mplug_tpu_torch.models.tasks import MPLUGVideo
from youku_mplug_tpu_torch.ops.preprocess import normalize_clip
from youku_mplug_tpu_torch.train.trainer import make_train_step


def base_parser(description: str = "mPLUG-Video pretraining (PyTorch)"):
    return common.base_parser(description)


def build_loader(args, cfg: RunConfig) -> Loader:
    if not args.synthetic_data:
        raise NotImplementedError("only --synthetic_data is ported yet")
    ds = SyntheticVideoDataset(length=cfg.get("synthetic_length", 64),
                               num_frames=cfg.num_frames, size=cfg.image_res)
    return Loader(ds, cfg.batch_size, seed=args.seed)


def setup(args) -> common.Runner:
    """Config, loader and ``common.setup`` (the model on the device, the
    train state, checkpoints and the resume).  Raises when the requested
    device is absent: nothing falls back to the CPU."""
    cfg = load_config(args.config)
    return common.setup(args, cfg, build_loader(args, cfg))


def make_batch(runner: common.Runner, raw) -> Dict[str, torch.Tensor]:
    text = runner.tokenizer(raw["text"])
    return common.to_device(runner, {"video": raw["video"], **text})


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
    runner = setup(args)
    return common.train_epochs(runner, build_train_step(runner), make_batch)


if __name__ == "__main__":
    main(base_parser().parse_args())
