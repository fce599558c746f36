"""ALPRO CLI: ``--task {pretrain, retrieval, cls}`` on the split-BERT
family.

Counterpart of ``youku_mplug_tpu/cli/run_alpro.py`` on ``cli/common.py``.
The model is ``models/alpro.ALPRO`` (the YAML's vision tower, the BERT of
``bert_config`` with ``bert_overrides``, ``embed_dim``, ``temp``,
``mlm_probability``, ``num_classes``), drawn by the JAX ``model.init``
rules, every leaf trainable.  Training, one train step per batch (the
dropout masks and the hard negatives from the step's generator):

- pretrain: ``pretrain_loss`` (ITA, ITM, MLM; the MLM masks from a
  generator seeded by (``--seed``, step)), no evaluation (``log.txt``
  gets ``{"done": step}``);
- retrieval: ``retrieval_loss``; evaluation as ``run_mplug_downstream``'s
  (the L2-normalized projected cls features of the whole test split,
  ``itm_eval``);
- cls: ``cls_forward``; evaluation top-1 / top-5 of the head.

Checkpoints, resume, ``--evaluate_only``, the logs and the datasets
(pretrain: ``train_file`` under ``train_video_root``, else
``video_root``, and no test split) are ``run_mplug_downstream``'s.

Usage (the card is the default device):
    python -m youku_mplug_tpu_torch.cli.run_alpro \\
        --config configs/alpro/alpro_vitb16_zh.yaml --task pretrain \\
        --synthetic_data --max_steps 2 --output_dir out
"""

from __future__ import annotations

import json
from typing import Dict


from youku_mplug_tpu_torch.cli import common
from youku_mplug_tpu_torch.cli import run_mplug_downstream as downstream
from youku_mplug_tpu_torch.config import RunConfig
from youku_mplug_tpu_torch.data.datasets import PretrainVideoDataset
from youku_mplug_tpu_torch.data.transforms import train_transform
from youku_mplug_tpu_torch.models.alpro import ALPRO, ALPROConfig
from youku_mplug_tpu_torch.models.mplug import mlm_mask_tokens
from youku_mplug_tpu_torch.train.trainer import (
    dropout_generator,
    make_train_step,
)


def parser():
    p = common.base_parser("ALPRO split-BERT video-text (PyTorch)")
    p.add_argument("--task", choices=("pretrain", "retrieval", "cls"),
                   default="pretrain")
    return p


def build_model_cfg(cfg: RunConfig) -> ALPROConfig:
    return ALPROConfig(
        vision=cfg.model.vision, bert=cfg.bert,
        embed_dim=int(cfg.get("embed_dim", 256)),
        temp=float(cfg.get("temp", 0.07)),
        mlm_probability=float(cfg.get("mlm_probability", 0.15)),
        num_classes=int(cfg.get("num_classes", 0)))


def build_dataset(args, cfg: RunConfig, train: bool):
    """The task's split (``run_mplug_downstream``'s); a file-backed
    pretrain run trains on ``train_file`` under ``train_video_root``
    (else ``video_root``) and has no test split."""
    if args.synthetic_data or args.task != "pretrain":
        return downstream.build_dataset(args, cfg, train)
    if not train:
        return None
    files = cfg.get("train_file")
    return PretrainVideoDataset(
        files if isinstance(files, list) else [files],
        cfg.get("train_video_root", cfg.get("video_root")),
        transform=train_transform(cfg.image_res),
        num_frames=cfg.num_frames, **common.decode_kwargs(cfg))


def prepare(args):
    """(runner, test split) with the ALPRO model and its tokenizer."""
    return downstream.prepare(args, ALPRO, build_model_cfg, build_dataset)


def make_batch_fn(task: str):
    base = downstream.make_batch_fn(task)

    def make_batch(runner: common.Runner, raw) -> Dict:
        b = base(runner, raw)
        if task == "pretrain":
            model = runner.model
            gen = dropout_generator(runner.args.seed, runner.state.step,
                                    runner.device, stream=1)
            b["mlm_input_ids"], b["mlm_labels"] = mlm_mask_tokens(
                b["input_ids"], b["attention_mask"],
                model.cfg.bert.vocab_size, gen,
                mlm_probability=model.cfg.mlm_probability,
                mask_token_id=runner.tokenizer.tokenizer.mask_id)
        return b
    return make_batch


def make_loss_fn_for(task: str):
    def make_loss_fn(model: ALPRO):
        def loss_fn(batch, generator=None):
            args = (batch["video"], batch["input_ids"],
                    batch["attention_mask"])
            if task == "pretrain":
                return model.pretrain_loss(*args, batch["mlm_input_ids"],
                                           batch["mlm_labels"],
                                           generator=generator,
                                           neg_idx=batch.get("neg_idx"))
            if task == "cls":
                return model.cls_forward(*args, labels=batch["labels"],
                                         generator=generator)
            return model.retrieval_loss(*args, batch["idx"],
                                        generator=generator,
                                        neg_idx=batch.get("neg_idx"))
        return loss_fn
    return make_loss_fn


def build_train_step(runner: common.Runner, task: str):
    return make_train_step(make_loss_fn_for(task)(runner.model),
                           dropout_seed=runner.args.seed)


def main(args):
    runner, test_ds = prepare(args)
    task = args.task
    if not args.evaluate_only:
        common.train_epochs(runner, build_train_step(runner, task),
                            make_batch_fn(task))
    if task == "pretrain":
        common.write_log(args, {"done": runner.state.step})
        return runner, {}
    result = downstream.evaluation(runner, test_ds, task,
                                   runner.model.cfg.num_classes)
    print(f"* ALPRO {task} eval:", json.dumps(result, ensure_ascii=False),
          flush=True)
    common.write_log(args, {"test": result})
    return runner, result


if __name__ == "__main__":
    main(parser().parse_args())
