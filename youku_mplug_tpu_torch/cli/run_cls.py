"""Video category prediction CLI: finetune, then the 45-way evaluation.

Counterpart of ``youku_mplug_tpu/cli/run_cls.py`` on ``cli/common.py``.
Each clip's title makes the prompt ``视频标题：{title} 视频类目：`` and
its class name the target: training takes the prefix-LM loss of that
pair plus (``use_cls``) the classifier head's cross-entropy on the title
(``cls_train_loss``), with the decoder's dropout drawn from the step's
generator.  Evaluation scores every clip against every class name
(``cls_eval_scores``: the softmax over the classes of each pair's
sequence log-likelihood, and the head's logits) and reports top-1 and
top-5 accuracy, generative (``gen_*``) and from the head (``cls_*``).
Each epoch saves a checkpoint and evaluates the validation split;
``--evaluate_only --resume <dir>`` only evaluates the test split, and
``--max_steps`` caps the evaluation batches too.

The class names come from ``classname_file`` (``classname.json``: name ->
index), else ``类目<i>``; with ``--synthetic_data`` the first
``num_classes`` (the synthetic labels are index mod ``num_classes``).
One cut of the port, for memory: ``eval_video_batch`` (a YAML key the
JAX cls runner does not read) scores a test batch that many clips a call
(45 x 32 pairs of 208 positions would hold a 61 GB fp32 logits tensor at
the reference's batch 32); unset, a call takes the whole batch, as in
JAX.  The results are the same either way.  The clips and titles come
from the YAML's ``train_file``, ``val_file`` and ``test_file`` under
``video_root`` (``data/datasets.ClsVideoDataset``; a three-column CSV
``video_id:FILE, video_title, category_id`` keeps its title and label,
which JAX's CSV reader drops: ROADMAP.md, Queue 3), decoded on
``num_workers`` threads; or with ``--synthetic_data`` procedural clips.
Under ``python -m torch.distributed.run`` it trains and evaluates under
the YAML's ``mesh:`` split (``cli/common.py``): each data rank reads its
block of every global batch and the step equals the unsplit one on the
global batch, dropout included (the decoder's and the vision tower's
masks are the unsplit run's); the evaluation runs on the model shards
over each data rank's stride of the split, ``local_batch_size`` clips a
batch, its hit counts summed over the data ranks (``sum_across_hosts``,
JAX's merge); rank 0 alone prints and writes.

Usage (the card is the default device; ``--device cpu --fp32`` runs a
tiny config on the CPU), on a copy of
``configs/cls/cls_gpt3_1.3B_youku_v0_sharp_2.yaml`` with
``eval_video_batch: 4`` added (one H100 holds 4 clips x 45 pairs a call):
    python -m youku_mplug_tpu_torch.cli.run_cls --config <that copy> \\
        --synthetic_data --max_steps 2 --output_dir out
and without ``--synthetic_data`` where the copy's ``train_file``,
``val_file``, ``test_file`` and ``video_root`` name your files.  Under a
split, e.g. ``mesh: {data: 2, model: 2}`` in the copy (the shipped
``data: -1`` takes every rank of the launch for data):
    python -m torch.distributed.run --standalone --nproc_per_node=4 \\
        -m youku_mplug_tpu_torch.cli.run_cls --config <that copy> \\
        --synthetic_data --max_steps 2 --output_dir out
one card a rank (NCCL); ``--device cuda:0 --dist_backend gloo`` puts the
ranks on one card, ``--device cpu --fp32`` on CPU processes (gloo).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from youku_mplug_tpu_torch.cli import common
from youku_mplug_tpu_torch.config import RunConfig, load_config
from youku_mplug_tpu_torch.data.datasets import (
    ClsVideoDataset,
    SyntheticVideoDataset,
)
from youku_mplug_tpu_torch.data.loader import Loader
from youku_mplug_tpu_torch.data.transforms import (
    test_transform,
    train_transform,
)
from youku_mplug_tpu_torch.evals.metrics import topk_accuracy
from youku_mplug_tpu_torch.models.tasks import MPLUGVideo
from youku_mplug_tpu_torch.ops.preprocess import normalize_clip
from youku_mplug_tpu_torch.train.trainer import make_train_step

PROMPT = "视频标题：{} 视频类目："


def parser():
    return common.base_parser("video category prediction (PyTorch)")


def load_classnames(cfg: RunConfig) -> List[str]:
    """``classname_file`` (a name -> index dict, or a list), else
    ``类目<i>`` for ``num_classes`` (default 45) classes."""
    path = cfg.get("classname_file", "classname.json")
    if os.path.exists(path):
        with open(path) as f:
            raw = json.load(f)
        if isinstance(raw, dict):
            idx2label = {int(v): k for k, v in raw.items()}
            return [idx2label[i] for i in range(len(idx2label))]
        return list(raw)
    return [f"类目{i}" for i in range(cfg.get("num_classes", 45))]


def build_loaders(args, cfg: RunConfig, mesh=None
                  ) -> Tuple[Loader, Loader, Loader]:
    """Train (shuffled), validation and test loaders (JAX
    ``build_loaders``): the YAML's files, or synthetic clips labelled
    index mod ``num_classes``; with a ``mesh``, the train loader's block
    of every global batch and the evaluation loaders' stride of their
    split (``common.eval_loader``)."""
    def dataset(key):
        if args.synthetic_data:
            return SyntheticVideoDataset(
                length=cfg.get("synthetic_length", 32),
                num_frames=cfg.num_frames, size=cfg.image_res,
                num_classes=cfg.get("num_classes", 5))
        train = key == "train_file"
        return ClsVideoDataset(
            cfg.get(key), cfg.get("video_root"),
            transform=(train_transform if train else test_transform)(
                cfg.image_res),
            num_frames=cfg.num_frames, train=train,
            seed=args.seed if train else 0, **common.decode_kwargs(cfg))
    return (common.make_loader(args, cfg, dataset("train_file"),
                               block=mesh),
            common.eval_loader(args, cfg, dataset("val_file"), mesh),
            common.eval_loader(args, cfg, dataset("test_file"), mesh))


def prepare(args) -> Tuple[common.Runner, Loader, Loader, List[str]]:
    """The runner (``common.setup`` on the YAML's mesh), the validation
    and test loaders and the class names."""
    cfg = load_config(args.config)
    mesh = common.init_mesh(args, cfg.mesh)
    train_loader, val_loader, test_loader = build_loaders(args, cfg, mesh)
    runner = common.setup(args, cfg, train_loader, mesh=mesh)
    classnames = load_classnames(cfg)
    if args.synthetic_data:
        classnames = classnames[:cfg.get("num_classes", 5)]
    return runner, val_loader, test_loader, classnames


def _title(t: str, max_length: int) -> str:
    return PROMPT.format(t[:max_length - 15])


def make_batch_factory(classnames: List[str], max_length: int):
    def make_batch(runner: common.Runner, raw) -> Dict[str, torch.Tensor]:
        titles = raw["text"]
        labels = np.asarray(raw["label"], np.int64)
        text = runner.tokenizer([(_title(t, max_length), classnames[la])
                                 for t, la in zip(titles, labels)],
                                padding="max_length")
        prompt = runner.tokenizer(list(titles), padding="max_length")
        return common.put_batch(runner, {
            "video": raw["video"], "input_ids": text["input_ids"],
            "attention_mask": text["attention_mask"],
            "prompt_lengths": text["prompt_lengths"],
            "prompt_ids": prompt["input_ids"],
            "prompt_mask": prompt["attention_mask"], "labels": labels})
    return make_batch


def make_loss_fn(model: MPLUGVideo):
    def loss_fn(batch, generator=None):
        video = normalize_clip(batch["video"],
                               dtype=model.policy.compute_dtype)
        return model.cls_train_loss(
            video, batch["input_ids"], batch["attention_mask"],
            batch["prompt_lengths"], prompt_ids=batch["prompt_ids"],
            prompt_mask=batch["prompt_mask"], labels=batch["labels"],
            generator=generator)
    return loss_fn


def build_train_step(runner: common.Runner):
    return make_train_step(make_loss_fn(runner.model),
                           update_freq=runner.cfg.update_freq,
                           dropout_seed=runner.args.seed)


def score_batch(runner: common.Runner, raw, classnames: List[str]
                ) -> Dict[str, np.ndarray]:
    """One test batch against every class name, ``eval_video_batch``
    clips a call: fp32 numpy ``generation_logits`` [B, C] and, with
    ``use_cls``, ``cls_logits``."""
    cfg, model = runner.cfg, runner.model
    num_cls, max_length = len(classnames), cfg.max_length
    titles = list(raw["text"])
    per_call = int(cfg.get("eval_video_batch") or len(titles))
    outs: Dict[str, list] = {"generation_logits": [], "cls_logits": []}
    for i in range(0, len(titles), per_call):
        part = titles[i:i + per_call]
        text = runner.tokenizer([(_title(t, max_length), c) for t in part
                                 for c in classnames], padding="max_length")
        prompt = runner.tokenizer(part, padding="max_length")
        b = common.to_device(runner, {
            "video": raw["video"][i:i + per_call],
            "input_ids": text["input_ids"],
            "attention_mask": text["attention_mask"],
            "prompt_lengths": text["prompt_lengths"],
            "prompt_ids": prompt["input_ids"],
            "prompt_mask": prompt["attention_mask"]})
        out = model.cls_eval_scores(
            normalize_clip(b["video"], dtype=model.policy.compute_dtype),
            b["input_ids"], b["attention_mask"], b["prompt_lengths"],
            prompt_ids=b["prompt_ids"], prompt_mask=b["prompt_mask"],
            num_cls=num_cls)
        for k, v in out.items():
            if v is not None:
                outs[k].append(v.float().cpu().numpy())
    return {k: np.concatenate(v) for k, v in outs.items() if v}


def evaluation(runner: common.Runner, loader: Loader,
               classnames: List[str]) -> Dict[str, float]:
    """Top-1 / top-5 accuracy (percent) over the loader's batches (at most
    --max_steps of them): generative, and the head's under ``use_cls``;
    under a data split each data rank's hits and clips summed
    (``sum_across_hosts``)."""
    num_cls, max_steps = len(classnames), runner.args.max_steps
    topk = (1, min(5, num_cls))
    gen_hits, cls_hits, n_total = np.zeros(2), np.zeros(2), 0
    training = runner.model.training
    runner.model.eval()
    try:
        with torch.inference_mode():
            for it, raw in enumerate(loader):
                if 0 < max_steps <= it:
                    break
                labels = np.asarray(raw["label"])
                out = score_batch(runner, raw, classnames)
                gen_hits += np.array(topk_accuracy(
                    out["generation_logits"], labels, topk)) * len(labels)
                if "cls_logits" in out:
                    cls_hits += np.array(topk_accuracy(
                        out["cls_logits"], labels, topk)) * len(labels)
                n_total += len(labels)
    finally:
        runner.model.train(training)
    gen_hits, cls_hits, counted = common.sum_across_hosts(
        np.stack([gen_hits, cls_hits, [n_total, n_total]]), runner.mesh)
    n = max(counted[0], 1)
    res = {"gen_top1_accuracy": gen_hits[0] / n,
           "gen_top5_accuracy": gen_hits[1] / n}
    if runner.cfg.model.use_cls:
        res.update(cls_top1_accuracy=cls_hits[0] / n,
                   cls_top5_accuracy=cls_hits[1] / n)
    if common.main_rank(runner):
        print(f"* Generation Top-1 Accuracy "
              f"{res['gen_top1_accuracy']:.3f}", flush=True)
    return res


def main(args) -> common.Runner:
    def body():
        runner, val_loader, test_loader, classnames = prepare(args)
        if not args.evaluate_only:
            common.train_epochs(
                runner, build_train_step(runner),
                make_batch_factory(classnames, runner.cfg.max_length),
                validate=lambda r: evaluation(r, val_loader, classnames))
        common.finish(runner, {"test": evaluation(runner, test_loader,
                                                  classnames)})
        return runner
    return common.run_main(body)


if __name__ == "__main__":
    main(parser().parse_args())
