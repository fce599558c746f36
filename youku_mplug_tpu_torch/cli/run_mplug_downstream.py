"""mPLUG (BERT-fusion) downstream CLI: ``--task {cls, caption,
retrieval}`` finetuning, then the task's evaluation.

Counterpart of ``youku_mplug_tpu/cli/run_mplug_downstream.py`` on
``cli/common.py``.  The model is ``models/mplug.MPLUG`` as the pretrain
runner builds it, with ``num_classes`` classes, every leaf trainable.
Training, one train step per batch (dropout and the hard negatives from
the step's generator):

- cls: ``cls_forward``'s cross-entropy on the fused cls token;
- caption: ``caption_loss``, the decoder cross-attending to the image
  tokens with the text as its target;
- retrieval: ``retrieval_loss``, idx-matched ITC and ITM in the batch (no
  queues: the pretrain runner owns them, as in JAX).

Evaluation (``--max_steps`` caps the cls and caption test batches, as in
JAX): cls top-1 / top-5 (top-``min(5, num_classes)``) of the head's
logits; caption ``mplug_generate`` (the YAML's ``beam_size``, default 1,
``max_new_tokens`` 20, ``min_length`` 0) then ``caption_eval`` on the
decoded text with its spaces removed; retrieval the clip x text matrix of
the L2-normalized projected cls features of the whole test split (one
text a clip) and ``itm_eval``.  It prints ``* mPLUG <task> eval:`` and
appends ``{"test": ...}`` to ``log.txt``; each epoch saves a checkpoint,
and a second run on the same ``--output_dir`` (or ``--resume <dir>``)
resumes; ``--evaluate_only`` only evaluates.  The clips are the YAML's
``train_file`` / ``test_file`` under ``video_root``, or with
``--synthetic_data`` procedural ones (``synthetic_length``, default 16).

Usage (the card is the default device):
    python -m youku_mplug_tpu_torch.cli.run_mplug_downstream \\
        --config configs/mplug/mplug_vitb16_zh.yaml --task caption \\
        --synthetic_data --max_steps 2 --output_dir out
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict

import numpy as np
import torch

from youku_mplug_tpu_torch.cli import common
from youku_mplug_tpu_torch.cli.run_mplug_pretrain import (
    build_model_cfg,
    build_tokenizer,
)
from youku_mplug_tpu_torch.config import RunConfig, load_config
from youku_mplug_tpu_torch.data.datasets import (
    CaptionVideoDataset,
    ClsVideoDataset,
    RetrievalVideoDataset,
    SyntheticVideoDataset,
)
from youku_mplug_tpu_torch.data.transforms import (
    test_transform,
    train_transform,
)
from youku_mplug_tpu_torch.evals.metrics import (
    caption_eval,
    itm_eval,
    topk_accuracy,
)
from youku_mplug_tpu_torch.models.mplug import MPLUG, mplug_generate
from youku_mplug_tpu_torch.ops.preprocess import normalize_clip
from youku_mplug_tpu_torch.train.trainer import make_train_step


def parser():
    p = common.base_parser("mPLUG BERT-fusion downstream (PyTorch)")
    p.add_argument("--task", choices=("cls", "caption", "retrieval"),
                   default="cls")
    return p


def synthetic_test_split(cfg: RunConfig, task: str):
    """JAX's synthetic test split: the train clips, and for retrieval each
    clip matching its own text."""
    ds = SyntheticVideoDataset(length=cfg.get("synthetic_length", 16),
                               num_frames=cfg.num_frames,
                               size=cfg.image_res,
                               num_classes=cfg.get("num_classes", 5))
    if task == "retrieval":
        ds.text = [f"synthetic clip {i}" for i in range(len(ds))]
        ds.vid2txt = {i: [i] for i in range(len(ds))}
        ds.txt2vid = {i: [i] for i in range(len(ds))}
    return ds


def build_dataset(args, cfg: RunConfig, train: bool):
    if args.synthetic_data:
        return synthetic_test_split(cfg, "" if train else args.task)
    kw = dict(transform=(train_transform if train else test_transform)(
        cfg.image_res), num_frames=cfg.num_frames, train=train,
        **common.decode_kwargs(cfg))
    key = "train_file" if train else "test_file"
    cls = {"cls": ClsVideoDataset, "caption": CaptionVideoDataset}.get(
        args.task, RetrievalVideoDataset)
    return cls(cfg.get(key), cfg.get("video_root"), **kw)


def prepare(args, model_cls=MPLUG, model_cfg=None, dataset_fn=None):
    """(runner, test split): ``common.setup`` with the BERT-family model
    (``model_cls(model_cfg(cfg))``, default this runner's mPLUG with
    ``num_classes``) and its tokenizer, every leaf trainable; the splits
    from ``dataset_fn(args, cfg, train)`` (default ``build_dataset``; a
    None test split is not built)."""
    cfg = load_config(args.config)
    mcfg = model_cfg(cfg) if model_cfg else dataclasses.replace(
        build_model_cfg(cfg), num_classes=int(cfg.get("num_classes", 0)))
    dataset_fn = dataset_fn or build_dataset
    train_ds = dataset_fn(args, cfg, train=True)
    test_ds = dataset_fn(args, cfg, train=False)
    cfg.optimizer = dataclasses.replace(cfg.optimizer,
                                        freeze_text_decoder=False)
    runner = common.setup(
        args, cfg, common.make_loader(args, cfg, train_ds),
        model_fn=lambda policy: model_cls(mcfg, policy),
        tokenizer=build_tokenizer(cfg, mcfg.bert.vocab_size))
    return runner, test_ds


def make_batch_fn(task: str):
    def make_batch(runner: common.Runner, raw) -> Dict[str, torch.Tensor]:
        tok = runner.tokenizer(raw["text"], padding="max_length")
        arrays = {"video": raw["video"], **tok}
        if task == "cls":
            arrays["labels"] = np.asarray(raw["label"], np.int64)
        if task == "retrieval":
            arrays["idx"] = np.asarray(raw["match_id"], np.int64)
        b = common.to_device(runner, arrays)
        b["video"] = normalize_clip(b["video"],
                                    dtype=runner.model.policy.compute_dtype)
        return b
    return make_batch


def make_loss_fn_for(task: str, pad_id: int = 0):
    def make_loss_fn(model: MPLUG):
        def loss_fn(batch, generator=None):
            args = (batch["video"], batch["input_ids"],
                    batch["attention_mask"])
            if task == "cls":
                return model.cls_forward(*args, labels=batch["labels"],
                                         generator=generator)
            if task == "caption":
                return model.caption_loss(*args, pad_id=pad_id,
                                          generator=generator)
            return model.retrieval_loss(*args, batch["idx"],
                                        generator=generator,
                                        neg_idx=batch.get("neg_idx"))
        return loss_fn
    return make_loss_fn


def build_train_step(runner: common.Runner, task: str):
    pad_id = runner.tokenizer.tokenizer.pad_id
    return make_train_step(make_loss_fn_for(task, pad_id)(runner.model),
                           dropout_seed=runner.args.seed)


def _test_batches(runner: common.Runner, test_ds, capped: bool):
    args = runner.args
    loader = common.make_loader(args, runner.cfg, test_ds, shuffle=False,
                                drop_last=False)
    for it, raw in enumerate(loader):
        if capped and 0 < args.max_steps <= it:
            break
        yield raw, make_batch_fn("")(runner, raw)


@torch.inference_mode()
def cls_evaluation(runner: common.Runner, test_ds, num_classes: int
                   ) -> Dict[str, float]:
    hits, n = np.zeros(2), 0
    for raw, b in _test_batches(runner, test_ds, capped=True):
        logits = runner.model.cls_forward(b["video"], b["input_ids"],
                                          b["attention_mask"])["logits"]
        labels = np.asarray(raw["label"])
        t1, tk = topk_accuracy(logits.float().cpu().numpy(), labels,
                               topk=(1, min(5, num_classes)))
        hits += np.array([t1, tk]) * len(labels)
        n += len(labels)
    return {"top1": hits[0] / max(n, 1), "top5": hits[1] / max(n, 1)}


@torch.inference_mode()
def caption_evaluation(runner: common.Runner, test_ds) -> Dict[str, float]:
    cfg, tok = runner.cfg, runner.tokenizer
    results = []
    for raw, b in _test_batches(runner, test_ds, capped=True):
        seqs = mplug_generate(
            runner.model, b["video"], bos_id=tok.tokenizer.bos_id,
            eos_id=tok.tokenizer.eos_id,
            max_new_tokens=int(cfg.get("max_new_tokens", 20)),
            beam_size=int(cfg.get("beam_size", 1)),
            min_length=int(cfg.get("min_length", 0)))
        for vid, seq, golden in zip(raw["video_id"], seqs.cpu().numpy(),
                                    raw["golden"]):
            results.append({"video_id": vid,
                            "pred_caption": tok.decode(seq).replace(
                                " ", "").strip(),
                            "gold_caption": list(golden)})
    return caption_eval(results)


@torch.inference_mode()
def retrieval_features(runner: common.Runner, test_ds):
    """fp32 L2-normalized (clip features, text features) of the whole
    split in index order, the text of each clip its own."""
    model = runner.model
    vfeats, tfeats, order = [], [], []
    for raw, b in _test_batches(runner, test_ds, capped=False):
        img = model.encode_image(b["video"])
        txt = model.encode_text(b["input_ids"], b["attention_mask"])
        for out, emb, proj in ((vfeats, img, model.vision_proj),
                               (tfeats, txt, model.text_proj)):
            f = proj(emb[:, 0].float())
            out.append((f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)
                        ).float().cpu().numpy())
        order += list(raw["index"])
    perm = np.argsort(np.asarray(order))
    return np.concatenate(vfeats)[perm], np.concatenate(tfeats)[perm]


def retrieval_evaluation(runner: common.Runner, test_ds) -> Dict[str, float]:
    vfeats, tfeats = retrieval_features(runner, test_ds)
    sims = vfeats @ tfeats.T
    return itm_eval(sims, sims.T, test_ds.txt2vid, test_ds.vid2txt)


def evaluation(runner: common.Runner, test_ds, task: str, num_classes: int
               ) -> Dict[str, float]:
    """The task's test metrics, the model in evaluation mode."""
    training = runner.model.training
    runner.model.eval()
    try:
        if task == "cls":
            return cls_evaluation(runner, test_ds, num_classes)
        if task == "caption":
            return caption_evaluation(runner, test_ds)
        return retrieval_evaluation(runner, test_ds)
    finally:
        runner.model.train(training)


def main(args):
    runner, test_ds = prepare(args)
    task = args.task
    if not args.evaluate_only:
        common.train_epochs(runner, build_train_step(runner, task),
                            make_batch_fn(task))
    result = evaluation(runner, test_ds, task,
                        runner.model.cfg.num_classes)
    print(f"* mPLUG {task} eval:", json.dumps(result, ensure_ascii=False),
          flush=True)
    common.write_log(args, {"test": result})
    return runner, result


if __name__ == "__main__":
    main(parser().parse_args())
