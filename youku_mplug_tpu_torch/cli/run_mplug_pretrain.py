"""mPLUG (BERT-fusion) pretraining CLI: ITC with momentum distillation and
MoCo queues, ITM on hard negatives, MLM.

Counterpart of ``youku_mplug_tpu/cli/run_mplug_pretrain.py`` on
``cli/common.py``.  The model is ``models/mplug.MPLUG`` (the YAML's
vision tower; the BERT of ``bert_config`` with ``bert_overrides``;
``embed_dim``, ``temp``, ``queue_size``, ``momentum``,
``mlm_probability``), drawn by the JAX ``model.init`` rules, every leaf
trainable (the decoder too: it takes zero gradients here, yet AdamW's
weight decay moves it, as in JAX).  Each step:

1. the batch's text tokenized (``text_encoder_vocab``, a BERT
   ``vocab.txt``, through WordPiece; else the toy BERT hash), its MLM
   masks drawn from a generator seeded by (``--seed``, step);
2. the momentum features of the EMA twin (deterministic);
3. the train step: ``pretrain_loss`` against the queues with
   ``alpha * min(1, step / steps_per_epoch)`` (the YAML's ``alpha``,
   0.4), the dropout masks and the hard negatives from the step's
   generator;
4. ``update_momentum``: the EMA over every parameter and the twin's
   features written into the queues.

Each step prints loss, loss_ita, loss_itm, loss_mlm, grad_norm, lr,
skipped_nonfinite and its wall time; each ``--save_ckpt_freq`` epochs
save the train state under ``<output_dir>/checkpoints`` (the state only,
not the momentum state, and no run resumes from them: JAX's runner does
neither, ROADMAP.md Queue 3) and ``log.txt`` gets the epoch's means.
The clips are the YAML's ``train_file`` under ``train_video_root``, or
with ``--synthetic_data`` ``synthetic_length`` (default 32) procedural
ones.

Usage (the card is the default device; ``--device cpu --fp32`` runs a
tiny YAML on the CPU):
    python -m youku_mplug_tpu_torch.cli.run_mplug_pretrain \\
        --config configs/mplug/mplug_vitb16_zh.yaml --synthetic_data \\
        --max_steps 4 --output_dir out
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict

import torch

from youku_mplug_tpu_torch.cli import common
from youku_mplug_tpu_torch.config import RunConfig, load_config
from youku_mplug_tpu_torch.data.datasets import (
    PretrainVideoDataset,
    SyntheticVideoDataset,
)
from youku_mplug_tpu_torch.data.transforms import train_transform
from youku_mplug_tpu_torch.models.mplug import (
    MPLUG,
    MPLUGConfig,
    MomentumState,
    init_momentum_state,
    mlm_mask_tokens,
    update_momentum,
)
from youku_mplug_tpu_torch.models.tokenizer import (
    BatchTokenizer,
    BertWordPieceTokenizer,
    ToyBertTokenizer,
)
from youku_mplug_tpu_torch.ops.preprocess import normalize_clip
from youku_mplug_tpu_torch.train.trainer import (
    dropout_generator,
    make_train_step,
)


def parser():
    return common.base_parser("mPLUG BERT-fusion pretraining (PyTorch)")


def build_model_cfg(cfg: RunConfig) -> MPLUGConfig:
    return MPLUGConfig(
        vision=cfg.model.vision, bert=cfg.bert,
        embed_dim=int(cfg.get("embed_dim", 256)),
        temp=float(cfg.get("temp", 0.07)),
        queue_size=int(cfg.get("queue_size", 65536)),
        momentum=float(cfg.get("momentum", 0.995)),
        mlm_probability=float(cfg.get("mlm_probability", 0.15)),
        distill=bool(cfg.get("distill", True)))


def build_tokenizer(cfg: RunConfig, vocab_size: int) -> BatchTokenizer:
    """WordPiece over ``text_encoder_vocab`` where that file exists, else
    the toy BERT hash over ``vocab_size`` ids."""
    vocab = cfg.get("text_encoder_vocab", "")
    tok = (BertWordPieceTokenizer(vocab) if vocab and os.path.exists(vocab)
           else ToyBertTokenizer(vocab_size=vocab_size))
    return BatchTokenizer(tok, max_length=cfg.max_length)


def build_loader(args, cfg: RunConfig):
    if args.synthetic_data:
        ds = SyntheticVideoDataset(length=cfg.get("synthetic_length", 32),
                                   num_frames=cfg.num_frames,
                                   size=cfg.image_res)
    else:
        ds = PretrainVideoDataset(
            cfg.get("train_file"), cfg.get("train_video_root"),
            transform=train_transform(cfg.image_res),
            num_frames=cfg.num_frames, seed=args.seed,
            **common.decode_kwargs(cfg))
    return common.make_loader(args, cfg, ds)


@dataclasses.dataclass
class Pretrain:
    """What the pretrain loop carries beside the runner."""
    runner: common.Runner
    mcfg: MPLUGConfig
    mstate: MomentumState
    alpha: float
    niter: int


def setup(args) -> Pretrain:
    """Config, loader, the model and its train state (no resume), and the
    momentum state (the twin a copy of the fresh model, the queues drawn
    from a generator seeded 0, as JAX draws them from ``key(0)``).
    Raises when the requested device is absent."""
    cfg = load_config(args.config)
    mcfg = build_model_cfg(cfg)
    loader = build_loader(args, cfg)
    cfg.optimizer = dataclasses.replace(cfg.optimizer,
                                        freeze_text_decoder=False)
    runner = common.setup(
        args, cfg, loader, model_fn=lambda policy: MPLUG(mcfg, policy),
        tokenizer=build_tokenizer(cfg, mcfg.bert.vocab_size), resume=False)
    mstate = init_momentum_state(runner.model, mcfg.embed_dim,
                                 mcfg.queue_size)
    niter = len(loader) if args.max_steps <= 0 else min(len(loader),
                                                        args.max_steps)
    return Pretrain(runner=runner, mcfg=mcfg, mstate=mstate,
                    alpha=float(cfg.get("alpha", 0.4)), niter=max(niter, 1))


def make_batch_fn(pt: Pretrain):
    """make_batch(runner, raw): the normalized clips, ids, mask, the MLM
    ids and labels, the twin's features, the queues and this step's
    alpha."""
    def make_batch(runner: common.Runner, raw) -> Dict:
        text = runner.tokenizer(raw["text"], padding="max_length")
        b = common.to_device(runner, {"video": raw["video"], **text})
        step = runner.state.step
        gen = dropout_generator(runner.args.seed, step, runner.device,
                                stream=1)
        tok = runner.tokenizer.tokenizer
        b["mlm_input_ids"], b["mlm_labels"] = mlm_mask_tokens(
            b["input_ids"], b["attention_mask"], pt.mcfg.bert.vocab_size,
            gen, mlm_probability=pt.mcfg.mlm_probability,
            mask_token_id=getattr(tok, "mask_id", 103))
        b["video"] = normalize_clip(b["video"],
                                    dtype=runner.model.policy.compute_dtype)
        with torch.no_grad():
            feats = pt.mstate.ema.momentum_features(
                b["video"], b["input_ids"], b["attention_mask"])
        b["image_feat_m"], b["text_feat_m"] = (feats["image_feat"],
                                               feats["text_feat"])
        b["image_queue"], b["text_queue"] = (pt.mstate.image_queue,
                                             pt.mstate.text_queue)
        b["alpha"] = pt.alpha * min(1.0, step / pt.niter)
        return b
    return make_batch


def make_loss_fn(model: MPLUG):
    def loss_fn(batch, generator=None):
        return model.pretrain_loss(
            batch["video"], batch["input_ids"], batch["attention_mask"],
            batch["mlm_input_ids"], batch["mlm_labels"],
            feats_m={"image_feat": batch["image_feat_m"],
                     "text_feat": batch["text_feat_m"]},
            image_queue=batch["image_queue"],
            text_queue=batch["text_queue"], alpha=batch["alpha"],
            generator=generator, neg_idx=batch.get("neg_idx"))
    return loss_fn


def build_train_step(pt: Pretrain):
    """The train step, then ``update_momentum`` with the model's updated
    parameters and the twin's features of the batch."""
    inner = make_train_step(make_loss_fn(pt.runner.model),
                            dropout_seed=pt.runner.args.seed)

    def train_step(state, batch):
        metrics = inner(state, batch)
        update_momentum(pt.mstate, pt.runner.model, batch["image_feat_m"],
                        batch["text_feat_m"], momentum=pt.mcfg.momentum)
        return metrics
    return train_step


def main(args) -> Pretrain:
    pt = setup(args)
    common.train_epochs(pt.runner, build_train_step(pt), make_batch_fn(pt))
    return pt


if __name__ == "__main__":
    main(parser().parse_args())
