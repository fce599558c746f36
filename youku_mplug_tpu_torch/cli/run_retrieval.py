"""Video-text retrieval CLI (dual encoder): contrastive finetune, then
recall over every clip and text.

Counterpart of ``youku_mplug_tpu/cli/run_retrieval.py`` on
``cli/common.py``.  Training takes each batch's (clip, caption) pairs
through ``retrieval_loss``: the video tower's pooled cls and the
text-only decoder's last token, each projected (``vision_proj``,
``text_proj``) and normalized, in-batch NCE over the learned temperature
with every pair sharing a clip id counted as a positive.  The towers run
deterministic (no dropout), as the JAX method's do, and the frozen
decoder is not differentiated.  Evaluation extracts every text's feature
(``batch_size`` texts a call, padded with empty strings) and every clip's
(the split in order, the last batch partial), and reports R@1/5/10 both
ways and their means (``itm_eval``).  Each epoch saves a checkpoint and
evaluates the validation split; ``--evaluate_only --resume <dir>`` only
evaluates the test split.  The splits are the YAML's ``train_file``,
``val_file`` and ``test_file`` under ``video_root``
(``data/datasets.RetrievalVideoDataset``: an evaluation split's ``text``,
``vid2txt`` and ``txt2vid`` come from its rows), decoded on
``num_workers`` threads; or with ``--synthetic_data`` procedural clips.
Under ``python -m torch.distributed.run`` it trains and evaluates under
the YAML's ``mesh:`` split (``cli/common.py``): each data rank reads its
block of every global batch, and the NCE is the global batch's (each
rank's clips against every rank's texts and the reverse, the soft
targets from every rank's clip ids), so the step equals the unsplit
one; the evaluation extracts every text on every rank (JAX keeps the
texts replicated) and each data rank's stride of the clips,
``local_batch_size`` a batch, merged on the host
(``gather_eval_rows``); rank 0 alone prints and writes.

Usage:
    python -m youku_mplug_tpu_torch.cli.run_retrieval \\
        --config configs/retrieval/retrieval_gpt3_1.3B_youku_v0.yaml \\
        --synthetic_data --max_steps 2 --output_dir out
and without ``--synthetic_data`` on a copy whose files name yours.  The
shipped ``mesh: {data: -1, model: 1}`` takes every rank of a launch for
data; a copy with ``mesh: {data: 2, model: 2}`` on four:
    python -m torch.distributed.run --standalone --nproc_per_node=4 \\
        -m youku_mplug_tpu_torch.cli.run_retrieval --config <that copy> \\
        --synthetic_data --max_steps 2 --output_dir out
(NCCL, a card a rank; ``--device cpu --fp32`` on CPU processes).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from youku_mplug_tpu_torch.cli import common
from youku_mplug_tpu_torch.config import RunConfig, load_config
from youku_mplug_tpu_torch.data.datasets import (
    RetrievalVideoDataset,
    SyntheticRetrievalSplit,
    SyntheticVideoDataset,
)
from youku_mplug_tpu_torch.data.transforms import (
    test_transform,
    train_transform,
)
from youku_mplug_tpu_torch.evals.metrics import itm_eval
from youku_mplug_tpu_torch.models.tasks import MPLUGVideo
from youku_mplug_tpu_torch.ops.preprocess import normalize_clip
from youku_mplug_tpu_torch.train.trainer import make_train_step


def parser():
    return common.base_parser("video-text retrieval (PyTorch)")


def build_datasets(args, cfg: RunConfig):
    """(train, val, test) datasets (JAX ``build_datasets``): the YAML's
    files, or ``synthetic_length`` (default 16) synthetic clips whose val
    and test splits carry the retrieval fields."""
    if args.synthetic_data:
        n = cfg.get("synthetic_length", 16)
        kw = dict(num_frames=cfg.num_frames, size=cfg.image_res)
        return (SyntheticVideoDataset(length=n, **kw),
                SyntheticRetrievalSplit(n, **kw),
                SyntheticRetrievalSplit(n, **kw))

    def split(key):
        train = key == "train_file"
        return RetrievalVideoDataset(
            cfg.get(key), cfg.get("video_root"),
            transform=(train_transform if train else test_transform)(
                cfg.image_res),
            num_frames=cfg.num_frames, train=train,
            seed=args.seed if train else 0,
            has_multi_vision_gt=cfg.get("has_multi_vision_gt", False),
            **common.decode_kwargs(cfg))
    return split("train_file"), split("val_file"), split("test_file")


def prepare(args):
    """The runner (``common.setup`` on the YAML's mesh, the model with
    ``vision_proj`` and ``text_proj``), the validation and test
    splits."""
    cfg = load_config(args.config)
    mesh = common.init_mesh(args, cfg.mesh)
    train_ds, val_ds, test_ds = build_datasets(args, cfg)
    runner = common.setup(args, cfg, common.make_loader(args, cfg, train_ds,
                                                        block=mesh),
                          proj_heads=True, mesh=mesh)
    return runner, val_ds, test_ds


def make_batch(runner: common.Runner, raw) -> Dict[str, torch.Tensor]:
    text = runner.tokenizer(raw["text"], padding="max_length")
    return common.put_batch(runner, {
        "video": raw["video"], "input_ids": text["input_ids"],
        "attention_mask": text["attention_mask"],
        "idx": np.asarray(raw["match_id"], np.int64)})


def make_loss_fn(model: MPLUGVideo):
    def loss_fn(batch):  # the towers are deterministic: no generator
        video = normalize_clip(batch["video"],
                               dtype=model.policy.compute_dtype)
        return model.retrieval_loss(video, batch["input_ids"],
                                    batch["attention_mask"], batch["idx"])
    return loss_fn


def build_train_step(runner: common.Runner):
    return make_train_step(make_loss_fn(runner.model),
                           update_freq=runner.cfg.update_freq)


@torch.inference_mode()
def features(runner: common.Runner, dataset, batch_size=None
             ) -> Tuple[np.ndarray, np.ndarray]:
    """fp32 (clip features [V, E], text features [T, E]) of a split; under
    a data split the clips' by data rank, merged (``gather_eval_rows``)."""
    model, cfg, mesh = runner.model, runner.cfg, runner.mesh
    bs = batch_size or cfg.batch_size
    tfeats, vfeats = [], []
    for i in range(0, len(dataset.text), bs):
        chunk = list(dataset.text[i:i + bs])
        tok = runner.tokenizer(chunk + [""] * (bs - len(chunk)),
                               padding="max_length")
        b = common.to_device(runner, {"input_ids": tok["input_ids"],
                                      "attention_mask": tok[
                                          "attention_mask"]})
        f = model.extract_text_feature(b["input_ids"], b["attention_mask"])
        tfeats.append(f.float().cpu().numpy()[:len(chunk)])
    order = []
    for raw in common.eval_loader(runner.args, cfg, dataset, mesh, bs,
                                  drop_last=False):
        video = normalize_clip(
            torch.from_numpy(raw["video"]).to(runner.device),
            dtype=model.policy.compute_dtype)
        vfeats.append(model.extract_vision_feature(video).float()
                      .cpu().numpy())
        order.append(np.asarray(raw["index"]))
    vfeats, _ = common.gather_eval_rows(np.concatenate(vfeats),
                                        np.concatenate(order), mesh)
    return vfeats, np.concatenate(tfeats)


def evaluation(runner: common.Runner, dataset, batch_size=None
               ) -> Dict[str, float]:
    """R@1/5/10 (percent) of the full clip x text similarity matrix."""
    training = runner.model.training
    runner.model.eval()
    try:
        vfeats, tfeats = features(runner, dataset, batch_size)
    finally:
        runner.model.train(training)
    sims = vfeats @ tfeats.T
    res = itm_eval(sims, sims.T, dataset.txt2vid, dataset.vid2txt)
    if common.main_rank(runner):
        print("* Retrieval:", res, flush=True)
    return res


def main(args) -> common.Runner:
    def body():
        runner, val_ds, test_ds = prepare(args)
        if not args.evaluate_only:
            common.train_epochs(runner, build_train_step(runner),
                                make_batch,
                                validate=lambda r: evaluation(r, val_ds))
        common.finish(runner, {"test": evaluation(runner, test_ds)})
        return runner
    return common.run_main(body)


if __name__ == "__main__":
    main(parser().parse_args())
