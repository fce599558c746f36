"""Generative ITM rerank retrieval CLI: match / no-match finetune with
derangement negatives, then the V x T match matrix.

Counterpart of ``youku_mplug_tpu/cli/run_retrieval_itm.py`` on
``cli/common.py``.  A training batch of B clips gives 3B rows: each clip
with its own caption (label 是, match) and with the captions of two
derangements of the batch (是 where the match ids agree, else 否), drawn
from a numpy generator seeded by the batch's sample indices.  The prompt
``标题：{caption} 这个视频与标题匹配吗？`` with the yes / no word as the
target goes through ``itm_train_loss`` (prefix-LM loss plus, under
``use_cls``, the match head's cross-entropy on the caption alone), with
the decoder's dropout drawn from the step's generator.  Evaluation scores
every clip of the split against every text, ``eval_video_batch`` clips
(default 4) and 8 texts a call (``itm_eval_scores``), and reports the
recall of the generative scores (``gen_*``) and of the head's P(match)
(``cls_*``).  ``--evaluate_only --resume <dir>`` only evaluates the test
split.  The splits are ``run_retrieval.build_datasets``': the YAML's
files under ``video_root`` (each evaluation split's texts and clip <->
text maps from its rows), or with ``--synthetic_data`` procedural clips.

Under ``python -m torch.distributed.run`` it trains and evaluates under
the YAML's ``mesh:`` split (``cli/common.py``).  Each data rank reads its
block of the global batch's clips, and every rank gathers the global
batch's sample indices, match ids and captions (``host_gather``: a few
hundred bytes a row), so that it draws the global batch's derangements
from the global seed, as the unsplit run does; the 3B pair rows are cut
into one contiguous block a data rank (3B / data rows through the
decoder), each pair's query features taken from the gathered clips
(``itm_train_loss``): the step equals the unsplit one, dropout
included.  The evaluation scores each data rank's stride of the clips
against every text on the model shards, merged on the host
(``gather_eval_rows``); rank 0 alone prints and writes.

Unlike the JAX package, a ``use_cls`` config whose head has fewer than
two outputs raises here: P(match) reads column 1 of the head's softmax,
which a 1-way head (``num_classes`` unset, as in
``configs/retrieval/retrieval_itm_gpt3_1.3B_youku_v0.yaml``) lacks; JAX
clamps the index to column 0, which is 1 for every pair.  Set
``num_classes: 2``.

Usage:
    python -m youku_mplug_tpu_torch.cli.run_retrieval_itm \\
        --config <an ITM YAML with num_classes: 2> \\
        --synthetic_data --max_steps 2 --output_dir out
    # with mesh: {data: 2, model: 2} in that YAML (the shipped data: -1
    # takes every rank of the launch for data), on four ranks
    python -m torch.distributed.run --standalone --nproc_per_node=4 \\
        -m youku_mplug_tpu_torch.cli.run_retrieval_itm \\
        --config <that YAML> --synthetic_data --max_steps 2 --output_dir out
(NCCL, a card a rank; ``--device cpu --fp32`` on CPU processes).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from youku_mplug_tpu_torch.cli import common
from youku_mplug_tpu_torch.cli.run_retrieval import build_datasets
from youku_mplug_tpu_torch.config import load_config
from youku_mplug_tpu_torch.evals.metrics import itm_eval
from youku_mplug_tpu_torch.models.tasks import MPLUGVideo
from youku_mplug_tpu_torch.ops.preprocess import normalize_clip
from youku_mplug_tpu_torch.train.trainer import make_train_step

PROMPT = "标题：{} 这个视频与标题匹配吗？"
YES, NO = "是", "否"
TEXTS_PER_CALL = 8


def parser():
    return common.base_parser("ITM rerank retrieval (PyTorch)")


def random_derangement(n: int, rng: np.random.Generator) -> np.ndarray:
    """A permutation of range(n) with no fixed point (zeros for n = 1)."""
    if n == 1:
        return np.zeros(1, np.int64)
    while True:
        p = rng.permutation(n)
        if not np.any(p == np.arange(n)):
            return p


def prepare(args):
    """The runner (``common.setup`` on the YAML's mesh), the validation
    and test splits; raises on a match head with fewer than two outputs
    (module docstring)."""
    cfg = load_config(args.config)
    if cfg.model.use_cls and cfg.model.num_classes < 2:
        raise ValueError(
            f"use_cls with num_classes {cfg.model.num_classes}: the ITM "
            "match head needs 2 outputs (P(match) is column 1 of its "
            "softmax; the JAX package reads a 1-way head's column 0, 1 for "
            "every pair) - set num_classes: 2")
    mesh = common.init_mesh(args, cfg.mesh)
    if mesh.data > 1 and cfg.update_freq > 1:
        raise ValueError(
            f"update_freq {cfg.update_freq} under data={mesh.data}: a "
            f"micro-batch's pair rows index clips of the whole batch")
    train_ds, val_ds, test_ds = build_datasets(args, cfg)
    runner = common.setup(args, cfg, common.make_loader(args, cfg, train_ds,
                                                        block=mesh),
                          mesh=mesh)
    return runner, val_ds, test_ds


def _prompt(t: str, max_length: int) -> str:
    return PROMPT.format(t[:max_length - 20])


def make_batch(runner: common.Runner, raw) -> Dict[str, torch.Tensor]:
    """The step's inputs: this data rank's clips, the global batch's
    ``negative_indices``, and this data rank's block of the 3B pair rows
    (all of them in one process)."""
    mesh = getattr(runner, "mesh", None)
    parts = common.host_gather((np.asarray(raw["index"]), list(raw["text"]),
                                np.asarray(raw["match_id"])), mesh)
    rng = np.random.default_rng(int(np.sum(np.concatenate(
        [p[0] for p in parts]))))
    text = [t for p in parts for t in p[1]]
    idx = np.concatenate([p[2] for p in parts])
    b = len(text)
    neg = np.concatenate([random_derangement(b, rng),
                          random_derangement(b, rng)])
    neg_labels = (idx[np.arange(2 * b) % b] == idx[neg]).astype(np.int64)
    labels = np.concatenate([np.ones(b, np.int64), neg_labels])
    text_all = text + [text[i] for i in neg]
    rows = 3 * b // len(parts)
    lo = rows * (mesh.data_index if mesh is not None else 0)
    text_all, labels = text_all[lo:lo + rows], labels[lo:lo + rows]
    max_length = runner.cfg.max_length
    tok = runner.tokenizer([(_prompt(t, max_length), YES if la else NO)
                            for t, la in zip(text_all, labels)],
                           padding="max_length")
    prompt_tok = runner.tokenizer(text_all, padding="max_length")
    return common.put_batch(runner, {
        "video": raw["video"], "input_ids": tok["input_ids"],
        "attention_mask": tok["attention_mask"],
        "prompt_lengths": tok["prompt_lengths"],
        "prompt_ids": prompt_tok["input_ids"],
        "prompt_mask": prompt_tok["attention_mask"],
        "negative_indices": neg.astype(np.int64), "labels": labels})


def make_loss_fn(model: MPLUGVideo):
    def loss_fn(batch, generator=None):
        video = normalize_clip(batch["video"],
                               dtype=model.policy.compute_dtype)
        return model.itm_train_loss(
            video, batch["input_ids"], batch["attention_mask"],
            batch["prompt_lengths"], batch["negative_indices"],
            prompt_ids=batch["prompt_ids"], prompt_mask=batch["prompt_mask"],
            labels=batch["labels"], generator=generator)
    return loss_fn


def build_train_step(runner: common.Runner):
    return make_train_step(make_loss_fn(runner.model),
                           update_freq=runner.cfg.update_freq,
                           dropout_seed=runner.args.seed)


def score_block(runner: common.Runner, video: torch.Tensor, texts):
    """``video`` [V, ...] uint8 clips against up to TEXTS_PER_CALL texts
    (padded with empty strings): fp32 numpy (generation [V, T], head
    P(match) [V, T] or None)."""
    model, max_length = runner.model, runner.cfg.max_length
    pad = TEXTS_PER_CALL - len(texts)
    chunk = list(texts) + [""] * pad
    nv = video.shape[0]
    tok = runner.tokenizer([(_prompt(t, max_length), YES) for t in chunk]
                           * nv, padding="max_length")
    ptok = runner.tokenizer(chunk * nv, padding="max_length")
    b = common.to_device(runner, {
        "input_ids": tok["input_ids"],
        "attention_mask": tok["attention_mask"],
        "prompt_lengths": tok["prompt_lengths"],
        "prompt_ids": ptok["input_ids"],
        "prompt_mask": ptok["attention_mask"]})
    out = model.itm_eval_scores(
        normalize_clip(video, dtype=model.policy.compute_dtype),
        b["input_ids"], b["attention_mask"], b["prompt_lengths"],
        prompt_ids=b["prompt_ids"], prompt_mask=b["prompt_mask"],
        num_text=TEXTS_PER_CALL)
    keep = TEXTS_PER_CALL - pad
    return tuple(None if v is None else v.float().cpu().numpy()[:, :keep]
                 for v in (out["generation_logits"], out["cls_logits"]))


def evaluation(runner: common.Runner, dataset) -> Dict[str, float]:
    """Recall (percent) of the V x T generative and head match matrices
    over every clip and text of ``dataset``; under a data split each data
    rank scores its stride of the clips (``eval_video_batch`` a call, as
    JAX's hosts do) and the rows are merged (``gather_eval_rows``)."""
    texts, mesh = dataset.text, runner.mesh
    vb = int(runner.cfg.get("eval_video_batch", 4))
    gen_rows, cls_rows, order = [], [], []
    training = runner.model.training
    runner.model.eval()
    try:
        with torch.inference_mode():
            for raw in common.make_loader(runner.args, runner.cfg, dataset,
                                          shuffle=False, batch_size=vb,
                                          drop_last=False, mesh=mesh):
                order.append(np.asarray(raw["index"]))
                video = torch.from_numpy(raw["video"]).to(runner.device)
                cols = [score_block(runner, video,
                                    texts[i:i + TEXTS_PER_CALL])
                        for i in range(0, len(texts), TEXTS_PER_CALL)]
                gen_rows.append(np.concatenate([c[0] for c in cols], 1))
                if cols[0][1] is not None:
                    cls_rows.append(np.concatenate([c[1] for c in cols], 1))
    finally:
        runner.model.train(training)
    order = np.concatenate(order)
    gen, _ = common.gather_eval_rows(np.concatenate(gen_rows), order, mesh)
    res = {"gen_" + k: v for k, v in itm_eval(
        gen, gen.T, dataset.txt2vid, dataset.vid2txt).items()}
    if cls_rows:
        cls, _ = common.gather_eval_rows(np.concatenate(cls_rows), order,
                                         mesh)
        res.update({"cls_" + k: v for k, v in itm_eval(
            cls, cls.T, dataset.txt2vid, dataset.vid2txt).items()})
    if common.main_rank(runner):
        print("* ITM retrieval:", res, flush=True)
    return res


def main(args) -> common.Runner:
    def body():
        runner, _, test_ds = prepare(args)
        if not args.evaluate_only:
            common.train_epochs(runner, build_train_step(runner),
                                make_batch)
        common.finish(runner, {"test": evaluation(runner, test_ds)})
        return runner
    return common.run_main(body)


if __name__ == "__main__":
    main(parser().parse_args())
