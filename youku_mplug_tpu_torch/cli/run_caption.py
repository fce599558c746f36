"""Video captioning CLI: finetune, checkpoint, then beam-decode and score
the test clips.

Counterpart of ``youku_mplug_tpu/cli/run_caption.py`` on
``cli/common.py``.  Training takes (prompt, caption) pairs through the
prefix-LM ``caption_loss`` (the prompt's positions out of the loss), saves
a checkpoint each ``--save_ckpt_freq`` epochs, resumes from the run's own
checkpoints or from ``--resume <dir>`` (a pretrain run's, say), and rolls
back after 3 non-finite steps in a row.  Evaluation tokenizes the prompt
at 20 tokens, encodes each test batch's clips and decodes them in one
batched beam search (``beam_size``, default 5; ``max_new_tokens``,
default the decoder's ``tokens_to_generate``) whose every step after the
prefill runs the decode kernel on the card; ``--max_steps`` caps the
evaluation batches too.  It writes ``caption_results.json`` (each clip's
caption, its gold captions, and the token ids and beam score it came
from) and a ``log.txt`` line ``{"test": metrics}`` (BLEU-1..4, ROUGE-L,
CIDEr, METEOR over Chinese-character-normalized text).
``--evaluate_only --resume <dir>`` skips training.  Under ``python -m
torch.distributed.run`` both train and evaluate under the YAML's
``mesh:`` split (``cli/common.py``; as ``run_pretrain``): the finetune
steps equal the unsplit ones on the same global batches, and the beam
search runs on each model rank's heads and vocab rows (the decode kernel
on the local heads' cache) over its data rank's stride of the test clips,
``local_batch_size`` clips a batch, merged on the host
(``collect_records``).  The clips come from
the YAML's ``train_file`` and ``test_file`` under ``video_root``
(``data/datasets.CaptionVideoDataset``: ``num_frames`` a clip, ``rand``
and the train transform in training, ``middle`` and a resize in the test
split), decoded on ``num_workers`` threads, or with
``--synthetic_data`` procedural clips.

Usage (the card is the default device; ``--device cpu --fp32`` runs a
tiny config on the CPU):
    python -m youku_mplug_tpu_torch.cli.run_caption \\
        --config configs/caption/caption_gpt3_1.3B_flagship.yaml \\
        --synthetic_data --max_steps 2 --output_dir out
    python -m youku_mplug_tpu_torch.cli.run_caption \\
        --config <a caption YAML whose train_file, test_file and
                  video_root name your files> --max_steps 2 --output_dir out
    python -m youku_mplug_tpu_torch.cli.run_caption \\
        --config configs/caption/caption_gpt3_1.3B_flagship.yaml \\
        --synthetic_data --evaluate_only --resume out --output_dir eval
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Tuple

import torch

from youku_mplug_tpu_torch.cli import common
from youku_mplug_tpu_torch.config import RunConfig, load_config
from youku_mplug_tpu_torch.data.datasets import (
    CaptionVideoDataset,
    SyntheticVideoDataset,
)
from youku_mplug_tpu_torch.data.loader import Loader
from youku_mplug_tpu_torch.data.transforms import (
    test_transform,
    train_transform,
)
from youku_mplug_tpu_torch.evals.metrics import caption_eval
from youku_mplug_tpu_torch.models.generation import GenerationConfig
from youku_mplug_tpu_torch.models.tasks import MPLUGVideo, generate_captions
from youku_mplug_tpu_torch.ops.preprocess import normalize_clip
from youku_mplug_tpu_torch.train.trainer import make_train_step

PROMPT_LENGTH = 20  # tokens the evaluation prompt is padded to


def parser():
    return common.base_parser("video captioning (PyTorch)")


def dataset(args, cfg: RunConfig, train: bool):
    """The train or test split: the YAML's ``train_file`` / ``test_file``
    under ``video_root`` (JAX ``build_loaders``), or synthetic clips."""
    if args.synthetic_data:
        return SyntheticVideoDataset(length=cfg.get("synthetic_length", 32),
                                     num_frames=cfg.num_frames,
                                     size=cfg.image_res)
    return CaptionVideoDataset(
        cfg.get("train_file" if train else "test_file"),
        cfg.get("video_root"),
        transform=(train_transform if train else test_transform)(
            cfg.image_res),
        num_frames=cfg.num_frames, train=train,
        seed=args.seed if train else 0, **common.decode_kwargs(cfg))


def build_loaders(args, cfg: RunConfig, mesh=None) -> Tuple[Loader, Loader]:
    """Train (shuffled) and test loaders; with a ``mesh``, the train
    loader's block of every global batch and the test loader's stride of
    the clips at ``local_batch_size`` a batch (the same clips as the
    unsplit run's wherever the data degree divides the split)."""
    return (common.make_loader(args, cfg, dataset(args, cfg, True),
                               block=mesh),
            common.eval_loader(args, cfg, dataset(args, cfg, False), mesh))


def prepare(args) -> Tuple[common.Runner, Loader]:
    """The runner (``common.setup``: mesh, model, state, checkpoints,
    resume) and the test loader."""
    cfg = load_config(args.config)
    mesh = common.init_mesh(args, cfg.mesh)
    train_loader, test_loader = build_loaders(args, cfg, mesh)
    return (common.setup(args, cfg, train_loader, mesh=mesh),
            test_loader)


def make_batch(runner: common.Runner, raw) -> Dict[str, torch.Tensor]:
    text = runner.tokenizer([(runner.cfg.prompt, t) for t in raw["text"]],
                            padding="max_length")
    return common.put_batch(runner, {"video": raw["video"], **text})


def make_loss_fn(model: MPLUGVideo):
    def loss_fn(batch, generator=None):
        video = normalize_clip(batch["video"],
                               dtype=model.policy.compute_dtype)
        return model.caption_loss(video, batch["input_ids"],
                                  batch["attention_mask"],
                                  batch["prompt_lengths"],
                                  generator=generator)
    return loss_fn


def build_train_step(runner: common.Runner):
    return make_train_step(make_loss_fn(runner.model),
                           update_freq=runner.cfg.update_freq,
                           dropout_seed=runner.args.seed)


def generation_config(runner: common.Runner) -> GenerationConfig:
    cfg, tok = runner.cfg, runner.tokenizer.tokenizer
    return GenerationConfig(
        max_new_tokens=int(cfg.get("max_new_tokens",
                                   cfg.model.text.tokens_to_generate)),
        eos_id=tok.eos_id, pad_id=tok.pad_id, do_sample=False,
        beam_size=int(cfg.get("beam_size", 5)))


def eval_inputs(runner: common.Runner, raw):
    """A test batch's normalized clips and prompt ids and mask on the
    device."""
    text = runner.tokenizer([runner.cfg.prompt] * len(raw["video"]),
                            padding="max_length", max_length=PROMPT_LENGTH)
    dev = runner.device
    video = normalize_clip(torch.from_numpy(raw["video"]).to(dev),
                           dtype=runner.model.policy.compute_dtype)
    return (video, torch.from_numpy(text["input_ids"]).long().to(dev),
            torch.from_numpy(text["attention_mask"]).to(dev))


def evaluation(runner: common.Runner, loader: Loader
               ) -> Tuple[Dict[str, float], List[dict], Dict[str, float]]:
    """Caption each test batch (at most --max_steps of them) and score
    the captions.  Returns (metrics, records, stats: clips, batches, the
    decode steps run, the tokens of the returned sequences up to their
    eos, and the seconds spent in ``generate_captions``)."""
    cfg, max_steps = runner.cfg, runner.args.max_steps
    gen_cfg = generation_config(runner)
    eos = gen_cfg.eos_id
    results: List[dict] = []
    stats = {"clips": 0, "batches": 0, "decode_steps": 0, "tokens": 0,
             "generate_s": 0.0}
    training = runner.model.training
    runner.model.eval()
    try:
        for it, raw in enumerate(loader):
            if 0 < max_steps <= it:
                break
            video, ids, mask = eval_inputs(runner, raw)
            t0 = time.perf_counter()
            out = generate_captions(runner.model, video, ids, mask, gen_cfg)
            seqs = out["sequences"].cpu().numpy()  # waits for the device
            stats["generate_s"] += time.perf_counter() - t0
            stats["decode_steps"] += out["decode_steps"]
            stats["batches"] += 1
            for vid, seq, score, golden in zip(raw["video_id"], seqs,
                                               out["scores"].tolist(),
                                               raw["golden"]):
                ans = runner.tokenizer.decode(seq).replace(" ", "").strip()
                if cfg.prompt:
                    ans = ans.split(cfg.prompt)[-1].strip()
                ends = [i for i, t in enumerate(seq) if t == eos]
                stats["tokens"] += ends[0] + 1 if ends else len(seq)
                stats["clips"] += 1
                results.append({"video_id": vid, "pred_caption": ans,
                                "gold_caption": list(golden),
                                "tokens": seq.tolist(), "score": score})
    finally:
        runner.model.train(training)
    results = common.collect_records(results, dedup_key="video_id",
                                     mesh=runner.mesh)
    metrics = caption_eval(results)
    if common.main_rank(runner):
        print("* Caption metrics:", json.dumps(metrics, ensure_ascii=False),
              flush=True)
    return metrics, results, stats


def main(args) -> common.Runner:
    def body():
        runner, test_loader = prepare(args)
        if not args.evaluate_only:
            common.train_epochs(runner, build_train_step(runner),
                                make_batch)
        metrics, results, _ = evaluation(runner, test_loader)
        if common.main_rank(runner):
            with open(os.path.join(args.output_dir, "caption_results.json"),
                      "w") as f:
                json.dump(results, f, ensure_ascii=False)
        common.finish(runner, {"test": metrics})
        return runner
    return common.run_main(body)


if __name__ == "__main__":
    main(parser().parse_args())
