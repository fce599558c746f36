"""Export a trained run as a serving checkpoint.

Counterpart of the JAX package's ``tools/export_serving.py``: restore the
run's latest training checkpoint, merge its trainable and frozen leaves,
fold each tower's LoRA adapters into its base kernels with that tower's
own rank and alpha (``ops/lora.merge_lora``), with ``--int8``
int8-quantize the decoder (``ops/quant.quantize_gpt3_decoder``; the tied
embedding too with ``--int8_embedding``), and save ``{"params",
"qscales"}`` as one step of the port's checkpoint format
(``train/checkpoint.py``, CPU tensors under the JAX names) with JAX's
metadata ``source_step``, ``lora_merged`` and ``int8``.  The work runs on
``--device`` (the card by default).

``--owl`` exports a ``run_instruct --train`` run (the YAML is the
instruct config); serve the result with ``run_instruct --serving_ckpt
DEST``.

Usage:
    python -m youku_mplug_tpu_torch.cli.export_serving --owl --run_dir \\
        OUT --config configs/instruct/train_bloomz_7b_flagship.yaml \\
        --dest OUT/serving --int8 --int8_embedding
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict

from youku_mplug_tpu_torch.bridge import flatten, unflatten
from youku_mplug_tpu_torch.cli import common
from youku_mplug_tpu_torch.config import load_config, load_owl_config
from youku_mplug_tpu_torch.ops.lora import merge_lora
from youku_mplug_tpu_torch.ops.quant import quantize_gpt3_decoder
from youku_mplug_tpu_torch.train.checkpoint import CheckpointManager


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="export a trained run as a serving checkpoint")
    p.add_argument("--run_dir", required=True,
                   help="training output_dir (holds checkpoints/)")
    p.add_argument("--config", required=True, help="the run's YAML")
    p.add_argument("--dest", required=True, help="serving ckpt directory")
    p.add_argument("--int8", action="store_true",
                   help="int8-quantize the decoder kernels")
    p.add_argument("--int8_embedding", action="store_true",
                   help="also quantize the tied embedding (serving only)")
    p.add_argument("--owl", action="store_true",
                   help="the run is a run_instruct --train (BloomZ "
                        "video-instruct) finetune")
    p.add_argument("--device", default="cuda",
                   help="cuda[:i] (default), or cpu")
    return p


def _to_cpu(tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _to_cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


def export(args) -> Dict[str, Any]:
    """Write the serving checkpoint; returns what was saved."""
    device = common.device_of(args)
    if args.owl:
        owl_cfg, _ = load_owl_config(args.config)
        text_cfg, vis_cfg = owl_cfg.text, owl_cfg.vision
    else:
        model_cfg = load_config(args.config).model
        text_cfg, vis_cfg = model_cfg.text, model_cfg.vision
    ckpt = CheckpointManager(os.path.join(args.run_dir, "checkpoints"))
    step = ckpt.latest_step()
    if step is None:
        raise SystemExit(f"no checkpoint under {args.run_dir}/checkpoints")
    raw = ckpt.restore_raw(step, map_location=device)
    params = unflatten({**raw["trainable"], **raw["frozen"]})
    del raw

    # each tower with its own rank and alpha: a single global merge would
    # fold the text scale into the vision kernels (and vice versa)
    rank = getattr(text_cfg, "lora_rank", 0) or vis_cfg.lora_rank
    for tower, tc in (("text_decoder", text_cfg),
                      ("visual_encoder", vis_cfg)):
        tower_rank = getattr(tc, "lora_rank", 0)
        if tower_rank and tower in params:
            params[tower] = merge_lora(params[tower], tower_rank,
                                       tc.lora_alpha)
            print(f"merged {tower} LoRA adapters (rank {tower_rank}, "
                  f"alpha {tc.lora_alpha})", flush=True)

    out = {"params": params}
    if args.int8:
        qdec, scales = quantize_gpt3_decoder(
            params["text_decoder"], include_embedding=args.int8_embedding)
        params["text_decoder"] = qdec
        out["qscales"] = {"text_decoder": scales}
        print("int8 decoder kernels"
              + (" + embedding" if args.int8_embedding else ""), flush=True)
    out = _to_cpu(out)
    CheckpointManager(args.dest).save(
        step, out, metadata={"source_step": int(step),
                             "lora_merged": bool(rank),
                             "int8": bool(args.int8)})
    n = sum(t.numel() for t in flatten(out["params"]).values())
    print(f"wrote serving checkpoint (step {step}, {n / 1e6:.1f}M params) "
          f"to {args.dest}", flush=True)
    return out


def main(argv=None):
    return export(parser().parse_args(argv))


if __name__ == "__main__":
    main()
