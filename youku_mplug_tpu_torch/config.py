"""Config loading: the JAX package's YAML/JSON contract
(``youku_mplug_tpu/config.py``), for the keys the port's runners read
— ``text_cfg``, ``visual_cfg``, ``text_overrides``, ``visual_overrides``,
``num_frames``, ``num_learnable_token``, ``use_contrastive``,
``embed_dim``, ``temp``, ``use_cls``, ``num_classes``, ``freeze_vit``,
``freeze_text_decoder``, the ``optimizer`` and ``schedular`` blocks (with
``visual_backbone_scale`` set for a ``clip_model`` tower, as the JAX
loader sets it), ``update_freq``, ``epochs``, ``prompt``, ``batch_size``,
``max_length``, ``image_res``, and via ``RunConfig.get`` as the JAX
loader leaves them in its raw dict ``synthetic_length``,
``text_decoder``, ``max_new_tokens``, ``beam_size``,
``async_checkpointing``, ``classname_file``, ``eval_video_batch`` and
``import_torch_weights`` (``models/importers.import_all``);
``dump_config`` writes the merged YAML
into a run's output directory; and ``load_owl_config`` /
``instruct_train_config``, the mPLUG-Owl instruct YAML of
``youku_mplug_tpu/cli/run_instruct.py`` (the model blocks, and the
training keys its ``train_main`` reads)."""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import yaml

from youku_mplug_tpu_torch.models.bloom import BloomConfig
from youku_mplug_tpu_torch.models.gpt3 import GPT3Config
from youku_mplug_tpu_torch.models.owl import (
    MPLUGOwlVideoConfig,
    OwlAbstractorConfig,
)
from youku_mplug_tpu_torch.models.tasks import MPLUGVideoConfig
from youku_mplug_tpu_torch.models.vision import VisionConfig
from youku_mplug_tpu_torch.optim.factory import OptimizerConfig


@dataclasses.dataclass
class RunConfig:
    raw: Dict[str, Any]
    model: MPLUGVideoConfig
    optimizer: OptimizerConfig = OptimizerConfig()
    batch_size: int = 8
    max_length: int = 80
    num_frames: int = 8
    image_res: int = 224
    prompt: str = ""
    epochs: int = 10
    update_freq: int = 1

    def get(self, key, default=None):
        return self.raw.get(key, default)


def _optimizer_config(raw, model: MPLUGVideoConfig) -> OptimizerConfig:
    opt = dict(raw.get("optimizer", {}))
    sched = dict(raw.get("schedular", raw.get("scheduler", {})))
    return OptimizerConfig(
        opt=str(opt.get("opt", "adamw")).lower(),
        lr=float(opt.get("lr", 1e-4)),
        min_lr=float(sched.get("min_lr", 1e-6)),
        weight_decay=float(opt.get("weight_decay", 0.05)),
        opt_betas=tuple(opt.get("opt_betas", (0.9, 0.999))),
        opt_eps=float(opt.get("opt_eps", 1e-8)),
        clip_grad=(float(opt["clip_grad"]) if opt.get("clip_grad")
                   else None),
        warmup_steps=int(sched.get("warmup_steps", -1)),
        warmup_epochs=max(float(sched.get("warmup_epochs", 0) or 0), 0),
        epochs=int(sched.get("epochs", raw.get("epochs", 10))),
        sched_type=str(sched.get("lr_sched_type", "cos")
                       ).replace("cosine", "cos"),
        visual_backbone_scale=bool(model.vision.clip_model),
        freeze_text_decoder=model.freeze_text_decoder,
        freeze_vit=model.freeze_vit)


def load_config(yaml_path: str,
                overrides: Optional[Dict[str, Any]] = None) -> RunConfig:
    with open(yaml_path) as f:
        raw = yaml.safe_load(f)
    raw.update(overrides or {})
    if raw.get("connect_ln"):
        raise NotImplementedError("connect_ln (visual_norm) is not ported yet")
    # a top-level lora_rank (with its lora_alpha) makes the JAX loader grow
    # GPT-3 adapters; lora_alpha with no rank builds no adapter there either
    if raw.get("lora_rank"):
        raise NotImplementedError("a top-level lora_rank / lora_alpha (GPT-3 "
                                  "LoRA adapters) is not ported yet")
    root = os.path.dirname(os.path.dirname(os.path.abspath(yaml_path)))

    def resolve(p):
        # relative model JSON paths: as given (from the repo root), else
        # next to the configs/ tree the YAML lives in
        if p and not os.path.isabs(p) and not os.path.exists(p):
            for base in (root, os.path.dirname(root)):
                if os.path.exists(os.path.join(base, p)):
                    return os.path.join(base, p)
        return p

    text_path, visual_path = resolve(raw.get("text_cfg")), \
        resolve(raw.get("visual_cfg"))
    text = (GPT3Config.from_json_file(text_path)
            if text_path and os.path.exists(text_path) else GPT3Config())
    if raw.get("text_overrides"):
        text = dataclasses.replace(text, **raw["text_overrides"])
    vision = (VisionConfig.from_json_file(visual_path)
              if visual_path and os.path.exists(visual_path)
              else VisionConfig())
    num_frames = int(raw.get("num_frames", vision.num_frames))
    vision = dataclasses.replace(vision, num_frames=num_frames)
    if raw.get("visual_overrides"):
        vision = dataclasses.replace(vision, **raw["visual_overrides"])
    model = MPLUGVideoConfig(
        vision=vision, text=text,
        num_learnable_token=int(raw.get("num_learnable_token", 256)),
        use_contrastive=bool(raw.get("use_contrastive", False)),
        contrastive_embed_dim=int(raw.get("embed_dim", 256)),
        temp=float(raw.get("temp", 0.07)),
        use_cls=bool(raw.get("use_cls", False)),
        num_classes=int(raw.get("num_classes", 0)),
        freeze_vit=bool(raw.get("freeze_vit", False)),
        freeze_text_decoder=bool(raw.get("freeze_text_decoder", True)))
    sched = dict(raw.get("schedular", raw.get("scheduler", {})))
    return RunConfig(
        raw=raw, model=model, optimizer=_optimizer_config(raw, model),
        batch_size=int(raw.get("batch_size", 8)),
        max_length=int(raw.get("max_length", 80)),
        num_frames=num_frames,
        image_res=int(raw.get("image_res", vision.img_size)),
        prompt=str(raw.get("prompt", "") or ""),
        epochs=int(sched.get("epochs", raw.get("epochs", 10))),
        update_freq=int(raw.get("update_freq", 1)))


def dump_config(cfg: RunConfig, output_dir: str):
    """The merged raw config as ``<output_dir>/config.yaml``."""
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(cfg.raw, f, allow_unicode=True)


def flagship_config(tiny: bool = False) -> MPLUGVideoConfig:
    """The repo's flagship model (``__graft_entry__._flagship_cfg``):
    TimeSformer ViT-B/16 (12 heads of 64, 8 frames at 224 px, every sixth
    block checkpointed), 128 learnable queries, GPT-3 1.3B (24 layers,
    hidden 2048, 32 heads of 64, vocab 51200, no dropout, every layer
    checkpointed, CE chunk 32).  ``tiny``: the same structure at test
    size."""
    if tiny:
        return MPLUGVideoConfig(
            vision=VisionConfig(img_size=32, patch_size=16, embed_dim=64,
                                depth=2, num_heads=4, num_frames=2,
                                mlp_ratio=2.0),
            text=GPT3Config(vocab_size=256, hidden_size=64,
                            num_hidden_layers=2, num_attention_heads=4,
                            max_position_embeddings=256, hidden_dropout=0.0,
                            attention_dropout=0.0),
            num_learnable_token=8, contrastive_embed_dim=32)
    return MPLUGVideoConfig(
        vision=VisionConfig(img_size=224, patch_size=16, embed_dim=768,
                            depth=12, num_heads=12, num_frames=8,
                            mlp_ratio=4.0, grad_ckpt=True,
                            remat_policy="sixth"),
        text=GPT3Config(vocab_size=51200, hidden_size=2048,
                        num_hidden_layers=24, num_attention_heads=32,
                        max_position_embeddings=2048,
                        layernorm_epsilon=1e-5, hidden_dropout=0.0,
                        attention_dropout=0.0, remat=True, ce_chunk=32),
        num_learnable_token=128)


def load_owl_config(path: str) -> tuple:
    """Instruct YAML -> (MPLUGOwlVideoConfig, raw dict), as the JAX
    package's ``cli/run_instruct.load_owl_config`` reads it: the Bloom
    (``bloom_model_json``) and vision (``vision_model_json``) JSONs
    resolve next to the YAML first, then as given; ``text_overrides``,
    ``vision_overrides`` and ``abstractor`` fill the rest, and the vision
    GELU is quick (the CLIP-lineage tower) unless the YAML says
    otherwise."""
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    base = os.path.dirname(os.path.abspath(path))

    def resolve(p):
        if p and not os.path.isabs(p):
            for cand in (os.path.join(base, p), p):
                if os.path.exists(cand):
                    return cand
        return p

    text_kw = dict(raw.get("text_overrides") or {})
    tj = resolve(raw.get("bloom_model_json", ""))
    text = (BloomConfig.from_json_file(tj, **text_kw) if tj
            else BloomConfig(**text_kw))
    vis_kw = dict(raw.get("vision_overrides") or {})
    vis_kw.setdefault("gelu", "quick")
    vj = resolve(raw.get("vision_model_json", ""))
    vision = (VisionConfig.from_json_file(vj, **vis_kw) if vj
              else VisionConfig(**vis_kw))
    abstractor = OwlAbstractorConfig(**(raw.get("abstractor") or {}))
    return MPLUGOwlVideoConfig(vision=vision, abstractor=abstractor,
                               text=text), raw


@dataclasses.dataclass(frozen=True)
class InstructTrainConfig:
    """The training keys of an instruct YAML, with the JAX runner's
    defaults (``youku_mplug_tpu/cli/run_instruct.py`` ``train_main`` and
    ``build_train_loader``).  ``optimizer`` still needs its
    ``niter_per_ep``, which the loader decides."""

    optimizer: OptimizerConfig
    batch_size: int = 2
    epochs: int = 3
    max_length: int = 0
    update_freq: int = 1
    synthetic_length: int = 16
    num_frames: int = 8


def instruct_train_config(raw: Dict[str, Any]) -> InstructTrainConfig:
    """The raw instruct YAML -> its training keys: the ``optimizer`` block
    as given (lr 1e-4 by default, the rest ``OptimizerConfig``'s
    defaults), ``epochs`` for the schedule, and ``freeze_vit`` /
    ``freeze_text_decoder`` both True unless the YAML says otherwise."""
    epochs = int(raw.get("epochs", 3))
    opt_kw = dict(raw.get("optimizer") or {})
    opt_kw.setdefault("lr", 1e-4)
    for k in ("epochs", "niter_per_ep", "freeze_text_decoder",
              "freeze_vit"):
        opt_kw.pop(k, None)
    if "opt_betas" in opt_kw:
        opt_kw["opt_betas"] = tuple(opt_kw["opt_betas"])
    optimizer = OptimizerConfig(
        **opt_kw, epochs=epochs,
        freeze_text_decoder=bool(raw.get("freeze_text_decoder", True)),
        freeze_vit=bool(raw.get("freeze_vit", True)))
    return InstructTrainConfig(
        optimizer=optimizer, batch_size=int(raw.get("batch_size", 2)),
        epochs=epochs, max_length=int(raw.get("max_length", 0)),
        update_freq=int(raw.get("update_freq", 1)),
        synthetic_length=int(raw.get("synthetic_length", 16)),
        num_frames=int(raw.get("num_frames", 8)))
