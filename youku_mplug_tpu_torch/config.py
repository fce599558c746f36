"""Config loading for the serving path: the JAX package's YAML/JSON
contract (``youku_mplug_tpu/config.py``), limited to the keys serving
reads — ``text_cfg``, ``visual_cfg``, ``text_overrides``,
``visual_overrides``, ``num_frames``, ``num_learnable_token``, ``prompt``,
``max_new_tokens``, ``batch_size``, ``max_length``, ``image_res`` and
``synthetic_length`` (the last three via ``RunConfig.get``)."""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import yaml

from youku_mplug_tpu_torch.models.gpt3 import GPT3Config
from youku_mplug_tpu_torch.models.tasks import MPLUGVideoConfig
from youku_mplug_tpu_torch.models.vision import VisionConfig


@dataclasses.dataclass
class RunConfig:
    raw: Dict[str, Any]
    model: MPLUGVideoConfig
    batch_size: int = 8
    max_length: int = 80
    num_frames: int = 8
    image_res: int = 224
    prompt: str = ""

    def get(self, key, default=None):
        return self.raw.get(key, default)


def load_config(yaml_path: str,
                overrides: Optional[Dict[str, Any]] = None) -> RunConfig:
    with open(yaml_path) as f:
        raw = yaml.safe_load(f)
    raw.update(overrides or {})
    if raw.get("connect_ln"):
        raise NotImplementedError("connect_ln (visual_norm) is not ported yet")
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
        num_learnable_token=int(raw.get("num_learnable_token", 256)))
    return RunConfig(
        raw=raw, model=model,
        batch_size=int(raw.get("batch_size", 8)),
        max_length=int(raw.get("max_length", 80)),
        num_frames=num_frames,
        image_res=int(raw.get("image_res", vision.img_size)),
        prompt=str(raw.get("prompt", "") or ""))


def flagship_config(tiny: bool = False) -> MPLUGVideoConfig:
    """The repo's flagship model (``__graft_entry__._flagship_cfg``):
    TimeSformer ViT-B/16 (12 heads of 64, 8 frames at 224 px), 128
    learnable queries, GPT-3 1.3B (24 layers, hidden 2048, 32 heads of
    64, vocab 51200).  ``tiny``: the same structure at test size."""
    if tiny:
        return MPLUGVideoConfig(
            vision=VisionConfig(img_size=32, patch_size=16, embed_dim=64,
                                depth=2, num_heads=4, num_frames=2,
                                mlp_ratio=2.0),
            text=GPT3Config(vocab_size=256, hidden_size=64,
                            num_hidden_layers=2, num_attention_heads=4,
                            max_position_embeddings=256),
            num_learnable_token=8)
    return MPLUGVideoConfig(
        vision=VisionConfig(img_size=224, patch_size=16, embed_dim=768,
                            depth=12, num_heads=12, num_frames=8,
                            mlp_ratio=4.0),
        text=GPT3Config(vocab_size=51200, hidden_size=2048,
                        num_hidden_layers=24, num_attention_heads=32,
                        max_position_embeddings=2048,
                        layernorm_epsilon=1e-5),
        num_learnable_token=128)
