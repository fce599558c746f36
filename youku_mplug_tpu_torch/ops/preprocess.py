"""Device-side clip normalization (counterpart of
``youku_mplug_tpu/ops/preprocess.py``): uint8 clips go to the device and
are cast, scaled and normalized there."""

from __future__ import annotations

import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def normalize_clip(clips_u8: torch.Tensor, mean=CLIP_MEAN, std=CLIP_STD,
                   dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(B, T, H, W, C) uint8 -> (B, C, T, H, W) normalized ``dtype``."""
    x = clips_u8.float() / 255.0
    mean = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(std, dtype=torch.float32, device=x.device)
    x = (x - mean) / std
    return x.permute(0, 4, 1, 2, 3).to(dtype).contiguous()
