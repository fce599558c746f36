"""LayerNorm with a forced fp32 island (forward only).

Counterpart of ``youku_mplug_tpu/ops/layernorm.py``: statistics and
normalization in fp32 whatever the input dtype, result cast back.
"""

from __future__ import annotations

import torch


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
               eps: float = 1e-5) -> torch.Tensor:
    """fp32-island layernorm over the last axis; returns x.dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)
