"""XCLIP / VideoFormer: the CLIP visual tower with Local MHRA temporal
blocks.

Counterpart of ``youku_mplug_tpu/models/clip_video.py`` (the reference's
Local_MHRA, TemporalBlock, VideoFormer, XCLIP and inflate_weight):

- patchify per frame (``conv1`` [3 p p, W]), or with
  ``temporal_downsampling`` through a 3-D conv (``conv1_3d`` [3, p, p, 3,
  W], temporal stride ``temporal_stride``, one frame of zero padding on
  each side), written out as one product over folded (t, p, p) patches;
- each block: Local MHRA (LN -> ``reduce`` -> a depthwise temporal conv
  of ``pos_kernel_size`` taps -> ``expand``, zero-initialised in the
  reference so an inflated model starts as per-frame CLIP) on the patch
  tokens, per-frame spatial attention (plain, as in JAX), an optional
  second MHRA, the QuickGELU FFN;
- the tower returns per-frame tokens [B T', 1 + HW, W] after ``ln_post``;
  ``XCLIP.encode_video`` mean-pools the frames' cls tokens and projects.

``inflate_clip_to_videoformer`` maps a CLIP tree's visual weights onto a
VideoFormer's (the 2-D ``conv1`` replicated over the 3 temporal taps and
divided by 3 where the tower downsamples time; the blocks copied 1:1);
the MHRA leaves it leaves out come from the caller's init.  Parameters
keep the JAX names and shapes (``block_<i>``, ``lmhra1``, ``dw_kernel``
[k, 1, 1, 1, C]).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from youku_mplug_tpu_torch.models.clip import (
    LN_EPS,
    CLIPConfig,
    CLIPTextTower,
    _blocks,
    attention,
    quick_gelu,
)
from youku_mplug_tpu_torch.models.tasks import Dense
from youku_mplug_tpu_torch.models.vision import LayerNormFP32, _param
from youku_mplug_tpu_torch.runtime.precision import DEFAULT_POLICY, Policy


@dataclasses.dataclass(frozen=True)
class VideoFormerConfig:
    clip: CLIPConfig = CLIPConfig()
    num_frames: int = 8
    dw_reduction: float = 1.5
    pos_kernel_size: int = 3
    double_lmhra: bool = False
    temporal_downsampling: bool = False
    temporal_stride: int = 2


class LocalMHRA(nn.Module):
    """The depthwise temporal-conv residual branch over [B, T, H, W, C]:
    LN -> ``reduce`` -> per channel a ``kernel``-tap conv over T (zero
    padded to keep T) plus ``dw_bias`` -> ``expand``."""

    def __init__(self, dim: int, dw_reduction: float = 1.5,
                 kernel: int = 3, dtype=torch.float32):
        super().__init__()
        red = int(dim // dw_reduction)
        self.kernel = kernel
        self.ln = LayerNormFP32(dim, LN_EPS, dtype)
        self.reduce = Dense(dim, red, dtype)
        self.dw_kernel = _param(kernel, 1, 1, 1, red, dtype=dtype)
        self.dw_bias = _param(red, dtype=dtype)
        self.expand = Dense(red, dim, dtype)

    def forward(self, x):
        x = self.reduce(self.ln(x))
        t, pad = x.shape[1], self.kernel // 2
        xp = F.pad(x, (0, 0, 0, 0, 0, 0, pad, pad))
        w = self.dw_kernel.to(x.dtype)
        y = sum(xp[:, j:j + t] * w[j] for j in range(self.kernel))
        return self.expand(y + self.dw_bias.to(x.dtype))


class TemporalBlock(nn.Module):
    """MHRA, spatial attention per frame, (MHRA), FFN over
    x [B T, 1 + HW, W] with the frame grid ``grid``."""

    def __init__(self, cfg: VideoFormerConfig, dtype=torch.float32):
        super().__init__()
        w = cfg.clip.vision_width
        self.cfg = cfg
        self.lmhra1 = LocalMHRA(w, cfg.dw_reduction, cfg.pos_kernel_size,
                                dtype)
        self.ln_1 = LayerNormFP32(w, LN_EPS, dtype)
        self.in_proj = Dense(w, 3 * w, dtype)
        self.out_proj = Dense(w, w, dtype)
        if cfg.double_lmhra:
            self.lmhra2 = LocalMHRA(w, cfg.dw_reduction,
                                    cfg.pos_kernel_size, dtype)
        self.ln_2 = LayerNormFP32(w, LN_EPS, dtype)
        self.c_fc = Dense(w, 4 * w, dtype)
        self.c_proj = Dense(4 * w, w, dtype)

    def forward(self, x, t: int, grid):
        w = self.cfg.clip.vision_width
        bt, s, _ = x.shape
        b = bt // t

        def mhra(tokens, branch):
            patches = tokens[:, 1:, :].reshape(b, t, grid[0], grid[1], w)
            patches = patches + branch(patches)
            return torch.cat([tokens[:, :1, :],
                              patches.reshape(bt, s - 1, w)], dim=1)

        x = mhra(x, self.lmhra1)
        x = x + attention(self.ln_1(x), self.in_proj, self.out_proj,
                          self.cfg.clip.vision_heads)
        if self.cfg.double_lmhra:
            x = mhra(x, self.lmhra2)
        return x + self.c_proj(quick_gelu(self.c_fc(self.ln_2(x))))


class VideoFormer(nn.Module):
    """video [B, 3, T, H, W] -> per-frame tokens [B T', 1 + HW, W] after
    ``ln_post``."""

    def __init__(self, cfg: VideoFormerConfig,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        c, dt = cfg.clip, policy.param_dtype
        w, p = c.vision_width, c.vision_patch_size
        self.cfg, self.policy = cfg, policy
        grid = c.image_resolution // p
        if cfg.temporal_downsampling:
            self.conv1_3d = _param(3, p, p, 3, w, dtype=dt)
        else:
            self.conv1 = _param(3 * p * p, w, dtype=dt)
        self.class_embedding = _param(w, dtype=dt)
        self.positional_embedding = _param(grid * grid + 1, w, dtype=dt)
        self.ln_pre = LayerNormFP32(w, LN_EPS, dt)
        self.blocks = _blocks(self, c.vision_layers,
                              lambda: TemporalBlock(cfg, dt))
        self.ln_post = LayerNormFP32(w, LN_EPS, dt)

    def forward(self, video):
        cfg = self.cfg
        w, p = cfg.clip.vision_width, cfg.clip.vision_patch_size
        b, ch, t, hh, ww = video.shape
        gh, gw = hh // p, ww // p
        x = video.to(self.policy.compute_dtype)
        if cfg.temporal_downsampling:
            # NTHWC, one zero frame each side, taps t_o * stride + (0..2)
            x = F.pad(x.permute(0, 2, 3, 4, 1), (0, 0, 0, 0, 0, 0, 1, 1))
            t_out = (t + 2 - 3) // cfg.temporal_stride + 1
            idx = (cfg.temporal_stride * torch.arange(t_out)[:, None]
                   + torch.arange(3)[None]).to(x.device)
            x = x[:, idx]  # [B, T', 3, H, W, C]
            x = x.reshape(b, t_out, 3, gh, p, gw, p, ch).permute(
                0, 1, 3, 5, 2, 4, 6, 7)
            x = x.reshape(b * t_out, gh * gw, 3 * p * p * ch) \
                @ self.conv1_3d.reshape(3 * p * p * ch, w).to(x.dtype)
        else:
            x = x.transpose(1, 2).reshape(b * t, ch, gh, p, gw, p)
            x = x.permute(0, 2, 4, 1, 3, 5).reshape(b * t, gh * gw,
                                                    ch * p * p)
            x = x @ self.conv1.to(x.dtype)
            t_out = t
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, w)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(
            x.dtype)
        x = self.ln_pre(x)
        for blk in self.blocks:
            x = blk(x, t_out, (gh, gw))
        return self.ln_post(x)


class XCLIP(nn.Module):
    """VideoFormer visual tower and the CLIP text tower."""

    def __init__(self, cfg: VideoFormerConfig,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.cfg = cfg
        self.visual = VideoFormer(cfg, policy)
        self.text = CLIPTextTower(cfg.clip, policy)
        self.logit_scale = nn.Parameter(
            torch.tensor(math.log(1 / 0.07), dtype=torch.float32),
            requires_grad=False)
        self.proj = _param(cfg.clip.vision_width, cfg.clip.embed_dim,
                           dtype=policy.param_dtype)

    def encode_video(self, video):
        """-> [B, E]: the frames' cls tokens mean-pooled, projected."""
        b = video.shape[0]
        tokens = self.visual(video)
        cls = tokens[:, 0, :].reshape(b, -1, tokens.shape[-1]).mean(1)
        return cls @ self.proj.to(cls.dtype)

    def encode_text(self, text_ids):
        return self.text(text_ids)[0]

    def forward(self, video, text_ids):
        v = self.encode_video(video).float()
        tx = self.encode_text(text_ids).float()
        v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        tx = tx / torch.linalg.vector_norm(tx, dim=-1, keepdim=True)
        scale = self.logit_scale.exp()
        return scale * v @ tx.T, scale * tx @ v.T


def inflate_clip_to_videoformer(clip_params: dict,
                                cfg: VideoFormerConfig) -> dict:
    """A CLIP tree's visual weights (JAX names; numpy arrays or tensors)
    -> the VideoFormer leaves they determine: ``conv1`` as it is, or
    ``conv1_3d`` [3, p, p, 3, W] (the 2-D kernel over each of 3 taps,
    divided by 3); the embeddings, ``ln_pre`` / ``ln_post`` and every
    block's attention, LayerNorms and FFN 1:1.  The MHRA leaves are not
    in it: merge it into an initialised tree."""
    src = clip_params["visual"]
    out = {}
    if cfg.temporal_downsampling:
        p = cfg.clip.vision_patch_size
        k2d = np.asarray(src["conv1"]).reshape(3, p, p, -1)
        out["conv1_3d"] = np.stack([k2d / 3.0] * 3).transpose(0, 2, 3, 1, 4)
    else:
        out["conv1"] = src["conv1"]
    for key in ("class_embedding", "positional_embedding", "ln_pre",
                "ln_post"):
        out[key] = src[key]
    for i in range(cfg.clip.vision_layers):
        blk = src[f"block_{i}"]
        out[f"block_{i}"] = {k: blk[k] for k in (
            "ln_1", "ln_2", "in_proj", "out_proj", "c_fc", "c_proj")}
    return out
