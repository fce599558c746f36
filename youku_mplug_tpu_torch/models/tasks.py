"""The video-LM backbone for serving: TimeSformer -> learnable queries ->
AttentionPool -> ``visual_fc`` -> GPT-3 decoder.

Counterpart of ``youku_mplug_tpu/models/tasks.py`` (``MPLUGVideoConfig``
and ``MPLUGVideo.encode_video`` / ``encode_queries``); the task losses and
heads are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from youku_mplug_tpu_torch.models.gpt3 import GPT3Config, GPT3LM
from youku_mplug_tpu_torch.models.vision import (
    AttentionPool,
    TimeSformer,
    VisionConfig,
)
from youku_mplug_tpu_torch.runtime.precision import DEFAULT_POLICY, Policy


@dataclasses.dataclass(frozen=True)
class MPLUGVideoConfig:
    vision: VisionConfig = VisionConfig()
    text: GPT3Config = GPT3Config()
    num_learnable_token: int = 256


class Dense(nn.Module):
    """flax ``nn.Dense`` counterpart: kernel [in, out]; computes in the
    promoted dtype of input and kernel, as flax does."""

    def __init__(self, features_in: int, features_out: int, dtype):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.empty(features_in, features_out, dtype=dtype),
            requires_grad=False)
        self.bias = nn.Parameter(torch.empty(features_out, dtype=dtype),
                                 requires_grad=False)

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.kernel.dtype)
        return x.to(dt) @ self.kernel.to(dt) + self.bias.to(dt)


class MPLUGVideo(nn.Module):
    def __init__(self, cfg: MPLUGVideoConfig,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.cfg, self.policy = cfg, policy
        v, dt = cfg.vision, policy.param_dtype
        self.visual_encoder = TimeSformer(v, policy)
        self.learnable_queries = nn.Parameter(
            torch.empty(1, cfg.num_learnable_token, v.embed_dim, dtype=dt),
            requires_grad=False)
        self.attn_pool = AttentionPool(v.embed_dim, v.num_heads, v.mlp_ratio,
                                       gelu=v.gelu, dtype=dt)
        self.visual_fc = Dense(v.embed_dim, cfg.text.hidden_size, dt)
        # contrastive temperature: not on the serving path, kept so a JAX
        # tree loads without leftovers
        self.temp = nn.Parameter(torch.empty((), dtype=torch.float32),
                                 requires_grad=False)
        self.text_decoder = GPT3LM(cfg.text, policy)

    def encode_video(self, video):
        """video [B, C, T, H, W] -> (pooled_cls [B, D],
        query_features [B, Q, H_text], image_query [B, Q, D])."""
        pooled, image_embeds = self.visual_encoder(video)
        b = image_embeds.shape[0]
        queries = self.learnable_queries.expand(
            b, -1, -1).to(image_embeds.dtype)
        image_query = self.attn_pool(queries, image_embeds)
        return pooled, self.visual_fc(image_query), image_query

    def encode_queries(self, video):
        """Just the query features (the serving prefix)."""
        return self.encode_video(video)[1]
