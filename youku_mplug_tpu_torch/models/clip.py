"""OpenAI CLIP: a ViT visual tower and a causal text transformer.

Counterpart of ``youku_mplug_tpu/models/clip.py`` (the reference's
vendored CLIP): QuickGELU (x * sigmoid(1.702 x)), pre-LN residual blocks
with fp32 LayerNorms (eps 1e-5), the visual tower ending in ``ln_post``
and ``proj`` over the patch tokens (the vendored tower drops the cls
token: it is a feature extractor), the text tower in ``ln_final`` and
``text_projection`` at the argmax (EOT) token.  Attention runs plain
(``mha_reference``), as in JAX.

Parameters keep the JAX names and shapes (``conv1`` [3 p p, W], blocks
``block_<i>`` with flax ``Dense`` kernels [in, out], the LayerNorms'
``scale`` / ``bias`` at eps 1e-5), so a JAX tree loads
through ``bridge.load_jax_params``; ``clip_params_from_torch`` turns an
OpenAI-named CLIP state dict into that tree (load it with
``bridge.load_jax_params(CLIP(cfg), clip_params_from_torch(sd, cfg))``).
Dtypes follow JAX's: the patches and ``conv1`` in the policy's compute
dtype, each ``Dense`` in the promoted dtype of its input and fp32 kernel
(so a bf16 tower runs fp32 from its first block's projections on).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from youku_mplug_tpu_torch.models.bert import Embed
from youku_mplug_tpu_torch.models.tasks import Dense
from youku_mplug_tpu_torch.models.vision import LayerNormFP32, _param
from youku_mplug_tpu_torch.ops.attention import mha_reference
from youku_mplug_tpu_torch.runtime.precision import DEFAULT_POLICY, Policy

LN_EPS = 1e-5  # CLIP's LayerNorms


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    image_resolution: int = 224
    vision_width: int = 768
    vision_layers: int = 12
    vision_patch_size: int = 16
    embed_dim: int = 512
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_heads: int = 8
    transformer_layers: int = 12

    @property
    def vision_heads(self) -> int:
        return self.vision_width // 64


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def attention(x, in_proj: Dense, out_proj: Dense, heads: int,
              causal: bool = False):
    """The blocks' self-attention: ``in_proj`` -> q, k, v -> plain
    attention -> ``out_proj``."""
    b, s, w = x.shape
    q, k, v = in_proj(x).split(w, dim=-1)

    def split(t):
        return t.reshape(b, s, heads, w // heads).transpose(1, 2)

    out = mha_reference(split(q), split(k), split(v), causal=causal)
    return out_proj(out.transpose(1, 2).reshape(b, s, w))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, causal: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.heads, self.causal = heads, causal
        self.ln_1 = LayerNormFP32(width, LN_EPS, dtype)
        self.in_proj = Dense(width, 3 * width, dtype)
        self.out_proj = Dense(width, width, dtype)
        self.ln_2 = LayerNormFP32(width, LN_EPS, dtype)
        self.c_fc = Dense(width, 4 * width, dtype)
        self.c_proj = Dense(4 * width, width, dtype)

    def forward(self, x):
        x = x + attention(self.ln_1(x), self.in_proj, self.out_proj,
                          self.heads, self.causal)
        return x + self.c_proj(quick_gelu(self.c_fc(self.ln_2(x))))


def _blocks(module: nn.Module, n: int, make) -> list:
    """``n`` blocks registered as ``block_<i>`` (the JAX names)."""
    blocks = [make() for _ in range(n)]
    for i, blk in enumerate(blocks):
        module.add_module(f"block_{i}", blk)
    return blocks


class CLIPVisionTower(nn.Module):
    def __init__(self, cfg: CLIPConfig, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        dt, w, p = policy.param_dtype, cfg.vision_width, \
            cfg.vision_patch_size
        self.cfg, self.policy = cfg, policy
        grid = cfg.image_resolution // p
        self.conv1 = _param(3 * p * p, w, dtype=dt)
        self.class_embedding = _param(w, dtype=dt)
        self.positional_embedding = _param(grid * grid + 1, w, dtype=dt)
        self.ln_pre = LayerNormFP32(w, LN_EPS, dt)
        self.blocks = _blocks(self, cfg.vision_layers,
                              lambda: ResidualAttentionBlock(
                                  w, cfg.vision_heads, dtype=dt))
        self.ln_post = LayerNormFP32(w, LN_EPS, dt)
        self.proj = _param(w, cfg.embed_dim, dtype=dt)

    def forward(self, images):
        """images [B, 3, H, W] -> (projected patch tokens [B, N, E], the
        blocks' tokens [B, 1 + N, W])."""
        w, p = self.cfg.vision_width, self.cfg.vision_patch_size
        b, c, hh, ww = images.shape
        gh, gw = hh // p, ww // p
        x = images.to(self.policy.compute_dtype)
        x = x.reshape(b, c, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5)
        x = x.reshape(b, gh * gw, c * p * p) @ self.conv1.to(x.dtype)
        cls = self.class_embedding.to(x.dtype).expand(b, 1, w)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(
            x.dtype)
        x = self.ln_pre(x)
        for blk in self.blocks:
            x = blk(x)
        patches = self.ln_post(x[:, 1:, :])
        return patches @ self.proj.to(patches.dtype), x


class CLIPTextTower(nn.Module):
    def __init__(self, cfg: CLIPConfig, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        dt, w = policy.param_dtype, cfg.transformer_width
        self.cfg = cfg
        self.token_embedding = Embed(cfg.vocab_size, w, dt)
        self.positional_embedding = _param(cfg.context_length, w, dtype=dt)
        self.blocks = _blocks(self, cfg.transformer_layers,
                              lambda: ResidualAttentionBlock(
                                  w, cfg.transformer_heads, causal=True,
                                  dtype=dt))
        self.ln_final = LayerNormFP32(w, LN_EPS, dt)
        self.text_projection = _param(w, cfg.embed_dim, dtype=dt)

    def forward(self, text_ids):
        """text_ids [B, S] -> (features at the EOT (argmax) token [B, E],
        the tokens [B, S, W])."""
        tok = self.token_embedding(text_ids)
        s = text_ids.shape[1]
        x = tok + self.positional_embedding[:s].to(tok.dtype)
        for blk in self.blocks:
            x = blk(x)
        x = self.ln_final(x)
        eot = text_ids.argmax(-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return pooled @ self.text_projection.to(x.dtype), x


class CLIP(nn.Module):
    """The two towers with a learned ``logit_scale``."""

    def __init__(self, cfg: CLIPConfig, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.cfg = cfg
        self.visual = CLIPVisionTower(cfg, policy)
        self.text = CLIPTextTower(cfg, policy)
        self.logit_scale = nn.Parameter(
            torch.tensor(math.log(1 / 0.07), dtype=torch.float32),
            requires_grad=False)

    def encode_image(self, images):
        return self.visual(images)[0]

    def encode_text(self, text_ids):
        return self.text(text_ids)[0]

    def forward(self, images, text_ids):
        """-> (image-to-text logits [B, B], text-to-image [B, B]) in fp32:
        the patch features mean-pooled, both sides L2-normalized, times
        exp(logit_scale)."""
        im = self.encode_image(images).mean(1).float()
        tx = self.encode_text(text_ids).float()
        im = im / torch.linalg.vector_norm(im, dim=-1, keepdim=True)
        tx = tx / torch.linalg.vector_norm(tx, dim=-1, keepdim=True)
        scale = self.logit_scale.exp()
        return scale * im @ tx.T, scale * tx @ im.T


def clip_params_from_torch(sd: dict, cfg: CLIPConfig) -> dict:
    """An OpenAI CLIP state dict (numpy arrays or tensors under the
    ``visual.transformer.resblocks.<i>.attn.in_proj_weight`` names) ->
    the JAX-named tree of numpy arrays that ``bridge.load_jax_params``
    loads into ``CLIP(cfg)``: Linear weights transposed to [in, out],
    ``conv1`` [W, 3, p, p] folded to [3 p p, W]."""
    def a(key):
        v = sd[key]
        return (v.detach().float().cpu().numpy()
                if isinstance(v, torch.Tensor) else np.asarray(v))

    def ln(p):
        return {"scale": a(p + ".weight"), "bias": a(p + ".bias")}

    def dense(w, b):
        return {"kernel": a(w).T, "bias": a(b)}

    def block(prefix):
        return {
            "ln_1": ln(prefix + ".ln_1"),
            "ln_2": ln(prefix + ".ln_2"),
            "in_proj": dense(prefix + ".attn.in_proj_weight",
                             prefix + ".attn.in_proj_bias"),
            "out_proj": dense(prefix + ".attn.out_proj.weight",
                              prefix + ".attn.out_proj.bias"),
            "c_fc": dense(prefix + ".mlp.c_fc.weight",
                          prefix + ".mlp.c_fc.bias"),
            "c_proj": dense(prefix + ".mlp.c_proj.weight",
                            prefix + ".mlp.c_proj.bias"),
        }

    conv = a("visual.conv1.weight")  # [W, 3, p, p]
    visual = {
        "conv1": conv.reshape(conv.shape[0], -1).T,
        "class_embedding": a("visual.class_embedding"),
        "positional_embedding": a("visual.positional_embedding"),
        "ln_pre": ln("visual.ln_pre"),
        "ln_post": ln("visual.ln_post"),
        "proj": a("visual.proj"),
    }
    for i in range(cfg.vision_layers):
        visual[f"block_{i}"] = block(f"visual.transformer.resblocks.{i}")
    text = {
        "token_embedding": {"embedding": a("token_embedding.weight")},
        "positional_embedding": a("positional_embedding"),
        "ln_final": ln("ln_final"),
        "text_projection": a("text_projection"),
    }
    for i in range(cfg.transformer_layers):
        text[f"block_{i}"] = block(f"transformer.resblocks.{i}")
    out = {"visual": visual, "text": text}
    if "logit_scale" in sd:
        out["logit_scale"] = a("logit_scale")
    return out
