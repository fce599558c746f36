"""Vision encoders: TimeSformer (divided space-time attention), the plain
(CLIP-style) ViT that mPLUG-Owl runs per frame, and the AttentionPool
visual abstractor.

Counterpart of ``youku_mplug_tpu/models/vision.py`` (forward; training
through autograd, with the attention backward on the flash kernels).
Parameters keep the JAX package's names and shapes, so loading a JAX tree
is a rename (``youku_mplug_tpu_torch/bridge.py``).  The behaviours a port
can lose silently, all kept here:

- VisionAttention has q and v biases but no k bias;
- the divided space-time block keeps ONE cls token, repeated per frame for
  spatial attention and mean-pooled over frames afterwards; tokens are
  n-major inside the blocks and time-major outside;
- temporal attention packs g patches x T frames per call with a period-T
  block-diagonal mask, and ``temporal_fc`` is folded into the temporal
  output projection in fp32 before the cast to the compute dtype;
- AttentionPool appends learnable ``bias_k`` / ``bias_v`` as one extra
  key, and its residual base is the *normed* queries;
- a ``clip_model`` tower (the TimeSformer of clip-b16 and the per-frame
  ViT) has a bias-free patch embedding and a ``norm_pre`` LayerNorm over
  [cls; tokens] before the blocks; the MLP's GELU is tanh, erf or CLIP's
  quick GELU as the config says;
- attention runs the packed flash kernel where the JAX package's packed
  kernel takes the head geometry (``packed_supported``); elsewhere
  (clip-b16's 8 heads of 96) einsum attention with fp32 scores and the
  period-block mask, as the JAX package does there.

Under ``grad_ckpt`` the blocks ``i % stride == 0`` run under
``torch.utils.checkpoint`` (stride 2/3/6/12 for ``remat_policy``
half/third/sixth/twelfth, else 1), as the JAX package remats them; its
named-save inner policies are XLA's and are not ported (a checkpointed
block recomputes everything).  Vision dropout and drop-path are not
ported (clip-b16 and vit-b16 set none): training with a rate above 0
raises.  Vision LoRA is not ported either.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from youku_mplug_tpu_torch.ops.attention import dot_product_attention
from youku_mplug_tpu_torch.ops.attention import NEG_INF
from youku_mplug_tpu_torch.ops.flash_attention import (
    flash_attention_packed,
    packed_supported,
)
from youku_mplug_tpu_torch.ops.layernorm import layer_norm
from youku_mplug_tpu_torch.runtime.precision import DEFAULT_POLICY, Policy


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """The fields of the JAX ``VisionConfig`` that serving and training
    read (same JSON contract, configs/models/{vit,clip}-*.json)."""

    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    num_frames: int = 4
    gelu: str = "tanh"  # "tanh" | "erf" | "quick"
    clip_model: bool = False
    lora_rank: int = 0
    ln_eps: float = 1e-6
    drop_path: float = 0.0
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    grad_ckpt: bool = False
    remat_policy: str = "nothing"  # "half" | "third" | "sixth" | "twelfth"

    def __post_init__(self):
        if self.lora_rank:
            raise NotImplementedError(
                f"vision LoRA (lora_rank {self.lora_rank}) is not ported yet")

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def remat_stride(self) -> int:
        """Checkpoint every stride-th block under ``grad_ckpt``
        (``vision.py:594-601`` of the JAX package)."""
        key = self.remat_policy.split(":", 1)[0]
        return {"half": 2, "third": 3, "sixth": 6, "twelfth": 12}.get(key, 1)

    @classmethod
    def from_json_file(cls, path: str, **overrides) -> "VisionConfig":
        with open(path) as f:
            raw = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        mapped = {k: v for k, v in raw.items() if k in known}
        mapped.update(overrides)
        return cls(**mapped)


def _param(*shape, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=dtype), requires_grad=False)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w.to(x.dtype)


class LayerNormFP32(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.scale = _param(dim, dtype=dtype)
        self.bias = _param(dim, dtype=dtype)

    def forward(self, x):
        return layer_norm(x, self.scale, self.bias, eps=self.eps)


def _gelu(y: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "quick":
        return y * torch.sigmoid(1.702 * y)
    return F.gelu(y, approximate="tanh" if kind == "tanh" else "none")


def _einsum_attention(q, k, v, n: int, period: int) -> torch.Tensor:
    """[B, S, n*d] q/k/v -> [B, S, n*d]: fp32 scores and softmax, the
    probabilities cast back before PV, keys outside a query's period
    group masked (JAX ``vision.py:276-301``)."""
    b, s, nd = q.shape
    d = nd // n
    q4, k4, v4 = (t.reshape(b, s, n, d) for t in (q, k, v))
    scores = torch.einsum("bqnd,bknd->bnqk", q4.float(), k4.float()) \
        * d ** -0.5
    if 0 < period < s:
        gi = torch.arange(s, device=q.device) // period
        scores = scores.masked_fill(gi[:, None] != gi[None, :], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bnqk,bknd->bqnd", p.to(q.dtype), v4).reshape(
        b, s, nd)


class VisionAttention(nn.Module):
    """Split q/v-bias attention over the flash kernel (packed layout), or
    einsum attention where the packed kernel has no geometry."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        d = dim // num_heads
        self.dim, self.num_heads = dim, num_heads
        self.qkv_kernel = _param(dim, 3, num_heads, d, dtype=dtype)
        self.q_bias = _param(num_heads, d, dtype=dtype)
        self.v_bias = _param(num_heads, d, dtype=dtype)
        self.proj_kernel = _param(num_heads, d, dim, dtype=dtype)
        self.proj_bias = _param(dim, dtype=dtype)

    def forward(self, x, *, period: int = 0,
                post_kernel: Optional[torch.Tensor] = None,
                post_bias: Optional[torch.Tensor] = None):
        """x [..., S, C].  ``period > 0``: tokens attend only within their
        own period group.  post_kernel/post_bias: a trailing [C, C] affine
        folded into the output projection, (x@P)@T == x@(P@T), with the
        weight product in fp32 and the cast to the compute dtype after."""
        n, c = self.num_heads, self.dim
        nd = c
        proj_kernel, proj_bias = self.proj_kernel, self.proj_bias
        if post_kernel is not None:
            pk32 = post_kernel.float()
            proj_kernel = torch.einsum("ndc,ce->nde", proj_kernel.float(),
                                       pk32)
            proj_bias = proj_bias.float() @ pk32
            if post_bias is not None:
                proj_bias = proj_bias + post_bias.float()
        lead, s = x.shape[:-2], x.shape[-2]
        xf = x.reshape(-1, s, c)
        qkv = _mm(xf, self.qkv_kernel.reshape(c, 3 * nd))
        q = qkv[..., :nd] + self.q_bias.reshape(nd).to(x.dtype)
        k = qkv[..., nd:2 * nd]
        v = qkv[..., 2 * nd:] + self.v_bias.reshape(nd).to(x.dtype)
        if packed_supported(n, c // n):
            out = flash_attention_packed(q, k, v, n, period=period)
        else:
            out = _einsum_attention(q, k, v, n, period)
        y = _mm(out, proj_kernel.reshape(nd, c)) + proj_bias.to(x.dtype)
        return y.reshape(*lead, s, c)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, gelu: str = "tanh",
                 dtype=torch.float32):
        super().__init__()
        self.gelu = gelu
        self.fc1_kernel = _param(dim, hidden, dtype=dtype)
        self.fc1_bias = _param(hidden, dtype=dtype)
        self.fc2_kernel = _param(hidden, dim, dtype=dtype)
        self.fc2_bias = _param(dim, dtype=dtype)

    def forward(self, x):
        y = _mm(x, self.fc1_kernel) + self.fc1_bias.to(x.dtype)
        y = _gelu(y, self.gelu)
        return _mm(y, self.fc2_kernel) + self.fc2_bias.to(x.dtype)


def temporal_group(n_patches: int, frames: int) -> int:
    """Patches packed per temporal attention call (g patches x T frames,
    g the largest divisor of n_patches with g*T <= 128; the JAX package's
    geometry, kept so the period kernel sees the same shapes)."""
    for cand in range(min(128 // frames, n_patches), 0, -1):
        if n_patches % cand == 0:
            return cand
    return 1


class SpaceTimeBlock(nn.Module):
    """Divided space-time block. x: [B, N, T, C] (n-major); cls: [B, C]."""

    def __init__(self, cfg: VisionConfig, dtype=torch.float32):
        super().__init__()
        c = cfg.embed_dim
        self.temporal_ln = LayerNormFP32(c, cfg.ln_eps, dtype)
        self.temporal_fc_kernel = _param(c, c, dtype=dtype)
        self.temporal_fc_bias = _param(c, dtype=dtype)
        self.temporal_attn = VisionAttention(c, cfg.num_heads, dtype)
        self.norm1 = LayerNormFP32(c, cfg.ln_eps, dtype)
        self.attn = VisionAttention(c, cfg.num_heads, dtype)
        self.norm2 = LayerNormFP32(c, cfg.ln_eps, dtype)
        self.mlp = Mlp(c, int(c * cfg.mlp_ratio), cfg.gelu, dtype)

    def forward(self, x, cls):
        b, n_p, t, c = x.shape
        # temporal attention: g patches x T frames per call, period-T mask
        g = temporal_group(n_p, t)
        xt = self.temporal_ln(x).reshape(b, n_p // g, g * t, c)
        xt = self.temporal_attn(xt, period=t if g > 1 else 0,
                                post_kernel=self.temporal_fc_kernel,
                                post_bias=self.temporal_fc_bias)
        xt = x + xt.reshape(b, n_p, t, c)

        # spatial attention: per frame, the one cls token repeated per frame
        xs = xt.transpose(1, 2)  # [B, T, N, C]
        cls_rep = cls[:, None, None, :].expand(b, t, 1, c)
        xs = self.attn(self.norm1(torch.cat([cls_rep, xs], dim=2)))
        cls_new = xs[:, :, 0, :].mean(dim=1)  # mean over frames
        xs = xs[:, :, 1:, :].transpose(1, 2)  # [B, N, T, C]

        # joint residual + MLP over [cls; (n t)] tokens
        res = torch.cat([cls[:, None, :], xt.reshape(b, n_p * t, c)], dim=1)
        upd = torch.cat([cls_new[:, None, :], xs.reshape(b, n_p * t, c)],
                        dim=1)
        y = res + upd
        y = y + self.mlp(self.norm2(y))
        return y[:, 1:, :].reshape(b, n_p, t, c), y[:, 0, :]


class PatchEmbed(nn.Module):
    """Patchify as one matmul over folded patches; kernel [3*p*p, D];
    no bias for a CLIP tower (its conv1 has none)."""

    def __init__(self, cfg: VisionConfig, dtype=torch.float32):
        super().__init__()
        self.p = cfg.patch_size
        self.kernel = _param(cfg.in_chans * self.p * self.p, cfg.embed_dim,
                             dtype=dtype)
        self.bias = (None if cfg.clip_model
                     else _param(cfg.embed_dim, dtype=dtype))

    def forward(self, x):  # [B, C, H, W] -> [B, N, D]
        b, c, hh, ww = x.shape
        p = self.p
        gh, gw = hh // p, ww // p
        x = x.reshape(b, c, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5)
        x = x.reshape(b, gh * gw, c * p * p)
        y = _mm(x, self.kernel)
        return y if self.bias is None else y + self.bias.to(x.dtype)


class TimeSformer(nn.Module):
    """forward(video [B, C, T, H, W]) -> (pooled cls [B, D],
    tokens [B, 1 + T*N, D])."""

    def __init__(self, cfg: VisionConfig, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.cfg, self.policy = cfg, policy
        d, dt = cfg.embed_dim, policy.param_dtype
        self.patch_embed = PatchEmbed(cfg, dt)
        self.cls_token = _param(1, 1, d, dtype=dt)
        self.pos_embed = _param(1, cfg.num_patches + 1, d, dtype=dt)
        self.temporal_embed = _param(1, cfg.num_frames, d, dtype=dt)
        if cfg.clip_model:
            self.norm_pre = LayerNormFP32(d, cfg.ln_eps, dt)
        self.blocks = nn.ModuleList(
            SpaceTimeBlock(cfg, dt) for _ in range(cfg.depth))
        self.norm = LayerNormFP32(d, cfg.ln_eps, dt)

    def forward(self, video):
        cfg = self.cfg
        if self.training and (cfg.drop_path > 0 or cfg.drop_rate > 0
                              or cfg.attn_drop_rate > 0):
            raise NotImplementedError(
                "vision dropout / drop-path is not ported yet: train with "
                "drop_path = drop_rate = attn_drop_rate = 0")
        b, c, t, hh, ww = video.shape
        d = self.cfg.embed_dim
        p = self.cfg.patch_size
        n_p = (hh // p) * (ww // p)
        frames = video.transpose(1, 2).reshape(b * t, c, hh, ww)
        x = self.patch_embed(frames.to(self.policy.compute_dtype))
        x = x.reshape(b, t * n_p, d)  # time-major token order
        # pos-embed tiled per frame, temporal embed repeated per patch
        tile_pos = self.pos_embed[:, 1:, :].repeat(1, t, 1)
        tile_temp = self.temporal_embed[:, :t, :].repeat_interleave(n_p, dim=1)
        x = x + (tile_pos + tile_temp).to(x.dtype)
        cls = (self.cls_token.expand(b, 1, d)
               + self.pos_embed[:, :1, :]).to(x.dtype)[:, 0]
        if cfg.clip_model:  # norm_pre over [cls; tokens] jointly
            joint = self.norm_pre(torch.cat([cls[:, None], x], dim=1))
            cls, x = joint[:, 0], joint[:, 1:]

        x = x.reshape(b, t, n_p, d).transpose(1, 2)  # n-major for the blocks
        remat = cfg.grad_ckpt and torch.is_grad_enabled()
        for i, blk in enumerate(self.blocks):
            if remat and i % cfg.remat_stride == 0:
                x, cls = checkpoint(blk, x, cls, use_reentrant=False)
            else:
                x, cls = blk(x, cls)
        x = x.transpose(1, 2).reshape(b, t * n_p, d)  # back to time-major
        tokens = self.norm(torch.cat([cls[:, None, :], x], dim=1))
        return tokens[:, 0], tokens


class PlainBlock(nn.Module):
    """Pre-LN ViT block: x + attn(norm1 x), then + mlp(norm2 x)."""

    def __init__(self, cfg: VisionConfig, dtype=torch.float32):
        super().__init__()
        c = cfg.embed_dim
        self.norm1 = LayerNormFP32(c, cfg.ln_eps, dtype)
        self.attn = VisionAttention(c, cfg.num_heads, dtype)
        self.norm2 = LayerNormFP32(c, cfg.ln_eps, dtype)
        self.mlp = Mlp(c, int(c * cfg.mlp_ratio), cfg.gelu, dtype)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class VisionTransformer(nn.Module):
    """Plain image ViT (mPLUG-Owl's per-frame CLIP ViT-L/14):
    forward(images [B, C, H, W]) -> (cls [B, D], tokens [B, 1 + N, D]).
    Attention over the 1 + N tokens runs the packed flash kernel."""

    def __init__(self, cfg: VisionConfig, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.cfg, self.policy = cfg, policy
        d, dt = cfg.embed_dim, policy.param_dtype
        self.patch_embed = PatchEmbed(cfg, dt)
        self.cls_token = _param(1, 1, d, dtype=dt)
        self.pos_embed = _param(1, cfg.num_patches + 1, d, dtype=dt)
        if cfg.clip_model:
            self.norm_pre = LayerNormFP32(d, cfg.ln_eps, dt)
        self.blocks = nn.ModuleList(PlainBlock(cfg, dt)
                                    for _ in range(cfg.depth))
        self.norm = LayerNormFP32(d, cfg.ln_eps, dt)

    def forward(self, images):
        cfg = self.cfg
        if self.training and (cfg.drop_path > 0 or cfg.drop_rate > 0
                              or cfg.attn_drop_rate > 0):
            raise NotImplementedError(
                "vision dropout / drop-path is not ported yet: train with "
                "drop_path = drop_rate = attn_drop_rate = 0")
        x = self.patch_embed(images.to(self.policy.compute_dtype))
        b, _, d = x.shape
        x = torch.cat([self.cls_token.to(x.dtype).expand(b, 1, d), x], dim=1)
        x = x + self.pos_embed.to(x.dtype)
        if cfg.clip_model:
            x = self.norm_pre(x)
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x)
        return x[:, 0], x


class AttentionPool(nn.Module):
    """Learnable-query cross-attention pooling (torch MultiheadAttention
    with add_bias_kv in the original model)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 ln_eps: float = 1e-6, gelu: str = "tanh",
                 dtype=torch.float32):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.norm1 = LayerNormFP32(dim, ln_eps, dtype)
        self.normk = LayerNormFP32(dim, ln_eps, dtype)
        for name in ("q_kernel", "k_kernel", "v_kernel", "out_kernel"):
            setattr(self, name, _param(dim, dim, dtype=dtype))
        for name in ("q_bias", "k_bias", "v_bias", "out_bias"):
            setattr(self, name, _param(dim, dtype=dtype))
        self.bias_k = _param(1, 1, dim, dtype=dtype)
        self.bias_v = _param(1, 1, dim, dtype=dtype)
        self.norm2 = LayerNormFP32(dim, ln_eps, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), gelu, dtype)

    def forward(self, queries, keys):
        d, n = self.dim, self.num_heads
        q_in = self.norm1(queries)
        k_in = self.normk(keys)
        dt = q_in.dtype
        b = q_in.shape[0]
        q = _mm(q_in, self.q_kernel) + self.q_bias.to(dt)
        k = _mm(k_in, self.k_kernel) + self.k_bias.to(dt)
        v = _mm(k_in, self.v_kernel) + self.v_bias.to(dt)
        k = torch.cat([k, self.bias_k.to(dt).expand(b, 1, d)], dim=1)
        v = torch.cat([v, self.bias_v.to(dt).expand(b, 1, d)], dim=1)

        def split(t):  # [B, S, d] -> [B, n, S, hd] view
            return t.unflatten(-1, (n, d // n)).transpose(1, 2)

        out = dot_product_attention(split(q), split(k), split(v))
        out = out.transpose(1, 2).reshape(b, q.shape[1], d)
        out = _mm(out, self.out_kernel) + self.out_bias.to(dt)
        x = q_in + out  # residual on the NORMED queries
        return x + self.mlp(self.norm2(x))
