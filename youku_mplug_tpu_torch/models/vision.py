"""Vision encoders: TimeSformer (divided space-time attention), the plain
ViT (mPLUG-Owl's per-frame CLIP tower, and the image encoder of the
image pretrain path, EVA-ViT-g among them: ``EVA_VIT_G``), and the
AttentionPool visual abstractor.

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
  key, and its residual base is the *normed* queries; its ``k_bias`` is
  applied as ``-k_bias`` on that extra key alone, not on the other keys:
  the softmax ignores a shift of a query's every score by q . k_bias,
  so the attention is the same, and the bias's gradient is one key's dk
  (-sum dS(bias key) . q) instead of the small residue of every key's dk,
  which the kernel's bf16 dk rows swamp with their rounding;
- a ``clip_model`` tower (the TimeSformer of clip-b16 and the per-frame
  ViT) has a bias-free patch embedding and a ``norm_pre`` LayerNorm over
  [cls; tokens] before the blocks; the MLP's GELU is tanh, erf or CLIP's
  quick GELU as the config says;
- attention runs the packed flash kernel where the JAX package's packed
  kernel runs (``packed_kernel_takes``: the head geometry of
  ``packed_supported``, and at least 128 tokens, or under a period mask a
  multiple of 8); elsewhere (clip-b16's 8 heads of 96, EVA-ViT-g's 16 of
  88, a short sequence) einsum attention with fp32 scores and the
  period-block mask, as the JAX package does there;
  AttentionPool's cross-attention goes through ``dot_product_attention``
  (the head-major flash kernel at 128 queries, at every head dim of
  ``HEAD_DIMS``, 88 included).

Under ``grad_ckpt`` the TimeSformer's blocks ``i % stride == 0`` run under
``torch.utils.checkpoint`` (stride 2/3/6/12 for ``remat_policy``
half/third/sixth/twelfth, else 1), as the JAX package remats them; its
named-save inner policies are XLA's and are not ported (a checkpointed
block recomputes everything, its dropout masks replayed from the
generator state it started with); the plain ViT checkpoints every block,
as the JAX package remats every ``PlainBlock``.

Training knobs, in training mode with a ``generator`` (the JAX
methods' ``deterministic=False``): ``drop_rate`` drops the TimeSformer's
patch tokens after the position embeddings (the per-frame ViT has no
such dropout in JAX either); ``drop_path`` drops each block's residual
branches per sample at the rates ``linspace(0, drop_path, depth)`` (the
space-time block: its spatial update and its MLP; the plain block: its
attention and its MLP); ``attn_drop_rate`` drops attention probabilities
on the plain path (``mha_reference``), as JAX's rule takes attention
dropout off its kernels — the temporal attention keeps its period mask
there as an additive bias (JAX's dropout path drops the mask, ROADMAP
Queue 3).  Under a split (the tower's ``mesh``) every mask is drawn at
the global batch's shape and this rank keeps its block
(``ops/attention.block_of``): the data rank's rows of the patch tokens
and of each drop-path draw, and of the attention probabilities its rows
and its model shard's heads; a checkpointed block replays those global
draws.  LoRA (``lora_rank > 0``): ``lora_{qkv,proj,fc1,fc2}_{a,b}``
on every attention and MLP of the blocks (qkv's delta before the q / v
biases, the others before their bias), in every attention route; with
adapters the temporal attention applies ``temporal_fc`` after its
projection instead of folding it in, as JAX does.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from youku_mplug_tpu_torch.ops.attention import (
    NEG_INF,
    Dropout,
    block_of,
    checkpoint_replaying,
    dot_product_attention,
    drop_path,
    dropout,
    mha_reference,
)
from youku_mplug_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_packed,
    packed_supported,
)
from youku_mplug_tpu_torch.ops.layernorm import layer_norm
from youku_mplug_tpu_torch.ops.lora import LoRAModule, plus
from youku_mplug_tpu_torch.parallel.data_parallel import data_group_of
from youku_mplug_tpu_torch.parallel.tensor_parallel import (
    copy_to_model,
    reduce_from_model,
)
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
    lora_alpha: float = 16.0
    ln_eps: float = 1e-6
    drop_path: float = 0.0
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    grad_ckpt: bool = False
    remat_policy: str = "nothing"  # "half" | "third" | "sixth" | "twelfth"

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def remat_stride(self) -> int:
        """Checkpoint every stride-th block under ``grad_ckpt``
        (``vision.py:594-601`` of the JAX package)."""
        key = self.remat_policy.split(":", 1)[0]
        return {"half": 2, "third": 3, "sixth": 6, "twelfth": 12}.get(key, 1)

    @property
    def drop_path_rates(self) -> list:
        """Each block's drop-path rate: linspace(0, drop_path, depth)."""
        return (np.linspace(0, self.drop_path, self.depth).tolist()
                if self.depth > 1 else [0.0])

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


LORA_INIT_STD = 0.015  # JAX VisionConfig.init_std, of lora_*_a


def _tower_dropout(tower: nn.Module, generator: Optional[torch.Generator]
                   ) -> Optional[Dropout]:
    """A tower's dropout in a training forward with a ``generator``: the
    config's token (``drop_rate``) and attention rates and the data
    rank's rows (``block_of``); None otherwise.  Each block adds its own
    drop-path rate."""
    if generator is None or not tower.training:
        return None
    return Dropout(generator, tower.cfg.drop_rate, tower.cfg.attn_drop_rate,
                   block_of(0, data_group_of(tower)))


def _drop_path(x: torch.Tensor, rate: float,
               drop: Optional[Dropout]) -> torch.Tensor:
    return x if drop is None else drop_path(x, rate, drop.generator,
                                            drop.rows)


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


def packed_kernel_takes(n: int, d: int, s: int, period: int) -> bool:
    """JAX's rule for the vision attention's packed kernel (JAX
    ``vision.py:243-247``, ``temporal_flash`` on): the head geometry
    (``packed_supported``), and a sequence of at least 128 tokens, or
    under a period mask one that is a multiple of 8."""
    return packed_supported(n, d) and (s % 8 == 0 if period > 0
                                       else s >= 128)


def _period_bias(s: int, period: int, device) -> Optional[torch.Tensor]:
    """fp32 [S, S]: NEG_INF between tokens of different period groups."""
    if not 0 < period < s:
        return None
    gi = torch.arange(s, device=device) // period
    return torch.zeros(s, s, device=device).masked_fill(
        gi[:, None] != gi[None, :], NEG_INF)


class VisionAttention(LoRAModule):
    """Split q/v-bias attention over the flash kernel (packed layout)
    where ``packed_kernel_takes`` the call, else einsum attention, or
    under attention dropout ``mha_reference``.

    On a model shard (``tp``, set by ``parallel/sharding.shard_params``)
    it holds n/m of the heads (``qkv_kernel``, ``q_bias``, ``v_bias``,
    ``proj_kernel``); the output projection's partial products are summed
    over the model ranks and ``proj_bias`` is added once, after.  The
    route is decided on the global geometry, as JAX decides it; where the
    packed kernel takes the call but the local heads fail
    ``packed_supported`` (ViT-B/16's 12 heads at model = 4 leave 3 of
    64, an odd count of 128-lane strips) the local heads take the
    head-major flash kernel (``flash_attention``, K4, with the same
    period mask): still the hand-written kernel, on head views.  In
    training the input and a folded ``post_kernel`` pass through
    ``copy_to_model`` (Megatron's *f*: both enter the local heads'
    partial product, so their gradients are summed over the model
    ranks; the folded bias, added after the sum, is not)."""

    TP_PARAM = "proj_kernel"  # the row-parallel product that is summed
    tp = None

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32,
                 lora_rank: int = 0, lora_alpha: float = 16.0):
        super().__init__()
        d = dim // num_heads
        self.dim = dim
        self.qkv_kernel = _param(dim, 3, num_heads, d, dtype=dtype)
        self.q_bias = _param(num_heads, d, dtype=dtype)
        self.v_bias = _param(num_heads, d, dtype=dtype)
        self.proj_kernel = _param(num_heads, d, dim, dtype=dtype)
        self.proj_bias = _param(dim, dtype=dtype)
        self.add_lora(lora_rank, lora_alpha, LORA_INIT_STD, dtype,
                      {"qkv": (dim, 3 * dim), "proj": (dim, dim)})

    @property
    def num_heads(self) -> int:
        """The heads this module holds (n / m on a model shard)."""
        return self.qkv_kernel.shape[-2]

    def forward(self, x, *, period: int = 0,
                post_kernel: Optional[torch.Tensor] = None,
                post_bias: Optional[torch.Tensor] = None,
                drop: Optional[Dropout] = None):
        """x [..., S, C].  ``period > 0``: tokens attend only within their
        own period group.  post_kernel/post_bias: a trailing [C, C] affine
        folded into the output projection, (x@P)@T == x@(P@T), with the
        weight product in fp32 and the cast to the compute dtype after
        (without adapters only).  ``drop`` with an ``attention`` rate > 0:
        attention dropout on the plain path, its mask at the global shape
        of ``drop.rows`` (x's rows: a data rank's block) and of this
        module's heads."""
        n, c = self.num_heads, self.dim
        d = self.qkv_kernel.shape[-1]
        nd = n * d
        proj_kernel, proj_bias = self.proj_kernel, self.proj_bias
        if post_kernel is not None:
            assert self.lora_rank == 0, "post_kernel fusion takes no LoRA"
            pk32 = post_kernel.float()
            proj_kernel = torch.einsum("ndc,ce->nde", proj_kernel.float(),
                                       copy_to_model(pk32, self.tp))
            proj_bias = proj_bias.float() @ pk32
            if post_bias is not None:
                proj_bias = proj_bias + post_bias.float()
        lead, s = x.shape[:-2], x.shape[-2]
        xf = copy_to_model(x.reshape(-1, s, c), self.tp)
        qkv = plus(_mm(xf, self.qkv_kernel.reshape(c, 3 * nd)),
                    self.delta("qkv", xf))
        q = qkv[..., :nd] + self.q_bias.reshape(nd).to(x.dtype)
        k = qkv[..., nd:2 * nd]
        v = qkv[..., 2 * nd:] + self.v_bias.reshape(nd).to(x.dtype)
        b = xf.shape[0]

        def heads(t):
            return t.unflatten(-1, (n, d)).transpose(1, 2)
        if drop is not None and drop.attention > 0.0:
            out = mha_reference(heads(q), heads(k), heads(v),
                                bias=_period_bias(s, period, x.device),
                                dropout_rate=drop.attention,
                                generator=drop.generator,
                                dropout_blocks=drop.rows
                                + block_of(1, self.tp))
            out = out.transpose(1, 2).reshape(b, s, nd)
        elif not packed_kernel_takes(c // d, d, s, period):
            out = _einsum_attention(q, k, v, n, period)
        elif packed_supported(n, d):
            out = flash_attention_packed(q, k, v, n, period=period)
        else:  # the local heads of a model shard, head-major
            out = flash_attention(heads(q), heads(k), heads(v),
                                  period=period)
            out = out.transpose(1, 2).reshape(b, s, nd)
        y = _mm(out, proj_kernel.reshape(nd, c))
        y = plus(y, self.delta("proj", out))
        y = reduce_from_model(y, self.tp) + proj_bias.to(x.dtype)
        return y.reshape(*lead, s, c)


class Mlp(LoRAModule):
    """fc1 -> GELU -> fc2; on a model shard fc1's columns and fc2's rows
    are this rank's, fc2's partial product is summed over the model ranks
    and ``fc2_bias`` added once, after; fc1's input passes through
    ``copy_to_model`` in training."""

    TP_PARAM = "fc2_kernel"
    tp = None

    def __init__(self, dim: int, hidden: int, gelu: str = "tanh",
                 dtype=torch.float32, lora_rank: int = 0,
                 lora_alpha: float = 16.0):
        super().__init__()
        self.gelu = gelu
        self.fc1_kernel = _param(dim, hidden, dtype=dtype)
        self.fc1_bias = _param(hidden, dtype=dtype)
        self.fc2_kernel = _param(hidden, dim, dtype=dtype)
        self.fc2_bias = _param(dim, dtype=dtype)
        self.add_lora(lora_rank, lora_alpha, LORA_INIT_STD, dtype,
                      {"fc1": (dim, hidden), "fc2": (hidden, dim)})

    def forward(self, x):
        x = copy_to_model(x, self.tp)
        y = plus(_mm(x, self.fc1_kernel), self.delta("fc1", x))
        y = _gelu(y + self.fc1_bias.to(x.dtype), self.gelu)
        out = plus(_mm(y, self.fc2_kernel), self.delta("fc2", y))
        return reduce_from_model(out, self.tp) + self.fc2_bias.to(x.dtype)


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

    def __init__(self, cfg: VisionConfig, dtype=torch.float32,
                 drop_path_rate: float = 0.0):
        super().__init__()
        c = cfg.embed_dim
        lora = dict(lora_rank=cfg.lora_rank, lora_alpha=cfg.lora_alpha)
        self.drop_path = drop_path_rate
        self.temporal_ln = LayerNormFP32(c, cfg.ln_eps, dtype)
        self.temporal_fc_kernel = _param(c, c, dtype=dtype)
        self.temporal_fc_bias = _param(c, dtype=dtype)
        self.temporal_attn = VisionAttention(c, cfg.num_heads, dtype, **lora)
        self.norm1 = LayerNormFP32(c, cfg.ln_eps, dtype)
        self.attn = VisionAttention(c, cfg.num_heads, dtype, **lora)
        self.norm2 = LayerNormFP32(c, cfg.ln_eps, dtype)
        self.mlp = Mlp(c, int(c * cfg.mlp_ratio), cfg.gelu, dtype, **lora)

    def forward(self, x, cls, drop: Optional[Dropout] = None):
        """``drop``: the tower's dropout (None: deterministic)."""
        b, n_p, t, c = x.shape
        # temporal attention: g patches x T frames per call, period-T mask
        g = temporal_group(n_p, t)
        xt = self.temporal_ln(x).reshape(b, n_p // g, g * t, c)
        period = t if g > 1 else 0
        if self.temporal_attn.lora_rank == 0:
            xt = self.temporal_attn(xt, period=period,
                                    post_kernel=self.temporal_fc_kernel,
                                    post_bias=self.temporal_fc_bias, drop=drop)
        else:  # the adapters' delta lands after proj: no folding
            xt = self.temporal_attn(xt, period=period, drop=drop)
            xt = _mm(xt, self.temporal_fc_kernel) \
                + self.temporal_fc_bias.to(xt.dtype)
        xt = x + xt.reshape(b, n_p, t, c)

        # spatial attention: per frame, the one cls token repeated per frame
        xs = xt.transpose(1, 2)  # [B, T, N, C]
        cls_rep = cls[:, None, None, :].expand(b, t, 1, c)
        xs = self.attn(self.norm1(torch.cat([cls_rep, xs], dim=2)), drop=drop)
        cls_new = xs[:, :, 0, :].mean(dim=1)  # mean over frames
        xs = xs[:, :, 1:, :].transpose(1, 2)  # [B, N, T, C]

        # joint residual + MLP over [cls; (n t)] tokens
        res = torch.cat([cls[:, None, :], xt.reshape(b, n_p * t, c)], dim=1)
        upd = torch.cat([cls_new[:, None, :], xs.reshape(b, n_p * t, c)],
                        dim=1)
        y = res + _drop_path(upd, self.drop_path, drop)
        y = y + _drop_path(self.mlp(self.norm2(y)), self.drop_path, drop)
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

    mesh = None  # the run's mesh (parallel/sharding.shard_params)

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
            SpaceTimeBlock(cfg, dt, rate) for rate in cfg.drop_path_rates)
        self.norm = LayerNormFP32(d, cfg.ln_eps, dt)

    def forward(self, video, generator: Optional[torch.Generator] = None):
        """``generator``: the dropout masks of a training forward
        (training mode); ignored otherwise."""
        cfg = self.cfg
        drop = _tower_dropout(self, generator)
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
        if drop is not None:
            x = dropout(x, drop.hidden, drop.generator, drop.rows)
        if cfg.clip_model:  # norm_pre over [cls; tokens] jointly
            joint = self.norm_pre(torch.cat([cls[:, None], x], dim=1))
            cls, x = joint[:, 0], joint[:, 1:]

        x = x.reshape(b, t, n_p, d).transpose(1, 2)  # n-major for the blocks
        remat = cfg.grad_ckpt and torch.is_grad_enabled()
        for i, blk in enumerate(self.blocks):
            if remat and i % cfg.remat_stride == 0 and drop is None:
                x, cls = checkpoint(blk, x, cls, use_reentrant=False)
            elif remat and i % cfg.remat_stride == 0:
                x, cls = checkpoint_replaying(blk, drop.generator, x, cls,
                                              drop)
            else:
                x, cls = blk(x, cls, drop)
        x = x.transpose(1, 2).reshape(b, t * n_p, d)  # back to time-major
        tokens = self.norm(torch.cat([cls[:, None, :], x], dim=1))
        return tokens[:, 0], tokens


class PlainBlock(nn.Module):
    """Pre-LN ViT block: x + attn(norm1 x), then + mlp(norm2 x), each
    branch under its drop-path rate in training."""

    def __init__(self, cfg: VisionConfig, dtype=torch.float32,
                 drop_path_rate: float = 0.0):
        super().__init__()
        c = cfg.embed_dim
        lora = dict(lora_rank=cfg.lora_rank, lora_alpha=cfg.lora_alpha)
        self.drop_path = drop_path_rate
        self.norm1 = LayerNormFP32(c, cfg.ln_eps, dtype)
        self.attn = VisionAttention(c, cfg.num_heads, dtype, **lora)
        self.norm2 = LayerNormFP32(c, cfg.ln_eps, dtype)
        self.mlp = Mlp(c, int(c * cfg.mlp_ratio), cfg.gelu, dtype, **lora)

    def forward(self, x, drop: Optional[Dropout] = None):
        """``drop``: the tower's dropout (None: deterministic)."""
        x = x + _drop_path(self.attn(self.norm1(x), drop=drop),
                           self.drop_path, drop)
        return x + _drop_path(self.mlp(self.norm2(x)), self.drop_path, drop)


class VisionTransformer(nn.Module):
    """Plain image ViT (mPLUG-Owl's per-frame CLIP ViT-L/14, the image
    pretrain path's encoder, ``EVA_VIT_G``): forward(images [B, C, H, W])
    -> (cls [B, D], tokens [B, 1 + N, D]).  Attention over the 1 + N
    tokens runs the packed flash kernel where ``packed_kernel_takes`` the
    call (128 tokens and more at a packed head geometry), else einsum
    attention.  Under ``grad_ckpt`` (with autograd on) every
    block is checkpointed, its drop-path and dropout masks replayed from
    the generator state it started with."""

    mesh = None  # the run's mesh (parallel/sharding.shard_params)

    def __init__(self, cfg: VisionConfig, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.cfg, self.policy = cfg, policy
        d, dt = cfg.embed_dim, policy.param_dtype
        self.patch_embed = PatchEmbed(cfg, dt)
        self.cls_token = _param(1, 1, d, dtype=dt)
        self.pos_embed = _param(1, cfg.num_patches + 1, d, dtype=dt)
        if cfg.clip_model:
            self.norm_pre = LayerNormFP32(d, cfg.ln_eps, dt)
        self.blocks = nn.ModuleList(PlainBlock(cfg, dt, rate)
                                    for rate in cfg.drop_path_rates)
        self.norm = LayerNormFP32(d, cfg.ln_eps, dt)

    def forward(self, images, generator: Optional[torch.Generator] = None):
        """``generator``: the attention dropout and drop-path masks of a
        training forward (training mode); ignored otherwise."""
        cfg = self.cfg
        drop = _tower_dropout(self, generator)
        x = self.patch_embed(images.to(self.policy.compute_dtype))
        b, _, d = x.shape
        x = torch.cat([self.cls_token.to(x.dtype).expand(b, 1, d), x], dim=1)
        x = x + self.pos_embed.to(x.dtype)
        if cfg.clip_model:
            x = self.norm_pre(x)
        remat = cfg.grad_ckpt and torch.is_grad_enabled()
        for blk in self.blocks:
            x = (checkpoint_replaying(blk, drop and drop.generator, x, drop)
                 if remat else blk(x, drop))
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
        k = _mm(k_in, self.k_kernel)  # k_bias on the extra key (above)
        v = _mm(k_in, self.v_kernel) + self.v_bias.to(dt)
        k = torch.cat([k, (self.bias_k - self.k_bias).to(dt).expand(b, 1, d)],
                      dim=1)
        v = torch.cat([v, self.bias_v.to(dt).expand(b, 1, d)], dim=1)

        def split(t):  # [B, S, d] -> [B, n, S, hd] view
            return t.unflatten(-1, (n, d // n)).transpose(1, 2)

        out = dot_product_attention(split(q), split(k), split(v))
        out = out.transpose(1, 2).reshape(b, q.shape[1], d)
        out = _mm(out, self.out_kernel) + self.out_bias.to(dt)
        x = q_in + out  # residual on the NORMED queries
        return x + self.mlp(self.norm2(x))


# EVA-ViT-g (JAX ``vision.py:747-753``, from the reference's
# create_eva_vit_g): a plain pre-LN ViT with absolute position
# embeddings, patch 14, 1408 wide, 40 blocks of 16 heads of 88, MLP
# ratio 4.3637 (6144 wide), drop-path 0.4, every block checkpointed; the
# image pretrain path's encoder (``MPLUGVideo(..., image=True)``).
EVA_VIT_G = VisionConfig(
    img_size=224, patch_size=14, embed_dim=1408, depth=40, num_heads=16,
    mlp_ratio=4.3637, drop_path=0.4, grad_ckpt=True)
