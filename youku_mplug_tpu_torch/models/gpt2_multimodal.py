"""GPT-2 multimodal decoder and the MPLUG-COCA pretraining model.

Counterpart of ``youku_mplug_tpu/models/gpt2_multimodal.py`` (the
reference's GPT2MultiModalBlock and MPLUG_COCA): learned positions,
pre-LN blocks with fp32 LayerNorms, tanh GELU, an untied ``lm_head``, and
TWO FFNs a block, ``mlp`` (text mode) and ``mlp_vision`` (vision mode),
picked per forward; COCA's mixed mask lets text attend to every visual
token while the visual tokens stay bidirectional.  Attention runs plain
(``mha_reference`` with the additive mask), as in JAX: no kernel takes
an additive bias.

Parameters keep the JAX names and shapes (flax ``Dense`` kernels [in,
out] with a bias, ``Embed`` tables, blocks ``h_<i>``), so a JAX tree loads
through ``bridge.load_jax_params``.  A flax module creates the parameters
of what its calls reach; the port builds the same set:
``GPT2MultiModalModel(..., embed=False)`` has no ``wte`` (MPLUGCOCA's
multimodal decoder takes embeddings), ``modes`` names the FFN branches
its blocks hold (``text``, ``vision``), and a block holds
``crossattention`` under ``add_cross_attention`` (JAX: when an encoder
state is passed).  MPLUGCOCA's text decoder runs the text mode alone,
its multimodal decoder both.

``blockwise_mask`` draws a uniform patch mask from a ``torch.Generator``
(JAX's from a ``jax.random`` key: other bits, the same law); the tests
pass one mask to both packages.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from youku_mplug_tpu_torch.models.bert import Embed
from youku_mplug_tpu_torch.models.tasks import Dense
from youku_mplug_tpu_torch.models.vision import (
    LayerNormFP32,
    VisionConfig,
    VisionTransformer,
)
from youku_mplug_tpu_torch.ops.attention import mha_reference
from youku_mplug_tpu_torch.ops.cross_entropy import cross_entropy_with_logits
from youku_mplug_tpu_torch.runtime.precision import DEFAULT_POLICY, Policy


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    add_cross_attention: bool = False

    @property
    def head_dim(self):
        return self.n_embd // self.n_head

    @classmethod
    def from_json_file(cls, path: str, **overrides):
        with open(path) as f:
            raw = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        mapped = {k: v for k, v in raw.items() if k in known}
        mapped.update(overrides)
        return cls(**mapped)


class GPT2Attention(nn.Module):
    """Self-attention (``c_attn`` [e, 3e] -> q, k, v) or, ``is_cross``,
    cross-attention (``q_attn`` on x, ``c_attn`` [e, 2e] on the encoder
    state), plain attention with an additive bias, then ``c_proj``."""

    def __init__(self, cfg: GPT2Config, is_cross: bool = False,
                 dtype=torch.float32):
        super().__init__()
        e = cfg.n_embd
        self.cfg, self.is_cross = cfg, is_cross
        if is_cross:
            self.q_attn = Dense(e, e, dtype)
            self.c_attn = Dense(e, 2 * e, dtype)
        else:
            self.c_attn = Dense(e, 3 * e, dtype)
        self.c_proj = Dense(e, e, dtype)

    def forward(self, x, attn_bias=None, kv=None):
        cfg = self.cfg
        n, d, e = cfg.n_head, cfg.head_dim, cfg.n_embd
        kv = x if kv is None else kv
        if self.is_cross:
            q = self.q_attn(x)
            k, v = self.c_attn(kv).split(e, dim=-1)
        else:
            q, k, v = self.c_attn(x).split(e, dim=-1)
        b, sq = x.shape[:2]
        sk = kv.shape[1]

        def split(t, s):
            return t.reshape(b, s, n, d).transpose(1, 2)

        out = mha_reference(split(q, sq), split(k, sk), split(v, sk),
                            bias=attn_bias)
        return self.c_proj(out.transpose(1, 2).reshape(b, sq, e))


class GPT2MLP(nn.Module):
    def __init__(self, cfg: GPT2Config, dtype=torch.float32):
        super().__init__()
        self.c_fc = Dense(cfg.n_embd, 4 * cfg.n_embd, dtype)
        self.c_proj = Dense(4 * cfg.n_embd, cfg.n_embd, dtype)

    def forward(self, x):
        return self.c_proj(F.gelu(self.c_fc(x), approximate="tanh"))


class GPT2MultiModalBlock(nn.Module):
    """Pre-LN block: self-attention, optional cross-attention, then the
    mode's FFN (``ln_2`` + ``mlp`` for text, ``ln_2_vision`` +
    ``mlp_vision`` for vision)."""

    def __init__(self, cfg: GPT2Config, modes: Sequence[str] = ("text",),
                 dtype=torch.float32):
        super().__init__()
        e, eps = cfg.n_embd, cfg.layer_norm_epsilon
        self.ln_1 = LayerNormFP32(e, eps, dtype)
        self.attn = GPT2Attention(cfg, dtype=dtype)
        if cfg.add_cross_attention:
            self.ln_cross_attn = LayerNormFP32(e, eps, dtype)
            self.crossattention = GPT2Attention(cfg, True, dtype)
        if "text" in modes:
            self.ln_2 = LayerNormFP32(e, eps, dtype)
            self.mlp = GPT2MLP(cfg, dtype)
        if "vision" in modes:
            self.ln_2_vision = LayerNormFP32(e, eps, dtype)
            self.mlp_vision = GPT2MLP(cfg, dtype)

    def forward(self, x, attn_bias=None, enc=None, enc_bias=None,
                mode: str = "text"):
        x = x + self.attn(self.ln_1(x), attn_bias)
        if enc is not None:
            x = x + self.crossattention(self.ln_cross_attn(x), enc_bias,
                                        kv=enc)
        if mode == "text":
            return x + self.mlp(self.ln_2(x))
        return x + self.mlp_vision(self.ln_2_vision(x))


def mixed_causal_bias(visual_len: int, text_len: int, attention_mask,
                      mask_v2t: bool = True, full: bool = False):
    """COCA's mixed mask as an additive fp32 bias [B, 1, S, S] (0 where a
    query sees a key, -1e4 elsewhere): visual-visual bidirectional,
    text-text causal, text -> visual allowed, visual -> text blocked
    (allowed with ``mask_v2t=False``; everything with ``full``), each key
    column also masked by ``attention_mask`` [B, S]."""
    s = visual_len + text_len
    dev = attention_mask.device
    m = torch.zeros(s, s, dtype=torch.float32, device=dev)
    m[:visual_len, :visual_len] = 1.0
    m[visual_len:, visual_len:] = torch.tril(torch.ones(
        text_len, text_len, dtype=torch.float32, device=dev))
    m[visual_len:, :visual_len] = 1.0
    if not mask_v2t or full:
        m[:visual_len, visual_len:] = 1.0
    if full:
        m = torch.ones(s, s, dtype=torch.float32, device=dev)
    ext = m[None] * attention_mask[:, None, :].float()
    return ((1.0 - ext) * -1e4)[:, None]


class GPT2MultiModalModel(nn.Module):
    """Embeddings (``wte`` unless ``embed=False``, ``wpe``), the blocks
    ``h_<i>``, ``ln_f`` and the untied ``lm_head`` (fp32 logits).
    forward -> (hidden [B, S, E], logits [B, S, V])."""

    def __init__(self, cfg: GPT2Config, policy: Policy = DEFAULT_POLICY,
                 modes: Sequence[str] = ("text",), embed: bool = True):
        super().__init__()
        dt = policy.param_dtype
        self.cfg = cfg
        if embed:
            self.wte = Embed(cfg.vocab_size, cfg.n_embd, dt)
        self.wpe = Embed(cfg.n_positions, cfg.n_embd, dt)
        self.blocks = [GPT2MultiModalBlock(cfg, modes, dt)
                       for _ in range(cfg.n_layer)]
        for i, blk in enumerate(self.blocks):
            self.add_module(f"h_{i}", blk)
        self.ln_f = LayerNormFP32(cfg.n_embd, cfg.layer_norm_epsilon, dt)
        self.lm_head = Dense(cfg.n_embd, cfg.vocab_size, dt, use_bias=False)

    def forward(self, input_ids=None, inputs_embeds=None, attn_bias=None,
                enc=None, enc_bias=None, mode: str = "text",
                position_ids=None):
        if inputs_embeds is None:
            inputs_embeds = self.wte(input_ids)
        b, s = inputs_embeds.shape[:2]
        if position_ids is None:
            position_ids = torch.arange(
                s, device=inputs_embeds.device)[None].expand(b, s)
        x = inputs_embeds + self.wpe(position_ids).to(inputs_embeds.dtype)
        for blk in self.blocks:
            x = blk(x, attn_bias, enc, enc_bias, mode)
        x = self.ln_f(x)
        return x, self.lm_head(x.float())


@dataclasses.dataclass(frozen=True)
class COCAConfig:
    vision: VisionConfig = VisionConfig()
    gpt2: GPT2Config = GPT2Config()
    predict_feature_dim: int = 512
    only_masked: bool = False


class MPLUGCOCA(nn.Module):
    """COCA pretraining: the caption LM over [image tokens; text] through
    the multimodal decoder's text mode, plus (with a patch mask and
    targets) masked image modeling, a cosine regression of the masked
    patches' vision-mode features onto ``image_target``."""

    def __init__(self, cfg: COCAConfig, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        dt = policy.param_dtype
        self.cfg, self.policy = cfg, policy
        self.visual_encoder = VisionTransformer(cfg.vision, policy)
        self.text_decoder = GPT2MultiModalModel(cfg.gpt2, policy)
        self.multimodal_decoder = GPT2MultiModalModel(
            cfg.gpt2, policy, modes=("text", "vision"), embed=False)
        self.visual_lm_head = Dense(cfg.gpt2.n_embd,
                                    cfg.predict_feature_dim, dt)
        self.mismatch = cfg.gpt2.n_embd != cfg.vision.embed_dim
        if self.mismatch:
            self.visual_fc = Dense(cfg.vision.embed_dim, cfg.gpt2.n_embd, dt)
            self.visual_norm = LayerNormFP32(cfg.gpt2.n_embd, 1e-6, dt)

    def _project(self, image_embeds):
        if self.mismatch:
            image_embeds = self.visual_norm(self.visual_fc(image_embeds))
        return image_embeds

    def forward(self, images, input_ids, attention_mask,
                bool_masked_pos=None, image_target=None,
                generator: Optional[torch.Generator] = None):
        """images [B, C, H, W], input_ids / attention_mask [B, S];
        bool_masked_pos [B, N] (N patches) and image_target [B, N, F] for
        the MIM loss; ``generator``: the vision tower's drop-path masks
        in training mode.  -> {loss, loss_caption, loss_mim} (fp32)."""
        _, image_embeds = self.visual_encoder(images, generator)
        image_embeds = self._project(image_embeds)
        b, lv, _ = image_embeds.shape
        lt = input_ids.shape[1]
        image_atts = torch.ones(b, lv, dtype=attention_mask.dtype,
                                device=attention_mask.device)
        text_embeds, _ = self.text_decoder(
            input_ids=input_ids,
            attn_bias=mixed_causal_bias(0, lt, attention_mask))
        dt = torch.promote_types(image_embeds.dtype, text_embeds.dtype)
        joint = torch.cat([image_embeds.to(dt), text_embeds.to(dt)], dim=1)
        joint_mask = torch.cat([image_atts, attention_mask], dim=1)

        _, logits = self.multimodal_decoder(
            inputs_embeds=joint,
            attn_bias=mixed_causal_bias(lv, lt, joint_mask), mode="text")
        logits = logits[:, lv:]
        mask = attention_mask[:, 1:].float()
        losses = cross_entropy_with_logits(logits[:, :-1],
                                           input_ids[:, 1:]) * mask
        loss_caption = losses.sum() / mask.sum().clamp_min(1.0)

        loss_mim = torch.zeros((), dtype=torch.float32,
                               device=loss_caption.device)
        if bool_masked_pos is not None and image_target is not None:
            # a second pass of the tower, as JAX makes it; masked patches
            # are zeros (the mask token) before the projection
            patches = self.visual_encoder(images, generator)[1][:, 1:]
            masked = self._project(torch.where(
                bool_masked_pos[:, :, None].bool(),
                torch.zeros((), dtype=patches.dtype, device=patches.device),
                patches))
            mdt = torch.promote_types(masked.dtype, text_embeds.dtype)
            masked_joint = torch.cat([image_embeds[:, :1].to(mdt),
                                      masked.to(mdt), text_embeds.to(mdt)],
                                     dim=1)
            feats, _ = self.multimodal_decoder(
                inputs_embeds=masked_joint,
                attn_bias=mixed_causal_bias(lv, lt, joint_mask, full=True),
                mode="vision")
            pred = self.visual_lm_head(feats[:, 1:lv].float())
            tgt = image_target.float()
            cos = (pred * tgt).sum(-1) / (
                torch.linalg.vector_norm(pred, dim=-1)
                * torch.linalg.vector_norm(tgt, dim=-1) + 1e-8)
            m = bool_masked_pos.float()
            loss_mim = 1.0 - (cos * m).sum() / m.sum().clamp_min(1.0)
        return {"loss": loss_caption + loss_mim,
                "loss_caption": loss_caption, "loss_mim": loss_mim}


def blockwise_mask(generator: torch.Generator, batch: int, grid: int,
                   num_masked: int, device=None) -> torch.Tensor:
    """A uniform random patch mask for MIM: bool [batch, grid * grid]
    with ``num_masked`` True a row (ties aside: the scores are fp32
    uniforms), drawn from ``generator``."""
    scores = torch.rand(batch, grid * grid, generator=generator,
                        device=device)
    thresh = scores.sort(dim=1).values[:, num_masked - 1][:, None]
    return scores <= thresh
