"""mPLUG-Owl video instruct model (mPLUG-Video BloomZ-7B): per-frame CLIP
ViT -> visual abstractor -> ``visual_fc`` (+ ``vit_eos``) -> features
spliced into the Bloom token embeddings at the ``<|video|>`` positions.

Counterpart of ``youku_mplug_tpu/models/owl.py``: ``encode_video`` and
``spliced_embeds`` for serving, ``generate_instruct`` (the batched
greedy, sampled or beam-search answer), ``instruct_loss`` (the
response-masked LM loss of instruction finetuning) for training.
Parameter names and shapes follow the JAX tree, so the bridge loads it by
rename.  What the port keeps:

- frames fold into the batch for one ViT sweep ([B*T, 1 + N, D]);
- the abstractor adds a learnable per-frame temporal embedding before
  flattening the frames, runs its queries against [normed queries ;
  normed frame features] (the 64 queries are below the flash kernel's
  one 128-row block, so plain attention, as in the JAX package), adds the
  attention output onto the NORMED queries (the external model's
  trained-in quirk), has a gated-SiLU MLP with its LayerNorm on the
  intermediate width, and no final LayerNorm;
- ``splice_media``: the k-th media position takes the k-th media
  feature (a cumulative-index gather);
- in training, a frozen vision tower (no parameter that wants a
  gradient, and the clips want none) builds no autograd graph, so it
  launches no backward kernel; with vision LoRA its adapters train and
  it does;
- ``instruct_loss`` takes the step's dropout ``generator`` to the ViT
  (attention dropout, drop-path) and to Bloom (hidden and attention
  dropout), the JAX method's ``deterministic=False``.

Tensor parallelism (``parallel/sharding.shard_params`` with JAX's
``BLOOM_SHARDING_RULES``): the ViT and Bloom as ``models/vision.py`` and
``models/bloom.py`` cut them; in each abstractor layer q, k and v are
cut on their columns (the rank's n/m heads), the out projection on its
rows (summed over the model ranks before ``out_bias``), the MLP's w1 and
w3 on their columns and w2 on its rows (summed before ``w2_bias``), and
``ffn_ln`` normalizes the split intermediate width with statistics
summed over the model group (``ops/layernorm.split_layer_norm``); the
inputs of the column-parallel products pass through *f*.  The queries,
embeddings, ``visual_fc``, ``vit_eos`` and the other LayerNorms stay
whole.  Under a data split the instruct loss is this rank's share of the
global batch's masked mean (Bloom's loss); ``generate_instruct`` picks
from the gathered full-vocabulary logits on every model rank.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from youku_mplug_tpu_torch.models.bloom import BloomConfig, BloomLM
from youku_mplug_tpu_torch.models.generation import GenerationConfig, generate
from youku_mplug_tpu_torch.models.tasks import Dense
from youku_mplug_tpu_torch.models.vision import (
    LayerNormFP32,
    VisionConfig,
    VisionTransformer,
    _mm,
    _param,
)
from youku_mplug_tpu_torch.ops.attention import dot_product_attention
from youku_mplug_tpu_torch.ops.layernorm import split_layer_norm
from youku_mplug_tpu_torch.parallel.tensor_parallel import (
    copy_to_model,
    reduce_from_model,
)
from youku_mplug_tpu_torch.runtime.precision import DEFAULT_POLICY, Policy


@dataclasses.dataclass(frozen=True)
class OwlAbstractorConfig:
    """mPLUG-Owl visual abstractor (ViT-L width defaults)."""

    hidden_size: int = 1024
    num_layers: int = 6
    num_heads: int = 16
    intermediate_size: int = 2816
    num_queries: int = 64
    ln_eps: float = 1e-6
    init_std: float = 0.02
    max_frames: int = 32


class SplitLayerNorm(LayerNormFP32):
    """``LayerNormFP32`` whose width a model shard may split (its scale and
    bias cut to the rank's slice): the statistics are then summed over
    the model group (``split_layer_norm``)."""

    TP_PARAM = "scale"  # the leaf a model shard must split
    tp = None

    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.float32):
        super().__init__(dim, eps, dtype)
        self.width = dim

    def forward(self, x):
        return split_layer_norm(x, self.scale, self.bias, self.tp,
                                width=self.width, eps=self.eps)


class OwlAbstractorMlp(nn.Module):
    """``w2(ffn_ln(silu(w1 x) * w3 x))``: the LayerNorm on the
    intermediate width.  On a model shard w1 / w3 hold this rank's
    columns, ``ffn_ln`` its slice, w2 its rows; w2's partial product is
    summed over the model ranks and ``w2_bias`` added once, after."""

    TP_PARAM = "w2_kernel"
    tp = None

    def __init__(self, dim: int, hidden: int, ln_eps: float, dtype):
        super().__init__()
        for name, shape in (("w1", (dim, hidden)), ("w3", (dim, hidden)),
                            ("w2", (hidden, dim))):
            setattr(self, f"{name}_kernel", _param(*shape, dtype=dtype))
            setattr(self, f"{name}_bias", _param(shape[1], dtype=dtype))
        self.ffn_ln = SplitLayerNorm(hidden, ln_eps, dtype)

    def forward(self, x):
        dt = x.dtype
        x = copy_to_model(x, self.tp)
        h = (F.silu(_mm(x, self.w1_kernel) + self.w1_bias.to(dt))
             * (_mm(x, self.w3_kernel) + self.w3_bias.to(dt)))
        out = _mm(self.ffn_ln(h), self.w2_kernel)
        return reduce_from_model(out, self.tp) + self.w2_bias.to(dt)


class OwlAbstractorLayer(nn.Module):
    """Queries attend [normed queries ; normed visual features]; the
    residual base is the normed queries; then the gated MLP.  On a model
    shard q / k / v hold this rank's columns (its heads), the out
    projection its rows; its partial product is summed over the model
    ranks and ``out_bias`` added once, after."""

    TP_PARAM = "out_kernel"
    tp = None

    def __init__(self, cfg: OwlAbstractorConfig, dtype):
        super().__init__()
        d = cfg.hidden_size
        self.head_dim = d // cfg.num_heads
        self.norm_q = LayerNormFP32(d, cfg.ln_eps, dtype)
        self.norm_kv = LayerNormFP32(d, cfg.ln_eps, dtype)
        for name in ("q", "k", "v", "out"):
            setattr(self, f"{name}_kernel", _param(d, d, dtype=dtype))
            setattr(self, f"{name}_bias", _param(d, dtype=dtype))
        self.norm_mlp = LayerNormFP32(d, cfg.ln_eps, dtype)
        self.mlp = OwlAbstractorMlp(d, cfg.intermediate_size, cfg.ln_eps,
                                    dtype)

    @property
    def n(self) -> int:
        """The heads this layer holds (n / m on a model shard)."""
        return self.q_kernel.shape[-1] // self.head_dim

    def forward(self, x, visual):
        b, nq, _ = x.shape
        q_in = self.norm_q(x)
        kv = torch.cat([q_in, self.norm_kv(visual)], dim=1)
        dt = q_in.dtype
        qf, kvf = copy_to_model(q_in, self.tp), copy_to_model(kv, self.tp)
        q = _mm(qf, self.q_kernel) + self.q_bias.to(dt)
        k = _mm(kvf, self.k_kernel) + self.k_bias.to(dt)
        v = _mm(kvf, self.v_kernel) + self.v_bias.to(dt)

        def heads(t):  # [B, S, n*hd] -> [B, n, S, hd] view
            return t.unflatten(-1, (self.n, self.head_dim)).transpose(1, 2)

        out = dot_product_attention(heads(q), heads(k), heads(v))
        out = out.transpose(1, 2).reshape(b, nq, -1)
        y = reduce_from_model(_mm(out, self.out_kernel), self.tp)
        x = q_in + (y + self.out_bias.to(dt))
        return x + self.mlp(self.norm_mlp(x))


class OwlVisualAbstractor(nn.Module):
    """``forward(frame_feats [B, T, N, Dv])`` -> [B, num_queries, D]."""

    def __init__(self, cfg: OwlAbstractorConfig, vision_dim: int, dtype):
        super().__init__()
        d = cfg.hidden_size
        self.temporal_embed = _param(cfg.max_frames, vision_dim, dtype=dtype)
        if vision_dim != d:
            self.in_proj = Dense(vision_dim, d, dtype)
        self.query_embeds = _param(1, cfg.num_queries, d, dtype=dtype)
        self.layers = nn.ModuleList(OwlAbstractorLayer(cfg, dtype)
                                    for _ in range(cfg.num_layers))

    def forward(self, frame_feats):
        b, t, npatch, dv = frame_feats.shape
        dt = frame_feats.dtype
        x = frame_feats + self.temporal_embed[:t][None, :, None, :].to(dt)
        x = x.reshape(b, t * npatch, dv)
        if hasattr(self, "in_proj"):
            x = self.in_proj(x)
        q = self.query_embeds.to(dt).expand(b, -1, -1)
        for layer in self.layers:
            q = layer(q, x)
        return q


@dataclasses.dataclass(frozen=True)
class MPLUGOwlVideoConfig:
    # quick GELU: the external vision tower is CLIP-lineage
    vision: VisionConfig = VisionConfig(
        img_size=224, patch_size=14, embed_dim=1024, depth=24,
        num_heads=16, clip_model=True, gelu="quick")
    abstractor: OwlAbstractorConfig = OwlAbstractorConfig()
    text: BloomConfig = BloomConfig()

    @property
    def num_media_tokens(self) -> int:
        """Positions one video fills in the prompt: the queries, plus the
        ``vit_eos`` token."""
        return self.abstractor.num_queries + 1


def splice_media(tok_emb, query_features, media_mask):
    """tok_emb [B, S, H], query_features [B, nq, H], media_mask [B, S]
    (exactly nq ones per row): the k-th marked position takes the k-th
    query feature; the others keep their token embedding."""
    qidx = (media_mask.long().cumsum(1) - 1).clamp(
        0, query_features.shape[1] - 1)
    gathered = query_features.to(tok_emb.dtype).gather(
        1, qidx[..., None].expand(-1, -1, tok_emb.shape[-1]))
    return torch.where(media_mask[..., None].bool(), gathered, tok_emb)


def instruct_targets(input_ids, attention_mask, media_mask, prompt_mask):
    """Shifted labels [B, S] (column 0 wraps to the end) and the loss mask
    [B, S-1]: only targets that are real text outside the media span and
    the instruction prompt (the answer and its eos) are supervised, in
    the ``losses[:, :-1] x loss_mask`` convention of ``BloomLM``."""
    labels = torch.cat([input_ids[:, 1:], input_ids[:, :1]], dim=1)
    keep = (attention_mask[:, 1:] * (1 - media_mask[:, 1:])
            * (1 - prompt_mask[:, 1:])).int()
    return labels, keep


class MPLUGOwlVideo(nn.Module):
    """Per-frame ViT -> visual abstractor -> Bloom decoder."""

    def __init__(self, cfg: MPLUGOwlVideoConfig,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.cfg, self.policy = cfg, policy
        dt = policy.param_dtype
        self.visual_encoder = VisionTransformer(cfg.vision, policy)
        self.abstractor = OwlVisualAbstractor(cfg.abstractor,
                                              cfg.vision.embed_dim, dt)
        self.visual_fc = Dense(cfg.abstractor.hidden_size,
                               cfg.text.hidden_size, dt)
        self.vit_eos = _param(1, 1, cfg.text.hidden_size, dtype=dt)
        self.text_decoder = BloomLM(cfg.text, policy)

    def encode_video(self, video, generator=None):
        """video [B, C, T, H, W] -> media features [B, num_media_tokens,
        H_text] (the queries, then ``vit_eos``); ``generator``: the ViT's
        dropout masks in training mode."""
        b, c, t, hh, ww = video.shape
        frames = video.transpose(1, 2).reshape(b * t, c, hh, ww)
        _, feats = self.visual_encoder(frames, generator)
        q = self.abstractor(feats.reshape(b, t, *feats.shape[1:]))
        q = self.visual_fc(q)
        return torch.cat([q, self.vit_eos.to(q.dtype).expand(b, 1, -1)],
                         dim=1)

    def spliced_embeds(self, input_ids, media_mask, query_features):
        """Raw prompt embeddings [B, S, H] with the media features at the
        media positions; the token rows come from the decoder's tied
        embedding, dequantized when it is int8."""
        return splice_media(self.text_decoder.embed(input_ids),
                            query_features, media_mask)

    def instruct_loss(self, video, input_ids, attention_mask, media_mask,
                      prompt_mask, generator=None):
        """Instruction-tuning LM loss over the answer tokens: {"loss"}.
        ``generator``: the dropout masks, in training mode."""
        embeds = self.spliced_embeds(input_ids, media_mask,
                                     self.encode_video(video, generator))
        labels, loss_mask = instruct_targets(input_ids, attention_mask,
                                             media_mask, prompt_mask)
        out = self.text_decoder(input_embeds=embeds, labels=labels,
                                loss_mask=loss_mask, generator=generator)
        return {"loss": out["loss"]}

    def forward(self, video, input_ids, attention_mask, media_mask,
                prompt_mask, generator=None):
        return self.instruct_loss(video, input_ids, attention_mask,
                                  media_mask, prompt_mask, generator)


def generate_instruct(model: MPLUGOwlVideo, video, input_ids, media_mask,
                      prompt_len, gen_config: GenerationConfig,
                      generator=None):
    """Video instruct inference in one lock-step batch (the JAX package's
    ``generate_instruct``): ``encode_video``, ``spliced_embeds``, then
    ``generate`` on the Bloom decoder with the spliced rows as the prompt
    embeddings.  video: normalized [B, C, T, H, W]; input_ids [B, P]
    right-padded, the ``<|video|>`` placeholder already expanded to
    ``num_media_tokens`` media positions; prompt_len [B] true lengths
    (media positions included).  Greedy, sampled (``do_sample``; draws
    from ``generator``) or beam search (``beam_size > 1``) as
    ``gen_config`` says.  An int8 decoder (``--int8``, or a serving
    checkpoint with ``qscales``) looks the spliced token rows up
    dequantized.  Returns ``generate``'s dict."""
    with torch.inference_mode():
        embeds = model.spliced_embeds(input_ids, media_mask,
                                      model.encode_video(video))
        return generate(model.text_decoder, input_ids, prompt_len,
                        config=gen_config, generator=generator,
                        prompt_embeds=embeds)
