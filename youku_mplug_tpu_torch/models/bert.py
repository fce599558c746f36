"""The BERT stack of the mPLUG and ALPRO families: encoder, the
skip-connected fusion network and the causal prefix decoder.

Counterpart of ``youku_mplug_tpu/models/bert.py``; the parameters keep
the JAX names and shapes (``layer_{i}`` by absolute index, ``kernel``
[in, out], ``embedding`` [V, H], LayerNorm ``scale`` / ``bias``), so a
JAX tree loads by rename (``bridge.load_jax_params``).  What a port can
lose silently, all kept here:

- post-LN blocks with HF's additive masks: ``extend_mask`` puts -10000
  (not -inf) at masked keys, so a fully masked row softmaxes over its raw
  scores as in JAX; the causal form adds the lower triangle, with an
  optional bidirectional prefix;
- the attention is the plain one (``ops/attention.mha_reference`` with the
  additive bias, fp32 scores), as JAX runs it outside any Pallas kernel;
  no attention-probability dropout (JAX's BERT has none);
- the GELU is exact (erf);
- ``FusionEncoder`` runs layers ``[L - fusion_layer, L)``: a layer
  cross-attends text to the image stream, except every ``stride_layer``-th
  after the first, which self-attends over [image; text] and adds its
  image half back into the image stream;
- ``BertPrefixModel`` is the decoder with cross-attention
  (``text_decoder_layers`` deep) and its loss shifts inside (HF's
  ``logits[:, :-1]`` against ``labels[:, 1:]``, -100 ignored).

Hidden dropout (after the embeddings, each attention's output projection
and each FFN) is inverted dropout at ``hidden_dropout_prob`` through
``ops/attention.dropout``, its masks drawn from the ``generator`` a
training forward passes (the JAX methods' ``deterministic=False``); with
no generator nothing drops.  Everything computes in fp32 with fp32
parameters, as flax promotes the BERT's fp32 weights in JAX whatever the
vision tower's compute dtype.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from youku_mplug_tpu_torch.models.tasks import Dense
from youku_mplug_tpu_torch.models.vision import LayerNormFP32, _param
from youku_mplug_tpu_torch.ops.attention import dropout, mha_reference
from youku_mplug_tpu_torch.ops.cross_entropy import (
    cross_entropy_with_logits,
    masked_mean_loss,
)

MASKED_BIAS = -10000.0  # HF get_extended_attention_mask


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """Matches configs/models/config_bert_*.json."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    pad_token_id: int = 0
    encoder_width: int = 768
    fusion_layer: int = 6
    stride_layer: int = 100
    add_cross_attention: bool = False
    text_encoder_layers: int = 6
    text_decoder_layers: int = 12

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_json_file(cls, path: str, **overrides) -> "BertConfig":
        with open(path) as f:
            raw = json.load(f)
        if "fusion_layers" in raw:  # the mPLUG JSON spells it plural
            raw.setdefault("fusion_layer", raw["fusion_layers"])
        known = {f.name for f in dataclasses.fields(cls)}
        mapped = {k: v for k, v in raw.items() if k in known}
        mapped.update(overrides)
        return cls(**mapped)


class Embed(nn.Module):
    """flax ``nn.Embed``: ``embedding`` [num, features]."""

    def __init__(self, num: int, features: int, dtype=torch.float32):
        super().__init__()
        self.embedding = _param(num, features, dtype=dtype)

    def forward(self, ids):
        return F.embedding(ids.long(), self.embedding)


class BertLayerNorm(LayerNormFP32):
    """The fp32 LayerNorm (``scale``, ``bias``) at BERT's eps 1e-12."""

    def __init__(self, dim: int, eps: float = 1e-12, dtype=torch.float32):
        super().__init__(dim, eps, dtype)


def _drop(x, cfg: BertConfig, generator):
    if generator is None:
        return x
    return dropout(x, cfg.hidden_dropout_prob, generator)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.word_embeddings = Embed(cfg.vocab_size, h, dtype)
        self.position_embeddings = Embed(cfg.max_position_embeddings, h,
                                         dtype)
        self.token_type_embeddings = Embed(cfg.type_vocab_size, h, dtype)
        self.layernorm = BertLayerNorm(h, cfg.layer_norm_eps, dtype)

    def forward(self, input_ids=None, token_type_ids=None,
                position_ids=None, inputs_embeds=None, generator=None):
        if inputs_embeds is None:
            inputs_embeds = self.word_embeddings(input_ids)
        b, s = inputs_embeds.shape[:2]
        device = inputs_embeds.device
        if position_ids is None:
            position_ids = torch.arange(s, device=device)[None].expand(b, s)
        if token_type_ids is None:
            token_type_ids = torch.zeros(b, s, dtype=torch.long,
                                         device=device)
        x = (inputs_embeds + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return _drop(self.layernorm(x), self.cfg, generator)


class BertAttention(nn.Module):
    """Self or cross attention, output dense and residual LayerNorm (HF
    BertSelfAttention + BertSelfOutput).  ``kv_width``: the width of the
    states a cross attention reads."""

    def __init__(self, cfg: BertConfig, kv_width: Optional[int] = None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        kv = kv_width or h
        self.query = Dense(h, h, dtype)
        self.key = Dense(kv, h, dtype)
        self.value = Dense(kv, h, dtype)
        self.out = Dense(h, h, dtype)
        self.out_layernorm = BertLayerNorm(h, cfg.layer_norm_eps, dtype)

    def forward(self, hidden, attn_bias=None, kv=None, generator=None):
        n = self.cfg.num_attention_heads
        kv = hidden if kv is None else kv

        def split(t):  # [B, S, n*d] -> [B, n, S, d]
            return t.unflatten(-1, (n, -1)).transpose(1, 2)

        out = mha_reference(split(self.query(hidden)), split(self.key(kv)),
                            split(self.value(kv)), bias=attn_bias)
        out = self.out(out.transpose(1, 2).flatten(2))
        out = _drop(out, self.cfg, generator)
        return self.out_layernorm(hidden + out)


class BertFFN(nn.Module):
    def __init__(self, cfg: BertConfig, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.intermediate = Dense(cfg.hidden_size, cfg.intermediate_size,
                                  dtype)
        self.output = Dense(cfg.intermediate_size, cfg.hidden_size, dtype)
        self.output_layernorm = BertLayerNorm(cfg.hidden_size,
                                              cfg.layer_norm_eps, dtype)

    def forward(self, x, generator=None):
        h = self.output(F.gelu(self.intermediate(x), approximate="none"))
        return self.output_layernorm(x + _drop(h, self.cfg, generator))


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, has_cross: bool = False,
                 kv_width: Optional[int] = None, dtype=torch.float32):
        super().__init__()
        self.attention = BertAttention(cfg, dtype=dtype)
        self.crossattention = (BertAttention(cfg, kv_width, dtype)
                               if has_cross else None)
        self.ffn = BertFFN(cfg, dtype)

    def forward(self, x, attn_bias=None, enc=None, enc_bias=None,
                generator=None):
        x = self.attention(x, attn_bias, generator=generator)
        if self.crossattention is not None:
            x = self.crossattention(x, enc_bias, kv=enc, generator=generator)
        return self.ffn(x, generator)


def extend_mask(attention_mask: torch.Tensor, causal: bool = False,
                prefix_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, S] 0/1 -> fp32 additive bias, -10000 at masked keys: [B, 1, 1,
    S], or causal [B, 1, S, S] (the lower triangle, each row's first
    ``prefix_len`` keys visible to every query)."""
    m = attention_mask.float()
    if not causal:
        return ((1.0 - m) * MASKED_BIAS)[:, None, None, :]
    s = attention_mask.shape[1]
    tri = torch.tril(torch.ones(s, s, device=m.device))[None]
    if prefix_len is not None:
        pos = torch.arange(s, device=m.device)[None, :]
        prefix = (pos < prefix_len.to(m.device)[:, None]).float()
        tri = torch.maximum(tri, prefix[:, None, :])
    ext = tri * m[:, None, :]
    return ((1.0 - ext) * MASKED_BIAS)[:, None]


class BertEncoder(nn.Module):
    """Layers ``layer_0`` .. ``layer_{L-1}``; a forward runs those of
    ``layer_range`` (default ``[0, num_layers or L)``), as ALPRO splits one
    BERT into its text and fusion halves."""

    def __init__(self, cfg: BertConfig, kv_width: Optional[int] = None,
                 dtype=torch.float32):
        super().__init__()
        self.num_layers = cfg.num_hidden_layers
        for i in range(cfg.num_hidden_layers):
            setattr(self, f"layer_{i}",
                    BertLayer(cfg, cfg.add_cross_attention,
                              kv_width or cfg.encoder_width, dtype))

    def forward(self, x, attn_bias=None, enc=None, enc_bias=None,
                num_layers=None, layer_range=None, generator=None):
        lo, hi = layer_range or (0, num_layers or self.num_layers)
        for i in range(lo, hi):
            x = getattr(self, f"layer_{i}")(x, attn_bias, enc, enc_bias,
                                            generator)
        return x


class BertModel(nn.Module):
    """Text encoder / decoder (embeddings + ``BertEncoder``)."""

    def __init__(self, cfg: BertConfig, kv_width: Optional[int] = None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg, dtype)
        self.encoder = BertEncoder(cfg, kv_width, dtype)

    def forward(self, input_ids=None, attention_mask=None,
                token_type_ids=None, inputs_embeds=None, encoder_embeds=None,
                encoder_hidden_states=None, encoder_attention_mask=None,
                is_decoder=False, prefix_len=None, num_layers=None,
                layer_range=None, generator=None):
        if encoder_embeds is not None:
            x = encoder_embeds
        else:
            x = self.embeddings(input_ids, token_type_ids,
                                inputs_embeds=inputs_embeds,
                                generator=generator)
        b, s = x.shape[:2]
        if attention_mask is None:
            attention_mask = torch.ones(b, s, dtype=torch.long,
                                        device=x.device)
        bias = extend_mask(attention_mask, causal=is_decoder,
                           prefix_len=prefix_len)
        enc_bias = None
        if encoder_hidden_states is not None:
            if encoder_attention_mask is None:
                encoder_attention_mask = torch.ones(
                    encoder_hidden_states.shape[:2], dtype=torch.long,
                    device=x.device)
            enc_bias = extend_mask(encoder_attention_mask)
        return self.encoder(x, bias, encoder_hidden_states, enc_bias,
                            num_layers=num_layers, layer_range=layer_range,
                            generator=generator)


class FusionEncoder(nn.Module):
    """mPLUG's skip-connected two-stream fusion over layers
    ``[L - fusion_layer, L)`` (see the module docstring)."""

    def __init__(self, cfg: BertConfig, kv_width: Optional[int] = None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.start = max(0, cfg.num_hidden_layers - cfg.fusion_layer)
        for i in range(self.start, cfg.num_hidden_layers):
            setattr(self, f"layer_{i}",
                    BertLayer(cfg, not self.connected(i),
                              kv_width or cfg.encoder_width, dtype))

    def connected(self, i: int) -> bool:
        rel = i - self.start
        return rel != 0 and rel % self.cfg.stride_layer == 0

    def forward(self, text, text_mask, image, image_mask, generator=None):
        text_bias, image_bias = extend_mask(text_mask), extend_mask(
            image_mask)
        img_len = image.shape[1]
        for i in range(self.start, self.cfg.num_hidden_layers):
            layer = getattr(self, f"layer_{i}")
            if not self.connected(i):
                text = layer(text, text_bias, image, image_bias, generator)
                continue
            joint = layer(torch.cat([image, text], 1),
                          extend_mask(torch.cat([image_mask, text_mask], 1)),
                          generator=generator)
            image = image + joint[:, :img_len]
            text = joint[:, img_len:]
        return image, text


class FusionModel(nn.Module):
    def __init__(self, cfg: BertConfig, kv_width: Optional[int] = None,
                 dtype=torch.float32):
        super().__init__()
        self.fusion_encoder = FusionEncoder(cfg, kv_width, dtype)

    def forward(self, text_embeds, text_mask, image_embeds, image_mask,
                generator=None) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.fusion_encoder(text_embeds, text_mask, image_embeds,
                                   image_mask, generator)


class BertLMHead(nn.Module):
    """Transform, GELU, LayerNorm, then the vocab projection: ``decoder``
    (kernel [H, V]), or with ``tied`` the ``shared_embedding`` [V, H] the
    forward is given; plus ``bias`` [V].  fp32 logits."""

    def __init__(self, cfg: BertConfig, tied: bool = False,
                 dtype=torch.float32):
        super().__init__()
        h = cfg.hidden_size
        self.transform = Dense(h, h, dtype)
        self.transform_layernorm = BertLayerNorm(h, cfg.layer_norm_eps,
                                                 dtype)
        self.bias = _param(cfg.vocab_size, dtype=dtype)
        self.decoder = None if tied else Dense(h, cfg.vocab_size, dtype,
                                               use_bias=False)

    def forward(self, hidden, shared_embedding=None):
        h = self.transform_layernorm(
            F.gelu(self.transform(hidden), approximate="none"))
        if shared_embedding is not None:
            logits = h.float() @ shared_embedding.float().t()
        else:
            logits = self.decoder(h).float()
        return logits + self.bias.float()


def lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over the positions whose label is not -100."""
    safe = torch.where(labels == -100, torch.zeros_like(labels), labels)
    return masked_mean_loss(cross_entropy_with_logits(logits, safe),
                            labels != -100)


class BertPrefixModel(nn.Module):
    """The causal BERT decoder with cross-attention and its LM head
    (``bert``, ``cls``): mPLUG's caption generator."""

    def __init__(self, cfg: BertConfig, kv_width: Optional[int] = None,
                 dtype=torch.float32):
        super().__init__()
        cfg = dataclasses.replace(cfg, add_cross_attention=True,
                                  num_hidden_layers=cfg.text_decoder_layers)
        self.cfg = cfg
        self.bert = BertModel(cfg, kv_width, dtype)
        self.cls = BertLMHead(cfg, dtype=dtype)

    def forward(self, input_ids, attention_mask=None,
                encoder_hidden_states=None, encoder_attention_mask=None,
                labels=None, prefix_len=None, generator=None):
        x = self.bert(input_ids, attention_mask, is_decoder=True,
                      prefix_len=prefix_len,
                      encoder_hidden_states=encoder_hidden_states,
                      encoder_attention_mask=encoder_attention_mask,
                      generator=generator)
        logits = self.cls(x)
        out = {"last_hidden_state": x, "logits": logits}
        if labels is not None:  # HF's shift inside
            out["loss"] = lm_loss(logits[:, :-1], labels[:, 1:])
        return out
