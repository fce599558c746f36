"""ALPRO, the ALBEF-style split-BERT video-text family.

Counterpart of ``youku_mplug_tpu/models/alpro.py`` (``ALPROConfig``,
``ALPRO`` with ``encode_image``, ``encode_text``, ``fuse``,
``pretrain_loss``, ``retrieval_loss``, ``cls_forward``), with the JAX
parameter names:

- the TimeSformer's patch tokens are averaged over frames beside its
  cls token: image embeds [B, 1 + N, D];
- ONE BERT (``text_encoder``): layers ``[0, fusion_layer)`` encode the
  text, layers ``[fusion_layer, L)`` self-attend over [text; image]
  (``BertModel``'s ``layer_range`` over one parameter set);
- ITA over the batch (identity targets, or in retrieval every pair
  sharing an ``idx``) on features scaled as JAX scales them
  (``models/mplug.jax_ord_neg1_normalize``: one scalar for the batch,
  not an L2 norm a row), ITM on hard negatives drawn as mPLUG draws them
  (``models/mplug.itm_loss``), MLM through text and fusion.

Dropout and the generator follow ``models/mplug.py``: a training forward
with a ``generator`` drops out the BERT's hidden states; the negatives
always draw from the generator.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from youku_mplug_tpu_torch.models.bert import (
    BertConfig,
    BertLayerNorm,
    BertLMHead,
    BertModel,
    lm_loss,
)
from youku_mplug_tpu_torch.models.mplug import (
    itm_loss,
    jax_ord_neg1_normalize,
    ones_mask,
)
from youku_mplug_tpu_torch.models.tasks import Dense
from youku_mplug_tpu_torch.models.vision import TimeSformer, VisionConfig
from youku_mplug_tpu_torch.ops.cross_entropy import cross_entropy_with_logits
from youku_mplug_tpu_torch.runtime.precision import DEFAULT_POLICY, Policy


@dataclasses.dataclass(frozen=True)
class ALPROConfig:
    vision: VisionConfig = VisionConfig()
    bert: BertConfig = BertConfig()
    embed_dim: int = 256
    temp: float = 0.07
    mlm_probability: float = 0.15
    num_classes: int = 0


def _ita(sim_i2t, sim_t2i, targets):
    return 0.5 * (-(torch.log_softmax(sim_i2t, -1) * targets).sum(-1).mean()
                  - (torch.log_softmax(sim_t2i, -1) * targets).sum(-1)
                  .mean())


class ALPRO(nn.Module):
    def __init__(self, cfg: ALPROConfig, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.cfg, self.policy = cfg, policy
        dt = policy.param_dtype
        w = cfg.bert.hidden_size
        self.visual_encoder = TimeSformer(cfg.vision, policy)
        self.text_encoder = BertModel(cfg.bert, dtype=dt)
        self.mlm_head = BertLMHead(cfg.bert, dtype=dt)
        self.large = w != cfg.vision.embed_dim
        if self.large:
            self.visn_fc = Dense(cfg.vision.embed_dim, w, dt)
            self.visn_layer_norm = BertLayerNorm(w, 1e-12, dt)
        self.vision_proj = Dense(w, cfg.embed_dim, dt)
        self.text_proj = Dense(w, cfg.embed_dim, dt)
        self.itm_head = Dense(w, 2, dt)
        if cfg.num_classes:
            self.cls_fc1 = Dense(w, w, dt)
            self.cls_fc2 = Dense(w, cfg.num_classes, dt)
        self.temp = nn.Parameter(torch.tensor(cfg.temp, dtype=dt),
                                 requires_grad=False)

    def _drop(self, generator):
        return generator if self.training else None

    def encode_image(self, video, generator=None):
        """[cls; the patch tokens averaged over frames] [B, 1 + N, w]."""
        t = video.shape[2]
        _, tokens = self.visual_encoder(video, self._drop(generator))
        cls_tok, patches = tokens[:, :1], tokens[:, 1:]
        b, tn, c = patches.shape
        patches = patches.reshape(b, t, tn // t, c).mean(dim=1)
        image_embeds = torch.cat([cls_tok, patches], dim=1)
        if self.large:
            image_embeds = self.visn_layer_norm(self.visn_fc(image_embeds))
        return image_embeds

    def encode_text(self, input_ids, attention_mask, generator=None):
        return self.text_encoder(input_ids, attention_mask,
                                 layer_range=(0, self.cfg.bert.fusion_layer),
                                 generator=self._drop(generator))

    def fuse(self, text_embeds, text_mask, image_embeds, image_mask,
             generator=None):
        """The upper layers over [text; image]."""
        bert = self.cfg.bert
        return self.text_encoder(
            encoder_embeds=torch.cat([text_embeds, image_embeds], 1),
            attention_mask=torch.cat([text_mask.long(), image_mask.long()],
                                     1),
            layer_range=(bert.fusion_layer, bert.num_hidden_layers),
            generator=self._drop(generator))

    def _features(self, video, input_ids, attention_mask, generator):
        image_embeds = self.encode_image(video, generator)
        image_feat = jax_ord_neg1_normalize(
            self.vision_proj(image_embeds[:, 0].float()))
        text_embeds = self.encode_text(input_ids, attention_mask, generator)
        text_feat = jax_ord_neg1_normalize(
            self.text_proj(text_embeds[:, 0].float()))
        return image_embeds, image_feat, text_embeds, text_feat

    def _itm(self, image_embeds, text_embeds, attention_mask, sim_t2i,
             sim_i2t, same, generator, neg_idx):
        def fuse_cls(*a):
            return self.fuse(*a, generator=generator)[:, 0]
        pos_cls = fuse_cls(text_embeds, attention_mask, image_embeds,
                           ones_mask(image_embeds))
        return itm_loss(self.itm_head, fuse_cls, image_embeds, text_embeds,
                        attention_mask, pos_cls, sim_t2i, sim_i2t, same,
                        generator, neg_idx)

    def pretrain_loss(self, video, input_ids, attention_mask, mlm_input_ids,
                      mlm_labels, generator=None, neg_idx=None):
        b = video.shape[0]
        temp = self.temp.clamp(0.001, 0.5)
        image_embeds, image_feat, text_embeds, text_feat = self._features(
            video, input_ids, attention_mask, generator)
        sim_i2t = image_feat @ text_feat.T / temp
        sim_t2i = text_feat @ image_feat.T / temp
        eye = torch.eye(b, device=video.device)
        loss_ita = _ita(sim_i2t, sim_t2i, eye)
        loss_itm, neg_img, neg_txt = self._itm(
            image_embeds, text_embeds, attention_mask, sim_t2i, sim_i2t,
            eye.bool(), generator, neg_idx)

        image_atts = ones_mask(image_embeds)
        mlm_text = self.encode_text(mlm_input_ids, attention_mask, generator)
        fused = self.fuse(mlm_text, attention_mask, image_embeds, image_atts,
                          generator)
        loss_mlm = lm_loss(self.mlm_head(fused[:, :input_ids.shape[1]]),
                           mlm_labels)
        return {"loss": loss_ita + loss_itm + loss_mlm, "loss_ita": loss_ita,
                "loss_itm": loss_itm, "loss_mlm": loss_mlm,
                "neg_img_idx": neg_img, "neg_txt_idx": neg_txt}

    def retrieval_loss(self, video, input_ids, attention_mask, idx,
                       generator=None, neg_idx=None):
        temp = self.temp.clamp(0.001, 0.5)
        image_embeds, image_feat, text_embeds, text_feat = self._features(
            video, input_ids, attention_mask, generator)
        same = idx.reshape(-1, 1) == idx.reshape(1, -1)
        pos = same.float()
        sim_i2t = image_feat @ text_feat.T / temp
        sim_t2i = text_feat @ image_feat.T / temp
        loss_ita = _ita(sim_i2t, sim_t2i, pos / pos.sum(1, keepdim=True))
        loss_itm, neg_img, neg_txt = self._itm(
            image_embeds, text_embeds, attention_mask, sim_t2i, sim_i2t,
            same, generator, neg_idx)
        return {"loss": loss_ita + loss_itm, "loss_ita": loss_ita,
                "loss_itm": loss_itm, "image_feat": image_feat,
                "text_feat": text_feat, "neg_img_idx": neg_img,
                "neg_txt_idx": neg_txt}

    def cls_forward(self, video, input_ids, attention_mask, labels=None,
                    generator=None):
        """Classification from the fused cls token."""
        image_embeds = self.encode_image(video, generator)
        image_atts = ones_mask(image_embeds)
        text_embeds = self.encode_text(input_ids, attention_mask, generator)
        fused = self.fuse(text_embeds, attention_mask, image_embeds,
                          image_atts, generator)
        logits = self.cls_fc2(torch.relu(self.cls_fc1(fused[:, 0].float())))
        out = {"logits": logits}
        if labels is not None:
            out["loss"] = cross_entropy_with_logits(logits, labels).mean()
        return out
