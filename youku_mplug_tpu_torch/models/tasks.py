"""The video-LM backbone: TimeSformer -> learnable queries -> AttentionPool
-> ``visual_fc`` -> GPT-3 decoder, with the pretrain loss.

Counterpart of ``youku_mplug_tpu/models/tasks.py`` (``MPLUGVideoConfig``,
``prefix_lm_targets``, ``MPLUGVideo.encode_video`` / ``encode_queries`` /
``pretrain_loss`` / ``caption_loss``, ``generate_captions``); the cls,
retrieval and ITM heads are not ported yet.  ``vision_proj`` and
``text_proj`` exist only under ``use_contrastive``, the one loss here
that calls them (the JAX package creates their parameters where a task
method calls them).
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
from youku_mplug_tpu_torch.ops.cross_entropy import cross_entropy_with_logits
from youku_mplug_tpu_torch.runtime.precision import DEFAULT_POLICY, Policy

# query and ignored label slots hold token id 100; the loss mask zeroes them
IGNORED_LABEL = 100


@dataclasses.dataclass(frozen=True)
class MPLUGVideoConfig:
    vision: VisionConfig = VisionConfig()
    text: GPT3Config = GPT3Config()
    num_learnable_token: int = 256
    use_contrastive: bool = False
    contrastive_embed_dim: int = 256
    temp: float = 0.07
    freeze_vit: bool = False
    freeze_text_decoder: bool = True
    label_smoothing: float = 0.1  # pretrain contrastive CE


def prefix_lm_targets(input_ids, attention_mask, n_query: int,
                      prompt_lengths=None, vocab_size=None):
    """Shifted labels and loss mask for the query-prefix LM loss: targets
    are input_ids shifted left with column 0 wrapping to the end; the
    query prefix's label slots hold ``min(100, V - 1)``; the loss mask is
    ``[0 x n_query ; attention_mask[:, 1:]]`` with the first
    ``prompt_lengths[i]`` text positions of sample i zeroed.  Returns
    (labels [B, n_query + S], loss_mask [B, n_query + S - 1])."""
    b, s = input_ids.shape
    targets = torch.cat([input_ids[:, 1:], input_ids[:, :1]], dim=1)
    fill = IGNORED_LABEL if vocab_size is None else min(IGNORED_LABEL,
                                                        vocab_size - 1)
    labels = torch.cat([torch.full((b, n_query), fill, dtype=input_ids.dtype,
                                   device=input_ids.device), targets], dim=1)
    text_loss = attention_mask[:, 1:].int()
    if prompt_lengths is not None:
        pos = torch.arange(s - 1, device=input_ids.device)[None, :]
        text_loss = text_loss * (pos >= prompt_lengths.to(
            input_ids.device)[:, None]).int()
    loss_mask = torch.cat([torch.zeros(b, n_query, dtype=torch.int32,
                                       device=input_ids.device),
                           text_loss], dim=1)
    return labels, loss_mask


def last_token_index(attention_mask):
    """Index of the final non-pad position."""
    return attention_mask.sum(-1).long() - 1


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


def _l2_normalize(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


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
        if cfg.use_contrastive:
            e = cfg.contrastive_embed_dim
            self.vision_proj = Dense(v.embed_dim, e, dt)
            self.text_proj = Dense(cfg.text.hidden_size, e, dt)
        # contrastive temperature (kept without the contrastive branch so a
        # JAX tree loads without leftovers)
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

    def _prefix_forward(self, query_features, input_ids, attention_mask,
                        prompt_lengths=None):
        """Caption-style prefix-LM forward: [queries ; tokens] through the
        decoder with the shifted labels and loss mask (prompt positions
        out of the loss when ``prompt_lengths`` is given)."""
        labels, loss_mask = prefix_lm_targets(
            input_ids, attention_mask, query_features.shape[1],
            prompt_lengths=prompt_lengths,
            vocab_size=self.cfg.text.vocab_size)
        tok_emb = self.text_decoder.embed(input_ids)
        input_embeds = torch.cat([query_features.to(tok_emb.dtype), tok_emb],
                                 dim=1)
        return self.text_decoder(input_embeds=input_embeds, labels=labels,
                                 loss_mask=loss_mask)

    def pretrain_loss(self, video, input_ids, attention_mask):
        """The caption LM loss over the query prefix, plus (under
        ``use_contrastive``) the per-query-max video-text contrastive loss
        against a text-only causal decoder pass.  Returns a dict of fp32
        scalars: loss, loss_caption, loss_contrastive."""
        _, query_features, image_query = self.encode_video(video)
        loss_caption = self._prefix_forward(query_features, input_ids,
                                            attention_mask)["loss"]
        loss_contrastive = torch.zeros((), dtype=torch.float32,
                                       device=loss_caption.device)
        if self.cfg.use_contrastive:
            hidden = self.text_decoder(tokens=input_ids)["last_hidden_state"]
            idx = last_token_index(attention_mask)
            pooled_text = hidden[torch.arange(hidden.shape[0],
                                              device=hidden.device), idx]
            vis = _l2_normalize(self.vision_proj(image_query.float()))
            txt = _l2_normalize(self.text_proj(pooled_text.float()))
            # per-query max similarity over the whole batch
            sim_i2t = torch.einsum("bqe,ce->bcq", vis, txt).amax(-1) \
                / self.temp
            sim_t2i = torch.einsum("ce,bqe->cbq", txt, vis).amax(-1) \
                / self.temp
            targets = torch.arange(vis.shape[0], device=vis.device)
            ls = self.cfg.label_smoothing
            loss_contrastive = 0.5 * (
                cross_entropy_with_logits(sim_i2t, targets, ls).mean()
                + cross_entropy_with_logits(sim_t2i, targets, ls).mean())
        return {"loss": loss_caption + loss_contrastive,
                "loss_caption": loss_caption,
                "loss_contrastive": loss_contrastive}

    def caption_loss(self, video, input_ids, attention_mask, prompt_lengths):
        """The captioning finetune loss: the prefix LM over the query
        features, the prompt's positions out of the loss.  Returns
        {"loss": fp32 scalar}."""
        query_features = self.encode_video(video)[1]
        out = self._prefix_forward(query_features, input_ids, attention_mask,
                                   prompt_lengths=prompt_lengths)
        return {"loss": out["loss"]}


def generate_captions(task_model: MPLUGVideo, video, input_ids,
                      attention_mask, gen_config, generator=None):
    """Video captioning decode: the clips' query features as the prefix of
    a batched greedy, sampled or beam-search decode
    (``models/generation.generate``) of the tokenized prompts, whose
    trailing eos is dropped (prompt length = mask sum - 1).  Returns
    ``generate``'s dict."""
    from youku_mplug_tpu_torch.models.generation import generate

    with torch.inference_mode():
        query_features = task_model.encode_queries(video)
        prompt_len = attention_mask.sum(-1).to(torch.int32) - 1
        return generate(task_model.text_decoder, input_ids, prompt_len,
                        query_embeds=query_features, config=gen_config,
                        generator=generator)
