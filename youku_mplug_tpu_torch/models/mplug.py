"""mPLUG, the BERT-fusion video-language family: TimeSformer, BERT text
encoder, skip-connected fusion, BERT prefix decoder; ITC with momentum
distillation and MoCo queues, ITM with in-batch hard negatives, MLM.

Counterpart of ``youku_mplug_tpu/models/mplug.py`` (``MPLUGConfig``,
``MomentumState``, ``init_momentum_state``, ``update_momentum``,
``mlm_mask_tokens``, ``MPLUG`` and its methods, ``mplug_generate``,
``mplug_beam_search``), with the JAX parameter names.

The momentum state is explicit, as in JAX: ``MomentumState`` holds the
EMA twin (a copy of the model, in evaluation mode, no gradients), both
feature queues [E, Q], the id queue [1, Q] and the write pointer.  A
train step computes ``momentum_features`` with the twin, steps the
model, then ``update_momentum``: every twin parameter becomes ``e * m +
p * (1 - m)`` and the twin's features of the batch are written into the
queues at the pointer.  The write is ``lax.dynamic_update_slice``'s:
where ``ptr + B > Q`` its start is clamped to ``Q - B`` (it does not
wrap), while the pointer still becomes ``(ptr + B) % Q``.

The random draws come from an explicit ``torch.Generator`` (JAX's bits
cannot be reproduced; the tests hold the laws):

- ``mlm_mask_tokens``: BERT's 80/10/10 rule over the positions with
  ``attention_mask == 1`` that are not ``[PAD]``, ``[CLS]`` or ``[SEP]``;
- the ITM hard negatives: one Gumbel-max draw a row over the in-batch
  similarities with -1e9 on the positive (pretrain: the diagonal;
  retrieval: every pair sharing an ``idx``), i.e. ``jax.random.
  categorical``'s law.  The two uniform [B, B] draws are taken even where
  a caller passes ``neg_idx`` (the indices to use instead), so the draws
  after them, the dropout masks, are the same either way.

A training forward (``model.train()`` and a ``generator``) drops out the
BERT's hidden states (and the vision tower's, as its config says) with
masks from the same generator; in evaluation mode nothing drops, and the
generator feeds the negatives alone.  The temperature is clipped to
[0.001, 0.5]; the L2 norms have no epsilon, as in JAX, and
``retrieval_loss`` scales its features as JAX's does
(``jax_ord_neg1_normalize``).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from youku_mplug_tpu_torch.models.bert import (
    BertConfig,
    BertLayerNorm,
    BertLMHead,
    BertModel,
    BertPrefixModel,
    FusionModel,
    lm_loss,
)
from youku_mplug_tpu_torch.models.tasks import Dense, _l2_normalize
from youku_mplug_tpu_torch.models.vision import TimeSformer, VisionConfig
from youku_mplug_tpu_torch.ops.cross_entropy import cross_entropy_with_logits
from youku_mplug_tpu_torch.runtime.precision import DEFAULT_POLICY, Policy

NEG_MASK = -1e9  # the positive pairs' logit in the hard-negative draw


@dataclasses.dataclass(frozen=True)
class MPLUGConfig:
    vision: VisionConfig = VisionConfig()
    bert: BertConfig = BertConfig()
    embed_dim: int = 256
    temp: float = 0.07
    queue_size: int = 65536
    momentum: float = 0.995
    mlm_probability: float = 0.15
    distill: bool = True
    num_classes: int = 0


@dataclasses.dataclass
class MomentumState:
    ema: nn.Module             # the EMA twin
    image_queue: torch.Tensor  # [E, Q]
    text_queue: torch.Tensor   # [E, Q]
    idx_queue: torch.Tensor    # [1, Q] int32 (retrieval)
    ptr: int = 0

    @property
    def ema_params(self) -> Dict[str, torch.Tensor]:
        """JAX path -> the twin's parameter."""
        from youku_mplug_tpu_torch.bridge import jax_path

        return {jax_path(n): p for n, p in self.ema.named_parameters()}


def init_momentum_state(model: nn.Module, embed_dim: int, queue_size: int,
                        generator: Optional[torch.Generator] = None
                        ) -> MomentumState:
    """The twin as a copy of ``model``; queue columns drawn normal from
    ``generator`` (default: seeded 0 on the model's device, as JAX draws
    them from ``key(0)``) and L2-normalized; ids -100; pointer 0."""
    ema = copy.deepcopy(model).eval()
    for p in ema.parameters():
        p.requires_grad_(False)
        p.grad = None
    device = next(model.parameters()).device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    queues = []
    for _ in range(2):
        q = torch.randn(embed_dim, queue_size, generator=generator,
                        device=device)
        queues.append(q / torch.linalg.vector_norm(q, dim=0, keepdim=True))
    return MomentumState(
        ema=ema, image_queue=queues[0], text_queue=queues[1],
        idx_queue=torch.full((1, queue_size), -100, dtype=torch.int32,
                             device=device))


@torch.no_grad()
def update_momentum(state: MomentumState, model: nn.Module,
                    image_feat_m: torch.Tensor, text_feat_m: torch.Tensor,
                    idx: Optional[torch.Tensor] = None,
                    momentum: float = 0.995) -> MomentumState:
    """The EMA over every parameter, then the queue write (see the module
    docstring); in place.  Returns ``state``."""
    ema = [p for _, p in state.ema.named_parameters()]
    params = [p.detach() for _, p in model.named_parameters()]
    torch._foreach_mul_(ema, momentum)
    torch._foreach_add_(ema, torch._foreach_mul(params, 1.0 - momentum))
    b, q = image_feat_m.shape[0], state.image_queue.shape[1]
    start = min(max(state.ptr, 0), q - b)  # dynamic_update_slice's clamp
    state.image_queue[:, start:start + b] = image_feat_m.T.float()
    state.text_queue[:, start:start + b] = text_feat_m.T.float()
    if idx is not None:
        state.idx_queue[:, start:start + b] = idx.reshape(1, -1).to(
            state.idx_queue.dtype)
    state.ptr = (state.ptr + b) % q
    return state


def mlm_mask_tokens(input_ids: torch.Tensor, attention_mask: torch.Tensor,
                    vocab_size: int, generator: torch.Generator,
                    mlm_probability: float = 0.15, mask_token_id: int = 103,
                    special_ids=(0, 101, 102)):
    """BERT 80/10/10 masking: each attended, non-special position is
    picked with ``mlm_probability``; a pick becomes ``mask_token_id``
    (80%), a uniform id in [0, V) (10%) or stays (10%).  Returns (ids,
    labels: the original id where picked, else -100)."""
    device = input_ids.device
    special = torch.zeros_like(input_ids, dtype=torch.bool)
    for sid in special_ids:
        special |= input_ids == sid
    prob = torch.rand(input_ids.shape, generator=generator, device=device)
    decision = torch.rand(input_ids.shape, generator=generator,
                          device=device)
    rand_tok = torch.randint(0, vocab_size, input_ids.shape,
                             generator=generator, device=device,
                             dtype=input_ids.dtype)
    masked = (prob < mlm_probability) & ~special & (attention_mask == 1)
    labels = torch.where(masked, input_ids, torch.full_like(input_ids, -100))
    out = torch.where(masked & (decision < 0.8),
                      torch.full_like(input_ids, mask_token_id), input_ids)
    out = torch.where(masked & (decision >= 0.8) & (decision < 0.9),
                      rand_tok, out)
    return out, labels


def jax_ord_neg1_normalize(x):
    """``x / jnp.linalg.norm(x, -1, keepdims=True)`` as JAX's retrieval
    and ALPRO losses write it: there -1 is ``ord``, not the axis, so a
    [B, E] batch of features is divided by one scalar, its matrix norm of
    order -1 (the least column sum of magnitudes), not row by row.  Kept
    for parity (ROADMAP Queue 3)."""
    return x / x.abs().sum(0).min()


def draw_negatives(sim_t2i: torch.Tensor, sim_i2t: torch.Tensor,
                   same: torch.Tensor, generator: Optional[torch.Generator],
                   neg_idx=None):
    """(negative image of each text, negative text of each image): a
    Gumbel-max draw per row of the [B, B] in-batch similarities with
    NEG_MASK where ``same``; ``neg_idx`` replaces the draws (which are
    taken all the same)."""
    if generator is None:
        raise ValueError("the hard-negative draw needs a torch.Generator")
    mask = torch.where(same, NEG_MASK, 0.0)
    picks = []
    for sim in (sim_t2i, sim_i2t):
        u = torch.rand(sim.shape, generator=generator, device=sim.device)
        gumbel = -torch.log(-torch.log(u))
        picks.append(torch.argmax(sim.detach().float() + mask + gumbel,
                                  dim=1))
    if neg_idx is not None:
        picks = [t.to(sim_t2i.device) for t in neg_idx]
    return picks


def ones_mask(states: torch.Tensor) -> torch.Tensor:
    """An all-ones int64 mask [B, S] of states [B, S, D]."""
    return torch.ones(states.shape[:2], dtype=torch.long,
                      device=states.device)


def itm_loss(itm_head, fuse_cls, image_embeds, text_embeds, attention_mask,
             pos_cls, sim_t2i, sim_i2t, same, generator, neg_idx=None):
    """ITM over B positives (their fused cls ``pos_cls``) and 2B hard
    negatives (``draw_negatives`` from the in-batch similarities): a text
    with another clip, a clip with another text, each fused by
    ``fuse_cls(text, text_mask, image, image_mask)``.  Returns (mean CE of
    the 2-way head against 1, 0, 0, the two negative index vectors)."""
    b = image_embeds.shape[0]
    image_atts = ones_mask(image_embeds)
    neg_img, neg_txt = draw_negatives(sim_t2i[:, :b], sim_i2t[:, :b], same,
                                      generator, neg_idx)
    neg_cls = fuse_cls(
        torch.cat([text_embeds, text_embeds[neg_txt]], 0),
        torch.cat([attention_mask, attention_mask[neg_txt]], 0),
        torch.cat([image_embeds[neg_img], image_embeds], 0),
        torch.cat([image_atts, image_atts], 0))
    itm_logits = itm_head(torch.cat([pos_cls, neg_cls], 0).float())
    itm_labels = torch.cat([torch.ones(b, dtype=torch.long),
                            torch.zeros(2 * b, dtype=torch.long)]).to(
        itm_logits.device)
    loss = cross_entropy_with_logits(itm_logits, itm_labels).mean()
    return loss, neg_img, neg_txt


def _itc_loss(sim_i2t, sim_t2i, sim_i2t_m, sim_t2i_m, targets, alpha):
    i2t = alpha * torch.softmax(sim_i2t_m, -1) + (1 - alpha) * targets
    t2i = alpha * torch.softmax(sim_t2i_m, -1) + (1 - alpha) * targets
    loss_i2t = -(torch.log_softmax(sim_i2t, -1) * i2t).sum(-1)
    loss_t2i = -(torch.log_softmax(sim_t2i, -1) * t2i).sum(-1)
    return 0.5 * (loss_i2t.mean() + loss_t2i.mean())


class MPLUG(nn.Module):
    """The shared mPLUG backbone with its pretrain, cls, caption and
    retrieval methods."""

    def __init__(self, cfg: MPLUGConfig, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.cfg, self.policy = cfg, policy
        dt = policy.param_dtype
        bert = cfg.bert
        w = bert.hidden_size
        self.visual_encoder = TimeSformer(cfg.vision, policy)
        # the cross-attentions read image states w wide (visn_fc makes a
        # narrower tower's so), whatever the JSON's encoder_width
        self.text_encoder = BertModel(
            dataclasses.replace(bert, num_hidden_layers=bert.
                                text_encoder_layers), w, dt)
        self.fusion_encoder = FusionModel(bert, w, dt)
        self.mlm_head = BertLMHead(bert, dtype=dt)
        self.text_decoder = BertPrefixModel(bert, w, dt)
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

    # ------------------------------------------------------------------

    def encode_image(self, video, generator=None):
        _, image_embeds = self.visual_encoder(video, self._drop(generator))
        if self.large:
            image_embeds = self.visn_layer_norm(self.visn_fc(image_embeds))
        return image_embeds

    def encode_text(self, input_ids, attention_mask, generator=None):
        return self.text_encoder(input_ids, attention_mask,
                                 generator=self._drop(generator))

    def fuse(self, text, text_mask, image, image_mask, generator=None):
        return self.fusion_encoder(text, text_mask, image, image_mask,
                                   self._drop(generator))

    def _features(self, video, input_ids, attention_mask, generator=None,
                  norm=_l2_normalize):
        image_embeds = self.encode_image(video, generator)
        image_feat = norm(self.vision_proj(image_embeds[:, 0].float()))
        text_embeds = self.encode_text(input_ids, attention_mask, generator)
        text_feat = norm(self.text_proj(text_embeds[:, 0].float()))
        return image_embeds, image_feat, text_embeds, text_feat

    def momentum_features(self, video, input_ids, attention_mask):
        """The features a train step takes from the EMA twin (call it on
        the twin), deterministic."""
        image_embeds, image_feat, _, text_feat = self._features(
            video, input_ids, attention_mask)
        return {"image_feat": image_feat, "text_feat": text_feat,
                "image_embeds": image_embeds}

    def _itm(self, image_embeds, text_embeds, attention_mask, txt_pos,
             sim_t2i, sim_i2t, same, generator, neg_idx):
        return itm_loss(
            self.itm_head,
            lambda *a: self.fuse(*a, generator=generator)[1][:, 0],
            image_embeds, text_embeds, attention_mask, txt_pos[:, 0],
            sim_t2i, sim_i2t, same, generator, neg_idx)

    def _contrast(self, image_feat, text_feat, feats_m, image_queue,
                  text_queue):
        temp = self.temp.clamp(0.001, 0.5)
        if feats_m is None:
            feats_m = {"image_feat": image_feat, "text_feat": text_feat}
        text_all, image_all = feats_m["text_feat"].T, feats_m["image_feat"].T
        if image_queue is not None:
            text_all = torch.cat([text_all, text_queue], 1)
            image_all = torch.cat([image_all, image_queue], 1)
        return (image_feat @ text_all / temp, text_feat @ image_all / temp,
                feats_m["image_feat"] @ text_all / temp,
                feats_m["text_feat"] @ image_all / temp)

    # ------------------------------------------------------------------

    def pretrain_loss(self, video, input_ids, attention_mask, mlm_input_ids,
                      mlm_labels, feats_m=None, image_queue=None,
                      text_queue=None, alpha=0.0, generator=None,
                      neg_idx=None):
        """ITC against the queues (targets distilled from the twin's
        similarities by ``alpha``), ITM on the hard negatives, MLM through
        the fusion network.  Returns the three losses, their sum, the
        features and the negatives drawn."""
        b = video.shape[0]
        image_embeds, image_feat, text_embeds, text_feat = self._features(
            video, input_ids, attention_mask, generator)
        sims = self._contrast(image_feat, text_feat, feats_m, image_queue,
                              text_queue)
        targets = torch.eye(b, sims[0].shape[1], device=video.device)
        loss_ita = _itc_loss(*sims, targets, alpha)

        image_atts = ones_mask(image_embeds)
        _, txt_pos = self.fuse(text_embeds, attention_mask, image_embeds,
                               image_atts, generator)
        eye = torch.eye(b, dtype=torch.bool, device=video.device)
        loss_itm, neg_img, neg_txt = self._itm(
            image_embeds, text_embeds, attention_mask, txt_pos, sims[1],
            sims[0], eye, generator, neg_idx)

        mlm_text = self.encode_text(mlm_input_ids, attention_mask, generator)
        _, mlm_fused = self.fuse(mlm_text, attention_mask, image_embeds,
                                 image_atts, generator)
        loss_mlm = lm_loss(self.mlm_head(mlm_fused), mlm_labels)
        return {"loss": loss_ita + loss_itm + loss_mlm, "loss_ita": loss_ita,
                "loss_itm": loss_itm, "loss_mlm": loss_mlm,
                "image_feat": image_feat, "text_feat": text_feat,
                "neg_img_idx": neg_img, "neg_txt_idx": neg_txt}

    def cls_forward(self, video, input_ids, attention_mask, labels=None,
                    generator=None):
        image_embeds = self.encode_image(video, generator)
        image_atts = ones_mask(image_embeds)
        text_embeds = self.encode_text(input_ids, attention_mask, generator)
        _, fused = self.fuse(text_embeds, attention_mask, image_embeds,
                             image_atts, generator)
        logits = self.cls_fc2(torch.relu(self.cls_fc1(fused[:, 0].float())))
        out = {"logits": logits}
        if labels is not None:
            out["loss"] = cross_entropy_with_logits(logits, labels).mean()
        return out

    def encode_for_decoder(self, video, input_ids=None, attention_mask=None,
                           generator=None):
        """The decoder's cross-attention states and mask: the image
        tokens, or with text the fused [image; text] streams."""
        image_embeds = self.encode_image(video, generator)
        image_atts = ones_mask(image_embeds)
        if input_ids is None:
            return image_embeds, image_atts
        text_embeds = self.encode_text(input_ids, attention_mask, generator)
        img_f, txt_f = self.fuse(text_embeds, attention_mask, image_embeds,
                                 image_atts, generator)
        return (torch.cat([img_f, txt_f], 1),
                torch.cat([image_atts, attention_mask.long()], 1))

    def caption_loss(self, video, caption_ids, caption_mask, pad_id=0,
                     input_ids=None, attention_mask=None, generator=None):
        enc, enc_mask = self.encode_for_decoder(video, input_ids,
                                                attention_mask, generator)
        labels = torch.where(caption_ids == pad_id,
                             torch.full_like(caption_ids, -100), caption_ids)
        out = self.text_decoder(caption_ids, caption_mask,
                                encoder_hidden_states=enc,
                                encoder_attention_mask=enc_mask,
                                labels=labels,
                                generator=self._drop(generator))
        return {"loss": out["loss"]}

    def retrieval_loss(self, video, input_ids, attention_mask, idx,
                       feats_m=None, image_queue=None, text_queue=None,
                       idx_queue=None, alpha=0.0, generator=None,
                       neg_idx=None):
        """ITC with every pair sharing an ``idx`` a positive (against the
        queues when given) and ITM on hard negatives of another
        ``idx``.  The features are scaled as JAX scales them there
        (``jax_ord_neg1_normalize``)."""
        image_embeds, image_feat, text_embeds, text_feat = self._features(
            video, input_ids, attention_mask, generator,
            jax_ord_neg1_normalize)
        sims = self._contrast(image_feat, text_feat, feats_m, image_queue,
                              text_queue)
        idx_all = idx.reshape(1, -1)
        if image_queue is not None:
            idx_all = torch.cat([idx_all, idx_queue.to(idx.dtype)], 1)
        pos = (idx.reshape(-1, 1) == idx_all).float()
        loss_ita = _itc_loss(*sims, pos / pos.sum(1, keepdim=True), alpha)

        image_atts = ones_mask(image_embeds)
        _, txt_pos = self.fuse(text_embeds, attention_mask, image_embeds,
                               image_atts, generator)
        same = idx.reshape(-1, 1) == idx.reshape(1, -1)
        loss_itm, neg_img, neg_txt = self._itm(
            image_embeds, text_embeds, attention_mask, txt_pos, sims[1],
            sims[0], same, generator, neg_idx)
        return {"loss": loss_ita + loss_itm, "loss_ita": loss_ita,
                "loss_itm": loss_itm, "image_feat": image_feat,
                "text_feat": text_feat, "neg_img_idx": neg_img,
                "neg_txt_idx": neg_txt}

    def itm_rerank_score(self, video, input_ids, attention_mask):
        """P(match) from the ITM head."""
        image_embeds = self.encode_image(video)
        image_atts = ones_mask(image_embeds)
        text_embeds = self.encode_text(input_ids, attention_mask)
        _, fused = self.fuse(text_embeds, attention_mask, image_embeds,
                             image_atts)
        return torch.softmax(self.itm_head(fused[:, 0].float()), -1)[:, 1]


# ---------------------------------------------------------------------------
# generation


def _next_logits(model: MPLUG, ids, t: int, enc, enc_mask):
    """fp32 logits at position t - 1 of the fixed-length decoder pass over
    ``ids`` [N, L] with keys ``< t`` visible (the LM head applied at that
    position alone: the others' logits are never read)."""
    n, length = ids.shape
    mask = (torch.arange(length, device=ids.device)[None, :] < t).long()
    dec = model.text_decoder
    x = dec.bert(ids, mask.expand(n, length), is_decoder=True,
                 encoder_hidden_states=enc, encoder_attention_mask=enc_mask)
    return dec.cls(x[:, t - 1]).float()


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k``: the k largest of the last axis, ties to the lower
    index."""
    values, index = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


@torch.no_grad()
def mplug_generate(model: MPLUG, video, bos_id: int, eos_id: int,
                   max_new_tokens: int = 30, input_ids=None,
                   attention_mask=None, beam_size: int = 1,
                   min_length: int = 0, alpha: float = 0.6) -> torch.Tensor:
    """Captions from the BERT prefix decoder, greedy or beam (reference
    TextGenerator semantics: the Wu length penalty ((5 + len) / 6) **
    alpha, EOS suppressed before ``min_length``).  Each step re-runs the
    fixed-length decoder over ``max_new_tokens + 1`` positions, as JAX
    does.  Returns token ids [B, max_new_tokens]."""
    enc, enc_mask = model.encode_for_decoder(video, input_ids,
                                             attention_mask)
    if beam_size > 1:
        return mplug_beam_search(model, enc, enc_mask, bos_id=bos_id,
                                 eos_id=eos_id, max_new_tokens=max_new_tokens,
                                 beam_size=beam_size, min_length=min_length,
                                 alpha=alpha)
    b, max_len = video.shape[0], max_new_tokens + 1
    ids = torch.full((b, max_len), eos_id, dtype=torch.long,
                     device=video.device)
    ids[:, 0] = bos_id
    done = torch.zeros(b, dtype=torch.bool, device=video.device)
    for t in range(1, max_len):
        nxt = torch.argmax(_next_logits(model, ids, t, enc, enc_mask), -1)
        nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
        ids[:, t] = nxt
        done |= nxt == eos_id
    return ids[:, 1:]


@torch.no_grad()
def mplug_beam_search(model: MPLUG, enc, enc_mask, *, bos_id: int,
                      eos_id: int, max_new_tokens: int, beam_size: int,
                      min_length: int = 0, alpha: float = 0.6
                      ) -> torch.Tensor:
    """Beam search over the BERT prefix decoder with JAX's (and the
    reference's ONMT-style) semantics: alive beams carry raw log-prob
    sums; candidates rank by score / wu(len); an EOS candidate enters the
    finished pool at its penalized score; EOS is suppressed while the
    step is below ``min_length``; at the end the open beams join the pool
    at score / wu(max_new_tokens).  Returns the best hypothesis's ids
    [B, max_new_tokens]."""
    neg_inf = torch.finfo(torch.float32).min
    b, k = enc.shape[0], beam_size
    max_len = max_new_tokens + 1
    enc_t = enc.repeat_interleave(k, 0)
    mask_t = enc_mask.repeat_interleave(k, 0)

    def logp_at(ids, t):
        logits = _next_logits(model, ids.reshape(b * k, max_len), t, enc_t,
                              mask_t)
        return torch.log_softmax(logits, -1).reshape(b, k, -1)

    def wu(step):
        return ((5.0 + step) / 6.0) ** alpha

    def gather_rows(x, index):  # x [b, n, ...], index [b, m]
        shape = index.shape + x.shape[2:]
        return torch.gather(x, 1, index.reshape(
            *index.shape, *([1] * (x.dim() - 2))).expand(shape))

    ids = torch.full((b, k, max_len), eos_id, dtype=torch.long,
                     device=enc.device)
    ids[:, :, 0] = bos_id
    logp = logp_at(ids, 1)[:, 0]
    v = logp.shape[-1]
    if min_length > 0:
        logp[:, eos_id] = -1e20
    top_scores, top_tokens = _top_k(logp, k)
    ids[:, :, 1] = top_tokens
    is_eos0 = top_tokens == eos_id
    alive_score = torch.where(is_eos0, neg_inf, top_scores)
    fin_seq = torch.where(is_eos0[..., None], ids, torch.zeros_like(ids))
    fin_score = torch.where(is_eos0, top_scores / wu(1), neg_inf)
    for t in range(2, max_len):
        logp = logp_at(ids, t)
        if t - 1 < min_length:
            logp[:, :, eos_id] = -1e20
        curr = ((alive_score[:, :, None] + logp) / wu(t)).reshape(b, k * v)
        top2k, idx2k = _top_k(curr, 2 * k)
        beam_idx, tok_idx = idx2k // v, idx2k % v
        is_eos = tok_idx == eos_id
        seq2k = gather_rows(ids, beam_idx)
        seq2k[:, :, t] = tok_idx
        all_fin_score = torch.cat(
            [fin_score, torch.where(is_eos, top2k, neg_inf)], 1)
        fin_score, keep_idx = _top_k(all_fin_score, k)
        fin_seq = gather_rows(torch.cat([fin_seq, seq2k], 1), keep_idx)
        new_curr, pick = _top_k(torch.where(is_eos, neg_inf, top2k), k)
        ids = gather_rows(ids, torch.gather(beam_idx, 1, pick))
        ids[:, :, t] = torch.gather(tok_idx, 1, pick)
        alive_score = torch.where(new_curr <= neg_inf / 2, neg_inf,
                                  new_curr * wu(t))
    open_score = torch.where(alive_score <= neg_inf / 2, neg_inf,
                             alive_score / wu(max_new_tokens))
    _, best = _top_k(torch.cat([fin_score, open_score], 1), 1)
    out = gather_rows(torch.cat([fin_seq, ids], 1), best)[:, 0]
    return out[:, 1:]
