"""The video-LM backbone: TimeSformer -> learnable queries -> AttentionPool
-> ``visual_fc`` -> GPT-3 decoder, with every task's loss and scores.

Counterpart of ``youku_mplug_tpu/models/tasks.py``: ``MPLUGVideoConfig``,
``prefix_lm_targets``, ``last_token_index``, and the ``MPLUGVideo``
methods ``encode_video`` / ``encode_queries``, ``pretrain_loss``,
``caption_loss``, the classification ``cls_logits_from_prompt`` /
``cls_train_loss`` / ``cls_eval_scores``, the dual-encoder retrieval
``extract_vision_feature`` / ``extract_text_feature`` /
``retrieval_loss``, the ITM rerank ``itm_train_loss`` /
``itm_eval_scores``, and the image pretrain variant ``image_pretrain_loss``
(a plain image ViT, ``image_encoder``, in place of the TimeSformer: the
reference's ViT-B/16 or EVA-ViT-g image pretraining);
``generate_captions``.  Under a (data, model) split (``mesh``, set by
``parallel/sharding.shard_params``) the same methods run on the model
shards: nothing here changes but the weights each module holds; in
training mode under a data split each loss is this rank's share of the
global batch's (``parallel/data_parallel.py``): the LM loss's masked
mean over the global token count, the cls / match head's cross-entropy
over the global rows, the contrastive loss's per-query max over the
global batch (``vis`` / ``txt`` gathered over the data ranks, the
targets global indices), the retrieval NCE over the global batch (each
rank's rows against every rank's features, the soft targets from the
gathered clip ids), and ITM's 3B pair rows cut into one contiguous block
a data rank, each pair's clip taken from the gathered query features
(a negative may be another rank's clip).  The dropout masks of the
towers are the (1,1) run's (``ops/attention.py``).

Towers: the JAX module declares both vision towers and flax creates the
parameters of the one a task method calls, so a video model's tree has
``visual_encoder`` and an image-pretrain tree ``image_encoder``.  The port
builds one: the TimeSformer by default, the plain ViT under
``MPLUGVideo(..., image=True)`` (an EVA-ViT-g image model holds no
40-block TimeSformer beside it).

Heads: ``cls_fc1`` / ``cls_fc2`` under ``use_cls`` (``cls_fc2`` with
``max(num_classes, 1)`` outputs, as in JAX); ``vision_proj`` and
``text_proj`` under ``use_contrastive`` or ``MPLUGVideo(...,
proj_heads=True)`` (the retrieval runner's dual encoder), the losses that
call them: the JAX package creates a head's parameters where a task
method calls it.

Dropout: the training losses take the step's ``generator`` and pass it
to the video tower and the decoder, which drop out in training mode
(``models/vision.py``, ``models/gpt3.py``); the JAX methods'
``deterministic=False``.  The evaluation methods, and the retrieval
towers (JAX ``extract_*`` run deterministic), pass none.

``connect_ln``: ``visual_norm``, an fp32 LayerNorm (eps 1e-6) over the
decoder width, normalizes ``visual_fc``'s output (JAX ``tasks.py:121-125``)
wherever the query features are made: the training losses and the
encode that serving and generation use.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from youku_mplug_tpu_torch.models.gpt3 import GPT3Config, GPT3LM
from youku_mplug_tpu_torch.models.vision import (
    AttentionPool,
    LayerNormFP32,
    TimeSformer,
    VisionConfig,
    VisionTransformer,
)
from youku_mplug_tpu_torch.ops.cross_entropy import cross_entropy_with_logits
from youku_mplug_tpu_torch.parallel.data_parallel import (
    data_group_of,
    gather_rows,
    share,
)
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
    use_cls: bool = False
    num_classes: int = 0
    connect_ln: bool = False  # visual_norm after visual_fc
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


def last_token_index(attention_mask, n_query: int = 0):
    """Index of the final non-pad position (+ the query prefix's length)."""
    return n_query + attention_mask.sum(-1).long() - 1


class Dense(nn.Module):
    """flax ``nn.Dense`` counterpart: kernel [in, out], a bias unless
    ``use_bias=False``; computes in the promoted dtype of input and
    kernel, as flax does."""

    def __init__(self, features_in: int, features_out: int, dtype,
                 use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.empty(features_in, features_out, dtype=dtype),
            requires_grad=False)
        self.bias = nn.Parameter(torch.empty(features_out, dtype=dtype),
                                 requires_grad=False) if use_bias else None

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.kernel.dtype)
        y = x.to(dt) @ self.kernel.to(dt)
        return y if self.bias is None else y + self.bias.to(dt)


def _l2_normalize(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


class MPLUGVideo(nn.Module):
    # the serving split (runtime/mesh.Mesh) once parallel/sharding.
    # shard_params has cut the weights: the vision tower and the decoder
    # then run on their model shards (their modules' ``tp``), and
    # encode_video / encode_queries and the decoder's serving entry
    # points give every model rank the unsharded outputs
    mesh = None

    def __init__(self, cfg: MPLUGVideoConfig,
                 policy: Policy = DEFAULT_POLICY, proj_heads: bool = False,
                 image: bool = False):
        super().__init__()
        self.cfg, self.policy = cfg, policy
        v, dt = cfg.vision, policy.param_dtype
        if image:  # the image pretrain path's tower (JAX tasks.py:128-133)
            self.image_encoder = VisionTransformer(v, policy)
        else:
            self.visual_encoder = TimeSformer(v, policy)
        self.learnable_queries = nn.Parameter(
            torch.empty(1, cfg.num_learnable_token, v.embed_dim, dtype=dt),
            requires_grad=False)
        self.attn_pool = AttentionPool(v.embed_dim, v.num_heads, v.mlp_ratio,
                                       gelu=v.gelu, dtype=dt)
        self.visual_fc = Dense(v.embed_dim, cfg.text.hidden_size, dt)
        if cfg.connect_ln:
            self.visual_norm = LayerNormFP32(cfg.text.hidden_size, 1e-6, dt)
        if cfg.use_contrastive or proj_heads:
            e = cfg.contrastive_embed_dim
            self.vision_proj = Dense(v.embed_dim, e, dt)
            self.text_proj = Dense(cfg.text.hidden_size, e, dt)
        if cfg.use_cls:
            h = cfg.text.hidden_size
            self.cls_fc1 = Dense(h, h, dt)
            self.cls_fc2 = Dense(h, max(cfg.num_classes, 1), dt)
        # contrastive temperature (kept without the contrastive branch so a
        # JAX tree loads without leftovers)
        self.temp = nn.Parameter(torch.empty((), dtype=torch.float32),
                                 requires_grad=False)
        self.text_decoder = GPT3LM(cfg.text, policy)

    def encode_video(self, video, generator=None):
        """video [B, C, T, H, W] -> (pooled_cls [B, D],
        query_features [B, Q, H_text], image_query [B, Q, D]);
        ``generator``: the video tower's dropout masks in training
        mode."""
        pooled, image_embeds = self.visual_encoder(video, generator)
        query_features, image_query = self._pool(image_embeds)
        return pooled, query_features, image_query

    def _pool(self, image_embeds):
        """Learnable queries -> AttentionPool over the tower's tokens ->
        ``visual_fc`` (-> ``visual_norm``): (query_features, image_query)."""
        b = image_embeds.shape[0]
        queries = self.learnable_queries.expand(
            b, -1, -1).to(image_embeds.dtype)
        image_query = self.attn_pool(queries, image_embeds)
        query_features = self.visual_fc(image_query)
        if self.cfg.connect_ln:
            query_features = self.visual_norm(query_features)
        return query_features, image_query

    def image_pretrain_loss(self, images, input_ids, attention_mask,
                            generator=None):
        """The image variant of the pretrain objective (JAX
        ``tasks.py:262-286``): images [B, C, H, W] through the plain ViT
        (``image_encoder``), the learnable queries pooled over its tokens,
        and the prefix LM loss over them.  Returns {"loss",
        "loss_caption"} (the same fp32 scalar)."""
        _, image_embeds = self.image_encoder(images, generator)
        query_features, _ = self._pool(image_embeds)
        loss = self._prefix_forward(query_features, input_ids,
                                    attention_mask,
                                    generator=generator)["loss"]
        return {"loss": loss, "loss_caption": loss}

    def encode_queries(self, video):
        """Just the query features (the serving prefix)."""
        return self.encode_video(video)[1]

    def _prefix_forward(self, query_features, input_ids, attention_mask,
                        prompt_lengths=None, need_loss=True, generator=None):
        """Caption-style prefix-LM forward: [queries ; tokens] through the
        decoder; with ``need_loss`` the shifted labels and loss mask too
        (prompt positions out of the loss when ``prompt_lengths`` is
        given), whose mask comes back as ``out["loss_mask"]``."""
        labels = loss_mask = None
        if need_loss:
            labels, loss_mask = prefix_lm_targets(
                input_ids, attention_mask, query_features.shape[1],
                prompt_lengths=prompt_lengths,
                vocab_size=self.cfg.text.vocab_size)
        tok_emb = self.text_decoder.embed(input_ids)
        input_embeds = torch.cat([query_features.to(tok_emb.dtype), tok_emb],
                                 dim=1)
        out = self.text_decoder(input_embeds=input_embeds, labels=labels,
                                loss_mask=loss_mask, generator=generator)
        out["loss_mask"] = loss_mask
        return out

    def _pooled(self, hidden, idx):
        return hidden[torch.arange(hidden.shape[0], device=hidden.device),
                      idx.to(hidden.device)]

    def cls_logits_from_prompt(self, query_features, prompt_ids, prompt_mask,
                               generator=None):
        """Classifier-head logits (fp32 [B, max(num_classes, 1)]) from the
        decoder's last hidden state at the final non-pad prompt position
        after the query prefix: relu(cls_fc1) -> cls_fc2."""
        out = self._prefix_forward(query_features, prompt_ids, prompt_mask,
                                   need_loss=False, generator=generator)
        pooled = self._pooled(out["last_hidden_state"], last_token_index(
            prompt_mask, n_query=query_features.shape[1]))
        return self.cls_fc2(torch.relu(self.cls_fc1(pooled.float())))

    def _generative_scores(self, out):
        """-sum of the per-position losses over the loss mask, per row
        (``losses[:, :-1]``, as the JAX package slices them)."""
        return -(out["losses"][:, :-1] * out["loss_mask"].float()).sum(-1)

    def pretrain_loss(self, video, input_ids, attention_mask, generator=None):
        """The caption LM loss over the query prefix, plus (under
        ``use_contrastive``) the per-query-max video-text contrastive loss
        against a text-only causal decoder pass.  Returns a dict of fp32
        scalars: loss, loss_caption, loss_contrastive."""
        _, query_features, image_query = self.encode_video(video, generator)
        loss_caption = self._prefix_forward(query_features, input_ids,
                                            attention_mask,
                                            generator=generator)["loss"]
        loss_contrastive = torch.zeros((), dtype=torch.float32,
                                       device=loss_caption.device)
        if self.cfg.use_contrastive:
            hidden = self.text_decoder(
                tokens=input_ids, generator=generator)["last_hidden_state"]
            pooled_text = self._pooled(hidden,
                                       last_token_index(attention_mask))
            vis = _l2_normalize(self.vision_proj(image_query.float()))
            txt = _l2_normalize(self.text_proj(pooled_text.float()))
            # per-query max similarity over the whole (global) batch
            dp = data_group_of(self)
            b = vis.shape[0]
            sim_i2t = torch.einsum("bqe,ce->bcq", vis,
                                   gather_rows(txt, dp)).amax(-1) / self.temp
            sim_t2i = torch.einsum("ce,bqe->cbq", txt,
                                   gather_rows(vis, dp)).amax(-1) / self.temp
            targets = torch.arange(b, device=vis.device) + (
                0 if dp is None else dp.index * b)
            ls = self.cfg.label_smoothing
            loss_contrastive = 0.5 * (
                share(cross_entropy_with_logits(sim_i2t, targets, ls), dp)
                + share(cross_entropy_with_logits(sim_t2i, targets, ls),
                        dp))
        return {"loss": loss_caption + loss_contrastive,
                "loss_caption": loss_caption,
                "loss_contrastive": loss_contrastive}

    def caption_loss(self, video, input_ids, attention_mask, prompt_lengths,
                     generator=None):
        """The captioning finetune loss: the prefix LM over the query
        features, the prompt's positions out of the loss.  Returns
        {"loss": fp32 scalar}."""
        query_features = self.encode_video(video, generator)[1]
        out = self._prefix_forward(query_features, input_ids, attention_mask,
                                   prompt_lengths=prompt_lengths,
                                   generator=generator)
        return {"loss": out["loss"]}

    def cls_train_loss(self, video, input_ids, attention_mask,
                       prompt_lengths, prompt_ids=None, prompt_mask=None,
                       labels=None, generator=None):
        """Classification finetune: the prefix-LM loss of each (title
        prompt, class name) pair, plus (``use_cls`` with ``labels``) the
        cross-entropy of the classifier head on the title prompt alone.
        Returns fp32 scalars loss, loss_caption, loss_cls."""
        query_features = self.encode_video(video, generator)[1]
        loss_caption = self._prefix_forward(
            query_features, input_ids, attention_mask,
            prompt_lengths=prompt_lengths, generator=generator)["loss"]
        loss_cls = torch.zeros((), dtype=torch.float32,
                               device=loss_caption.device)
        if self.cfg.use_cls and labels is not None:
            logits = self.cls_logits_from_prompt(
                query_features, prompt_ids, prompt_mask, generator)
            loss_cls = share(cross_entropy_with_logits(logits,
                                                       labels.long()),
                             data_group_of(self))
        return {"loss": loss_caption + loss_cls,
                "loss_caption": loss_caption, "loss_cls": loss_cls}

    def cls_eval_scores(self, video, input_ids, attention_mask,
                        prompt_lengths, prompt_ids=None, prompt_mask=None,
                        num_cls: int = 1):
        """Each clip against every class name: ``input_ids`` [B * num_cls,
        S] pairs clip-major.  Returns ``generation_logits``, the softmax
        over the classes of each pair's sequence log-likelihood [B,
        num_cls], and ``cls_logits``, the classifier head's on the title
        prompts (None without ``use_cls`` or prompts)."""
        query_features = self.encode_video(video)[1]
        b = query_features.shape[0]
        out = self._prefix_forward(
            query_features.repeat_interleave(num_cls, dim=0), input_ids,
            attention_mask, prompt_lengths=prompt_lengths)
        gen = torch.softmax(self._generative_scores(out).reshape(b, num_cls),
                            dim=-1)
        cls_logits = None
        if self.cfg.use_cls and prompt_ids is not None:
            cls_logits = self.cls_logits_from_prompt(query_features,
                                                     prompt_ids, prompt_mask)
        return {"generation_logits": gen, "cls_logits": cls_logits}

    def extract_vision_feature(self, video):
        """The video tower's pooled cls (not the abstractor's output, as in
        the reference's dual encoder) -> vision_proj -> L2 normalized,
        fp32 [B, E]."""
        pooled = self.visual_encoder(video)[0]
        return _l2_normalize(self.vision_proj(pooled.float()))

    def extract_text_feature(self, input_ids, attention_mask):
        """The text-only decoder's last hidden state at the final non-pad
        token -> text_proj -> L2 normalized, fp32 [B, E]."""
        hidden = self.text_decoder(tokens=input_ids)["last_hidden_state"]
        pooled = self._pooled(hidden, last_token_index(attention_mask))
        return _l2_normalize(self.text_proj(pooled.float()))

    def retrieval_loss(self, video, input_ids, attention_mask, idx):
        """In-batch NCE of the dual encoder with soft targets: every pair
        that shares a clip id ``idx`` counts as a positive, weighted
        evenly.  Under a data split the batch is the global one: this
        rank's clips against every rank's texts and its texts against
        every rank's clips, positives from every rank's ids.  Returns
        {"loss": fp32 scalar}."""
        dp = data_group_of(self)
        vis = self.extract_vision_feature(video)
        txt = self.extract_text_feature(input_ids, attention_mask)
        sim_i2t = vis @ gather_rows(txt, dp).t() / self.temp
        sim_t2i = txt @ gather_rows(vis, dp).t() / self.temp
        pos = (idx[:, None] == gather_rows(idx, dp)[None, :]).float()
        targets = pos / pos.sum(1, keepdim=True)
        loss_i2t = -(torch.log_softmax(sim_i2t, 1) * targets).sum(1)
        loss_t2i = -(torch.log_softmax(sim_t2i, 1) * targets).sum(1)
        return {"loss": 0.5 * (share(loss_i2t, dp) + share(loss_t2i, dp))}

    def itm_train_loss(self, video, input_ids, attention_mask,
                       prompt_lengths, negative_indices, prompt_ids=None,
                       prompt_mask=None, labels=None, generator=None):
        """ITM rerank finetune: the batch's 3B pair rows are the B
        positives and then the 2B pairs of ``negative_indices`` (two
        derangements of the batch), whose query features are the clips
        they index.  The prefix-LM loss of the (prompt, yes / no) pairs,
        plus (``use_cls`` with ``labels``) the match head's
        cross-entropy.  Under a data split ``video`` is this rank's block
        of the B clips, ``negative_indices`` the global batch's, and
        ``input_ids`` (and the prompts and labels) this rank's contiguous
        block of the 3B pair rows, whose clips come from every rank's
        query features.  Returns fp32 scalars loss, loss_caption,
        loss_cls."""
        dp = data_group_of(self)
        query_features = gather_rows(
            self.encode_video(video, generator)[1], dp)
        rows = input_ids.shape[0]
        pairs = torch.cat([torch.arange(query_features.shape[0],
                                        device=negative_indices.device),
                           negative_indices.long()])
        lo = 0 if dp is None else dp.index * rows
        qf = query_features[pairs[lo:lo + rows].to(query_features.device)]
        loss_caption = self._prefix_forward(
            qf, input_ids, attention_mask, prompt_lengths=prompt_lengths,
            generator=generator)["loss"]
        loss_cls = torch.zeros((), dtype=torch.float32,
                               device=loss_caption.device)
        if self.cfg.use_cls and labels is not None:
            logits = self.cls_logits_from_prompt(qf, prompt_ids, prompt_mask,
                                                 generator)
            loss_cls = share(cross_entropy_with_logits(logits,
                                                       labels.long()), dp)
        return {"loss": loss_caption + loss_cls,
                "loss_caption": loss_caption, "loss_cls": loss_cls}

    def itm_eval_scores(self, video, input_ids, attention_mask,
                        prompt_lengths, prompt_ids=None, prompt_mask=None,
                        num_text: int = 1):
        """A [V, T] block: each of V clips against T texts, ``input_ids``
        [V * T, S] clip-major.  Returns ``generation_logits`` [V, T]
        (each pair's sequence log-likelihood) and ``cls_logits`` [V, T],
        the match head's P(match) = softmax(logits)[:, 1] (None without
        ``use_cls`` or prompts; the head needs two outputs)."""
        query_features = self.encode_video(video)[1]
        v = query_features.shape[0]
        qf = query_features.repeat_interleave(num_text, dim=0)
        out = self._prefix_forward(qf, input_ids, attention_mask,
                                   prompt_lengths=prompt_lengths)
        gen = self._generative_scores(out).reshape(v, num_text)
        cls_scores = None
        if self.cfg.use_cls and prompt_ids is not None:
            logits = self.cls_logits_from_prompt(qf, prompt_ids, prompt_mask)
            cls_scores = torch.softmax(logits, dim=-1)[:, 1].reshape(
                v, num_text)
        return {"generation_logits": gen, "cls_logits": cls_scores}


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
