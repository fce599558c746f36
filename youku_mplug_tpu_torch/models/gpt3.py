"""GPT-3 decoder: the full-sequence training forward, and prefill and
decode over the stacked cache for serving.

Counterpart of ``youku_mplug_tpu/models/gpt3.py``.
Parameters keep the JAX names and shapes — fused ``qkv_kernel
[H, 3, n, d]``, ``out_kernel [n, d, H]`` — and the JAX package's scanned
layer stack stays a leading ``[L]`` dimension on every layer parameter;
the layers run as a Python loop that indexes it.

Numerics: fp32 layernorms, fp32 attention softmax, tanh-GELU, fp32 logits
from the tied embedding.  Training runs the whole sequence through
causal attention (padded text positions stay keys; only the loss mask
drops them), each layer under ``torch.utils.checkpoint`` when
``remat``; which attention follows the JAX package's dispatch (JAX
``gpt3.py:245-247``, :281-284): the packed flash kernel where
``packed_supported(n, d)`` holds (the 1.3B decoder's 32 heads of 64),
else ``dot_product_attention`` on head views (the 2.7B decoder's 32 heads
of 80: the head-major flash kernel at S >= 128, ``mha_reference``
below).  Dropout, as the JAX package applies it with
``deterministic=False``: given a ``generator`` to the training forward of
a module in training mode, the embeddings (after the position add) and
the attention and MLP outputs take ``hidden_dropout`` and the attention
probabilities ``attention_dropout``, the latter on the plain path
(``mha_reference``), as the JAX package leaves its flash kernels under
attention dropout; a checkpointed layer replays its masks from the
generator state it started with.  Without a generator, or in eval mode,
nothing is drawn.  Under a split (the decoder's ``mesh``) each mask is
drawn at the global batch's shape and this rank keeps its block: its data
rank's rows, and for the attention probabilities its model shard's heads
(``ops/attention.block_of``), so every rank draws what the (1,1) run
draws, replays included.  The cache is ``[L, B, M, 2*hidden]`` with rows
[K | V] taken straight from the qkv projection's output (``qkv[..., n*d:]``);
the new rows are written in place before attention reads them.

LoRA (``lora_rank > 0``, a top-level ``lora_rank`` in a YAML): each of
``lora_targets`` among ``qkv``, ``out``, ``fc1`` and ``fc2`` gains
``lora_<name>_a [L, in, r]`` and ``lora_<name>_b [L, r, out]`` (fp32
leaves that train inside the frozen bf16 decoder; ``b`` starts at zero)
and adds ``(x @ a) @ b * alpha / r`` to its product after the int8
scale and, for ``qkv``, after the bias (JAX ``gpt3.py:159-176``), before
it elsewhere, in the training forward, prefill and the decode step
alike.  ``ops/lora.merge_lora`` folds them into the kernels for serving.

int8 serving (``ops/quant.py``, ``ops/kv_cache.py``): a decoder quantized
by ``quant.quantize_decoder_`` multiplies each product's output channels
by its kernel's scales before the bias, and the int8 tied embedding
dequantizes the rows it looks up and scales the logits per vocab row.
With ``kv_cache_dtype: int8`` the cache is the int8 dict: prefill reads
the written layer back dequantized (the prompt's own keys too, as in the
JAX package), decode reads it in place through the int8 decode kernel.

Tensor parallelism (``parallel/sharding.shard_params`` with the GPT-3
rules): each model rank holds n/m heads (the attention reads its head
count from ``qkv_kernel``), F/m MLP columns and V/m vocab rows; the
attention output and fc2 products are summed over the model ranks
(``parallel/tensor_parallel.py``) before their biases, the embedding
lookup and the tied logits go through the vocab-parallel lookup and
gather, and the cache holds the rank's own heads.  In training the
inputs of the column-parallel products (qkv, fc1) pass through
``copy_to_model`` (Megatron's *f*), so the gradient that reaches the
layer's input, and the frozen decoder's dgrad down to the query
features, is the sum over the model ranks; the flash kernels run their
forward and backward on the local heads; the LM loss is the
vocab-parallel CE over the rank's table rows (``TiedEmbedding.loss``).
Under a data split (``mesh``, set by ``shard_params``) the training
loss is this rank's share of the global batch's masked mean
(``parallel/data_parallel.py``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from youku_mplug_tpu_torch.ops import kv_cache as kvc
from youku_mplug_tpu_torch.ops.attention import (
    NEG_INF,
    Dropout,
    block_of,
    dot_product_attention,
    dropout,
    mha_reference,
)
from youku_mplug_tpu_torch.ops.cross_entropy import (
    lm_cross_entropy,
    masked_mean_loss,
)
from youku_mplug_tpu_torch.ops.decode_attention import (
    write_decode_attention,
)
from youku_mplug_tpu_torch.ops.flash_attention import (
    flash_attention_packed,
    packed_supported,
)
from youku_mplug_tpu_torch.ops.layernorm import layer_norm
from youku_mplug_tpu_torch.ops.lora import LoRAModule, plus
from youku_mplug_tpu_torch.ops.quant import dequantize, qscale
from youku_mplug_tpu_torch.parallel.data_parallel import data_group_of
from youku_mplug_tpu_torch.parallel.tensor_parallel import (
    copy_to_model,
    gather_vocab_logits,
    reduce_from_model,
    vocab_parallel_embedding,
)
from youku_mplug_tpu_torch.runtime.precision import DEFAULT_POLICY, Policy

KV_CACHE_DTYPES = ("auto", "int8")
LORA_TARGETS = ("qkv", "out", "fc1", "fc2")


@dataclasses.dataclass(frozen=True)
class GPT3Config:
    """Decoder hyperparameters; JSON layout of configs/models/
    config_gpt3_*.json (the fields the serving and training paths
    read)."""

    vocab_size: int = 25600
    hidden_size: int = 768
    ffn_hidden_size: Optional[int] = None
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 2048
    layernorm_epsilon: float = 1e-12
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    init_method_std: float = 0.02
    tokens_to_generate: int = 100  # new tokens a caption decode makes
    remat: bool = False  # checkpoint each layer in training
    ce_chunk: int = 0    # sequence chunk of the LM loss (0: dense)
    # "auto": the compute dtype; "int8": per-(token, head) quantized
    kv_cache_dtype: str = "auto"
    # rank-r adapters on the projections (0: none)
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_targets: tuple = LORA_TARGETS

    def __post_init__(self):
        check_lora_targets(self)
        if self.kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(f"kv_cache_dtype {self.kv_cache_dtype!r} not in "
                             f"{KV_CACHE_DTYPES}")

    @property
    def ffn_dim(self) -> int:
        return self.ffn_hidden_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        assert self.hidden_size % self.num_attention_heads == 0
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_json_file(cls, path: str, **overrides) -> "GPT3Config":
        with open(path) as f:
            raw = json.load(f)
        mapped = dict(
            vocab_size=raw.get("vocab_size", 25600),
            hidden_size=raw.get("hidden_size", 768),
            ffn_hidden_size=raw.get("ffn_hidden_size"),
            num_hidden_layers=raw.get("num_hidden_layers", 12),
            num_attention_heads=raw.get("num_attention_heads", 12),
            max_position_embeddings=raw.get("max_position_embeddings", 2048),
            layernorm_epsilon=raw.get("layernorm_epsilon", 1e-12),
            hidden_dropout=raw.get("hidden_dropout_prob", 0.1),
            attention_dropout=raw.get("attention_probs_dropout_prob", 0.1),
            init_method_std=raw.get("initializer_range", 0.02),
        )
        mapped.update(overrides)
        return cls(**mapped)


def check_lora_targets(cfg):
    """A YAML list becomes the tuple the JAX config holds; a target the
    decoder does not have raises."""
    object.__setattr__(cfg, "lora_targets", tuple(cfg.lora_targets))
    unknown = set(cfg.lora_targets) - set(LORA_TARGETS)
    if unknown:
        raise ValueError(f"unknown LoRA targets {sorted(unknown)}; the "
                         f"decoder projections are {LORA_TARGETS}")


def _param(*shape, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=dtype), requires_grad=False)


def add_lora(mod: LoRAModule, cfg, num_layers: int, dtype, shapes):
    """The [L]-stacked adapters of ``cfg.lora_targets`` among ``shapes``
    (name -> (in, out)) on a decoder module, at ``cfg``'s rank and
    alpha, ``lora_*_a`` drawn at ``init_method_std``."""
    mod.add_lora(cfg.lora_rank, cfg.lora_alpha, cfg.init_method_std, dtype,
                 {k: v for k, v in shapes.items() if k in cfg.lora_targets},
                 num_layers)


CacheLen = Union[int, torch.Tensor]


def qscaled(y: torch.Tensor, mod: nn.Module, name: str,
            lidx: Optional[int] = None) -> torch.Tensor:
    """``y`` (a product with ``mod.<name>``) times that kernel's
    per-output-channel int8 scales (layer ``lidx`` of a stack) in y's
    dtype; ``y`` itself for a float kernel."""
    s = qscale(mod, name)
    if s is None:
        return y
    return y * (s if lidx is None else s[lidx]).reshape(-1).to(y.dtype)


class GPT3Attention(LoRAModule):
    """Self-attention with a fused QKV projection and the stacked cache.
    Parameters carry a leading [L] layer dimension.  On a model shard
    (``tp``, set by ``parallel/sharding.shard_params``) it holds n/m of
    the heads: the head count is read from ``qkv_kernel``, the kernels
    run on the local heads, the output projection's partial products are
    summed over the model ranks and ``out_bias`` is added once, after."""

    TP_PARAM = "out_kernel"  # the row-parallel product that is summed
    tp = None

    def __init__(self, cfg: GPT3Config, num_layers: int, dtype):
        super().__init__()
        n, d, h = cfg.num_attention_heads, cfg.head_dim, cfg.hidden_size
        self.d, self.h = d, h
        self.qkv_kernel = _param(num_layers, h, 3, n, d, dtype=dtype)
        self.qkv_bias = _param(num_layers, 3, n, d, dtype=dtype)
        self.out_kernel = _param(num_layers, n, d, h, dtype=dtype)
        self.out_bias = _param(num_layers, h, dtype=dtype)
        add_lora(self, cfg, num_layers, dtype,
                 {"qkv": (h, 3 * n * d), "out": (n * d, h)})

    @property
    def n(self) -> int:
        """The heads this module holds (n / m on a model shard)."""
        return self.qkv_kernel.shape[-2]

    def forward(self, x, lidx: int, cache: Optional[kvc.Cache] = None,
                cache_len: CacheLen = 0,
                valid_from: Optional[torch.Tensor] = None,
                drop: Optional[Dropout] = None):
        """x [B, S, H] -> [B, S, H].  Without a cache: causal attention over
        the whole sequence, by the JAX package's rule: without attention
        dropout and where ``packed_supported(n, d)`` holds, q/k/v packed
        slices of the qkv projection into the packed flash kernel (K1);
        otherwise head views into ``dot_product_attention``, which runs
        the head-major flash kernel (K4) at S >= 128 without dropout and
        ``mha_reference`` (with the attention dropout of ``drop``) else.
        With one: writes this chunk's K|V rows into
        layer ``lidx`` of ``cache`` at ``cache_len`` (int, or [B] per-sample
        positions), then attends to keys ``valid_from <= j <= position``;
        S == 1 writes the row and reads the cache in place in one launch
        of the decode kernel, a longer chunk (prefill) runs plain attention
        over the layer view."""
        n, d, h = self.n, self.d, self.h
        nd = n * d
        b, s, _ = x.shape
        dt = x.dtype
        x = copy_to_model(x, self.tp)
        qkv = x @ self.qkv_kernel[lidx].reshape(h, 3 * nd).to(dt)
        qkv = qscaled(qkv, self, "qkv_kernel", lidx)
        qkv = qkv + self.qkv_bias[lidx].reshape(3 * nd).to(dt)
        qkv = plus(qkv, self.delta("qkv", x, lidx))
        rate = drop.attention if drop is not None else 0.0
        if cache is None and rate == 0.0 and packed_supported(n, d):
            out = flash_attention_packed(qkv[..., :nd], qkv[..., nd:2 * nd],
                                         qkv[..., 2 * nd:], n, causal=True)
        elif cache is None:
            q, k, v = (qkv[..., i * nd:(i + 1) * nd].unflatten(
                -1, (n, d)).transpose(1, 2) for i in range(3))
            out = dot_product_attention(
                q, k, v, causal=True, dropout_rate=rate,
                generator=drop.generator if rate > 0 else None,
                dropout_blocks=drop.rows + block_of(1, self.tp)
                if rate > 0 else ())
            out = out.transpose(1, 2).reshape(b, s, nd)
        else:
            out = self._cache_attention(qkv, lidx, cache, cache_len,
                                        valid_from)
        y = out @ self.out_kernel[lidx].reshape(nd, h).to(dt)
        y = qscaled(y, self, "out_kernel", lidx)
        y = plus(y, self.delta("out", out, lidx))
        return reduce_from_model(y, self.tp) + self.out_bias[lidx].to(dt)

    def _cache_attention(self, qkv, lidx, cache, cache_len, valid_from):
        n, d = self.n, self.d
        nd = n * d
        b, s, _ = qkv.shape
        if s == 1:  # the decode kernel writes the row and attends
            return write_decode_attention(
                qkv[:, 0, :nd], qkv[:, 0, nd:2 * nd], qkv[:, 0, 2 * nd:],
                cache, n, lidx, cache_len, valid_from)[:, None]
        kvc.cache_write(cache, qkv[..., nd:], cache_len, lidx)  # [K | V]
        # [B, M, 2nd]: a view, or the int8 layer dequantized
        ckv = kvc.layer_dequant(kvc.layer_slice(cache, lidx), n, qkv.dtype)
        m = ckv.shape[1]
        q = qkv[..., :nd].unflatten(-1, (n, d)).transpose(1, 2)
        ck = ckv[..., :nd].unflatten(-1, (n, d)).transpose(1, 2)
        cv = ckv[..., nd:].unflatten(-1, (n, d)).transpose(1, 2)
        ki = torch.arange(m, device=qkv.device)
        steps = torch.arange(s, device=qkv.device)
        if isinstance(cache_len, int):
            qi = (cache_len + steps)[None, :, None]              # [1, S, 1]
        else:
            qi = (cache_len.to(qkv.device)[:, None, None]
                  + steps[None, :, None])
        allowed = ki[None, None, :] <= qi                        # [B|1, S, M]
        if valid_from is not None:
            allowed = allowed & (ki[None, None, :]
                                 >= valid_from[:, None, None])
        bias = torch.zeros(allowed.shape, dtype=torch.float32,
                           device=qkv.device).masked_fill(~allowed, NEG_INF)
        out = mha_reference(q, ck, cv, bias=bias[:, None])
        return out.transpose(1, 2).reshape(b, s, nd)


class GPT3MLP(LoRAModule):
    """fc1 -> tanh-GELU -> fc2; on a model shard fc1's columns and fc2's
    rows are this rank's, fc2's partial product is summed over the model
    ranks and ``fc2_bias`` added once, after."""

    TP_PARAM = "fc2_kernel"
    tp = None

    def __init__(self, cfg: GPT3Config, num_layers: int, dtype):
        super().__init__()
        h, f = cfg.hidden_size, cfg.ffn_dim
        self.fc1_kernel = _param(num_layers, h, f, dtype=dtype)
        self.fc1_bias = _param(num_layers, f, dtype=dtype)
        self.fc2_kernel = _param(num_layers, f, h, dtype=dtype)
        self.fc2_bias = _param(num_layers, h, dtype=dtype)
        add_lora(self, cfg, num_layers, dtype, {"fc1": (h, f), "fc2": (f, h)})

    def forward(self, x, lidx: int):
        dt = x.dtype
        x = copy_to_model(x, self.tp)
        y = qscaled(x @ self.fc1_kernel[lidx].to(dt), self, "fc1_kernel", lidx)
        y = plus(y, self.delta("fc1", x, lidx))
        # fused bias + tanh-approx gelu (megatron bias_gelu contract)
        y = F.gelu(y + self.fc1_bias[lidx].to(dt), approximate="tanh")
        out = qscaled(y @ self.fc2_kernel[lidx].to(dt), self, "fc2_kernel",
                      lidx)
        out = plus(out, self.delta("fc2", y, lidx))
        return reduce_from_model(out, self.tp) + self.fc2_bias[lidx].to(dt)


class GPT3Layer(nn.Module):
    """Pre-LN decoder layer; ``forward(x, lidx, ...)`` runs layer lidx of
    the stack."""

    def __init__(self, cfg: GPT3Config, num_layers: int, dtype):
        super().__init__()
        h = cfg.hidden_size
        self.eps = cfg.layernorm_epsilon
        self.ln1_scale = _param(num_layers, h, dtype=dtype)
        self.ln1_bias = _param(num_layers, h, dtype=dtype)
        self.ln2_scale = _param(num_layers, h, dtype=dtype)
        self.ln2_bias = _param(num_layers, h, dtype=dtype)
        self.attn = GPT3Attention(cfg, num_layers, dtype)
        self.mlp = GPT3MLP(cfg, num_layers, dtype)

    def forward(self, x, lidx: int, cache=None, cache_len=0, valid_from=None,
                drop: Optional[Dropout] = None):
        a = layer_norm(x, self.ln1_scale[lidx], self.ln1_bias[lidx],
                       eps=self.eps)
        a = self.attn(a, lidx, cache, cache_len, valid_from, drop)
        if drop is not None:
            a = dropout(a, drop.hidden, drop.generator, drop.rows)
        x = x + a
        m = layer_norm(x, self.ln2_scale[lidx], self.ln2_bias[lidx],
                       eps=self.eps)
        m = self.mlp(m, lidx)
        if drop is not None:
            m = dropout(m, drop.hidden, drop.generator, drop.rows)
        return x + m

    def replay(self, x, lidx: int, drop: Dropout, state: torch.Tensor):
        """Layer ``lidx`` with its generator first set to ``state``: run
        under ``torch.utils.checkpoint``, the recompute draws the masks
        the forward drew (at the global shape, as the forward did)."""
        drop.generator.set_state(state)
        return self(x, lidx, drop=drop)


class GPT3Decoder(nn.Module):
    """Position embedding + the layer stack + final layernorm."""

    mesh = None  # the run's mesh (parallel/sharding.shard_params)

    def __init__(self, cfg: GPT3Config, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        dt = policy.param_dtype
        self.cfg = cfg
        self.position_embeddings = _param(cfg.max_position_embeddings,
                                          cfg.hidden_size, dtype=dt)
        self.layers = GPT3Layer(cfg, cfg.num_hidden_layers, dt)
        self.ln_f_scale = _param(cfg.hidden_size, dtype=dt)
        self.ln_f_bias = _param(cfg.hidden_size, dtype=dt)

    def forward(self, input_embeds, positions, *, cache=None, cache_len=0,
                valid_from=None, generator: Optional[torch.Generator] = None):
        """[B, S, H] embeddings at ``positions`` -> final hidden states.
        ``generator``: dropout's masks in a training forward (no cache,
        training mode); ignored otherwise."""
        cfg = self.cfg
        drop = None
        if (generator is not None and cache is None and self.training
                and (cfg.hidden_dropout > 0 or cfg.attention_dropout > 0)):
            drop = Dropout(generator, cfg.hidden_dropout,
                           cfg.attention_dropout,
                           block_of(0, data_group_of(self)))
        x = input_embeds + F.embedding(positions, self.position_embeddings
                                       ).to(input_embeds.dtype)
        if drop is not None:
            x = dropout(x, drop.hidden, drop.generator, drop.rows)
        remat = cache is None and cfg.remat and torch.is_grad_enabled()
        for lidx in range(cfg.num_hidden_layers):
            if remat and drop is not None:
                x = checkpoint(self.layers.replay, x, lidx, drop,
                               generator.get_state(), use_reentrant=False)
            elif remat:
                x = checkpoint(self.layers, x, lidx, use_reentrant=False)
            else:
                x = self.layers(x, lidx, cache, cache_len, valid_from, drop)
        return layer_norm(x, self.ln_f_scale, self.ln_f_bias,
                          eps=self.cfg.layernorm_epsilon)


_VOCAB_CHUNK = 32768  # rows of an int8 table converted at once (256 MB)


class TiedEmbedding(nn.Module):
    """Token embedding [V, H] with the tied logits head.  An int8 table
    (``quant.quantize_decoder_(..., include_embedding=True)``) carries
    per-vocab-row scales [V, 1]: lookups dequantize the gathered rows,
    the logits are the product with the int8 values times the row's
    scale.  On a model shard (``tp``) the table holds this rank's
    contiguous V/m rows (and their scales): lookups go through
    ``vocab_parallel_embedding`` and the logits through
    ``gather_vocab_logits``, so every rank gets the unsharded values."""

    TP_PARAM = "embedding"
    tp = None

    def __init__(self, num_embeddings: int, features: int, dtype):
        super().__init__()
        self.embedding = _param(num_embeddings, features, dtype=dtype)

    def encode(self, tokens, dtype):
        def lookup(ids):
            rows = F.embedding(ids, self.embedding)
            s = qscale(self, "embedding")
            if s is not None:
                rows = rows.float() * F.embedding(ids, s)
            return rows.to(dtype)
        return vocab_parallel_embedding(tokens, self.embedding.shape[0],
                                        lookup, self.tp)

    def attend(self, hidden):
        """fp32 logits of a product with fp32 accumulation, as the JAX
        package computes them.  bf16 hidden states on the card take one
        bf16 x bf16 product with an fp32 output (no fp32 copy of the
        [V, H] table per call: 4 GB at Bloom's 250880 x 4096), an int8
        table converted to bf16 a vocab chunk at a time (no 2 GB bf16 copy
        held); elsewhere the fp32 product of the same values, which equals
        it because bf16 products are exact in fp32."""
        s = qscale(self, "embedding")
        h2 = hidden.reshape(-1, hidden.shape[-1])
        if hidden.is_cuda and hidden.dtype == torch.bfloat16:
            if s is None:
                y = torch.mm(h2, self.embedding.to(h2.dtype).t(),
                             out_dtype=torch.float32)
            else:
                y = torch.empty(h2.shape[0], self.embedding.shape[0],
                                dtype=torch.float32, device=hidden.device)
                for i in range(0, y.shape[1], _VOCAB_CHUNK):
                    chunk = self.embedding[i:i + _VOCAB_CHUNK].to(h2.dtype)
                    y[:, i:i + _VOCAB_CHUNK] = torch.mm(
                        h2, chunk.t(), out_dtype=torch.float32)
        else:
            y = h2.float() @ self.embedding.to(hidden.dtype).float().t()
        if s is not None:
            y = y * s.reshape(-1)
        y = gather_vocab_logits(y, self.tp)
        return y.reshape(*hidden.shape[:-1], y.shape[-1])

    def table(self, dtype):
        """The [V, H] table in ``dtype`` (dequantized if int8); on a model
        shard, where the table is this rank's rows, ``loss`` is the
        entry."""
        if self.tp is not None and self.tp.size > 1:
            raise ValueError("the [V, H] table of a vocab-parallel shard: "
                             "take the LM loss through loss()")
        return self._rows(dtype)

    def _rows(self, dtype):
        s = qscale(self, "embedding")
        if s is not None:
            return dequantize(self.embedding, s, dtype)
        return self.embedding.to(dtype)

    def loss(self, hidden, labels, chunk: int = 0):
        """fp32 per-position LM losses [B, S] of the tied logits of
        ``hidden`` [B, S, H] against ``labels`` (already shifted), in
        sequence chunks of ``chunk``; on a model shard the vocab-parallel
        CE over this rank's rows (``ops/cross_entropy.py``)."""
        return lm_cross_entropy(hidden, self._rows(hidden.dtype), labels,
                                chunk=chunk, tp=self.tp)


def _init_cache(cfg, policy: Policy, batch: int, max_len: int, device,
                num_heads: Optional[int] = None):
    """The stacked cache of ``num_heads`` heads (default the config's;
    a model shard's own n/m)."""
    max_len = -(-max_len // 128) * 128
    n = num_heads or cfg.num_attention_heads
    return kvc.make_cache(cfg.num_hidden_layers, batch, max_len,
                          n * (cfg.hidden_size // cfg.num_attention_heads),
                          policy.compute_dtype, device=device, num_heads=n,
                          quantized=cfg.kv_cache_dtype == "int8")


class GPT3LM(nn.Module):
    """Tied-embedding LM over the decoder: the training forward with the
    masked-mean LM loss, and the serving entry points."""

    mesh = None  # the run's mesh (parallel/sharding.shard_params)

    def __init__(self, cfg: GPT3Config, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.cfg, self.policy = cfg, policy
        self.word_embeddings = TiedEmbedding(cfg.vocab_size, cfg.hidden_size,
                                             policy.param_dtype)
        self.decoder = GPT3Decoder(cfg, policy)

    def embed(self, tokens):
        return self.word_embeddings.encode(tokens, self.policy.compute_dtype)

    def logits(self, hidden):
        return self.word_embeddings.attend(hidden)

    def forward(self, tokens=None, input_embeds=None, labels=None,
                loss_mask=None, positions=None,
                generator: Optional[torch.Generator] = None):
        """Full-sequence causal forward.  Returns ``last_hidden_state``;
        with ``labels`` (already shifted) the fp32 per-position
        ``losses`` [B, S]; with a ``loss_mask`` too, ``loss``: the masked
        mean over ``losses[:, :-1]`` (the last position is dropped).
        ``generator``: the dropout masks, in training mode."""
        if input_embeds is None:
            input_embeds = self.embed(tokens)
        else:
            input_embeds = input_embeds.to(self.policy.compute_dtype)
        b, s, _ = input_embeds.shape
        if positions is None:
            positions = torch.arange(s, device=input_embeds.device
                                     )[None].expand(b, s)
        hidden = self.decoder(input_embeds, positions, generator=generator)
        out = {"last_hidden_state": hidden}
        if labels is not None:
            losses = self.word_embeddings.loss(hidden, labels,
                                               chunk=self.cfg.ce_chunk)
            out["losses"] = losses
            if loss_mask is not None:
                out["loss"] = masked_mean_loss(losses[:, :-1], loss_mask,
                                               data_group_of(self))
        return out

    def init_cache(self, batch: int, max_len: int, device=None):
        """Stacked cache [L, B, M, 2*hidden] (the int8 dict with
        ``kv_cache_dtype: int8``), M rounded up to a multiple of 128 as in
        the JAX package (the extra rows are never attended); on a model
        shard [L, B, M, 2*(n/m)*d], its local heads' rows."""
        return _init_cache(self.cfg, self.policy, batch, max_len, device,
                           self.decoder.layers.attn.n)

    def decode_step(self, input_embeds, cache, cache_len: CacheLen,
                    valid_from=None, position_offset=None,
                    return_all: bool = False):
        """Run a chunk (prefill or a verify chunk: S > 1; decode: S = 1)
        through the decoder, updating ``cache`` in place.  Returns (fp32
        vocab logits of the last position [B, V], or with ``return_all``
        of every position [B, S, V] (speculative verification), cache).

        cache_len: int (every sample writes at the same position) or [B]
        per-sample write positions; valid_from [B]: first valid cache
        position per sample; position_offset [B]: subtracted from the
        absolute positions (clamped at 0) so each sample's first real
        token gets position 0."""
        b, s, _ = input_embeds.shape
        dev = input_embeds.device
        steps = torch.arange(s, device=dev)
        if isinstance(cache_len, int):
            positions = (cache_len + steps)[None].expand(b, s)
        else:
            positions = cache_len.to(dev).long()[:, None] + steps[None]
        if position_offset is not None:
            positions = (positions - position_offset.to(dev)[:, None]
                         ).clamp_min(0)
        hidden = self.decoder(input_embeds.to(self.policy.compute_dtype),
                              positions, cache=cache, cache_len=cache_len,
                              valid_from=valid_from)
        return self.logits(hidden if return_all else hidden[:, -1]), cache
