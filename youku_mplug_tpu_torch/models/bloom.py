"""Bloom decoder (the BloomZ-7B LM of mPLUG-Owl video instruct): the
full-sequence training forward, and prefill and decode over the stacked
packed cache for serving.

Counterpart of ``youku_mplug_tpu/models/bloom.py``.
Parameters keep the JAX names and shapes, so loading a JAX tree is a
rename (``bridge.py``): the fused QKV is HEAD-MAJOR, ``qkv_kernel
[H, n, 3, d]`` (rows of the fused output are [q | k | v] per head), the
scanned layer stack is a leading ``[L]`` dimension on every layer
parameter, and the layers run as a Python loop that indexes it.

The architecture the port keeps: no position embeddings — ALiBi adds
``slope_h * j`` (absolute key position j, which front padding leaves
correct by softmax shift-invariance) to every score; a LayerNorm on the
input embeddings (``skip_emb_ln`` skips it); pre-LN blocks whose residual
is the block input unless ``apply_residual_post_ln``; tanh GELU; fp32
layernorms, softmax and logits from the tied embedding.

Training (no cache): causal attention over the whole sequence through
the flash kernels with ALiBi, q/k/v handed as [B, S, n, d] head views of
the fused projection (no copy); ``BloomLM.forward`` returns the tied-
embedding LM losses and their masked mean, the loss over sequence
chunks of ``ce_chunk`` rows when set.  Dropout, as the JAX package
applies it with ``deterministic=False``: given a ``generator`` in
training mode, the embeddings after their LayerNorm and the attention
and MLP outputs take ``hidden_dropout``, and the attention probabilities
``attention_dropout`` on the plain path (``mha_reference`` with the ALiBi
bias: JAX's rule leaves the flash kernel under attention dropout); under a
split each mask at the global batch's shape, this rank keeping its data
rank's rows and its model shard's heads (``models/gpt3.py``).
``remat`` checkpoints every layer in training (JAX
``bloom.py:442-452``): ``remat_policy`` "nothing" recomputes the whole
layer, attention included; "names" and "narrow" keep the attention's
output and log-sum-exp (its forward kernel runs once a layer) and
recompute the segments around it — "names" keeps the GELU output of the
MLP too, "narrow" recomputes the MLP whole.  A recomputed segment
replays its dropout masks from the generator state it started with.

LoRA (``lora_rank > 0``): each target projection (``qkv``, ``out``,
``fc1``, ``fc2``) gains ``lora_<name>_a [L, in, r]`` and ``lora_<name>_b
[L, r, out]`` and adds ``(x @ a) @ b * alpha / r`` to its output, before
its bias (the qkv delta lands on the flat head-major lanes before the
reshape), in training and serving alike.

Cache: ``[L, B, M, 2*n*d]`` rows [K | V] repacked from the head-major
projection.  A decode step (S = 1) reads it in place through the ALiBi
decode kernel, handed q as a [B, n, d] head-strided view of the fused
row; a longer chunk (prefill) runs plain attention over the layer view
with the ALiBi bias plus the ``valid_from``/causal mask as an additive
fp32 minimum.

int8 serving, as in ``models/gpt3.py``: a quantized decoder scales each
product's output channels (the qkv scales on the head-major lanes) before
its LoRA delta and bias; with ``kv_cache_dtype: int8`` prefill reads the
written layer back dequantized and decode runs the int8 ALiBi decode
kernel.

Tensor parallelism (``parallel/sharding.shard_params`` with JAX's
``BLOOM_SHARDING_RULES``), Megatron's layout as in ``models/gpt3.py``:
each model rank holds a contiguous n/m of the heads (the head-major qkv
kernel cut on its head dim, the head count read from it), F/m MLP
columns and V/m vocab rows.  The qkv and fc1 inputs pass through
``copy_to_model`` (*f*), the attention output and fc2 products are summed
over the model ranks (*g*) before ``out_bias`` and ``fc2_bias``, and the
cache holds the rank's own heads.  The ALiBi slopes are the rank's slice
of the whole ladder of ``num_attention_heads``: the flash kernels read
that slice of the fp32 array, the prefill's bias and the dropout route
take it, and the decode kernel builds each slope from its head offset
and the total (``ops/decode_attention.py``).  The LM loss is the
vocab-parallel CE over the rank's table rows (``TiedEmbedding.loss``),
and under a data split (``mesh``) the training loss is this rank's share
of the global batch's masked mean (``parallel/data_parallel.py``).  The
LayerNorms stay whole on every rank.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from youku_mplug_tpu_torch.models.gpt3 import (
    KV_CACHE_DTYPES,
    LORA_TARGETS,
    CacheLen,
    Dropout,
    TiedEmbedding,
    _init_cache,
    _param,
    add_lora,
    check_lora_targets,
    qscaled,
)
from youku_mplug_tpu_torch.ops import kv_cache as kvc
from youku_mplug_tpu_torch.ops.attention import (
    NEG_INF,
    block_of,
    checkpoint_replaying,
    dropout,
    mha_reference,
)
from youku_mplug_tpu_torch.ops.cross_entropy import masked_mean_loss
from youku_mplug_tpu_torch.ops.decode_attention import (
    alibi_slopes,
    write_decode_attention,
)
from youku_mplug_tpu_torch.ops.flash_attention import flash_attention_packed
from youku_mplug_tpu_torch.ops.layernorm import layer_norm
from youku_mplug_tpu_torch.ops.lora import LoRAModule, plus
from youku_mplug_tpu_torch.parallel.data_parallel import data_group_of
from youku_mplug_tpu_torch.parallel.tensor_parallel import (
    copy_to_model,
    reduce_from_model,
)
from youku_mplug_tpu_torch.runtime.precision import DEFAULT_POLICY, Policy

__all__ = ["BloomConfig", "BloomLM", "alibi_slopes"]

REMAT_POLICIES = ("nothing", "names", "narrow")


@dataclasses.dataclass(frozen=True)
class BloomConfig:
    """Decoder hyperparameters; JSON field names follow the HF config.json
    contract (``n_head`` / ``n_layer`` / ``n_embed`` aliases accepted), as
    the JAX ``BloomConfig`` reads them."""

    vocab_size: int = 250880
    hidden_size: int = 4096
    num_hidden_layers: int = 30
    num_attention_heads: int = 32
    layernorm_epsilon: float = 1e-5
    hidden_dropout: float = 0.0
    attention_dropout: float = 0.0
    init_method_std: float = 0.02
    apply_residual_post_ln: bool = False  # all shipped Blooms: False
    eos_id: int = 2
    pad_id: int = 3
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_targets: tuple = LORA_TARGETS
    # "auto": the compute dtype; "int8": per-(token, head) quantized
    kv_cache_dtype: str = "auto"
    remat: bool = False  # checkpoint each layer in training
    remat_policy: str = "nothing"  # "nothing" | "names" | "narrow"
    ce_chunk: int = 0    # sequence chunk of the LM loss (0: dense)

    def __post_init__(self):
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {self.remat_policy!r} not in "
                             f"{REMAT_POLICIES}")
        if self.kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(f"kv_cache_dtype {self.kv_cache_dtype!r} not in "
                             f"{KV_CACHE_DTYPES}")
        check_lora_targets(self)

    @property
    def ffn_dim(self) -> int:
        return 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        assert self.hidden_size % self.num_attention_heads == 0
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_json_file(cls, path: str, **overrides) -> "BloomConfig":
        with open(path) as f:
            raw = json.load(f)
        mapped = dict(
            vocab_size=raw.get("vocab_size", 250880),
            hidden_size=raw.get("hidden_size", raw.get("n_embed", 4096)),
            num_hidden_layers=raw.get("num_hidden_layers",
                                      raw.get("n_layer", 30)),
            num_attention_heads=raw.get("num_attention_heads",
                                        raw.get("n_head", 32)),
            layernorm_epsilon=raw.get("layer_norm_epsilon", 1e-5),
            hidden_dropout=raw.get("hidden_dropout", 0.0),
            attention_dropout=raw.get("attention_dropout", 0.0),
            init_method_std=raw.get("initializer_range", 0.02),
            apply_residual_post_ln=raw.get(
                "apply_residual_connection_post_layernorm", False),
            eos_id=raw.get("eos_token_id", 2),
            pad_id=raw.get("pad_token_id", 3),
        )
        mapped.update(overrides)
        return cls(**mapped)


class BloomAttention(LoRAModule):
    """ALiBi self-attention, head-major fused QKV: the training forward
    without a cache, prefill and decode with one.  Parameters carry a
    leading [L] layer dimension.  On a model shard (``tp``) it holds a
    contiguous n/m of the heads and their slice of the slopes, the output
    projection's partial products are summed over the model ranks and
    ``out_bias`` is added once, after."""

    TP_PARAM = "out_kernel"  # the row-parallel product that is summed
    tp = None

    def __init__(self, cfg: BloomConfig, num_layers: int, dtype):
        super().__init__()
        n, d, h = cfg.num_attention_heads, cfg.head_dim, cfg.hidden_size
        self.n_total, self.d, self.h = n, d, h
        self.slopes = alibi_slopes(n)
        # the flash kernels read the slopes from an fp32 device array
        self.register_buffer("slopes_fp32", torch.tensor(self.slopes),
                             persistent=False)
        self.qkv_kernel = _param(num_layers, h, n, 3, d, dtype=dtype)
        self.qkv_bias = _param(num_layers, n, 3, d, dtype=dtype)
        self.out_kernel = _param(num_layers, n, d, h, dtype=dtype)
        self.out_bias = _param(num_layers, h, dtype=dtype)
        add_lora(self, cfg, num_layers, dtype,
                 {"qkv": (h, 3 * n * d), "out": (n * d, h)})

    @property
    def n(self) -> int:
        """The heads this module holds (n / m on a model shard)."""
        return self.qkv_kernel.shape[-3]

    @property
    def head_offset(self) -> int:
        """The index of this module's first head in the whole ladder."""
        return self.tp.index * self.n if self.tp is not None else 0

    def local_slopes(self):
        """(numpy, fp32 device tensor) slopes of this module's heads."""
        lo, hi = self.head_offset, self.head_offset + self.n
        return self.slopes[lo:hi], self.slopes_fp32[lo:hi]

    def forward(self, x, lidx: int, cache: Optional[kvc.Cache] = None,
                cache_len: CacheLen = 0,
                valid_from: Optional[torch.Tensor] = None,
                drop: Optional[Dropout] = None):
        """x [B, S, H] -> [B, S, H].  Without a cache: causal ALiBi
        attention over the whole sequence through the flash kernels, or
        under attention dropout (``drop``) the plain path.  With one:
        writes this chunk's K|V rows into layer ``lidx`` of ``cache`` at
        ``cache_len`` (int, or [B] per-sample positions), then attends to
        keys ``valid_from <= j <= position``."""
        qkv5 = self.qkv(x, lidx)
        if cache is None:
            return self.project(self.core(qkv5, drop), lidx)
        n, d = self.n, self.d
        b, s = qkv5.shape[:2]
        if s == 1:  # the decode kernel writes the row and attends
            out = write_decode_attention(
                qkv5[:, 0, :, 0, :], qkv5[:, 0, :, 1, :], qkv5[:, 0, :, 2, :],
                cache, n, lidx, cache_len, valid_from,
                alibi_slopes=self.local_slopes()[0],
                head_offset=self.head_offset, n_total=self.n_total)[:, None]
        else:
            kvp = torch.cat([qkv5[..., 1, :].reshape(b, s, n * d),
                             qkv5[..., 2, :].reshape(b, s, n * d)], dim=-1)
            kvc.cache_write(cache, kvp, cache_len, lidx)  # [K | V] rows
            out = self._prefill_attention(qkv5, lidx, cache, cache_len,
                                          valid_from)
        return self.project(out, lidx)

    def qkv(self, x, lidx: int) -> torch.Tensor:
        """The fused projection (int8 scale, bias, LoRA delta), head-major
        [B, S, n, 3, d]; its input through *f* on a model shard."""
        n, d, h = self.n, self.d, self.h
        dt = x.dtype
        x = copy_to_model(x, self.tp)
        qkv = x @ self.qkv_kernel[lidx].reshape(h, 3 * n * d).to(dt)
        qkv = qscaled(qkv, self, "qkv_kernel", lidx)
        qkv = qkv + self.qkv_bias[lidx].reshape(3 * n * d).to(dt)
        qkv = plus(qkv, self.delta("qkv", x, lidx))
        return qkv.unflatten(-1, (n, 3, d))

    def core(self, qkv5, drop: Optional[Dropout] = None) -> torch.Tensor:
        """Causal ALiBi attention of the training forward, [B, S, n*d]:
        the flash kernels, or with attention dropout ``mha_reference``
        over the ALiBi bias of the key positions."""
        n, d = self.n, self.d
        b, s = qkv5.shape[:2]
        slopes = self.local_slopes()[1]
        rate = drop.attention if drop is not None else 0.0
        if rate == 0.0:
            return flash_attention_packed(
                qkv5[..., 0, :], qkv5[..., 1, :], qkv5[..., 2, :], n,
                causal=True, alibi_slopes=slopes)
        q, k, v = (qkv5[..., i, :].transpose(1, 2) for i in range(3))
        bias = (slopes[None, :, None, None]
                * torch.arange(s, dtype=torch.float32,
                               device=qkv5.device)[None, None, None, :])
        out = mha_reference(q, k, v, causal=True, bias=bias,
                            dropout_rate=rate, generator=drop.generator,
                            dropout_blocks=drop.rows + block_of(1, self.tp))
        return out.transpose(1, 2).reshape(b, s, n * d)

    def project(self, out, lidx: int) -> torch.Tensor:
        """The output projection of the attention [B, S, n*d] -> [B, S,
        H] (int8 scale, LoRA delta, the sum over the model ranks, bias)."""
        nd, h = self.n * self.d, self.h
        dt = out.dtype
        y = out @ self.out_kernel[lidx].reshape(nd, h).to(dt)
        y = qscaled(y, self, "out_kernel", lidx)
        y = plus(y, self.delta("out", out, lidx))
        return reduce_from_model(y, self.tp) + self.out_bias[lidx].to(dt)

    def _prefill_attention(self, qkv5, lidx, cache, cache_len, valid_from):
        n, d = self.n, self.d
        nd = n * d
        b, s = qkv5.shape[:2]
        # [B, M, 2nd]: a view, or the int8 layer dequantized
        ckv = kvc.layer_dequant(kvc.layer_slice(cache, lidx), n, qkv5.dtype)
        m = ckv.shape[1]
        dev = qkv5.device
        q = qkv5[..., 0, :].transpose(1, 2)                  # [B, n, S, d]
        ck = ckv[..., :nd].unflatten(-1, (n, d)).transpose(1, 2)
        cv = ckv[..., nd:].unflatten(-1, (n, d)).transpose(1, 2)
        ki = torch.arange(m, device=dev)
        steps = torch.arange(s, device=dev)
        if isinstance(cache_len, int):
            qi = (cache_len + steps)[None, :, None]              # [1, S, 1]
        else:
            qi = cache_len.to(dev)[:, None, None] + steps[None, :, None]
        allowed = ki[None, None, :] <= qi                        # [B|1, S, M]
        if valid_from is not None:
            allowed = allowed & (ki[None, None, :]
                                 >= valid_from.to(dev)[:, None, None])
        alibi = (torch.as_tensor(self.local_slopes()[0],
                                 device=dev)[:, None, None]
                 * ki.float()[None, None, :])                    # [n, 1, M]
        bias = alibi[None] + torch.zeros(
            allowed.shape, dtype=torch.float32, device=dev).masked_fill(
                ~allowed, NEG_INF)[:, None]
        out = mha_reference(q, ck, cv, bias=bias)
        return out.transpose(1, 2).reshape(b, s, nd)


class BloomMLP(LoRAModule):
    """fc1 -> tanh-GELU -> fc2; on a model shard fc1's columns and fc2's
    rows are this rank's, fc2's partial product is summed over the model
    ranks and ``fc2_bias`` added once, after."""

    TP_PARAM = "fc2_kernel"
    tp = None

    def __init__(self, cfg: BloomConfig, num_layers: int, dtype):
        super().__init__()
        h, f = cfg.hidden_size, cfg.ffn_dim
        self.fc1_kernel = _param(num_layers, h, f, dtype=dtype)
        self.fc1_bias = _param(num_layers, f, dtype=dtype)
        self.fc2_kernel = _param(num_layers, f, h, dtype=dtype)
        self.fc2_bias = _param(num_layers, h, dtype=dtype)
        add_lora(self, cfg, num_layers, dtype, {"fc1": (h, f), "fc2": (f, h)})

    def forward(self, x, lidx: int):
        return self.fc2(self.fc1(x, lidx), lidx)

    def fc1(self, x, lidx: int) -> torch.Tensor:
        """``gelu(x @ fc1 + delta + bias)``, the MLP's hidden; its input
        through *f* on a model shard."""
        dt = x.dtype
        x = copy_to_model(x, self.tp)
        y = plus(qscaled(x @ self.fc1_kernel[lidx].to(dt), self,
                         "fc1_kernel", lidx), self.delta("fc1", x, lidx))
        # BloomGelu is the tanh-approximate GELU
        return F.gelu(y + self.fc1_bias[lidx].to(dt), approximate="tanh")

    def fc2(self, y, lidx: int) -> torch.Tensor:
        dt = y.dtype
        out = plus(qscaled(y @ self.fc2_kernel[lidx].to(dt), self,
                           "fc2_kernel", lidx), self.delta("fc2", y, lidx))
        return reduce_from_model(out, self.tp) + self.fc2_bias[lidx].to(dt)


class BloomLayer(nn.Module):
    """Pre-LN Bloom block; ``forward(x, lidx, ...)`` runs layer lidx of
    the stack."""

    def __init__(self, cfg: BloomConfig, num_layers: int, dtype):
        super().__init__()
        h = cfg.hidden_size
        self.eps = cfg.layernorm_epsilon
        self.post_ln_residual = cfg.apply_residual_post_ln
        self.ln1_scale = _param(num_layers, h, dtype=dtype)
        self.ln1_bias = _param(num_layers, h, dtype=dtype)
        self.ln2_scale = _param(num_layers, h, dtype=dtype)
        self.ln2_bias = _param(num_layers, h, dtype=dtype)
        self.attn = BloomAttention(cfg, num_layers, dtype)
        self.mlp = BloomMLP(cfg, num_layers, dtype)

    def forward(self, x, lidx: int, cache=None, cache_len: CacheLen = 0,
                valid_from=None, drop: Optional[Dropout] = None):
        a = self._ln1(x, lidx)
        x = self._attn_residual(
            x, a, self.attn(a, lidx, cache, cache_len, valid_from, drop),
            drop)
        return self._mlp_block(x, lidx, drop)

    def _ln1(self, x, lidx):
        return layer_norm(x, self.ln1_scale[lidx], self.ln1_bias[lidx],
                          eps=self.eps)

    def _attn_residual(self, x, a, attn_out, drop):
        if drop is not None:
            attn_out = dropout(attn_out, drop.hidden, drop.generator,
                               drop.rows)
        return (a if self.post_ln_residual else x) + attn_out

    def _mlp_block(self, x, lidx, drop):
        """ln2 -> MLP -> dropout -> residual."""
        return self._mlp_out(x, self._mlp_in(x, lidx)[1], lidx, drop)

    def _mlp_in(self, x, lidx):
        m = layer_norm(x, self.ln2_scale[lidx], self.ln2_bias[lidx],
                       eps=self.eps)
        return m, self.mlp.fc1(m, lidx)

    def _mlp_out(self, x, hidden, lidx, drop, m=None):
        out = self.mlp.fc2(hidden, lidx)
        if drop is not None:
            out = dropout(out, drop.hidden, drop.generator, drop.rows)
        if self.post_ln_residual:
            if m is None:
                m = layer_norm(x, self.ln2_scale[lidx], self.ln2_bias[lidx],
                               eps=self.eps)
            return m + out
        return x + out

    def remat(self, x, lidx: int, policy: str, drop: Optional[Dropout]):
        """The training forward (no cache) under ``remat_policy`` (see
        the module docstring): "nothing" checkpoints the layer whole;
        "names" and "narrow" run the attention outside the checkpointed
        segments."""
        gen = drop.generator if drop is not None else None
        if policy == "nothing":
            return checkpoint_replaying(self, gen, x, lidx, None, 0, None,
                                        drop)
        attn = self.attn
        qkv5 = checkpoint_replaying(
            lambda t: attn.qkv(self._ln1(t, lidx), lidx), None, x)
        core = attn.core(qkv5, drop)

        def post_attention(x, core):
            a = self._ln1(x, lidx) if self.post_ln_residual else None
            return self._attn_residual(x, a, attn.project(core, lidx), drop)

        if policy == "narrow":
            return checkpoint_replaying(
                lambda t, c: self._mlp_block(post_attention(t, c), lidx,
                                             drop), gen, x, core)

        def to_hidden(x, core):
            x1 = post_attention(x, core)
            m, hidden = self._mlp_in(x1, lidx)
            return x1, m, hidden
        x1, m, hidden = checkpoint_replaying(to_hidden, gen, x, core)
        return self._mlp_out(x1, hidden, lidx, drop, m)


class BloomDecoder(nn.Module):
    """Embedding LayerNorm + the layer stack + final LayerNorm.  Input
    embeddings arrive raw (spliced video features included) and pass the
    embedding LayerNorm here, as in the HF model."""

    mesh = None  # the run's mesh (parallel/sharding.shard_params)

    def __init__(self, cfg: BloomConfig, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        dt = policy.param_dtype
        h = cfg.hidden_size
        self.cfg = cfg
        self.emb_ln_scale = _param(h, dtype=dt)
        self.emb_ln_bias = _param(h, dtype=dt)
        self.layers = BloomLayer(cfg, cfg.num_hidden_layers, dt)
        self.ln_f_scale = _param(h, dtype=dt)
        self.ln_f_bias = _param(h, dtype=dt)

    def forward(self, input_embeds, *, cache=None, cache_len: CacheLen = 0,
                valid_from=None, skip_emb_ln: bool = False,
                generator: Optional[torch.Generator] = None):
        """``generator``: the dropout masks of a training forward (no
        cache, training mode); ignored otherwise."""
        cfg = self.cfg
        drop = None
        if (generator is not None and cache is None and self.training
                and (cfg.hidden_dropout > 0 or cfg.attention_dropout > 0)):
            drop = Dropout(generator, cfg.hidden_dropout,
                           cfg.attention_dropout,
                           block_of(0, data_group_of(self)))
        eps = cfg.layernorm_epsilon
        x = input_embeds
        if not skip_emb_ln:
            x = layer_norm(x, self.emb_ln_scale, self.emb_ln_bias, eps=eps)
        if drop is not None:
            x = dropout(x, drop.hidden, drop.generator, drop.rows)
        remat = cache is None and cfg.remat and torch.is_grad_enabled()
        for lidx in range(cfg.num_hidden_layers):
            if remat:
                x = self.layers.remat(x, lidx, cfg.remat_policy, drop)
            else:
                x = self.layers(x, lidx, cache, cache_len, valid_from, drop)
        return layer_norm(x, self.ln_f_scale, self.ln_f_bias, eps=eps)


class BloomLM(nn.Module):
    """Tied-embedding Bloom LM: the training forward with the masked-mean
    LM loss, and the serving surface of ``GPT3LM`` (``embed`` / ``logits``
    / ``init_cache`` / ``decode_step``), so the serving engine drives
    either."""

    mesh = None  # the run's mesh (parallel/sharding.shard_params)

    def __init__(self, cfg: BloomConfig, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.cfg, self.policy = cfg, policy
        self.word_embeddings = TiedEmbedding(cfg.vocab_size, cfg.hidden_size,
                                             policy.param_dtype)
        self.decoder = BloomDecoder(cfg, policy)

    def embed(self, tokens):
        """Raw token embeddings (the decoder applies the embedding
        LayerNorm)."""
        return self.word_embeddings.encode(tokens, self.policy.compute_dtype)

    def logits(self, hidden):
        return self.word_embeddings.attend(hidden)

    def forward(self, tokens=None, input_embeds=None, labels=None,
                loss_mask=None, generator: Optional[torch.Generator] = None):
        """Full-sequence causal forward (JAX ``BloomLM.__call__``).  Returns
        ``last_hidden_state``; with ``labels`` (already shifted) the fp32
        per-position ``losses`` [B, S]; with a ``loss_mask`` too, ``loss``:
        the masked mean over ``losses[:, :-1]``.  ``generator``: the
        dropout masks, in training mode."""
        if input_embeds is None:
            input_embeds = self.embed(tokens)
        else:
            input_embeds = input_embeds.to(self.policy.compute_dtype)
        hidden = self.decoder(input_embeds, generator=generator)
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
        """Same contract as ``GPT3LM.decode_step``; ``position_offset`` is
        accepted and ignored (ALiBi carries position).  Returns (fp32
        logits of the last position [B, V], or of every position
        [B, S, V] with ``return_all``, cache)."""
        del position_offset
        hidden = self.decoder(input_embeds.to(self.policy.compute_dtype),
                              cache=cache, cache_len=cache_len,
                              valid_from=valid_from)
        return self.logits(hidden if return_all else hidden[:, -1]), cache
