"""Bloom decoder (the BloomZ-7B LM of mPLUG-Owl video instruct): prefill
and decode over the stacked packed cache, for serving.

Counterpart of ``youku_mplug_tpu/models/bloom.py`` (the cached branch).
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

Cache: ``[L, B, M, 2*n*d]`` rows [K | V] repacked from the head-major
projection.  A decode step (S = 1) reads it in place through the ALiBi
decode kernel, handed q as a [B, n, d] head-strided view of the fused
row; a longer chunk (prefill) runs plain attention over the layer view
with the ALiBi bias plus the ``valid_from``/causal mask as an additive
fp32 minimum.  The no-cache forward (training; flash attention with
ALiBi) and LoRA are not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from youku_mplug_tpu_torch.models.gpt3 import CacheLen, TiedEmbedding, _param
from youku_mplug_tpu_torch.ops import kv_cache as kvc
from youku_mplug_tpu_torch.ops.attention import NEG_INF, mha_reference
from youku_mplug_tpu_torch.ops.decode_attention import (
    alibi_slopes,
    decode_attention,
)
from youku_mplug_tpu_torch.ops.layernorm import layer_norm
from youku_mplug_tpu_torch.runtime.precision import DEFAULT_POLICY, Policy

__all__ = ["BloomConfig", "BloomLM", "alibi_slopes"]


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

    def __post_init__(self):
        if self.lora_rank:
            raise NotImplementedError(
                f"LoRA (lora_rank {self.lora_rank}) is not ported yet: serve "
                "the merged-adapter form (text_overrides.lora_rank: 0)")

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


class BloomAttention(nn.Module):
    """ALiBi self-attention over the stacked cache; head-major fused QKV.
    Parameters carry a leading [L] layer dimension."""

    def __init__(self, cfg: BloomConfig, num_layers: int, dtype):
        super().__init__()
        n, d, h = cfg.num_attention_heads, cfg.head_dim, cfg.hidden_size
        self.n, self.d, self.h = n, d, h
        self.slopes = alibi_slopes(n)
        self.qkv_kernel = _param(num_layers, h, n, 3, d, dtype=dtype)
        self.qkv_bias = _param(num_layers, n, 3, d, dtype=dtype)
        self.out_kernel = _param(num_layers, n, d, h, dtype=dtype)
        self.out_bias = _param(num_layers, h, dtype=dtype)

    def forward(self, x, lidx: int, cache: torch.Tensor, cache_len: CacheLen,
                valid_from: Optional[torch.Tensor] = None):
        """x [B, S, H] -> [B, S, H].  Writes this chunk's K|V rows into
        layer ``lidx`` of ``cache`` at ``cache_len`` (int, or [B]
        per-sample positions), then attends to keys ``valid_from <= j <=
        position``."""
        n, d, h = self.n, self.d, self.h
        nd = n * d
        b, s, _ = x.shape
        dt = x.dtype
        qkv = x @ self.qkv_kernel[lidx].reshape(h, 3 * nd).to(dt)
        qkv = qkv + self.qkv_bias[lidx].reshape(3 * nd).to(dt)
        qkv5 = qkv.unflatten(-1, (n, 3, d))  # head-major [B, S, n, 3, d]
        kvp = torch.cat([qkv5[..., 1, :].reshape(b, s, nd),
                         qkv5[..., 2, :].reshape(b, s, nd)], dim=-1)
        kvc.cache_write(cache, kvp, cache_len, lidx)  # [K | V] rows
        if s == 1:
            out = decode_attention(qkv5[:, 0, :, 0, :], cache, n, lidx,
                                   cache_len, valid_from,
                                   alibi_slopes=self.slopes)[:, None]
        else:
            out = self._prefill_attention(qkv5, lidx, cache, cache_len,
                                          valid_from)
        y = out @ self.out_kernel[lidx].reshape(nd, h).to(dt)
        return y + self.out_bias[lidx].to(dt)

    def _prefill_attention(self, qkv5, lidx, cache, cache_len, valid_from):
        n, d = self.n, self.d
        nd = n * d
        b, s = qkv5.shape[:2]
        ckv = kvc.layer_slice(cache, lidx)  # [B, M, 2nd] view
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
        alibi = (torch.as_tensor(self.slopes, device=dev)[:, None, None]
                 * ki.float()[None, None, :])                    # [n, 1, M]
        bias = alibi[None] + torch.zeros(
            allowed.shape, dtype=torch.float32, device=dev).masked_fill(
                ~allowed, NEG_INF)[:, None]
        out = mha_reference(q, ck, cv, bias=bias)
        return out.transpose(1, 2).reshape(b, s, nd)


class BloomMLP(nn.Module):
    def __init__(self, cfg: BloomConfig, num_layers: int, dtype):
        super().__init__()
        h, f = cfg.hidden_size, cfg.ffn_dim
        self.fc1_kernel = _param(num_layers, h, f, dtype=dtype)
        self.fc1_bias = _param(num_layers, f, dtype=dtype)
        self.fc2_kernel = _param(num_layers, f, h, dtype=dtype)
        self.fc2_bias = _param(num_layers, h, dtype=dtype)

    def forward(self, x, lidx: int):
        dt = x.dtype
        y = x @ self.fc1_kernel[lidx].to(dt)
        # BloomGelu is the tanh-approximate GELU
        y = F.gelu(y + self.fc1_bias[lidx].to(dt), approximate="tanh")
        return y @ self.fc2_kernel[lidx].to(dt) + self.fc2_bias[lidx].to(dt)


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

    def forward(self, x, lidx: int, cache, cache_len, valid_from=None):
        a = layer_norm(x, self.ln1_scale[lidx], self.ln1_bias[lidx],
                       eps=self.eps)
        x = (a if self.post_ln_residual else x) + self.attn(
            a, lidx, cache, cache_len, valid_from)
        m = layer_norm(x, self.ln2_scale[lidx], self.ln2_bias[lidx],
                       eps=self.eps)
        return (m if self.post_ln_residual else x) + self.mlp(m, lidx)


class BloomDecoder(nn.Module):
    """Embedding LayerNorm + the layer stack + final LayerNorm.  Input
    embeddings arrive raw (spliced video features included) and pass the
    embedding LayerNorm here, as in the HF model."""

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

    def forward(self, input_embeds, *, cache, cache_len: CacheLen,
                valid_from=None, skip_emb_ln: bool = False):
        eps = self.cfg.layernorm_epsilon
        x = input_embeds
        if not skip_emb_ln:
            x = layer_norm(x, self.emb_ln_scale, self.emb_ln_bias, eps=eps)
        for lidx in range(self.cfg.num_hidden_layers):
            x = self.layers(x, lidx, cache, cache_len, valid_from)
        return layer_norm(x, self.ln_f_scale, self.ln_f_bias, eps=eps)


class BloomLM(nn.Module):
    """Tied-embedding Bloom LM with the serving surface of ``GPT3LM``
    (``embed`` / ``logits`` / ``init_cache`` / ``decode_step``), so the
    serving engine drives either."""

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

    def forward(self, *args, **kwargs):
        raise NotImplementedError(
            "the no-cache Bloom forward (training: flash attention with "
            "ALiBi) is not ported yet; serve through decode_step")

    def init_cache(self, batch: int, max_len: int, device=None):
        """Stacked cache [L, B, M, 2*hidden], M rounded up to a multiple of
        128 as in the JAX package (the extra rows are never attended)."""
        cfg = self.cfg
        max_len = -(-max_len // 128) * 128
        return kvc.make_cache(cfg.num_hidden_layers, batch, max_len,
                              cfg.hidden_size, self.policy.compute_dtype,
                              device=device)

    def decode_step(self, input_embeds, cache, cache_len: CacheLen,
                    valid_from=None, position_offset=None):
        """Same contract as ``GPT3LM.decode_step``; ``position_offset`` is
        accepted and ignored (ALiBi carries position).  Returns (fp32
        logits of the last position [B, V], cache)."""
        del position_offset
        hidden = self.decoder(input_embeds.to(self.policy.compute_dtype),
                              cache=cache, cache_len=cache_len,
                              valid_from=valid_from)
        return self.logits(hidden[:, -1]), cache
