"""Decode attention over the stacked packed KV cache, read in place.

Counterpart of ``youku_mplug_tpu/ops/decode_attention.py`` for the bf16
cache without ALiBi: one query token per sample attends to layer
``layer_idx`` of the stacked cache ``[L, B, M, 2*n*d]`` (rows = [K | V]),
over the live keys ``valid_from[b] <= j <= cache_len[b]``; the caller
writes the new token's row at ``cache_len[b]`` first.  A sample with no
live key gets zeros.

The wrapper runs ``decode_attention_plain`` for CPU tensors and launches
the CUDA kernel (``csrc/decode_attention.cu``) for CUDA tensors, or
raises; ``decode_attention.launches`` counts kernel launches.  The int8
cache with per-head scales and the ALiBi ladder are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from youku_mplug_tpu_torch.ops import _native

HEAD_DIM = 64  # the one head width the kernel is built for


def _per_sample(x: Union[int, torch.Tensor], b: int, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device).reshape(
        -1).expand(b)


def decode_attention_plain(q: torch.Tensor, ckv: torch.Tensor, n_heads: int,
                           layer_idx: int, cache_len, valid_from=None, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of the kernel (fp32 scores, probabilities and
    accumulation). q [B, n*d]; ckv [L, B, M, 2*n*d]; returns [B, n*d] in
    q.dtype."""
    b, nd = q.shape
    m = ckv.shape[2]
    d = nd // n_heads
    if scale is None:
        scale = d ** -0.5
    layer = ckv[layer_idx]
    k = layer[..., :nd].unflatten(-1, (n_heads, d)).float()
    v = layer[..., nd:].unflatten(-1, (n_heads, d)).float()
    s = torch.einsum("bnd,bmnd->bnm", q.float().unflatten(-1, (n_heads, d)),
                     k) * scale
    cl = _per_sample(cache_len, b, q.device)
    vf = _per_sample(0 if valid_from is None else valid_from, b, q.device)
    j = torch.arange(m, device=q.device)[None, :]
    allowed = ((j >= vf[:, None]) & (j <= cl[:, None]))[:, None, :]
    s = s.masked_fill(~allowed, float("-inf"))
    mx = s.amax(-1, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    p = torch.exp(s - mx)
    den = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bnm,bmnd->bnd", p / den, v)
    return o.reshape(b, nd).to(q.dtype)


def decode_attention(q: torch.Tensor, ckv: torch.Tensor, n_heads: int,
                     layer_idx: int, cache_len, valid_from=None, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token attention against layer ``layer_idx`` of the stacked
    packed cache.  q: [B, n*d] (a row-strided view is fine); ckv:
    [L, B, M, 2*n*d]; cache_len / valid_from: int or [B].  Returns
    [B, n*d] in q.dtype."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, ckv, n_heads, layer_idx, cache_len,
                                      valid_from, scale=scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"no decode attention kernel for {q.device}")
    n_layers, b, m, nd2 = ckv.shape
    nd = nd2 // 2
    if q.dtype != torch.bfloat16 or ckv.dtype != torch.bfloat16 \
            or ckv.device != q.device:
        raise TypeError("decode kernel: q and the cache must be bf16 on one "
                        f"device; got {q.dtype}/{ckv.dtype} on "
                        f"{q.device}/{ckv.device}")
    if nd != n_heads * HEAD_DIM or q.shape != (b, nd):
        raise ValueError(f"decode kernel: needs head dim {HEAD_DIM} and q "
                         f"[{b}, {nd}]; got q {tuple(q.shape)}, n={n_heads}")
    if not ckv.is_contiguous() or q.stride(1) != 1 or q.stride(0) % 2:
        raise ValueError("decode kernel: needs a contiguous cache and q rows")
    if not 0 <= layer_idx < n_layers:
        raise IndexError(f"layer {layer_idx} of {n_layers}")
    if scale is None:
        scale = HEAD_DIM ** -0.5
    cl = _per_sample(cache_len, b, q.device).contiguous()
    vf = _per_sample(0 if valid_from is None else valid_from, b,
                     q.device).contiguous()
    out = torch.empty(b, nd, dtype=q.dtype, device=q.device)
    err = _native.library().ymt_decode_attention_bf16(
        q.data_ptr(), q.stride(0), ckv.data_ptr(), out.data_ptr(),
        cl.data_ptr(), vf.data_ptr(), b, n_heads, m,
        layer_idx * b * m * nd2, float(scale), _native.stream_handle(q))
    _native.check_launch(err, "ymt_decode_attention_bf16")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
