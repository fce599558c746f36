"""One decode step's cache write and attention over the stacked packed KV
cache, read in place.

Counterpart of ``youku_mplug_tpu/ops/decode_attention.py`` together with
the per-sample row write of ``youku_mplug_tpu/ops/kv_cache.py``
(``cache_write``, on the TPU ``cache_scatter_write``) that the JAX decode
step runs right before it: the new token's K and V rows go to row
``cache_len[b]`` of layer ``layer_idx`` of the stacked cache
``[L, B, M, 2*n*d]`` (rows = [K | V]; an int8 cache quantizes them per
(row, head) on the way in), then one query token per sample attends over
the live keys ``valid_from[b] <= j <= cache_len[b]``.  A sample with no
live key gets zeros; ``cache_len[b] >= M`` writes nothing and reads rows
up to M-1.  With ``alibi_slopes`` the score of key j is
``scale * q.k + slope_h * j``.  An int8 cache is the dict of
``ops/kv_cache.py`` (int8 rows, fp32 scales [L, B, M, 2*n]).  On a model
shard the step holds a contiguous slice of the heads: its n heads are
heads ``head_offset .. head_offset + n - 1`` of ``n_total``, and their
slopes that slice of the ladder of ``n_total`` (the kernel builds each
slope from ``h + head_offset`` and ``n_total``).

``write_decode_attention`` runs its plain version
(``write_decode_attention_plain``: ``kv_cache.cache_write``, then
``decode_attention_plain``) for CPU tensors and launches the CUDA kernel
(``csrc/decode_attention.cu``, head dim 64 or 128 with or without ALiBi,
80 without: the GPT-3 2.7B decoder), which does both in one launch, for
CUDA tensors, or raises.  Its ``launches`` counts kernel launches on a
bf16 cache without ALiBi, ``alibi_launches`` those with it,
``int8_launches`` and ``int8_alibi_launches`` the same on an int8 cache,
``d80_launches`` and ``int8_d80_launches`` those at head dim 80, and
``d128_launches`` and ``int8_d128_launches`` those at head dim 128
without ALiBi (the GPT-3 13B decoder's 40 heads of 128).
Like the JAX package, which runs its kernel where the cache width M is a
multiple of 64 (``decode_attention_supported``), the port's callers make
caches of a multiple of 128 rows (``GPT3LM.init_cache``); the kernel
itself takes any M.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Union

import numpy as np
import torch

from youku_mplug_tpu_torch.ops import _native
from youku_mplug_tpu_torch.ops import kv_cache as kvc

HEAD_DIMS = (64, 80, 128)  # the head widths the kernel is built for
ALIBI_HEAD_DIMS = (64, 128)  # ... and with the ALiBi ladder


def alibi_slopes(num_heads: int) -> np.ndarray:
    """Per-head ALiBi slopes, fp32 [n]: the geometric ladder 2^(-8i/c)
    for c the largest power of two <= n, then the interleaved half-step
    ladder for the remaining heads (HF ``build_alibi_tensor``; the JAX
    package's ``models/bloom.py:alibi_slopes``)."""
    closest = 2 ** math.floor(math.log2(num_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(closest) - 3)))
    slopes = base ** np.arange(1, 1 + closest, dtype=np.float64)
    if closest != num_heads:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * closest) - 3)))
        n_rem = min(closest, num_heads - closest)
        extra = extra_base ** np.arange(1, 1 + 2 * n_rem, 2,
                                        dtype=np.float64)
        slopes = np.concatenate([slopes, extra])
    return slopes.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _is_ladder(n_heads: int, head_offset: int, n_total: int,
               raw: bytes) -> bool:
    a = np.frombuffer(raw, np.float32)
    return 0 <= head_offset and head_offset + n_heads <= n_total \
        and a.shape == (n_heads,) and bool(np.allclose(
            a, alibi_slopes(n_total)[head_offset:head_offset + n_heads],
            rtol=1e-6))


def _check_ladder(slopes, n_heads: int, head_offset: int = 0,
                  n_total: Optional[int] = None) -> None:
    """Raise unless ``slopes`` is heads ``head_offset .. head_offset +
    n_heads - 1`` of the standard ladder of ``n_total`` (default
    ``n_heads``: the whole ladder): the kernel generates the slopes from
    the head index (the JAX kernel's check, decode_attention.py:257-265,
    on a model shard's slice of the heads)."""
    n_total = n_heads if n_total is None else n_total
    raw = np.ascontiguousarray(slopes, np.float32).tobytes()
    if not _is_ladder(n_heads, head_offset, n_total, raw):
        raise ValueError(
            "decode attention only supports the standard ALiBi ladder: "
            f"heads {head_offset}..{head_offset + n_heads - 1} of the "
            f"ladder of {n_total} heads")


def _per_sample(x: Union[int, torch.Tensor], b: int, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device).reshape(
        -1).expand(b)


def decode_attention_plain(q: torch.Tensor, ckv: torch.Tensor, n_heads: int,
                           layer_idx: int, cache_len, valid_from=None, *,
                           scale: Optional[float] = None,
                           alibi_slopes=None,
                           kv_scales: Optional[torch.Tensor] = None,
                           head_offset: int = 0,
                           n_total: Optional[int] = None) -> torch.Tensor:
    """The attention half of the plain version (fp32 scores, bias,
    probabilities and accumulation), on a cache already written.
    q [B, n*d] or [B, n, d]; ckv [L, B, M, 2*n*d]; alibi_slopes: optional
    [n] per-head slopes, read as given (any values: a model shard's slice
    of a ladder too; ``head_offset`` and ``n_total``, the kernel's place
    of the slice, are taken and not needed); kv_scales: optional [L, B,
    M, 2*n] scales of an int8 ``ckv``, which dequantizes to fp32 first;
    returns [B, n*d] in q.dtype."""
    b = q.shape[0]
    q = q.reshape(b, -1)
    nd = q.shape[1]
    m = ckv.shape[2]
    d = nd // n_heads
    if scale is None:
        scale = d ** -0.5
    layer = ckv[layer_idx]
    if kv_scales is not None:
        layer = kvc.dequantize_rows(layer, kv_scales[layer_idx], n_heads,
                                    torch.float32)
    k = layer[..., :nd].unflatten(-1, (n_heads, d)).float()
    v = layer[..., nd:].unflatten(-1, (n_heads, d)).float()
    s = torch.einsum("bnd,bmnd->bnm", q.float().unflatten(-1, (n_heads, d)),
                     k) * scale
    j = torch.arange(m, device=q.device)
    if alibi_slopes is not None:
        slopes = torch.as_tensor(np.asarray(alibi_slopes, np.float32),
                                 device=q.device)
        s = s + slopes[:, None] * j.float()
    cl = _per_sample(cache_len, b, q.device)
    vf = _per_sample(0 if valid_from is None else valid_from, b, q.device)
    allowed = ((j[None] >= vf[:, None]) & (j[None] <= cl[:, None]))[:, None]
    s = s.masked_fill(~allowed, float("-inf"))
    mx = s.amax(-1, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    p = torch.exp(s - mx)
    den = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bnm,bmnd->bnd", p / den, v)
    return o.reshape(b, nd).to(q.dtype)


def write_decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, cache: kvc.Cache,
                                 n_heads: int, layer_idx: int, cache_len,
                                 valid_from=None, *,
                                 scale: Optional[float] = None,
                                 alibi_slopes=None, head_offset: int = 0,
                                 n_total: Optional[int] = None
                                 ) -> torch.Tensor:
    """Plain version of the kernel, with its arguments:
    ``kv_cache.cache_write`` of the [K | V] rows at row cache_len[b] (in
    place; int8: ``quantize_rows``; a row outside the cache is not
    written), then ``decode_attention_plain`` (the slopes as given)."""
    b = q.shape[0]
    rows = torch.cat([k.reshape(b, -1), v.reshape(b, -1)], -1)[:, None]
    kvc.cache_write(cache, rows, _per_sample(cache_len, b, q.device),
                    layer_idx)
    ckv, scales = kvc.leaves(cache)
    return decode_attention_plain(q, ckv, n_heads, layer_idx, cache_len,
                                  valid_from, scale=scale,
                                  alibi_slopes=alibi_slopes, kv_scales=scales)


def _heads(t: torch.Tensor, b: int, n_heads: int, d: int, what: str):
    t3 = t.unflatten(-1, (n_heads, d)) if t.dim() == 2 else t
    if t3.shape != (b, n_heads, d) or t3.stride(2) != 1 \
            or t3.dtype != torch.bfloat16:
        raise ValueError(f"decode kernel: {what} must be bf16 [{b}, "
                         f"{n_heads * d}] or [{b}, {n_heads}, {d}] with a "
                         f"contiguous head dim; got {t.dtype} "
                         f"{tuple(t.shape)} strides {t.stride()}")
    return t3


def write_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           cache: kvc.Cache, n_heads: int, layer_idx: int,
                           cache_len, valid_from=None, *,
                           scale: Optional[float] = None,
                           alibi_slopes=None, head_offset: int = 0,
                           n_total: Optional[int] = None) -> torch.Tensor:
    """One decode step of attention with its cache write.  q, k, v: the
    step's query and new K and V rows, each [B, n*d] or [B, n, d] (any
    batch and head strides with a contiguous d: views of a fused qkv row
    are fine); cache: the stacked [L, B, M, 2*n*d] cache, bf16 or the int8
    dict (``ops/kv_cache.py``), written in place at row cache_len[b] of
    layer ``layer_idx``; cache_len / valid_from: int or [B]; alibi_slopes:
    optional [n] slopes, which must be heads ``head_offset ..
    head_offset + n - 1`` of the standard ladder of ``n_total`` heads
    (default n: ``alibi_slopes(n)`` whole; a model shard's slice
    otherwise).  Returns [B, n*d] in q.dtype."""
    n_total = n_heads if n_total is None else n_total
    if alibi_slopes is not None:
        _check_ladder(alibi_slopes, n_heads, head_offset, n_total)
    ckv, scales = kvc.leaves(cache)
    int8 = scales is not None
    if int8 and (ckv.dtype != torch.int8 or scales.shape
                 != ckv.shape[:3] + (2 * n_heads,)):
        raise ValueError(f"an int8 cache with scales [L, B, M, 2n]; got "
                         f"{ckv.dtype} {tuple(ckv.shape)}, scales "
                         f"{tuple(scales.shape)}, n={n_heads}")
    if q.device.type == "cpu":
        return write_decode_attention_plain(
            q, k, v, cache, n_heads, layer_idx, cache_len, valid_from,
            scale=scale, alibi_slopes=alibi_slopes)
    if q.device.type != "cuda":
        raise RuntimeError(f"no decode attention kernel for {q.device}")
    n_layers, b, m, nd2 = ckv.shape
    d = nd2 // (2 * n_heads)
    if ckv.dtype != (torch.int8 if int8 else torch.bfloat16) \
            or {k.device, v.device, ckv.device} != {q.device} \
            or (int8 and (scales.dtype != torch.float32
                          or scales.device != q.device)):
        raise TypeError("decode kernel: bf16 q, k, v and a bf16 cache (or an "
                        "int8 cache with fp32 scales) on one device; got "
                        f"{q.dtype}/{ckv.dtype} on {q.device}/{ckv.device}")
    if d not in HEAD_DIMS or nd2 != 2 * n_heads * d:
        raise ValueError(f"decode kernel: needs head dim in {HEAD_DIMS}; got "
                         f"cache {tuple(ckv.shape)} with n={n_heads}")
    alibi = alibi_slopes is not None
    if alibi and d not in ALIBI_HEAD_DIMS:
        raise ValueError(f"decode kernel: ALiBi is built for head dims "
                         f"{ALIBI_HEAD_DIMS}; got {d}")
    q3, k3, v3 = (_heads(t, b, n_heads, d, name)
                  for t, name in ((q, "q"), (k, "k"), (v, "v")))
    if not ckv.is_contiguous() or ckv.data_ptr() % 16 \
            or (int8 and not scales.is_contiguous()):
        raise ValueError("decode kernel: needs contiguous cache leaves, the "
                         "rows at a 16-byte aligned address")
    if not 0 <= layer_idx < n_layers:
        raise IndexError(f"layer {layer_idx} of {n_layers}")
    if scale is None:
        scale = d ** -0.5
    cl = _per_sample(cache_len, b, q.device).contiguous()
    vf = _per_sample(0 if valid_from is None else valid_from, b,
                     q.device).contiguous()
    out = torch.empty(b, n_heads * d, dtype=q.dtype, device=q.device)
    err = _native.library().ymt_decode_attention(
        q3.data_ptr(), q3.stride(0), q3.stride(1),
        k3.data_ptr(), k3.stride(0), k3.stride(1),
        v3.data_ptr(), v3.stride(0), v3.stride(1),
        ckv.data_ptr(), scales.data_ptr() if int8 else None, out.data_ptr(),
        cl.data_ptr(), vf.data_ptr(), b, n_heads, m, layer_idx,
        float(scale), d, int(alibi), int(head_offset), int(n_total),
        _native.stream_handle(q))
    _native.check_launch(err, "ymt_decode_attention")
    counter = ("int8_" if int8 else "") + ("alibi_" if alibi else "") \
        + ("d80_" if d == 80 else "d128_" if d == 128 and not alibi
           else "") + "launches"
    setattr(write_decode_attention, counter,
            getattr(write_decode_attention, counter) + 1)
    return out


write_decode_attention.launches = 0
write_decode_attention.alibi_launches = 0
write_decode_attention.int8_launches = 0
write_decode_attention.int8_alibi_launches = 0
write_decode_attention.d80_launches = 0
write_decode_attention.int8_d80_launches = 0
write_decode_attention.d128_launches = 0
write_decode_attention.int8_d128_launches = 0
