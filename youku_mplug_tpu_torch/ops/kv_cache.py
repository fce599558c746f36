"""Stacked packed KV cache: bf16 (the compute dtype), or int8 with
per-(token, head) scales.

Counterpart of ``youku_mplug_tpu/ops/kv_cache.py``: one tensor
``[L, B, M, 2*hidden]`` whose rows are the [K | V] lanes the fused qkv
projection emits, so a token's write is one contiguous row.  The int8
cache is the dict ``{"kv": int8 [L, B, M, 2*n*d], "scale": fp32
[L, B, M, 2*n]}`` as in the JAX package: each of the 2n K and V heads of
a row shares one symmetric absmax scale.  Unlike the JAX package
(immutable arrays), writes here update the cache in place, and
``layer_slice`` / ``slot_view`` return views, not copies.

The decode step's per-sample single-token write is fused into the decode
attention kernel (``ops/decode_attention.py``, ``csrc/decode_attention.cu``;
it replaces the JAX package's Pallas ``cache_scatter_write`` and the
``quantize_rows`` that feeds it); :func:`cache_write` is its plain
version and every other write: int8 rows quantize with ``quantize_rows``,
and each leaf takes one indexed assignment in place.
"""

from __future__ import annotations

from typing import Dict, Union

import torch

SCALE_EPS = 1e-8

Cache = Union[torch.Tensor, Dict[str, torch.Tensor]]


def is_quantized(cache: Cache) -> bool:
    return isinstance(cache, dict)


def leaves(cache: Cache):
    """(rows, scales or None) of a bf16 or int8 cache."""
    if is_quantized(cache):
        return cache["kv"], cache["scale"]
    return cache, None


def nbytes(cache: Cache) -> int:
    """Device bytes the cache occupies (both leaves of an int8 cache)."""
    return sum(t.numel() * t.element_size() for t in leaves(cache)
               if t is not None)


def cache_width(cache: Cache, axis: int = 2) -> int:
    """M (token capacity): axis 2 of a stacked [L, B, M, ...] cache, axis 1
    of a per-layer [B, M, ...] slice."""
    return (cache["kv"] if is_quantized(cache) else cache).shape[axis]


def make_cache(num_layers: int, batch: int, max_len: int, hidden: int,
               dtype: torch.dtype, device=None, *, num_heads: int = 0,
               quantized: bool = False) -> Cache:
    """Fresh zeroed cache [L, B, M, 2*hidden]; int8 rows and per-head fp32
    scales [L, B, M, 2*num_heads] when ``quantized``."""
    shape = (num_layers, batch, max_len, 2 * hidden)
    if not quantized:
        return torch.zeros(shape, dtype=dtype, device=device)
    if num_heads <= 0 or hidden % num_heads:
        raise ValueError(f"an int8 cache needs the head count; got "
                         f"num_heads={num_heads} for hidden {hidden}")
    return {"kv": torch.zeros(shape, dtype=torch.int8, device=device),
            "scale": torch.zeros(shape[:3] + (2 * num_heads,),
                                 dtype=torch.float32, device=device)}


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as an IEEE division on every device.  PyTorch's CUDA
    kernels multiply by the reciprocal of a Python-number divisor, which
    differs from ``x / c`` in the last bit for some x; a divisor on x's
    device keeps the division (the JAX package's, and the kernel's)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def quantize_rows(kvp: torch.Tensor, n: int):
    """[..., 2*n*d] float K|V rows -> (int8 rows, fp32 scales [..., 2*n]):
    symmetric per-head absmax, ``scale = max(amax, SCALE_EPS) / 127``,
    rounded half to even and clipped to +-127."""
    g = kvp.unflatten(-1, (2 * n, -1)).float()
    scale = true_div(g.abs().amax(-1).clamp_min(SCALE_EPS), 127.0)
    q = torch.round(g / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8).flatten(-2), scale


def dequantize_rows(kv_rows: torch.Tensor, scales: torch.Tensor, n: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_rows` on [..., 2*n*d] int8 rows with
    [..., 2*n] scales."""
    g = kv_rows.unflatten(-1, (2 * n, -1)).float()
    return (g * scales[..., None]).flatten(-2).to(dtype)


def _write_rows(leaf: torch.Tensor, rows: torch.Tensor, idx, lidx: int):
    """rows [B, S, W] into layer ``lidx`` of ``leaf`` [L, B, M, W] at rows
    idx .. idx+S-1 (``idx`` an int) or idx[b] .. idx[b]+S-1 (a [B] tensor;
    a row that falls outside [0, M) is not written, as the decode kernel
    leaves it), in place."""
    b, s, _ = rows.shape
    if isinstance(idx, int):
        leaf[lidx, :, idx:idx + s] = rows
        return
    pos = idx.to(device=rows.device, dtype=torch.long)[:, None] \
        + torch.arange(s, device=rows.device)
    keep = (pos >= 0) & (pos < leaf.shape[2])
    sample = torch.arange(b, device=rows.device)[:, None].expand(b, s)
    leaf[lidx, sample[keep], pos[keep]] = rows[keep]


def cache_write(cache: Cache, kvp: torch.Tensor,
                idx: Union[int, torch.Tensor], lidx: int) -> Cache:
    """Write the K|V rows ``kvp`` [B, S, 2*hidden] into layer ``lidx`` IN
    PLACE: at rows idx .. idx+S-1 of every sample (``idx`` an int), or at
    rows idx[b] .. idx[b]+S-1 of sample b (``idx`` a [B] tensor).  An int8
    cache quantizes on the way in (:func:`quantize_rows`).  Returns
    ``cache``."""
    if not is_quantized(cache):
        _write_rows(cache, kvp.to(cache.dtype), idx, lidx)
        return cache
    q, scale = quantize_rows(kvp, cache["scale"].shape[-1] // 2)
    _write_rows(cache["kv"], q, idx, lidx)
    _write_rows(cache["scale"], scale, idx, lidx)
    return cache


def layer_slice(cache: Cache, lidx: int) -> Cache:
    """Layer ``lidx`` of the stacked cache, [B, M, ...] (views; the same
    form)."""
    if is_quantized(cache):
        return {k: v[lidx] for k, v in cache.items()}
    return cache[lidx]


def slot_view(cache: Cache, slot: int) -> Cache:
    """Slot ``slot`` of every layer, [L, 1, M, ...] (views; the same
    form): a prefill writes one request's rows through it in place."""
    if is_quantized(cache):
        return {k: v[:, slot:slot + 1] for k, v in cache.items()}
    return cache[:, slot:slot + 1]


def layer_dequant(layer_cache: Cache, n: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """A layer slice -> float [B, M, 2*n*d] rows (the prefill read path;
    the decode kernel dequantizes in registers instead).  A bf16 slice is
    returned as it is."""
    if is_quantized(layer_cache):
        return dequantize_rows(layer_cache["kv"], layer_cache["scale"], n,
                               dtype)
    return layer_cache
