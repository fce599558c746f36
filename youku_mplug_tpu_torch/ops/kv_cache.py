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

A per-sample single-token write into the stacked int8 cache (the decode
step of the serving engine) goes through ``quantize_scatter_write``: the
CUDA kernel of ``csrc/kv_cache.cu`` on the card (it replaces the JAX
package's Pallas ``cache_scatter_write`` and fuses ``quantize_rows`` into
it), its plain version for CPU tensors.  Every other int8 write quantizes
with ``quantize_rows`` and assigns in place; the bf16 cache keeps one
indexed assignment.
"""

from __future__ import annotations

from typing import Dict, Union

import torch

from youku_mplug_tpu_torch.ops import _native

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
    idx .. idx+S-1 (``idx`` an int) or idx[b] .. idx[b]+S-1 (a [B] tensor),
    in place."""
    b, s, _ = rows.shape
    if isinstance(idx, int):
        leaf[lidx, :, idx:idx + s] = rows
    else:
        pos = idx.to(device=rows.device, dtype=torch.long)[:, None] \
            + torch.arange(s, device=rows.device)
        leaf[lidx, torch.arange(b, device=rows.device)[:, None], pos] = rows


def quantize_scatter_write_plain(cache: Dict[str, torch.Tensor],
                                 rows: torch.Tensor, idx: torch.Tensor,
                                 lidx: int) -> Dict[str, torch.Tensor]:
    """Plain version of the kernel: ``quantize_rows`` of ``rows`` [B, 2nd]
    and one indexed assignment per leaf at row idx[b] of layer ``lidx``."""
    n = cache["scale"].shape[-1] // 2
    q, scale = quantize_rows(rows[:, None], n)
    _write_rows(cache["kv"], q, idx, lidx)
    _write_rows(cache["scale"], scale, idx, lidx)
    return cache


def quantize_scatter_write(cache: Dict[str, torch.Tensor],
                           rows: torch.Tensor, idx: torch.Tensor,
                           lidx: int) -> Dict[str, torch.Tensor]:
    """Quantize one K|V row per sample (``rows`` [B, 2*n*d], any row
    stride) and write it, in place, at row ``idx[b]`` of layer ``lidx`` of
    the stacked int8 cache (both leaves); returns ``cache``.  CPU tensors
    take :func:`quantize_scatter_write_plain`; CUDA tensors launch the
    kernel (bf16 rows, head dim <= 128; an ``idx[b]`` outside [0, M) writes
    nothing there), any other device raises.  ``quantize_scatter_write.
    launches`` counts the kernel's launches."""
    kv, sc = cache["kv"], cache["scale"]
    if rows.device.type == "cpu":
        return quantize_scatter_write_plain(cache, rows, idx, lidx)
    if rows.device.type != "cuda":
        raise RuntimeError(f"no cache-write kernel for {rows.device}")
    n_layers, b, m, nd2 = kv.shape
    n = sc.shape[-1] // 2
    d = nd2 // (2 * n)
    if rows.dtype != torch.bfloat16 or kv.dtype != torch.int8 \
            or sc.dtype != torch.float32 \
            or {kv.device, sc.device, idx.device} != {rows.device}:
        raise TypeError("cache-write kernel: bf16 rows into an int8 cache "
                        "with fp32 scales, on one device; got "
                        f"{rows.dtype}/{kv.dtype}/{sc.dtype}")
    if rows.shape != (b, nd2) or sc.shape != (n_layers, b, m, 2 * n) \
            or nd2 != 2 * n * d or not 0 < d <= 128:
        raise ValueError(f"cache-write kernel: rows [{b}, {nd2}], scales "
                         f"[{n_layers}, {b}, {m}, 2n], head dim <= 128; got "
                         f"rows {tuple(rows.shape)}, scales "
                         f"{tuple(sc.shape)}")
    if not (kv.is_contiguous() and sc.is_contiguous()) \
            or rows.stride(1) != 1:
        raise ValueError("cache-write kernel: needs contiguous cache leaves "
                         f"and contiguous row lanes; got row strides "
                         f"{rows.stride()}")
    if not 0 <= lidx < n_layers:
        raise IndexError(f"layer {lidx} of {n_layers}")
    pos = idx.to(torch.int32).reshape(b).contiguous()
    err = _native.library().ymt_quantize_scatter_write(
        rows.data_ptr(), rows.stride(0), kv.data_ptr(), sc.data_ptr(),
        pos.data_ptr(), lidx, b, m, n, d, _native.stream_handle(rows))
    _native.check_launch(err, "ymt_quantize_scatter_write")
    quantize_scatter_write.launches += 1
    return cache


quantize_scatter_write.launches = 0


def cache_write(cache: Cache, kvp: torch.Tensor,
                idx: Union[int, torch.Tensor], lidx: int) -> Cache:
    """Write the K|V rows ``kvp`` [B, S, 2*hidden] into layer ``lidx`` IN
    PLACE: at rows idx .. idx+S-1 of every sample (``idx`` an int), or at
    rows idx[b] .. idx[b]+S-1 of sample b (``idx`` a [B] tensor).  An int8
    cache quantizes on the way in: a per-sample single-token write through
    :func:`quantize_scatter_write`, any other write with
    :func:`quantize_rows` and an assignment.  Returns ``cache``."""
    if not is_quantized(cache):
        _write_rows(cache, kvp.to(cache.dtype), idx, lidx)
        return cache
    if not isinstance(idx, int) and kvp.shape[1] == 1:
        return quantize_scatter_write(cache, kvp[:, 0], idx, lidx)
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
