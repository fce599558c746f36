"""Stacked packed KV cache (bf16 or the compute dtype).

Counterpart of ``youku_mplug_tpu/ops/kv_cache.py`` without the int8 form:
one tensor ``[L, B, M, 2*hidden]`` whose rows are the [K | V] lanes the
fused qkv projection emits, so a token's write is one contiguous row.
Unlike the JAX package (immutable arrays), writes here update the cache in
place, and ``layer_slice`` returns a view, not a copy.
"""

from __future__ import annotations

from typing import Union

import torch


def make_cache(num_layers: int, batch: int, max_len: int, hidden: int,
               dtype: torch.dtype, device=None) -> torch.Tensor:
    """Fresh zeroed cache [L, B, M, 2*hidden]."""
    return torch.zeros(num_layers, batch, max_len, 2 * hidden, dtype=dtype,
                       device=device)


def cache_write(cache: torch.Tensor, kvp: torch.Tensor,
                idx: Union[int, torch.Tensor], lidx: int) -> torch.Tensor:
    """Write the K|V rows ``kvp`` [B, S, 2*hidden] into layer ``lidx`` IN
    PLACE: at rows idx .. idx+S-1 of every sample (``idx`` an int), or at
    rows idx[b] .. idx[b]+S-1 of sample b (``idx`` a [B] tensor; one
    indexed assignment).  Returns ``cache``."""
    b, s, _ = kvp.shape
    rows = kvp.to(cache.dtype)
    if isinstance(idx, int):
        cache[lidx, :, idx:idx + s] = rows
    else:
        pos = idx.to(torch.long)[:, None] + torch.arange(s, device=kvp.device)
        cache[lidx, torch.arange(b, device=kvp.device)[:, None], pos] = rows
    return cache


def layer_slice(cache: torch.Tensor, lidx: int) -> torch.Tensor:
    """Layer ``lidx`` of the stacked cache, [B, M, 2*hidden] (a view)."""
    return cache[lidx]
