"""Scaled-dot-product attention with an fp32 softmax island.

Counterpart of ``youku_mplug_tpu/ops/attention.py``: ``mha_reference`` is
the plain attention (the decoder's prefill path and the oracle of every
attention kernel), and ``dot_product_attention`` dispatches to the flash
kernel where the JAX package does on its accelerator.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

NEG_INF = torch.finfo(torch.float32).min


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False,
                  kv_len: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention. q, k, v: [B, H, S, D]. fp32 scores and softmax,
    probabilities cast back to q.dtype for PV; returns q.dtype.

    kv_len: optional [B] int tensor — keys at positions >= kv_len are
    masked.  bias: optional additive score bias broadcastable to
    [B, H, Sq, Sk]."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        ki = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(~(qi >= ki), NEG_INF)
    if kv_len is not None:
        ki = torch.arange(k.shape[2], device=q.device)
        s = s.masked_fill(~(ki[None, None, None, :]
                            < kv_len[:, None, None, None]), NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), v)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = False,
                          kv_len: Union[None, int, torch.Tensor] = None,
                          bias: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Dispatched attention. q, k, v: [B, H, S, D].

    Unbiased attention, causal or not, with at least one 128-row query
    block and at most a static ``kv_len`` goes to the flash kernel
    (``flash_attention``; the same rule under which the JAX package uses
    its Pallas kernel, which also requires Sq == Sk when causal).
    Everything else runs ``mha_reference``."""
    use_flash = (bias is None and q.shape[2] >= 128
                 and not isinstance(kv_len, torch.Tensor))
    if use_flash:
        from youku_mplug_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal, kv_len=kv_len,
                               scale=scale)
    if isinstance(kv_len, int):
        kv_len = torch.full((q.shape[0],), kv_len, device=q.device)
    return mha_reference(q, k, v, causal=causal, kv_len=kv_len, bias=bias,
                         scale=scale)
