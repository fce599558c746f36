"""Flash attention forward on a hand-written Hopper kernel.

Counterpart of ``youku_mplug_tpu/ops/flash_attention.py`` (forward only).
Two public wrappers share one strided CUDA kernel
(``csrc/flash_fwd.cu``), because the packed ``[B, S, n*d]`` layout is only
a strided view of ``[B, S, n, d]``:

- ``flash_attention_packed`` replaces ``_fwd_kernel_packed`` (the vision
  tower's spatial attention, mask mode none, and its grouped temporal
  attention, mask mode ``period``);
- ``flash_attention`` replaces ``_fwd_kernel`` (head-major ``[B, H, S, D]``
  with a static ``kv_len``; AttentionPool's cross-attention).

Each wrapper runs its plain PyTorch version (``*_plain``) for CPU
tensors and launches the kernel for CUDA tensors, or raises; it never
falls back.  ``<wrapper>.launches`` counts kernel launches.  Causal masks,
ALiBi and the backward kernels belong to the training slice and are not
here.
"""

from __future__ import annotations

from typing import Optional

import torch

from youku_mplug_tpu_torch.ops import _native

HEAD_DIM = 64  # the one head width the kernel is built for


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, period: int = 0,
                    kv_len: Optional[int] = None):
    """Plain version of the kernel. q [B,H,Sq,D], k/v [B,H,Sk,D] ->
    (o [B,H,Sq,D] in q.dtype, lse [B,H,Sq] fp32).  Keys at or past
    ``kv_len`` are masked; ``period > 0`` keeps only keys with
    ``qi // period == ki // period``."""
    sq, sk = q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    ki = torch.arange(sk, device=q.device)
    allowed = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if kv_len is not None:
        allowed = allowed & (ki < kv_len)[None, :]
    if period > 0:
        qi = torch.arange(sq, device=q.device)
        allowed = allowed & ((qi[:, None] // period)
                             == (ki[None, :] // period))
    s = s.masked_fill(~allowed, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), v)
    return o, lse


def _check_operand(name: str, t: torch.Tensor, device) -> None:
    if t.device != device or t.dtype != torch.bfloat16:
        raise TypeError(f"flash kernel: {name} must be bf16 on {device}; got "
                        f"{t.dtype} on {t.device}")
    if t.shape[-1] != HEAD_DIM:
        raise ValueError(f"flash kernel: head dim must be {HEAD_DIM}; got "
                         f"{t.shape[-1]}")
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]) \
            or t.data_ptr() % 16:
        raise ValueError(f"flash kernel: {name} needs a contiguous head dim, "
                         f"16-byte aligned rows; got strides {t.stride()}")


def flash_fwd_cuda(q, k, v, o, *, scale: float, period: int = 0,
                   kv_len: Optional[int] = None) -> torch.Tensor:
    """Launch the kernel on [B,H,S,64] views (any batch/head/sequence
    strides), writing ``o`` in place.  Returns the fp32 lse [B,H,Sq]."""
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o)):
        _check_operand(name, t, q.device)
    if k.shape != (b, h, sk, HEAD_DIM) or v.shape != k.shape \
            or o.shape != q.shape:
        raise ValueError(f"flash kernel: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} o "
                         f"{tuple(o.shape)}")
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return lse
    kv = sk if kv_len is None else min(int(kv_len), sk)
    strides = [s for t in (q, k, v, o) for s in
               (t.stride(0), t.stride(1), t.stride(2))]
    err = _native.library().ymt_flash_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, h, sq, sk, kv, *strides, float(scale),
        int(period), _native.stream_handle(q))
    _native.check_launch(err, "ymt_flash_fwd_bf16")
    return lse


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise RuntimeError(f"no attention kernel for device {t.device}")


def flash_attention_packed_plain(q, k, v, n_heads: int, *, period: int = 0,
                                 scale: Optional[float] = None):
    """Plain version of ``flash_attention_packed`` (same arguments)."""
    b, sq, nd = q.shape
    d = nd // n_heads
    q4, k4, v4 = (t.unflatten(-1, (n_heads, d)).transpose(1, 2)
                  for t in (q, k, v))
    o4, _ = flash_fwd_plain(q4, k4, v4, scale=scale or d ** -0.5,
                            period=period)
    return o4.transpose(1, 2).reshape(b, sq, nd)


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           n_heads: int, *, period: int = 0,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Non-causal attention over packed [B, S, n_heads*d] q/k/v (views of
    a wider projection are fine); ``period > 0`` is the block-diagonal
    mask of the grouped temporal attention.  Returns [B, Sq, n_heads*d]."""
    if _on_cpu(q):
        return flash_attention_packed_plain(q, k, v, n_heads, period=period,
                                            scale=scale)
    b, sq, nd = q.shape
    d = nd // n_heads
    q4, k4, v4 = (t.unflatten(-1, (n_heads, d)).transpose(1, 2)
                  for t in (q, k, v))
    out = torch.empty(b, sq, nd, dtype=q.dtype, device=q.device)
    flash_fwd_cuda(q4, k4, v4, out.unflatten(-1, (n_heads, d)).transpose(1, 2),
                   scale=scale or d ** -0.5, period=period)
    flash_attention_packed.launches += 1
    return out


flash_attention_packed.launches = 0


def flash_attention_plain(q, k, v, *, kv_len: Optional[int] = None,
                          scale: Optional[float] = None):
    """Plain version of ``flash_attention`` (same arguments)."""
    return flash_fwd_plain(q, k, v, scale=scale or q.shape[-1] ** -0.5,
                           kv_len=kv_len)[0]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    kv_len: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Non-causal attention over head-major [B, H, S, D] (any strides with
    a contiguous D).  ``kv_len`` (static int): keys at or past it are
    masked.  Returns [B, H, Sq, D]."""
    if _on_cpu(q):
        return flash_attention_plain(q, k, v, kv_len=kv_len, scale=scale)
    b, h, sq, d = q.shape
    # [B, Sq, H, D] storage: callers merge heads back with a free reshape
    out = torch.empty(b, sq, h, d, dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    flash_fwd_cuda(q, k, v, out, scale=scale or d ** -0.5, kv_len=kv_len)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
