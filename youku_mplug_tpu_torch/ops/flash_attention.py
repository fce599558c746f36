"""Flash attention, forward and backward, on hand-written Hopper kernels.

Counterpart of ``youku_mplug_tpu/ops/flash_attention.py``.  Three strided
CUDA kernels serve both public wrappers, because the packed
``[B, S, n*d]`` layout is only a strided view of ``[B, S, n, d]``:

- the forward (``csrc/flash_fwd.cu``) replaces ``_fwd_kernel_packed``
  (mask modes none, ``period`` and causal, the last optionally with the
  ALiBi bias: the vision tower's spatial and grouped temporal attention,
  the decoders' training attention) and ``_fwd_kernel`` (head-major
  ``[B, H, S, D]``, static ``kv_len``, causal; AttentionPool's
  cross-attention);
- the backward (``csrc/flash_bwd.cu``: a dq kernel and a dk/dv kernel,
  the latter with a short-query form for AttentionPool's 128 queries at
  head dim 96) replaces ``_bwd_dq_kernel[_packed]`` and
  ``_bwd_dkv_kernel[_packed]``, the FlashAttention-2 recipe with p
  rebuilt from (q, k, lse); a small kernel before them computes delta =
  rowsum(dO * O), which the JAX package leaves to XLA.

Each kernel is built for head dim 64 and 128, with and without ALiBi, and
for head dims 80, 88 and 96 without it (the GPT-3 2.7B decoder's 32 heads
of 80, EVA-ViT-g's AttentionPool, 16 heads of 88, and clip-b16's, 8 heads
of 96), the forward and the backward alike on tiles D wide (at 80, 88 and
96 a 128-byte panel and a 16- or 32-column tail panel, ``csrc/hopper.cuh``;
at 88 the tail's last 8 columns are zeros in shared memory, so q, k and v
go in at their own width).
Where the (64-row query tile, head, batch) blocks are too few to fill the
card (AttentionPool's 128 queries over 1570 keys while serving), the
forward splits each block's key tiles ``kv_splits`` ways into fp32
scratch that the wrapper allocates, and a second small kernel merges the
shares by their lse.  The backward takes no split.
``packed_supported`` copies the JAX package's rule for the head
geometries its packed kernel takes, which the vision tower and the GPT-3
decoder follow.
ALiBi (``alibi_slopes``: any fp32 per-head values, as the JAX flash takes
them) adds ``slope_h * key_index`` in fp32 to the scaled score before the
mask, in the forward and when the backward rebuilds p; it requires
``causal``.
At head dim 64 without ALiBi (``F32_OUT_HEAD_DIMS``) each kernel has a
second build that writes its output in fp32: ``flash_fwd_cuda``,
``flash_bwd_dq_cuda`` and ``flash_bwd_dkv_cuda`` take it when handed fp32
output tensors (ring attention's per-block partials, merged in fp32 and
rounded once, ``parallel/ring_attention.py``); fp32 outputs at another
head dim raise.  The plain versions take the same ``out_dtype``.

Both wrappers go through a ``torch.autograd.Function`` that saves
(q, k, v, o, lse) where a gradient is wanted.  Each runs its
plain PyTorch version (``flash_fwd_plain``, ``flash_bwd_plain``) for CPU
tensors and launches the kernels for CUDA tensors, or raises; it never
falls back.  ``<wrapper>.launches`` counts kernel launches at head dim
64 without ALiBi, ``<wrapper>.d80_launches``, ``<wrapper>.d88_launches``,
``<wrapper>.d96_launches`` and ``<wrapper>.d128_launches`` those at head
dim 80, 88, 96 and 128 (the GPT-3 13B decoder's),
``flash_bwd_dq_cuda.f32_launches`` and ``flash_bwd_dkv_cuda.f32_launches``
those of the fp32-output builds (the forward's count in the ring's own
``ring_attention.launches``), and
``<wrapper>.alibi_launches`` those with ALiBi: ``flash_attention_packed``
and ``flash_attention`` the forward's, ``flash_bwd_dq_cuda`` and
``flash_bwd_dkv_cuda`` the backward's; ``flash_bwd_dkv_cuda.
d96_short_launches`` counts, of its launches at 96, those of the
short-query dk/dv kernel (``dkv_short_splits``), and
``flash_bwd_delta_cuda.launches`` those of the backward's delta kernel
(rowsum(dO * O), one a backward at every head dim).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from youku_mplug_tpu_torch.ops import _native

HEAD_DIMS = (64, 80, 88, 96, 128)  # the head widths the kernels are built for
ALIBI_HEAD_DIMS = (64, 128)  # ... and with the ALiBi bias
TILE = 64  # rows of a query or key tile in the kernels
SMS = 132  # the H100's streaming multiprocessors, where no card is asked
# forward blocks resident on one streaming multiprocessor, by head dim:
# at d 64 registers allow 4 (41 KB of shared memory would allow 5); at
# d 80 the D-wide tiles' 51 KB allow 4 and the build is capped at 128
# registers so that they fit; at d 96 the build's cap of 168 registers
# allows 3 (its 49 KB would allow 4), and d 88 on d 96's tiles the same;
# at d 128, 81 KB, 2.  chip_smoke.py holds these against the card's own
# count (fwd_blocks_per_sm)
FWD_BLOCKS_PER_SM = {64: 4, 80: 4, 88: 3, 96: 3, 128: 2}
# the backward's blocks resident on one multiprocessor, by head dim: (dq,
# dk/dv, short-query dk/dv; None where that kernel is not built).  At d 80,
# 88 and 96 the dq build is capped at 168 registers so that 3 of its 61 or
# 73 KB blocks fit, at d 64 at 128 for 4; the dk/dv builds hold 168-255
# registers a thread, 3 blocks at d 64 and 2 elsewhere.  chip_smoke.py
# holds these against the card's own count (bwd_blocks_per_sm)
BWD_BLOCKS_PER_SM = {64: (4, 3, None), 80: (3, 2, None), 88: (3, 2, None),
                     96: (3, 2, 2), 128: (2, 2, None)}
SHORT_HEAD_DIMS = (96,)  # the short-query dk/dv kernel's build
# the fp32-output builds' blocks on one multiprocessor, by head dim:
# (forward, dq, dk/dv), the bf16 builds' counts (the same tiles; only the
# epilogue's stores differ).  chip_smoke.py holds these against the
# card's own count (f32_out_blocks_per_sm)
F32_OUT_BLOCKS_PER_SM = {64: (4, 4, 3)}
# the head dims of the builds that write their output in fp32 (the
# forward's o, the backward's dq, dk and dv; without ALiBi): ring
# attention's per-block partials, merged in fp32 and rounded once
F32_OUT_HEAD_DIMS = tuple(F32_OUT_BLOCKS_PER_SM)
SHORT_SQ = 2 * TILE  # ... which keeps at most this many queries resident
# key tiles a short-query dk/dv block walks, at most: its share of a
# (head, batch)'s key tiles (2-6, 8, 16 and all measured on the H100,
# PERF.md: 3 and 4 fastest, 3 by 2% at ITM train)
SHORT_TILES_PER_BLOCK = 3
MIN_TILES_PER_SPLIT = 4  # a share shorter than this is not worth a merge


def packed_supported(n_heads: int, head_dim: int) -> bool:
    """The head geometries the JAX package's packed kernel takes (its
    ``packed_supported``): a head dim that is a multiple of 128, or one
    that divides 128 with the heads filling whole 128-lane strips.  The
    vision tower and the GPT-3 decoder run the packed kernel only there;
    elsewhere, as in the JAX package, clip-b16's 8 heads of 96 run einsum
    attention and the 2.7B decoder's 32 heads of 80 go through
    ``dot_product_attention``."""
    if head_dim % 128 == 0:
        return True
    return 128 % head_dim == 0 and n_heads % (128 // head_dim) == 0


def kv_splits(b: int, h: int, sq: int, sk: int, *, head_dim: int = 64,
              causal: bool = False, period: int = 0,
              kv_len: Optional[int] = None, sms: int = SMS) -> int:
    """How many ways the forward kernel splits each block's key tiles:
    as many as keep the (query tile, head, batch, split) blocks within one
    wave of the card (``sms`` times the forward's resident blocks at
    ``head_dim``; a second, partial wave costs more than the split saves),
    each share at least MIN_TILES_PER_SPLIT key tiles.  1 for causal and
    period masks, whose blocks see few tiles."""
    if causal or period > 0:
        return 1
    blocks = -(-sq // TILE) * h * b
    tiles = -(-_kv(kv_len, sk) // TILE)
    wave = FWD_BLOCKS_PER_SM[head_dim] * sms
    return max(1, min(wave // blocks, tiles // MIN_TILES_PER_SPLIT))


def fwd_blocks_per_sm(head_dim: int, alibi: bool = False) -> int:
    """The forward build's resident blocks on one multiprocessor of the
    current card (cudaOccupancyMaxActiveBlocksPerMultiprocessor at its
    threads and dynamic shared memory); builds the kernels if needed."""
    blocks = ctypes.c_int()
    err = _native.library().ymt_flash_fwd_blocks_per_sm(
        int(head_dim), int(alibi), ctypes.byref(blocks))
    _native.check_launch(err, "ymt_flash_fwd_blocks_per_sm")
    return blocks.value


def dkv_short_splits(b: int, h: int, sq: int, sk: int, *, head_dim: int,
                     causal: bool = False, period: int = 0,
                     alibi: bool = False) -> int:
    """How the dk/dv backward runs: 0 for the key-tile kernel (one block
    per 64-key tile, the query tiles streaming), n > 0 for the short-query
    kernel with each (head, batch)'s key tiles split n ways (every query
    resident, the key tiles streaming; head dim 96 without ALiBi,
    Sq <= SHORT_SQ, no causal or period mask: AttentionPool's 128
    queries), each share at most SHORT_TILES_PER_BLOCK key tiles."""
    if (head_dim not in SHORT_HEAD_DIMS or sq > SHORT_SQ or causal
            or period > 0 or alibi):
        return 0
    tiles = -(-sk // TILE)
    return -(-tiles // SHORT_TILES_PER_BLOCK)


def f32_out_blocks_per_sm(head_dim: int) -> tuple:
    """The fp32-output builds' resident blocks on one multiprocessor of
    the current card, as ``fwd_blocks_per_sm`` counts them: (forward, dq,
    dk/dv); builds the kernels if needed."""
    lib, counts = _native.library(), []
    for kind in ("fwd", 0, 1):
        blocks = ctypes.c_int()
        if kind == "fwd":
            err = lib.ymt_flash_fwd_f32out_blocks_per_sm(
                int(head_dim), ctypes.byref(blocks))
        else:
            err = lib.ymt_flash_bwd_f32out_blocks_per_sm(
                int(head_dim), kind, ctypes.byref(blocks))
        _native.check_launch(err, "f32out blocks_per_sm")
        counts.append(blocks.value)
    return tuple(counts)


def bwd_blocks_per_sm(head_dim: int, alibi: bool = False) -> tuple:
    """The backward builds' resident blocks on one multiprocessor of the
    current card, as ``fwd_blocks_per_sm`` counts them: (dq, dk/dv,
    short-query dk/dv, None where that kernel is not built); builds the
    kernels if needed."""
    lib, counts = _native.library(), []
    short = head_dim in SHORT_HEAD_DIMS and not alibi
    for kind in (0, 1, 2) if short else (0, 1):
        blocks = ctypes.c_int()
        err = lib.ymt_flash_bwd_blocks_per_sm(int(head_dim), int(alibi),
                                              kind, ctypes.byref(blocks))
        _native.check_launch(err, "ymt_flash_bwd_blocks_per_sm")
        counts.append(blocks.value)
    return tuple(counts) + (() if short else (None,))


def split_scratch_shapes(b: int, h: int, sq: int, d: int, splits: int):
    """The fp32 scratch of a split forward: (o partials [splits, B, H,
    Sq, D], lse partials [splits, B, H, Sq]); None for one split."""
    if splits == 1:
        return None
    return (splits, b, h, sq, d), (splits, b, h, sq)


@functools.lru_cache(maxsize=None)
def _device_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _allowed(sq: int, sk: int, *, causal: bool, period: int,
             kv_len: Optional[int], device) -> torch.Tensor:
    """[Sq, Sk] bool: the keys each query may see."""
    qi = torch.arange(sq, device=device)[:, None]
    ki = torch.arange(sk, device=device)[None, :]
    allowed = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if kv_len is not None:
        allowed = allowed & (ki < kv_len)
    if period > 0:
        allowed = allowed & ((qi // period) == (ki // period))
    if causal:
        allowed = allowed & (ki <= qi)
    return allowed


def _scores(q, k, scale: float, alibi_slopes) -> torch.Tensor:
    """fp32 [B, H, Sq, Sk] scaled scores, plus slope_h * key_index."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes, dtype=torch.float32,
                                 device=q.device)
        ki = torch.arange(k.shape[2], device=q.device, dtype=torch.float32)
        s = s + slopes[:, None, None] * ki
    return s


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = False, period: int = 0,
                    kv_len: Optional[int] = None, alibi_slopes=None,
                    out_dtype: Optional[torch.dtype] = None):
    """Plain version of the forward kernel. q [B,H,Sq,D], k/v [B,H,Sk,D]
    -> (o [B,H,Sq,D] in q.dtype, lse [B,H,Sq] fp32).  Keys at or past
    ``kv_len`` are masked; ``period > 0`` keeps only keys with
    ``qi // period == ki // period``; ``causal`` keeps ``ki <= qi``;
    ``alibi_slopes`` [H] adds ``slope_h * ki`` before the mask.
    ``out_dtype`` fp32 (the fp32-output build): p still goes to q.dtype
    before P V, as in the kernel, and o leaves the fp32 sum unrounded."""
    s = _scores(q, k, scale, alibi_slopes)
    allowed = _allowed(q.shape[2], k.shape[2], causal=causal, period=period,
                       kv_len=kv_len, device=q.device)
    s = s.masked_fill(~allowed, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    if out_dtype is None or out_dtype == q.dtype:
        return torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), v), lse
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype).float(), v.float())
    return o.to(out_dtype), lse


def flash_bwd_delta_plain(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Plain version of the delta kernel: rowsum(dO * O) in fp32,
    [B, H, Sq] contiguous (the JAX package's ``_bwd`` computes it so)."""
    return (do.float() * o.float()).sum(-1).contiguous()


def flash_bwd_plain(q, k, v, o, lse, do, *, scale: float,
                    causal: bool = False, period: int = 0,
                    kv_len: Optional[int] = None, alibi_slopes=None,
                    out_dtype: Optional[torch.dtype] = None):
    """Plain version of the backward kernels (the FlashAttention-2 recipe,
    ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``): p = exp(s - lse) with the
    forward's bias in s, dp = dO V^T, dS = p * (dp - delta) * scale with
    delta = rowsum(dO * O) in fp32; p and dS are cast to the input dtype
    before their products, which accumulate in fp32.  Same layouts, masks
    and ALiBi as ``flash_fwd_plain``; returns (dq, dk, dv) in the input
    dtypes, or in ``out_dtype`` (fp32: the fp32-output builds' sums,
    unrounded)."""
    dt = q.dtype
    allowed = _allowed(q.shape[2], k.shape[2], causal=causal, period=period,
                       kv_len=kv_len, device=q.device)
    s = _scores(q, k, scale, alibi_slopes)
    p = torch.where(allowed, torch.exp(s - lse[..., None]), 0.0)
    delta = flash_bwd_delta_plain(o, do)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = p * (dp - delta[..., None]) * scale
    p_in, ds_in = p.to(dt).float(), ds.to(dt).float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p_in, do.float())
    dq = torch.einsum("bhqk,bhkd->bhqd", ds_in, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds_in, q.float())
    if out_dtype is not None:
        return dq.to(out_dtype), dk.to(out_dtype), dv.to(out_dtype)
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype)


def _check_operand(name: str, t: torch.Tensor, device,
                   f32_ok: bool = False) -> None:
    """A bf16 operand on ``device`` (with ``f32_ok`` an output, which may
    be fp32: the fp32-output builds) at a built head dim, strided as the
    kernels read it."""
    if t.device != device or not (t.dtype == torch.bfloat16 or (
            f32_ok and t.dtype == torch.float32)):
        raise TypeError(f"flash kernel: {name} must be bf16 on {device}; got "
                        f"{t.dtype} on {t.device}")
    if t.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash kernel: head dim must be one of "
                         f"{HEAD_DIMS}; got {t.shape[-1]}")
    if not _strides_ok(t):
        raise ValueError(f"flash kernel: {name} needs a contiguous head dim, "
                         f"16-byte aligned rows; got strides {t.stride()}")


def _strides_ok(t: torch.Tensor) -> bool:
    return (t.stride(-1) == 1 and not any(s % 8 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def _check_shapes(q, k, v, *outs, causal: bool) -> None:
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(f"flash kernel: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if causal and sq != sk:
        raise ValueError("causal flash attention requires Sq == Sk")
    for t, like in outs:
        if t.shape != like.shape:
            raise ValueError(f"flash kernel: output {tuple(t.shape)} != "
                             f"{tuple(like.shape)}")


def _slopes_ptr(alibi_slopes, q: torch.Tensor, causal: bool):
    """The kernels' slopes argument: None, or the address of an fp32
    contiguous [H] tensor on q's device."""
    if alibi_slopes is None:
        return None
    if not causal:
        raise ValueError("ALiBi flash attention requires causal")
    if q.shape[-1] not in ALIBI_HEAD_DIMS:
        raise ValueError(f"flash kernel: ALiBi is built for head dims "
                         f"{ALIBI_HEAD_DIMS}; got {q.shape[-1]}")
    h = q.shape[1]
    if not (isinstance(alibi_slopes, torch.Tensor)
            and alibi_slopes.dtype == torch.float32
            and alibi_slopes.device == q.device
            and alibi_slopes.shape == (h,) and alibi_slopes.is_contiguous()):
        raise ValueError(f"flash kernel: alibi_slopes must be a contiguous "
                         f"fp32 [{h}] tensor on {q.device}")
    return alibi_slopes.data_ptr()


def _strides(*ts) -> list:
    return [s for t in ts for s in (t.stride(0), t.stride(1), t.stride(2))]


def _f32_out(outs, head_dim: int, alibi_slopes, what: str) -> bool:
    """Whether the outputs ``outs`` ask for an fp32-output build (all fp32;
    bf16 and fp32 mixed raise), which exists at F32_OUT_HEAD_DIMS without
    ALiBi: another head dim raises a ValueError naming it, never a bf16
    launch in its place."""
    kinds = {t.dtype for t in outs}
    if kinds == {torch.bfloat16}:
        return False
    if kinds != {torch.float32}:
        raise TypeError(f"flash kernel: {what} outputs mix dtypes {kinds}")
    if head_dim not in F32_OUT_HEAD_DIMS or alibi_slopes is not None:
        raise ValueError(f"flash kernel: fp32 {what} output is built at head "
                         f"dims {F32_OUT_HEAD_DIMS} without ALiBi; got head "
                         f"dim {head_dim}"
                         + (" with ALiBi" if alibi_slopes is not None
                            else ""))
    return True


def _kv(kv_len: Optional[int], sk: int) -> int:
    return sk if kv_len is None else min(int(kv_len), sk)


def _count(fn, alibi_slopes, head_dim: int) -> None:
    if alibi_slopes is not None:
        fn.alibi_launches += 1
    elif head_dim == 80:
        fn.d80_launches += 1
    elif head_dim == 88:
        fn.d88_launches += 1
    elif head_dim == 96:
        fn.d96_launches += 1
    elif head_dim == 128:
        fn.d128_launches += 1
    else:
        fn.launches += 1


def _scratch(shape, device) -> Optional[torch.Tensor]:
    return None if shape is None else torch.empty(
        shape, dtype=torch.float32, device=device)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def flash_fwd_cuda(q, k, v, o, *, scale: float, causal: bool = False,
                   period: int = 0, kv_len: Optional[int] = None,
                   alibi_slopes: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Launch the forward kernel on [B,H,S,D] views, D 64, 80, 88, 96 or 128 (any
    batch/head/sequence strides), writing ``o`` in place: bf16, or fp32
    (the fp32-output build, at F32_OUT_HEAD_DIMS without ALiBi).  Returns
    the fp32 lse [B,H,Sq]."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q.device)
    _check_operand("o", o, q.device, f32_ok=True)
    _check_shapes(q, k, v, (o, q), causal=causal)
    entry = ("ymt_flash_fwd_f32out" if _f32_out((o,), d, alibi_slopes,
                                                "forward")
             else "ymt_flash_fwd_bf16")
    slopes = _slopes_ptr(alibi_slopes, q, causal)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return lse
    splits = kv_splits(b, h, sq, sk, head_dim=d, causal=causal,
                       period=period, kv_len=kv_len,
                       sms=_device_sms(q.device.index))
    o_part, lse_part = (_scratch(t, q.device) for t in split_scratch_shapes(
        b, h, sq, d, splits) or (None, None))
    err = getattr(_native.library(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, h, sq, sk, _kv(kv_len, sk), *_strides(q, k, v, o),
        float(scale), int(period), int(causal), d, slopes, splits,
        _ptr(o_part), _ptr(lse_part), _native.stream_handle(q))
    _native.check_launch(err, entry)
    return lse


def _check_bwd(q, k, v, do, lse, delta, grads, causal):
    """``grads``: (gradient, the operand whose shape it has) pairs."""
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        _check_operand(name, t, q.device)
    for t, _ in grads:
        _check_operand("gradient", t, q.device, f32_ok=True)
    b, h, sq, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.shape != (b, h, sq) \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"flash kernel: {name} must be contiguous fp32 "
                             f"{(b, h, sq)}; got {t.dtype} "
                             f"{tuple(t.shape)}")
    _check_shapes(q, k, v, (do, q), *grads, causal=causal)


def flash_bwd_delta_cuda(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Launch the delta kernel on [B,H,Sq,D] views (the backward's
    preprocessing): returns rowsum(dO * O) in fp32, [B, H, Sq]
    contiguous."""
    for name, t in (("o", o), ("do", do)):
        _check_operand(name, t, o.device)
    if do.shape != o.shape:
        raise ValueError(f"flash kernel: do {tuple(do.shape)} != o "
                         f"{tuple(o.shape)}")
    b, h, sq, d = o.shape
    delta = torch.empty(b, h, sq, dtype=torch.float32, device=o.device)
    if delta.numel() == 0:
        return delta
    err = _native.library().ymt_flash_bwd_delta_bf16(
        o.data_ptr(), do.data_ptr(), delta.data_ptr(), b, h, sq,
        *_strides(o, do), d, _native.stream_handle(o))
    _native.check_launch(err, "ymt_flash_bwd_delta_bf16")
    flash_bwd_delta_cuda.launches += 1
    return delta


flash_bwd_delta_cuda.launches = 0


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, dq, *, scale: float,
                      causal: bool = False, period: int = 0,
                      kv_len: Optional[int] = None,
                      alibi_slopes: Optional[torch.Tensor] = None) -> None:
    """Launch the dq kernel (one block per 64-query tile, looping over
    key tiles), writing ``dq`` [B,H,Sq,D] in place (bf16, or fp32: the
    fp32-output build, at F32_OUT_HEAD_DIMS without ALiBi)."""
    _check_bwd(q, k, v, do, lse, delta, ((dq, q),), causal)
    slopes = _slopes_ptr(alibi_slopes, q, causal)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    entry = ("ymt_flash_bwd_dq_f32out" if _f32_out((dq,), d, alibi_slopes,
                                                   "dq")
             else "ymt_flash_bwd_dq_bf16")
    err = getattr(_native.library(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, sq, sk,
        _kv(kv_len, sk), *_strides(q, k, v, do, dq), float(scale),
        int(period), int(causal), d, slopes, _native.stream_handle(q))
    _native.check_launch(err, entry)
    if entry == "ymt_flash_bwd_dq_f32out":
        flash_bwd_dq_cuda.f32_launches += 1
    else:
        _count(flash_bwd_dq_cuda, alibi_slopes, d)


flash_bwd_dq_cuda.launches = 0
flash_bwd_dq_cuda.d80_launches = 0
flash_bwd_dq_cuda.d88_launches = 0
flash_bwd_dq_cuda.d96_launches = 0
flash_bwd_dq_cuda.d128_launches = 0
flash_bwd_dq_cuda.f32_launches = 0  # the fp32-output build's
flash_bwd_dq_cuda.alibi_launches = 0


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, dk, dv, *, scale: float,
                       causal: bool = False, period: int = 0,
                       kv_len: Optional[int] = None,
                       alibi_slopes: Optional[torch.Tensor] = None) -> None:
    """Launch the dk/dv kernel (one block per 64-key tile, looping over
    query tiles; or, where ``dkv_short_splits`` says so, the short-query
    kernel: a block per share of a (head, batch)'s key tiles, every query
    resident), writing ``dk`` and ``dv`` [B,H,Sk,D] in place (bf16, or
    both fp32: the fp32-output build of the key-tile kernel, at
    F32_OUT_HEAD_DIMS without ALiBi)."""
    _check_bwd(q, k, v, do, lse, delta, ((dk, k), (dv, v)), causal)
    b, h, sq, d = q.shape
    _launch_dkv(q, k, v, do, lse, delta, dk, dv, scale=scale, causal=causal,
                period=period, kv_len=kv_len, alibi_slopes=alibi_slopes,
                splits=dkv_short_splits(
                    b, h, sq, k.shape[2], head_dim=d, causal=causal,
                    period=period, alibi=alibi_slopes is not None))


def _launch_dkv(q, k, v, do, lse, delta, dk, dv, *, scale, causal, period,
                kv_len, alibi_slopes, splits: int) -> None:
    """The dk/dv launch on checked operands: the key-tile kernel at
    ``splits`` 0, else the short-query kernel split that many ways (the
    C entry refuses a call it cannot take).  ``cli/profile_flash.py``
    passes 0 to time the key-tile kernel where the short-query one
    runs."""
    slopes = _slopes_ptr(alibi_slopes, q, causal)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    f32 = _f32_out((dk, dv), d, alibi_slopes, "dk/dv")
    if f32 and splits:
        raise ValueError("flash kernel: the short-query dk/dv kernel has no "
                         "fp32-output build")
    entry = "ymt_flash_bwd_dkv_f32out" if f32 else "ymt_flash_bwd_dkv_bf16"
    err = getattr(_native.library(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h,
        sq, sk, _kv(kv_len, sk), *_strides(q, k, v, do, dk, dv),
        float(scale), int(period), int(causal), d, slopes, int(splits),
        _native.stream_handle(q))
    _native.check_launch(err, entry)
    if f32:
        flash_bwd_dkv_cuda.f32_launches += 1
    else:
        _count(flash_bwd_dkv_cuda, alibi_slopes, d)
    if splits:
        flash_bwd_dkv_cuda.d96_short_launches += 1


flash_bwd_dkv_cuda.launches = 0
flash_bwd_dkv_cuda.d80_launches = 0
flash_bwd_dkv_cuda.d88_launches = 0
flash_bwd_dkv_cuda.d96_launches = 0
flash_bwd_dkv_cuda.d128_launches = 0
flash_bwd_dkv_cuda.f32_launches = 0  # the fp32-output build's
flash_bwd_dkv_cuda.alibi_launches = 0
# ... and of those at head dim 96, the short-query kernel's
flash_bwd_dkv_cuda.d96_short_launches = 0


@functools.lru_cache(maxsize=None)
def _side_stream(index: int) -> "torch.cuda.Stream":
    return torch.cuda.Stream(device=index)


def _head_major_empty(like: torch.Tensor) -> torch.Tensor:
    """An uninitialised [B, H, S, D] tensor in [B, S, H, D] storage: callers
    merge heads back (or autograd un-transposes the gradient) for free."""
    b, h, s, d = like.shape
    return torch.empty(b, s, h, d, dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def flash_bwd_cuda(q, k, v, o, lse, do, *, scale: float,
                   causal: bool = False, period: int = 0,
                   kv_len: Optional[int] = None,
                   alibi_slopes: Optional[torch.Tensor] = None):
    """The backward on the card: the delta kernel (rowsum(dO * O) in fp32,
    which the JAX package leaves to XLA), then the dq kernel and, at the
    same time, the dk/dv kernel on a side stream (it waits for the
    caller's stream, which then waits for it), so that each fills the
    other's last partial wave of blocks.  Returns (dq, dk, dv) in
    [B, S, H, D] storage."""
    if not _strides_ok(do):
        do = do.contiguous()
    delta = flash_bwd_delta_cuda(o, do)
    dq, dk, dv = (_head_major_empty(t) for t in (q, k, v))
    kw = dict(scale=scale, causal=causal, period=period, kv_len=kv_len,
              alibi_slopes=alibi_slopes)
    main = torch.cuda.current_stream(q.device)
    side = _side_stream(q.device.index)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        flash_bwd_dkv_cuda(q, k, v, do, lse, delta, dk, dv, **kw)
    flash_bwd_dq_cuda(q, k, v, do, lse, delta, dq, **kw)
    # every later use of these tensors, or of their memory once freed,
    # is ordered after the side stream's work by this wait
    main.wait_stream(side)
    return dq, dk, dv


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise RuntimeError(f"no attention kernel for device {t.device}")


class _Flash(torch.autograd.Function):
    """Attention over [B, H, S, D] views with the flash backward.  Saves
    (q, k, v, o, lse); the plain versions run for CPU tensors, the kernels
    for CUDA tensors (each forward launch adds one to ``counter.launches``,
    to ``counter.d80_launches``, ``counter.d88_launches`` or
    ``counter.d96_launches`` or ``counter.d128_launches`` at head dim 80,
    88, 96 or 128, or to ``counter.alibi_launches`` with ALiBi)."""

    @staticmethod
    def forward(ctx, q, k, v, kw, counter):
        if _on_cpu(q):
            o, lse = flash_fwd_plain(q, k, v, **kw)
        else:
            o = _head_major_empty(q)
            lse = flash_fwd_cuda(q, k, v, o, **kw)
            _count(counter, kw["alibi_slopes"], q.shape[-1])
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = flash_bwd_plain if _on_cpu(q) else flash_bwd_cuda
        dq, dk, dv = bwd(q, k, v, o, lse, do, **ctx.kw)
        return dq, dk, dv, None, None


def _heads(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, S, n*d] (or [B, S, n, d] head views) -> a [B, n, S, d] view."""
    if t.dim() == 3:
        t = t.unflatten(-1, (n_heads, t.shape[-1] // n_heads))
    return t.transpose(1, 2)


def _head_dim(q: torch.Tensor, n_heads: int) -> int:
    return q.shape[-1] if q.dim() == 4 else q.shape[-1] // n_heads


def _alibi(alibi_slopes, n_heads: int, causal: bool, device):
    """The slopes as an fp32 [n] tensor on ``device`` (no copy when they
    are one already), or None."""
    if alibi_slopes is None:
        return None
    if not causal:
        raise ValueError("ALiBi flash attention requires causal")
    slopes = torch.as_tensor(alibi_slopes, dtype=torch.float32,
                             device=device)
    if slopes.shape != (n_heads,):
        raise ValueError(f"alibi_slopes must have {n_heads} values; got "
                         f"{tuple(slopes.shape)}")
    return slopes.contiguous()


def flash_attention_packed_plain(q, k, v, n_heads: int, *,
                                 causal: bool = False, period: int = 0,
                                 scale: Optional[float] = None,
                                 alibi_slopes=None):
    """Plain version of ``flash_attention_packed`` (same arguments; plain
    torch ops, so autograd differentiates it directly)."""
    b, sq = q.shape[:2]
    d = _head_dim(q, n_heads)
    o4, _ = flash_fwd_plain(
        *(_heads(t, n_heads) for t in (q, k, v)), scale=scale or d ** -0.5,
        causal=causal, period=period,
        alibi_slopes=_alibi(alibi_slopes, n_heads, causal, q.device))
    return o4.transpose(1, 2).reshape(b, sq, n_heads * d)


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           n_heads: int, *, causal: bool = False,
                           period: int = 0, scale: Optional[float] = None,
                           alibi_slopes=None) -> torch.Tensor:
    """Attention over packed [B, S, n_heads*d] q/k/v (views of a wider
    projection are fine), or [B, S, n_heads, d] head views (Bloom's
    head-major fused projection, taken without a copy); ``period > 0`` is
    the block-diagonal mask of the grouped temporal attention, ``causal``
    the decoder's mask (Sq == Sk), ``alibi_slopes`` [n_heads] Bloom's bias
    (requires causal).  Returns [B, Sq, n_heads*d]."""
    b, sq = q.shape[:2]
    d = _head_dim(q, n_heads)
    o4 = _Flash.apply(*(_heads(t, n_heads) for t in (q, k, v)),
                      dict(scale=scale or d ** -0.5, causal=bool(causal),
                           period=int(period), kv_len=None,
                           alibi_slopes=_alibi(alibi_slopes, n_heads, causal,
                                               q.device)),
                      flash_attention_packed)
    return o4.transpose(1, 2).reshape(b, sq, n_heads * d)


flash_attention_packed.launches = 0
flash_attention_packed.d80_launches = 0
flash_attention_packed.d88_launches = 0
flash_attention_packed.d96_launches = 0
flash_attention_packed.d128_launches = 0
flash_attention_packed.alibi_launches = 0


def flash_attention_plain(q, k, v, *, causal: bool = False,
                          kv_len: Optional[int] = None,
                          scale: Optional[float] = None, period: int = 0):
    """Plain version of ``flash_attention`` (same arguments)."""
    if causal and q.shape[2] != k.shape[2]:
        raise ValueError("causal flash attention requires Sq == Sk")
    return flash_fwd_plain(q, k, v, scale=scale or q.shape[-1] ** -0.5,
                           causal=causal, kv_len=kv_len,
                           period=int(period))[0]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, kv_len: Optional[int] = None,
                    scale: Optional[float] = None,
                    period: int = 0) -> torch.Tensor:
    """Attention over head-major [B, H, S, D] (any strides with a
    contiguous D).  ``kv_len`` (static int): keys at or past it are
    masked; ``causal`` requires Sq == Sk; ``period > 0`` the grouped
    temporal attention's block-diagonal mask (a model shard's local
    vision heads, ``models/vision.py``).  Returns [B, H, Sq, D]."""
    if causal and q.shape[2] != k.shape[2]:
        raise ValueError("causal flash attention requires Sq == Sk")
    return _Flash.apply(q, k, v, dict(scale=scale or q.shape[-1] ** -0.5,
                                      causal=bool(causal),
                                      period=int(period), kv_len=kv_len,
                                      alibi_slopes=None),
                        flash_attention)


flash_attention.launches = 0
flash_attention.d80_launches = 0
flash_attention.d88_launches = 0
flash_attention.d96_launches = 0
flash_attention.d128_launches = 0
flash_attention.alibi_launches = 0
