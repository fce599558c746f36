"""Ring and Ulysses attention: exact attention over a sequence split
across ranks.

Counterpart of ``youku_mplug_tpu/parallel/ring_attention.py``.  q, k and
v are this rank's ``[B, H, S/P, D]`` block of the sequence: rank ``i`` of
the ``sp`` axis (an ``AxisGroup``, ``runtime/mesh.named_axes``; None for
one rank) holds tokens ``[i * S/P, (i + 1) * S/P)``, as JAX's
``P(None, None, "sp", None)`` places them.

``ring_attention``: the query block stays, the K/V blocks go round the
ring (``parallel/collectives.ppermute``, one exchange a step).  At step
``t`` a rank holds the K/V block of rank ``src = (i - t) mod P`` and
computes that block's partial ``(o_b, lse_b)`` with the flash forward
(K4: ``ops/flash_attention.flash_fwd_cuda`` on CUDA tensors, its plain
version ``flash_fwd_plain`` on CPU ones); the partials merge in fp32 by
their lse.  Each partial o_b leaves the kernel in fp32 (K4's fp32-output
build: P is rounded to the inputs' dtype before P V, as in every build,
but the sum is not), so a bf16 rank's output is rounded once, after the
merge, as JAX's fp32 accumulator is.  Under ``causal`` the
diagonal block (``src == i``) runs the causal kernel (its local mask is
the global one there), earlier blocks run unmasked and later blocks are
skipped: JAX's mask on global positions, without its fully masked
blocks.  The backward is
FlashAttention-2's over the ring, on K4b: delta = rowsum(dO * O) once
(``flash_bwd_delta_cuda``), then for each block the dq and dk/dv kernels
with the global lse and delta; dq accumulates here in fp32, the fp32
dk/dv accumulators travel with their K/V block and reach its owner after
P hops.  It is the gradient JAX's autodiff of ``_block_attend`` gives:
dq_b, dk_b and dv_b leave K4b in fp32 (its fp32-output builds) and are
summed in fp32, so a bf16 rank's gradients are rounded once, at the end,
and the error does not grow with P (``tests/test_torch_ring_attention.py``
holds a bf16 ring at sp 8 against JAX in fp32, and its error against the
one-rank form's).  The fp32-output builds exist at head dim 64 (the 1.3B
decoder's heads); on the card another head dim raises.
``ring_attention.launches`` counts the forward's K4 launches (the
backward's count in ``flash_bwd_dq_cuda``, ``flash_bwd_dkv_cuda`` and
``flash_bwd_delta_cuda`` as everywhere).

``ulysses_attention``: one ``all_to_all`` scatters the heads and gathers
the sequence, attention runs on H/P heads over the whole sequence through
``ops/attention.dot_product_attention`` (K4 and K4b on the card at
S >= 128), a second ``all_to_all`` restores the layout.  H must divide
by P (``ValueError`` otherwise, as JAX raises).
"""

from __future__ import annotations

from typing import Optional

import torch

from youku_mplug_tpu_torch.ops import flash_attention as fa
from youku_mplug_tpu_torch.ops.attention import dot_product_attention
from youku_mplug_tpu_torch.parallel.collectives import all_to_all, ppermute
from youku_mplug_tpu_torch.runtime.mesh import ONE_RANK, AxisGroup


def _block_fwd(q, k, v, scale, causal):
    """(o_b fp32, lse_b fp32) of one K/V block."""
    if fa._on_cpu(q):
        return fa.flash_fwd_plain(q, k, v, scale=scale, causal=causal,
                                  out_dtype=torch.float32)
    o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = fa.flash_fwd_cuda(q, k, v, o, scale=scale, causal=causal)
    ring_attention.launches += 1
    return o, lse


def _block_bwd(q, k, v, o, lse, do, delta, scale, causal):
    """(dq_b, dk_b, dv_b) of one K/V block in fp32 with the global lse and
    delta (on the CPU the plain backward, which rebuilds delta from the
    global o and dO)."""
    if fa._on_cpu(q):
        return fa.flash_bwd_plain(q, k, v, o, lse, do, scale=scale,
                                  causal=causal, out_dtype=torch.float32)
    dq, dk, dv = (torch.empty(t.shape, dtype=torch.float32, device=t.device)
                  for t in (q, k, v))
    fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, dq, scale=scale,
                         causal=causal)
    fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, dk, dv, scale=scale,
                          causal=causal)
    return dq, dk, dv


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, axis, causal, scale):
        ax = axis or ONE_RANK
        p, i = ax.size, ax.index
        o_acc = lse = None
        kk, vv = k, v
        for t in range(p):
            src = (i - t) % p
            if not (causal and src > i):
                o_b, lse_b = _block_fwd(q, kk, vv, scale, causal and src == i)
                if o_acc is None:
                    o_acc, lse = o_b, lse_b
                else:
                    new = torch.logaddexp(lse, lse_b)
                    o_acc = (o_acc * torch.exp(lse - new)[..., None]
                             + o_b * torch.exp(lse_b - new)[..., None])
                    lse = new
            if t < p - 1:
                kk, vv = ppermute([kk, vv], axis)
        o = o_acc.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse.contiguous())
        ctx.axis, ctx.causal, ctx.scale = axis, causal, scale
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        axis, causal, scale = ctx.axis, ctx.causal, ctx.scale
        ax = axis or ONE_RANK
        p, i = ax.size, ax.index
        do = do.contiguous()
        delta = (fa.flash_bwd_delta_plain(o, do) if fa._on_cpu(q)
                 else fa.flash_bwd_delta_cuda(o, do))
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk, dv = (torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                  for t in (k, v))
        kk, vv = k, v
        for t in range(p):
            src = (i - t) % p
            if not (causal and src > i):
                dq_b, dk_b, dv_b = _block_bwd(q, kk, vv, o, lse, do, delta,
                                              scale, causal and src == i)
                dq += dq_b
                dk += dk_b
                dv += dv_b
            # the accumulators go on with their block; after the last
            # step that brings them home
            if t < p - 1:
                kk, vv, dk, dv = ppermute([kk, vv, dk, dv], axis)
            else:
                dk, dv = ppermute([dk, dv], axis)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   axis: Optional[AxisGroup], causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention of this rank's query block over the whole
    sequence, the sequence split over ``axis`` (see the module
    docstring).  q, k, v: [B, H, S/P, D]; returns [B, H, S/P, D]."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _Ring.apply(q, k, v, axis, bool(causal), float(scale))


ring_attention.launches = 0


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      axis: Optional[AxisGroup], causal: bool = False,
                      scale: Optional[float] = None) -> torch.Tensor:
    """DeepSpeed-Ulysses context parallelism (see the module docstring).
    q, k, v: [B, H, S/P, D] with H % P == 0; returns [B, H, S/P, D]."""
    p = (axis or ONE_RANK).size
    if q.shape[1] % p:
        raise ValueError(
            f"ulysses needs heads ({q.shape[1]}) divisible by the axis "
            f"size ({p}); use ring_attention instead")
    qh, kh, vh = (all_to_all(t, axis, 1, 2) for t in (q, k, v))
    out = dot_product_attention(qh, kh, vh, causal=causal, scale=scale)
    return all_to_all(out, axis, 2, 1)
