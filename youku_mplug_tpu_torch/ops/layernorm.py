"""LayerNorm with a forced fp32 island and a memory-lean backward.

Counterpart of ``youku_mplug_tpu/ops/layernorm.py``: statistics and
normalization in fp32 whatever the input dtype, result cast back.  The
op is an ``autograd.Function`` that saves only (x, mean, rstd) and
recomputes the normalized input in the backward, as the JAX package's
custom VJP does: autograd of the plain chain would keep fp32 copies of
the widened input and of the normalized activation for every call.

``split_layer_norm`` normalizes a width split over the model ranks (the
Owl abstractor's ``ffn_ln`` on its MLP's split intermediate width): the
mean first, then the centred variance, each a sum over the model group
(``parallel/tensor_parallel.sum_over_model``, whose backward sums too),
the order of the one-rank op, so fp32 values stay within rounding of it;
each rank applies its slice of the scale and bias.
"""

from __future__ import annotations

from typing import Optional

import torch

from youku_mplug_tpu_torch.parallel.tensor_parallel import (
    ModelGroup,
    sum_over_model,
)


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = (x32 - mean).square().mean(-1, keepdim=True)
        rstd = torch.rsqrt(var + eps)
        y = (x32 - mean) * rstd * scale.float() + bias.float()
        ctx.save_for_backward(x, mean, rstd, scale)
        ctx.bias_dtype = bias.dtype
        return y.to(x.dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, mean, rstd, scale = ctx.saved_tensors
        g32 = g.float()
        xhat = (x.float() - mean) * rstd
        dxhat = g32 * scale.float()
        lead = tuple(range(x.dim() - 1))
        dscale = dbias = None
        if ctx.needs_input_grad[1]:
            dscale = (g32 * xhat).sum(lead).to(scale.dtype)
        if ctx.needs_input_grad[2]:
            dbias = g32.sum(lead).to(ctx.bias_dtype)
        dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                     - xhat * (dxhat * xhat).mean(-1, keepdim=True))
        return dx.to(x.dtype), dscale, dbias, None


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
               eps: float = 1e-5) -> torch.Tensor:
    """fp32-island layernorm over the last axis; returns x.dtype."""
    return _LayerNorm.apply(x, scale, bias, eps)


def split_layer_norm(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, tp: Optional[ModelGroup], *,
                     width: int, eps: float = 1e-5) -> torch.Tensor:
    """``layer_norm`` over a last axis split over the model ranks: ``x``
    [..., width / m] this rank's slice, ``scale`` and ``bias`` its slices,
    ``width`` the whole axis; the statistics are summed over the model
    group (see the module docstring).  ``layer_norm`` itself without a
    model group."""
    if tp is None or tp.size <= 1:
        return layer_norm(x, scale, bias, eps=eps)
    x32 = x.float()
    mean = sum_over_model(x32.sum(-1, keepdim=True), tp) / width
    xc = x32 - mean
    var = sum_over_model(xc.square().sum(-1, keepdim=True), tp) / width
    y = xc * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return y.to(x.dtype)
