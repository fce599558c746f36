"""LayerNorm with a forced fp32 island and a memory-lean backward.

Counterpart of ``youku_mplug_tpu/ops/layernorm.py``: statistics and
normalization in fp32 whatever the input dtype, result cast back.  The
op is an ``autograd.Function`` that saves only (x, mean, rstd) and
recomputes the normalized input in the backward, as the JAX package's
custom VJP does: autograd of the plain chain would keep fp32 copies of
the widened input and of the normalized activation for every call.
"""

from __future__ import annotations

import torch


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
