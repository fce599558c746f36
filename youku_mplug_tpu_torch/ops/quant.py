"""Int8 weight quantization of the decoder for serving.

Counterpart of ``youku_mplug_tpu/ops/quant.py``: each big decoder kernel
(``qkv_kernel``, ``out_kernel``, ``fc1_kernel``, ``fc2_kernel``, and the
tied ``embedding`` with ``include_embedding``) becomes int8 with one fp32
scale per output channel, ``scale = max(absmax, 1e-12) / 127`` over the
axes the matmul contracts, rounded half to even and clipped to +-127.
The models multiply each product's output channels by the scale before
the bias (``models/gpt3.py``, ``models/bloom.py``).

On a module the layout is: the parameter keeps its name and shape with
dtype int8 (frozen), and a buffer ``<name>_qscale`` beside it holds the
scales in the JAX package's shape (the reduced axes kept as 1, the
leading [L] of a layer stack kept).  ``quantize_decoder_`` converts a
seeded or loaded decoder in place, slab by slab along the first axis, so
a 7B decoder is never copied to the host and no fp32 copy of a whole
stack exists (fc1 of BloomZ-7B1, [30, 4096, 16384], would be 8 GB).

Unlike the JAX package, where XLA fuses the int8 -> bf16 convert into
the product, eager PyTorch converts each kernel to a bf16 temporary per
call: the weights stay int8 in memory, the products read a bf16 copy.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from youku_mplug_tpu_torch.ops.kv_cache import true_div

SCALE_SUFFIX = "_qscale"
_SLAB_VALUES = 1 << 26  # fp32 values of one slab's temporary (256 MB)

# decoder kernel -> matmul reduction axes (models/gpt3.py shapes)
_GPT3_REDUCE_AXES = {
    "qkv_kernel": (0,),        # [H, 3, n, d] (Bloom [H, n, 3, d]) contracts H
    "out_kernel": (0, 1),      # [n, d, H] contracts n, d
    "fc1_kernel": (0,),        # [H, F]
    "fc2_kernel": (0,),        # [F, H]
}
_BASE_RANKS = {"qkv_kernel": 4, "out_kernel": 3, "fc1_kernel": 2,
               "fc2_kernel": 2, "embedding": 2}


def reduce_axes(name: str, ndim: int,
                include_embedding: bool = False) -> Optional[Tuple[int, ...]]:
    """The reduced axes of leaf ``name`` at rank ``ndim`` (a layer stack's
    leading [L] shifts them), or None if the leaf is not quantized."""
    axes = _GPT3_REDUCE_AXES.get(name)
    if axes is None and include_embedding and name == "embedding":
        axes = (1,)  # [V, H] contracts H in the tied logits
    if axes is None or ndim < len(axes) + 1:
        return None
    shift = ndim - _BASE_RANKS[name]
    return tuple(a + shift for a in axes)


def quantize_int8(w: torch.Tensor, axes) -> Tuple[torch.Tensor,
                                                 torch.Tensor]:
    """-> (int8 q of w's shape, fp32 scale with ``axes`` kept as 1)."""
    if isinstance(axes, int):
        axes = (axes,)
    w32 = w.float()
    absmax = w32.abs().amax(dim=tuple(axes), keepdim=True)
    scale = true_div(absmax.clamp_min(1e-12), 127.0)
    q = torch.round(w32 / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def _leaves(tree: Dict[str, Any], prefix=()) -> Iterator:
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _assign(tree: Dict[str, Any], path, leaf) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


def quantize_gpt3_decoder(params: Dict[str, Any],
                          include_embedding: bool = False
                          ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Quantize a JAX-named decoder tree (GPT-3 or Bloom; nested dicts of
    arrays or tensors) as the JAX function does.  Returns (q_params,
    scales): q_params has the tree's structure with int8 kernel leaves,
    the other leaves as they were; scales mirrors the quantized leaves.
    Leaves come back as CPU tensors."""
    q_out: Dict[str, Any] = {}
    s_out: Dict[str, Any] = {}
    for path, leaf in _leaves(params):
        t = torch.as_tensor(np.asarray(leaf)) if not isinstance(
            leaf, torch.Tensor) else leaf
        axes = reduce_axes(path[-1], t.dim(), include_embedding)
        if axes is None:
            _assign(q_out, path, t)
            continue
        q, scale = quantize_int8(t, axes)
        _assign(q_out, path, q)
        _assign(s_out, path, scale)
    return q_out, s_out


def qscale(module: nn.Module, name: str) -> Optional[torch.Tensor]:
    """The scales of ``module``'s int8 parameter ``name``, or None for a
    float parameter."""
    return module._buffers.get(name + SCALE_SUFFIX)


def set_int8(module: nn.Module, name: str, q: torch.Tensor,
             scale: torch.Tensor) -> None:
    """Make ``module.<name>`` the frozen int8 parameter ``q`` with the
    scale buffer ``<name>_qscale`` beside it (replacing the float
    parameter, which is freed unless referenced elsewhere)."""
    module.register_parameter(name, nn.Parameter(q, requires_grad=False))
    module.register_buffer(name + SCALE_SUFFIX, scale)


@torch.no_grad()
def quantize_decoder_(lm: nn.Module,
                      include_embedding: bool = False) -> nn.Module:
    """Quantize a port decoder LM (``GPT3LM`` or ``BloomLM``) in place,
    on its own device: every parameter ``quantize_gpt3_decoder`` would
    quantize, one slab of the first axis at a time (never reduced: the
    layer axis of a stack, the vocab axis of the embedding).  Returns
    ``lm``."""
    for mod in lm.modules():
        for name in [n for n, _ in mod.named_parameters(recurse=False)]:
            p = getattr(mod, name)
            axes = reduce_axes(name, p.dim(), include_embedding)
            if axes is None:
                continue
            if p.dtype == torch.int8:
                raise ValueError(f"{name} is int8 already")
            q = torch.empty(p.shape, dtype=torch.int8, device=p.device)
            scale_shape = [1 if i in axes else size
                           for i, size in enumerate(p.shape)]
            scale = torch.empty(scale_shape, dtype=torch.float32,
                                device=p.device)
            rows = max(1, _SLAB_VALUES // max(1, p[0].numel()))
            for i in range(0, p.shape[0], rows):
                q[i:i + rows], scale[i:i + rows] = quantize_int8(
                    p[i:i + rows], axes)
            del p
            set_int8(mod, name, q, scale)
    return lm


def decoder_bytes(module: nn.Module) -> int:
    """Device bytes of the module's weights: its parameters and the int8
    scales beside them."""
    tensors = list(module.parameters()) + [
        b for name, b in module.named_buffers()
        if name.endswith(SCALE_SUFFIX)]
    return sum(t.numel() * t.element_size() for t in tensors)
