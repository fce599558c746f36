"""LoRA: the low-rank delta of an adapted projection, and the merge of
trained adapters into their base kernels.

Counterpart of ``youku_mplug_tpu/ops/lora.py``.  An adapted projection
``x @ W`` gains ``(x @ a) @ b * (alpha / rank)`` with ``a [in, r]`` and
``b [r, out]`` (``b`` starts at zero, so a fresh adapter is a no-op).
``merge_lora`` folds every ``lora_<name>_{a,b}`` pair of a JAX-named
parameter tree into its base kernel (``W' = W + (alpha/r) a @ b``
reshaped to the kernel's layout, the scanned ``[L]`` leading dim
included: the GPT-3 and Bloom stacks, and the vision blocks' ``qkv``,
``proj``, ``fc1`` and ``fc2``) and drops the adapters, so serving runs
the plain rank-0 model.  ``extract_adapters`` / ``inject_adapters``
move a module's adapters to and from a flat dict keyed by JAX's
``keystr`` of each leaf's path (``"['text_decoder']['decoder']['layers']
['attn']['lora_qkv_a']"``), so an adapter file ``np.savez(path,
**extract_adapters(model))`` of a few MB loads in either package; the
injection copies into the parameters' storage, where a captured decode
graph reads it.

On a model shard (``parallel/sharding.shard_params``) the adapters stay
whole on every rank, as JAX's rules replicate every ``lora_*`` leaf,
while their base kernel holds this rank's slice (``lora_cut``, set by
``shard_params``): a column-parallel product (qkv, fc1) adds ``(x @ a)
@ b_local``, ``b``'s columns of this rank's output lanes, and a
row-parallel one (out, proj, fc2) ``(x_local @ a_local) @ b``, ``a``'s
rows of this rank's input lanes, before the product's sum over the model
ranks.  With the product's input taken after Megatron's *f*, each rank's
gradient of ``a`` and ``b`` is its share of the whole one: the train step
sums those leaves (``shard_params``' ``tp_partial``) over the model
group (``train/trainer.py``), so every rank updates them as (1,1) does.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from youku_mplug_tpu_torch.bridge import jax_path

# adapter name -> base kernel parameter name
_TARGET_KERNEL = {
    "qkv": "qkv_kernel",
    "out": "out_kernel",       # decoder attention out projection
    "proj": "proj_kernel",     # vision attention out projection
    "fc1": "fc1_kernel",
    "fc2": "fc2_kernel",
}


def lora_delta(pair: Optional[Tuple[torch.Tensor, torch.Tensor]],
               x: torch.Tensor, rank: int, alpha: float, dtype):
    """alpha/r-scaled low-rank delta ``(x @ a) @ b`` in ``dtype``, or None
    without an adapter."""
    if pair is None:
        return None
    a, b = pair
    return (x @ a.to(dtype)) @ b.to(dtype) * (alpha / rank)


LoRACut = Tuple[str, Tuple[int, ...], int]


def _cut(kernel_shape: Tuple[int, ...], lead: int, fan_in: int,
         dim: int) -> LoRACut:
    """How a model shard cuts an adapter pair whose base kernel (its
    unsharded ``kernel_shape``, ``lead`` stacked dims first) is split on
    ``dim``: ("a", the dims of ``a``'s input lanes, the index among them)
    for a row-parallel product, ("b", the dims of ``b``'s output lanes,
    the index) for a column-parallel one.  ``fan_in``: the adapter's
    input width (``a``'s rows)."""
    trailing = tuple(kernel_shape[lead:])
    k = next(k for k in range(len(trailing) + 1)
             if int(np.prod(trailing[:k])) == fan_in)
    rel = dim - lead
    return ("a", trailing[:k], rel) if rel < k else \
        ("b", trailing[k:], rel - k)


def cut_adapters(owner: "LoRAModule", kernel: str,
                 kernel_shape: Tuple[int, ...], dim: int) -> List[str]:
    """Record on ``owner`` the cut of the adapters on its ``kernel`` (of
    unsharded ``kernel_shape``), which a model shard splits on ``dim``;
    returns their leaf names (``lora_<name>_a``, ``lora_<name>_b``): the
    leaves whose gradient on a rank is its share."""
    leaves = []
    for name, target in _TARGET_KERNEL.items():
        a = getattr(owner, f"lora_{name}_a", None)
        if target != kernel or a is None:
            continue
        owner.lora_cut = {**owner.lora_cut, name: _cut(
            tuple(kernel_shape), a.dim() - 2, a.shape[-2], dim)}
        leaves += [f"lora_{name}_a", f"lora_{name}_b"]
    return leaves


def _local(t: torch.Tensor, axis: int, dims: Tuple[int, ...], dim: int,
           tp) -> torch.Tensor:
    """This model rank's lanes of ``t``'s flat axis ``axis`` (-2: ``a``'s
    input lanes, -1: ``b``'s output lanes) laid out as ``dims``, cut on
    ``dims[dim]``."""
    size = dims[dim] // tp.size
    start = axis - len(dims) + 1
    t = t.unflatten(axis, dims).narrow(start + dim, tp.index * size, size)
    return t.flatten(start, start + len(dims) - 1)


class LoRAModule(nn.Module):
    """A module with rank-r adapters ``lora_<name>_a [(L,) in, r]`` and
    ``lora_<name>_b [(L,) r, out]`` on some of its projections
    (``add_lora``; L for an [L]-stacked module); ``delta(name, x, lidx)``
    is the alpha/r-scaled ``(x @ a) @ b`` (of layer ``lidx``), or None
    where the projection has no adapter.  ``lora_init_std`` is the std
    of a fresh ``lora_*_a`` (``bridge``'s inits).  On a model shard
    ``lora_cut`` ({name: cut}, ``cut_adapters``) says which factor the
    delta takes this rank's lanes of (see the module docstring)."""

    lora_cut: Dict[str, LoRACut] = {}
    tp = None  # the ModelGroup of a model shard (shard_params)

    def add_lora(self, rank: int, alpha: float, init_std: float, dtype,
                 shapes: Dict[str, Tuple[int, int]],
                 num_layers: Optional[int] = None):
        self.lora_rank, self.lora_alpha = rank, alpha
        self.lora_init_std = init_std
        if rank <= 0:
            return
        lead = () if num_layers is None else (num_layers,)
        for name, (i, o) in shapes.items():
            for suffix, shape in (("a", (i, rank)), ("b", (rank, o))):
                setattr(self, f"lora_{name}_{suffix}", nn.Parameter(
                    torch.empty(*lead, *shape, dtype=dtype),
                    requires_grad=False))

    def delta(self, name: str, x: torch.Tensor,
              lidx: Optional[int] = None) -> Optional[torch.Tensor]:
        a = getattr(self, f"lora_{name}_a", None)
        if a is None:
            return None
        b = getattr(self, f"lora_{name}_b")
        if lidx is not None:
            a, b = a[lidx], b[lidx]
        cut = self.lora_cut.get(name)
        if cut is not None:
            which, dims, dim = cut
            if which == "a":
                a = _local(a, -2, dims, dim, self.tp)
            else:
                b = _local(b, -1, dims, dim, self.tp)
        return lora_delta((a, b), x, self.lora_rank, self.lora_alpha,
                          x.dtype)


def plus(y: torch.Tensor, delta: Optional[torch.Tensor]) -> torch.Tensor:
    """``y + delta``, or ``y`` without an adapter."""
    return y if delta is None else y + delta


def _merge_module(mod: dict, scale: float) -> dict:
    out = {}
    for k, v in mod.items():
        if isinstance(v, dict):
            out[k] = _merge_module(v, scale)
            continue
        if k.startswith("lora_"):
            # every adapter must have a fold target: never drop one
            name = k[len("lora_"):].rsplit("_", 1)[0]
            if name not in _TARGET_KERNEL:
                raise ValueError(f"no merge target for adapter {k!r}")
            continue  # folded below
        out[k] = v
    for name, kernel_name in _TARGET_KERNEL.items():
        a, b = mod.get(f"lora_{name}_a"), mod.get(f"lora_{name}_b")
        if a is None or b is None:
            continue
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        kernel = torch.as_tensor(out[kernel_name])
        # a [..., in, r], b [..., r, out_flat] with the scanned leading
        # dims; the kernel may be higher-rank (qkv [H, n, 3, d], out
        # [n, d, H]): fold through a flat 2-D view of its trailing dims
        delta = torch.einsum("...ir,...ro->...io", a.float(), b.float())
        lead = tuple(kernel.shape[:a.dim() - 2])
        flat = kernel.reshape(lead + (a.shape[-2], b.shape[-1]))
        out[kernel_name] = (flat.float() + delta * scale).to(
            kernel.dtype).reshape(kernel.shape)
    return out


def merge_lora(params: Any, lora_rank: int, lora_alpha: float = 16.0):
    """Fold the ``lora_*`` adapters of a nested parameter dict (JAX names;
    tensors or numpy arrays) into their base kernels.  Returns a rank-0
    tree of tensors (unchanged when ``lora_rank <= 0``)."""
    if lora_rank <= 0:
        return params
    return _merge_module(dict(params), float(lora_alpha) / float(lora_rank))


def _keystr(name: str) -> str:
    """The port parameter name -> JAX's ``keystr`` of its tree path."""
    return "".join(f"[{k!r}]" for k in jax_path(name).split("/"))


def extract_adapters(module: nn.Module) -> Dict[str, np.ndarray]:
    """Every ``lora_*`` parameter of ``module`` as fp32 numpy, keyed by
    JAX's ``keystr`` of its path."""
    return {_keystr(name): p.detach().float().cpu().numpy()
            for name, p in module.named_parameters() if "lora_" in name}


@torch.no_grad()
def inject_adapters(module: nn.Module, adapters: Dict[str, Any]
                    ) -> nn.Module:
    """``extract_adapters``'s inverse: copy each adapter into the
    parameter at its path (cast to its dtype, on its device).  Raises
    ValueError on a path the module lacks or a shape mismatch, before
    copying anything.  Returns ``module``."""
    params = {_keystr(name): p for name, p in module.named_parameters()}
    missing = sorted(set(adapters) - set(params))
    if missing:
        raise ValueError(f"adapter paths not in the param tree: "
                         f"{missing[:5]}")
    values = {k: torch.as_tensor(np.asarray(v)) for k, v in adapters.items()}
    for k, v in values.items():
        if tuple(v.shape) != tuple(params[k].shape):
            raise ValueError(f"adapter {k}: shape {tuple(v.shape)} != "
                             f"param {tuple(params[k].shape)}")
    for k, v in values.items():
        params[k].copy_(v)
    return module
