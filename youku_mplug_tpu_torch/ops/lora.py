"""LoRA: the low-rank delta of an adapted projection, and the merge of
trained adapters into their base kernels.

Counterpart of ``youku_mplug_tpu/ops/lora.py``.  An adapted projection
``x @ W`` gains ``(x @ a) @ b * (alpha / rank)`` with ``a [in, r]`` and
``b [r, out]`` (``b`` starts at zero, so a fresh adapter is a no-op).
``merge_lora`` folds every ``lora_<name>_{a,b}`` pair of a JAX-named
parameter tree into its base kernel (``W' = W + (alpha/r) a @ b``
reshaped to the kernel's layout, the scanned ``[L]`` leading dim
included) and drops the adapters, so serving runs the plain rank-0
model.  ``extract_adapters`` / ``inject_adapters`` move a module's
adapters to and from a flat dict keyed by JAX's ``keystr`` of each
leaf's path (``"['text_decoder']['decoder']['layers']['attn']
['lora_qkv_a']"``), so an adapter file ``np.savez(path,
**extract_adapters(model))`` of a few MB loads in either package.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

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
