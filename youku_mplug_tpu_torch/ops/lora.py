"""LoRA: the low-rank delta of an adapted projection, and the merge of
trained adapters into their base kernels.

Counterpart of ``youku_mplug_tpu/ops/lora.py``.  An adapted projection
``x @ W`` gains ``(x @ a) @ b * (alpha / rank)`` with ``a [in, r]`` and
``b [r, out]`` (``b`` starts at zero, so a fresh adapter is a no-op).
``merge_lora`` folds every ``lora_<name>_{a,b}`` pair of a JAX-named
parameter tree into its base kernel (``W' = W + (alpha/r) a @ b``
reshaped to the kernel's layout, the scanned ``[L]`` leading dim
included) and drops the adapters, so serving runs the plain rank-0
model.  The adapter-file helpers (``extract_adapters`` /
``inject_adapters``) wait with checkpoints.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

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
