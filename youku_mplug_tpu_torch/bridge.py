"""Weights for the port: load a JAX parameter tree, export one, or a
seeded init.

``load_jax_params`` turns the JAX package's parameter tree (nested dicts
of numpy arrays, e.g. ``jax.device_get(params)``) into the port's modules.
The port keeps the JAX names and shapes, so the mapping is a rename:
``a/b/c`` -> ``a.b.c``, and flax's ``blocks_<i>`` / ``layers_<i>`` ->
``blocks.<i>`` / ``layers.<i>`` (a scanned stack, ``decoder/layers``,
stays one name with a leading ``[L]`` dimension).  It
raises on any JAX leaf it does not consume, on any port parameter it
leaves unfilled, and on any shape mismatch.  Each leaf is cast to its
parameter's dtype, so a model split by ``train.state.create_train_state``
takes trainable leaves as fp32 master weights and frozen ones in bf16;
``requires_grad`` is the split's and is left as it is.
``jax_path`` is the inverse rename and ``to_jax_tree`` the inverse load
(port parameters -> a JAX-named tree of numpy arrays).  An int8 tree
comes with its ``qscales`` (the layout ``tools/export_serving.py --int8``
writes, rooted where the tree is): each leaf with a scale loads as an int8
parameter with its scale buffer (``ops/quant.py``).

``seeded_init`` fills every parameter from one ``torch.Generator``: normals
of std 0.02 everywhere (biases, cls/pos/temporal embeddings, ``bias_k``,
``temporal_fc`` of every block, the contrastive projections and the
LoRA ``lora_*_a`` included, the latter at its module's
``lora_init_std``, so no path through the model is zeroed out),
LayerNorm scales one, LayerNorm biases zero, every LoRA ``lora_*_b``
zero (a fresh adapter is a no-op, as the JAX package inits it, so
training starts from the base model), and the contrastive temperature
``temp`` its configured value (``module.cfg.temp``, else 0.07).  It
draws float weights only: quantize after it, never before.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from youku_mplug_tpu_torch.ops import quant


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            flat.update(_flatten(value, path))
        else:
            flat[path] = value
    return flat


def port_name(jax_path: str) -> str:
    """JAX tree path -> the port's parameter name."""
    return re.sub(r"(^|/)(blocks|layers)_(\d+)(?=/|$)", r"\1\2/\3",
                  jax_path).replace("/", ".")


def jax_path(port_param_name: str) -> str:
    """The port's parameter name -> the JAX tree path (``port_name``'s
    inverse)."""
    return re.sub(r"(^|\.)(blocks|layers)\.(\d+)(?=\.|$)", r"\1\2_\3",
                  port_param_name).replace(".", "/")


def to_jax_tree(module: nn.Module) -> Dict[str, Any]:
    """The module's parameters as a nested dict of fp32 numpy arrays under
    the JAX names."""
    tree: Dict[str, Any] = {}
    for name, p in module.named_parameters():
        *parents, leaf = jax_path(name).split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = p.detach().float().cpu().numpy()
    return tree


def _to_tensor(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes arrays from jax
        a = a.astype(np.float32)
    return torch.from_numpy(a.copy())  # C-contiguous, 0-d stays 0-d


def _int8_leaves(module: nn.Module, params, flat, qscales) -> None:
    """Turn each parameter that ``qscales`` names into an int8 parameter
    with its scale buffer (values filled by the caller's copy)."""
    for name, (path, s) in ((port_name(k), (k, v))
                            for k, v in _flatten(qscales).items()):
        p = params.get(name)
        if p is None:
            raise KeyError(f"qscales leaf with no port parameter: {path}")
        if name not in flat or np.asarray(flat[name][1]).dtype != np.int8:
            raise TypeError(f"{path}: a scale for a leaf that is not int8")
        leaf = name.rsplit(".", 1)[-1]
        axes = quant.reduce_axes(leaf, p.dim(), include_embedding=True)
        want = tuple(1 if i in (axes or ()) else n
                     for i, n in enumerate(p.shape))
        if axes is None or tuple(np.shape(s)) != want:
            raise ValueError(f"{path}: scale shape {tuple(np.shape(s))}, "
                             f"expected {want if axes else 'none'}")
        owner = module.get_submodule(name.rsplit(".", 1)[0]) \
            if "." in name else module
        quant.set_int8(owner, leaf,
                       torch.empty(p.shape, dtype=torch.int8,
                                   device=p.device),
                       _to_tensor(s).to(dtype=torch.float32,
                                        device=p.device))
        params[name] = getattr(owner, leaf)


@torch.no_grad()
def load_jax_params(module: nn.Module, tree: Dict[str, Any],
                    qscales: Optional[Dict[str, Any]] = None) -> nn.Module:
    """Copy a JAX parameter tree into ``module`` (cast to each parameter's
    dtype and device).  With ``qscales``, the leaves they name load as
    int8 parameters with their scales; an int8 leaf without a scale
    raises.  Returns ``module``."""
    params = dict(module.named_parameters())
    flat = {port_name(k): (k, v) for k, v in _flatten(tree).items()}
    if qscales:
        _int8_leaves(module, params, flat, qscales)
    unused = sorted(k for name, (k, _) in flat.items() if name not in params)
    if unused:
        raise KeyError(f"JAX leaves with no port parameter: {unused}")
    missing = sorted(set(params) - set(flat))
    if missing:
        raise KeyError(f"port parameters not in the JAX tree: {missing}")
    for name, p in params.items():
        jax_path, value = flat[name]
        src = _to_tensor(value)
        if src.dtype == torch.int8 and p.dtype != torch.int8:
            raise TypeError(f"{jax_path}: an int8 leaf without qscales")
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{jax_path}: JAX shape {tuple(src.shape)} != "
                             f"port shape {tuple(p.shape)}")
        p.copy_(src.to(dtype=p.dtype, device=p.device))
    return module


def _is_norm_scale(name: str) -> bool:
    return name.split(".")[-1].endswith("scale")


def _is_norm_bias(name: str, names) -> bool:
    leaf = name.split(".")[-1]
    if not leaf.endswith("bias"):
        return False
    scale = name[:len(name) - len(leaf)] + leaf[:-len("bias")] + "scale"
    return scale in names


def _is_lora_b(name: str) -> bool:
    leaf = name.split(".")[-1]
    return leaf.startswith("lora_") and leaf.endswith("_b")


_DRAW_VALUES = 1 << 26  # 256 MB of fp32


@torch.no_grad()
def seeded_init(module: nn.Module, seed: int, std: float = 0.02
                ) -> nn.Module:
    """Fill every parameter of ``module`` from a generator seeded with
    ``seed``, on the parameters' own device (see module docstring)."""
    params = dict(module.named_parameters())
    quantized = sorted(k for k, p in params.items() if p.dtype == torch.int8)
    if quantized:
        raise TypeError(f"seeded_init draws float weights; int8 parameters "
                        f"{quantized[:3]}: quantize after the init")
    stds = {f"{prefix}.{leaf}" if prefix else leaf: m.lora_init_std
            for prefix, m in module.named_modules()
            if hasattr(m, "lora_init_std")
            for leaf, _ in m.named_parameters(recurse=False)
            if leaf.startswith("lora_")}
    gens = {}
    for name in sorted(params):
        p = params[name]
        if name == "temp":
            p.fill_(getattr(getattr(module, "cfg", None), "temp", 0.07))
        elif _is_norm_scale(name):
            p.fill_(1.0)
        elif _is_norm_bias(name, params) or _is_lora_b(name):
            p.zero_()
        else:
            gen = gens.get(p.device)
            if gen is None:
                gen = gens[p.device] = torch.Generator(
                    device=p.device).manual_seed(seed)
            # draw in slabs of at most _DRAW_VALUES values: the fp32
            # temporary of one draw stays small beside a 7B model
            rows = max(1, _DRAW_VALUES // max(1, p[0].numel())) \
                if p.dim() else 1
            for part in (p.split(rows) if p.dim() else (p,)):
                part.copy_(torch.randn(part.shape, generator=gen,
                                       device=p.device,
                                       dtype=torch.float32)
                           * stds.get(name, std))
    return module
