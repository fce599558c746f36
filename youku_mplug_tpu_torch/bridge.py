"""Weights for the port: load a JAX parameter tree, export one, or a
seeded init (``seeded_init`` for serving and the parity tests,
``jax_init`` with the JAX ``model.init`` rules for the training CLIs).

``load_jax_params`` turns the JAX package's parameter tree (nested dicts
of numpy arrays, e.g. ``jax.device_get(params)``, or of tensors, as the
port's checkpoints hold it) into the port's modules.
The port keeps the JAX names and shapes, so the mapping is a rename:
``a/b/c`` -> ``a.b.c``, and flax's ``blocks_<i>`` / ``layers_<i>`` ->
``blocks.<i>`` / ``layers.<i>`` (a scanned stack, ``decoder/layers``,
stays one name with a leading ``[L]`` dimension).  It
raises on any JAX leaf it does not consume, on any port parameter it
leaves unfilled, and on any shape mismatch.  Each leaf is cast to its
parameter's dtype, so a model split by ``train.state.create_train_state``
takes trainable leaves as fp32 master weights and frozen ones in bf16;
``requires_grad`` is the split's and is left as it is.
``load_momentum_state`` carries mPLUG's momentum state (the EMA twin's
tree, the queues and the pointer) the same way.
``jax_path`` is the inverse rename and ``to_jax_tree`` the inverse load
(port parameters -> a JAX-named tree of numpy arrays).  An int8 tree
comes with its ``qscales`` (the layout ``cli/export_serving.py --int8``
writes, as JAX's ``tools/export_serving.py`` does, rooted where the tree
is): each leaf with a scale loads as an int8
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


def flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """A nested dict -> {"a/b/c": leaf}."""
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            flat.update(flatten(value, path))
        else:
            flat[path] = value
    return flat


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """``flatten``'s inverse: {"a/b/c": leaf} -> a nested dict."""
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        *parents, key = path.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[key] = leaf
    return tree


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
    return unflatten({jax_path(name): p.detach().float().cpu().numpy()
                      for name, p in module.named_parameters()})


def _to_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):  # a port checkpoint's leaf
        return x
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes arrays from jax
        a = a.astype(np.float32)
    return torch.from_numpy(a.copy())  # C-contiguous, 0-d stays 0-d


def _int8_leaves(module: nn.Module, params, flat, qscales) -> None:
    """Turn each parameter that ``qscales`` names into an int8 parameter
    with its scale buffer (values filled by the caller's copy)."""
    for name, (path, s) in ((port_name(k), (k, v))
                            for k, v in flatten(qscales).items()):
        p = params.get(name)
        if p is None:
            raise KeyError(f"qscales leaf with no port parameter: {path}")
        if name not in flat or _to_tensor(flat[name][1]).dtype != torch.int8:
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
    flat = {port_name(k): (k, v) for k, v in flatten(tree).items()}
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


@torch.no_grad()
def load_momentum_state(state, jax_state):
    """A JAX ``models/mplug.MomentumState`` (its ``ema_params`` tree, both
    feature queues, ``idx_queue`` and ``ptr``; numpy or device arrays)
    into the port's ``models/mplug.MomentumState``: the twin through
    ``load_jax_params`` (every leaf, none left over), the queues copied,
    the pointer an int.  Returns ``state``."""
    load_jax_params(state.ema, jax_state.ema_params)
    for name in ("image_queue", "text_queue", "idx_queue"):
        dst = getattr(state, name)
        src = _to_tensor(getattr(jax_state, name))
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: JAX shape {tuple(src.shape)} != "
                             f"port shape {tuple(dst.shape)}")
        dst.copy_(src.to(dtype=dst.dtype, device=dst.device))
    state.ptr = int(np.asarray(jax_state.ptr))
    return state


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


def _lora_stds(module: nn.Module) -> Dict[str, float]:
    """Each LoRA leaf's init std: its module's ``lora_init_std``."""
    return {f"{prefix}.{leaf}" if prefix else leaf: m.lora_init_std
            for prefix, m in module.named_modules()
            if hasattr(m, "lora_init_std")
            for leaf, _ in m.named_parameters(recurse=False)
            if leaf.startswith("lora_")}


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
    stds = _lora_stds(module)
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


# The JAX package's initializers (``model.init``), per leaf:
#   ("normal", s)   normal of std s (flax ``normal``);
#   ("trunc", s)    a standard normal truncated to [-2, 2], times s (flax
#                   ``truncated_normal``: |x| <= 2 s, std ~0.88 s);
#   ("lecun", _)    flax ``Dense``'s default, lecun_normal: ("trunc",
#                   1 / sqrt(fan_in) / 0.8796...), std 1 / sqrt(fan_in);
#   ("xavier", _)   xavier_uniform over the kernel's (in, out);
#   ("const", v)    every value v.
VISION_INIT_STD = 0.015  # youku_mplug_tpu/models/vision.py VisionConfig
_TRUNC2_STD = 0.87962566103423978  # std of a standard normal cut at +-2


def _vision_rule(name: str, leaf: str):
    """TimeSformer / VisionTransformer leaves (``name`` below the tower;
    the plain ViT's blocks scale ``proj`` and ``fc2`` alike, vision.py:624-
    643):
    truncated normals of std 0.015 (vision.py:120-129); the spatial
    attention's ``proj`` and the MLP's ``fc2`` divided by sqrt(2 x
    layer_id) (vision.py:433, :624); ``temporal_fc`` zero past block 1
    (:447-450); zero ``cls_token`` and ``temporal_embed`` (:563-567)."""
    block = re.match(r"blocks\.(\d+)\.", name)
    if leaf in ("cls_token", "temporal_embed"):
        return ("const", 0.0)
    if block and leaf == "temporal_fc_kernel" and int(block[1]) > 0:
        return ("const", 0.0)
    if block and re.search(r"\.(attn\.proj_kernel|mlp\.fc2_kernel)$", name):
        return ("trunc", VISION_INIT_STD / (2.0 * (int(block[1]) + 1)) ** 0.5)
    return ("trunc", VISION_INIT_STD)


def _jax_rule(module: nn.Module, name: str, lora_stds: Dict[str, float]):
    leaf = name.split(".")[-1]
    root, _, rest = name.partition(".")
    cfg = module.cfg
    owl = hasattr(cfg, "abstractor")
    if name == "temp":
        return ("const", float(cfg.temp))
    if _is_lora_b(name):
        return ("const", 0.0)
    if name in lora_stds:
        return ("normal", lora_stds[name])
    if _is_norm_scale(name):
        return ("const", 1.0)
    if leaf.endswith("bias") or leaf in ("bias_k", "bias_v"):
        # every bias, LayerNorm's included, and AttentionPool's bias_k /
        # bias_v (vision.py:711-715)
        return ("const", 0.0)
    if root in ("visual_encoder", "image_encoder"):
        return _vision_rule(rest, leaf)
    if hasattr(cfg, "bert"):  # mPLUG / ALPRO (mplug.py, alpro.py)
        if root in ("visn_fc", "vision_proj", "text_proj", "itm_head",
                    "cls_fc1", "cls_fc2"):
            return ("lecun", None)  # default Dense
        if root in ("text_encoder", "fusion_encoder", "text_decoder",
                    "mlm_head"):
            # every BERT kernel and embedding (bert.py ``_init``)
            return ("normal", cfg.bert.initializer_range)
        raise KeyError(f"jax_init: no JAX initializer known for {name}")
    text = cfg.text
    if root == "text_decoder":
        # normal(init_method_std) (gpt3.py:155, bloom.py:190-194); GPT-3's
        # out / fc2 at std / sqrt(2L) (gpt3.py:448), Bloom's unscaled
        if not owl and leaf in ("out_kernel", "fc2_kernel"):
            return ("normal", text.init_method_std
                    / (2.0 * text.num_hidden_layers) ** 0.5)
        return ("normal", text.init_method_std)
    if owl:
        # the abstractor's and visual_fc's normals (owl.py:108, :140,
        # :190-199, :273-281); in_proj is a default Dense
        if name == "abstractor.in_proj.kernel":
            return ("lecun", None)
        if root in ("abstractor", "visual_fc", "vit_eos"):
            return ("normal", cfg.abstractor.init_std)
    else:
        if root in ("learnable_queries", "visual_fc"):  # tasks.py:108-119
            return ("trunc", VISION_INIT_STD)
        if root == "attn_pool":  # vision.py:708-716, Mlp at 0.015
            return (("xavier", None) if leaf in (
                "q_kernel", "k_kernel", "v_kernel", "out_kernel")
                else ("trunc", VISION_INIT_STD))
        if root in ("vision_proj", "text_proj", "cls_fc1", "cls_fc2"):
            return ("lecun", None)  # default Dense (tasks.py:124-144)
    raise KeyError(f"jax_init: no JAX initializer known for {name}")


def _draw(kind, arg, shape, gen, device) -> torch.Tensor:
    if kind == "lecun":
        kind, arg = "trunc", shape[-2] ** -0.5 / _TRUNC2_STD
    if kind == "normal":
        return torch.randn(shape, generator=gen, device=device) * arg
    if kind == "trunc":
        out = torch.empty(shape, device=device)
        return torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0,
                                           generator=gen) * arg
    if kind == "xavier":
        bound = (6.0 / (shape[-2] + shape[-1])) ** 0.5
        return (torch.rand(shape, generator=gen, device=device) * 2 - 1) \
            * bound
    raise ValueError(kind)


@torch.no_grad()
def jax_init(module: nn.Module, seed: int) -> nn.Module:
    """Fill an ``MPLUGVideo``, ``MPLUGOwlVideo``, ``MPLUG`` or ``ALPRO``
    (the BERT family: normal(``initializer_range``) kernels and
    embeddings, default-Dense heads) the way the JAX
    package's ``model.init`` does (the rules above, by leaf), from one
    ``torch.Generator`` seeded with ``seed`` on the parameters' device:
    the fresh weights the training CLIs start from.  The draws are not
    JAX's bits; their distributions are.  Raises on a leaf it has no rule
    for and on int8 parameters."""
    params = dict(module.named_parameters())
    if any(p.dtype == torch.int8 for p in params.values()):
        raise TypeError("jax_init draws float weights: quantize after it")
    lora_stds = _lora_stds(module)
    gens = {}
    for name in sorted(params):
        p = params[name]
        kind, arg = _jax_rule(module, name, lora_stds)
        if kind == "const":
            p.fill_(arg)
            continue
        gen = gens.get(p.device)
        if gen is None:
            gen = gens[p.device] = torch.Generator(
                device=p.device).manual_seed(seed)
        if kind == "xavier" or p.dim() < 2:
            p.copy_(_draw(kind, arg, p.shape, gen, p.device))
            continue
        # slabs of the leading axis, as in seeded_init; a Dense kernel's
        # fan stays its last two axes
        rows = max(1, _DRAW_VALUES // max(1, p[0].numel()))
        for part in p.split(rows):
            part.copy_(_draw(kind, arg, part.shape, gen, p.device))
    return module
