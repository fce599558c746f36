"""Parameter sharding by path rules: where each parameter is split over
the mesh's model axis.

Counterpart of ``youku_mplug_tpu/parallel/sharding.py``.  The rules are
JAX's, verbatim, as ``(regex, spec)`` pairs matched first-hit against a
parameter's JAX path (``bridge.jax_path`` of the port's name: the port
keeps JAX's names and shapes), a spec a tuple of ``"model"`` / None per
dim.  ``sharding_for_params`` applies them as JAX does: a spec shorter
than the parameter is right-aligned (the decoder's stacked ``[L, ...]``
leaves take the rule on their trailing dims), a longer one keeps its
trailing entries, and an axis that does not divide its dim is dropped.

GPT-3 tensor-parallel layout (Megatron's, on the port's shapes):
qkv ``[H, 3, n, d]`` and its bias split on the heads (column-parallel),
``out_kernel [n, d, H]`` on the heads (row-parallel: its product is
summed over the model ranks, ``out_bias`` added once after), the MLP's
``fc1`` on its columns and ``fc2`` on its rows (``fc2_bias`` after the
sum), the tied embedding on the vocab; the vision tower's attention the
same way on its heads (``proj_bias`` after the sum) and every module
whose path the ``mlp`` rules match (AttentionPool's MLP too); the rest
replicated.  ``shard_params`` keeps this rank's contiguous slice of each
split parameter (model index ``i`` of ``m``: ``[i * D / m, (i + 1) * D /
m)``) and hands each module that now holds a slice its ``ModelGroup``
(``parallel/tensor_parallel.py``), which runs the reductions.  Only
modules written for it take a slice (``TP_PARAM``: GPT-3's attention,
MLP and tied embedding, the vision attention and MLP); a rule that would
split any other module's parameter raises.

Bloom / mPLUG-Owl layout (``BLOOM_SHARDING_RULES``, ``models/bloom.py``,
``models/owl.py``): the head-major qkv ``[H, n, 3, d]`` and its bias cut
on the heads (the rank's ALiBi slopes are its slice of the ladder), the
output projection, fc1 / fc2 and the tied embedding as GPT-3's; the
per-frame ViT as the vision tower above; each abstractor layer's q / k / v
on their columns, its out projection on its rows (``out_bias`` after the
sum), the MLP's w1 / w3 on their columns, w2 on its rows and ``ffn_ln``
on the split intermediate width (``ops/layernorm.split_layer_norm``).

Expert layout (``MOE_SHARDING_RULES``, ``parallel/moe.py``): the expert
stacks ``w1``, ``b1``, ``w2``, ``b2`` of a module whose path names
``moe`` or ``expert`` cut on their leading expert dim; the router
replicated.

LoRA adapters stay whole on every rank, as JAX's rules replicate every
``lora_*`` leaf: on a split product the delta takes this rank's lanes of
``b`` (column-parallel) or of ``a`` (row-parallel) (``ops/lora.py``,
``cut_adapters``), and ``module.tp_partial`` names those adapters, whose
gradient on a rank is its share: the train step sums them over the model
group (``train/trainer.py``).
``unshard`` is the inverse (all-gather over the host group) and
``data_shard`` cuts a global batch by the data coordinate (JAX's
``data_sharding``).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from youku_mplug_tpu_torch.bridge import jax_path
from youku_mplug_tpu_torch.ops.lora import LoRAModule, cut_adapters
from youku_mplug_tpu_torch.ops.quant import SCALE_SUFFIX
from youku_mplug_tpu_torch.parallel.tensor_parallel import ModelGroup
from youku_mplug_tpu_torch.runtime.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    axis_sizes,
)

Spec = Tuple[Optional[str], ...]
ShardingRules = Sequence[Tuple[str, Spec]]

M = MODEL_AXIS
GPT3_SHARDING_RULES: ShardingRules = (
    # decoder (param shapes: see models/gpt3.py)
    (r".*word_embeddings/embedding$", (M, None)),
    (r".*attn/qkv_kernel$", (None, None, M, None)),
    (r".*attn/qkv_bias$", (None, M, None)),
    (r".*attn/out_kernel$", (M, None, None)),
    (r".*/mlp/fc1_kernel$", (None, M)),
    (r".*/mlp/fc1_bias$", (M,)),
    (r".*/mlp/fc2_kernel$", (M, None)),
    # vision encoder attention: heads column-parallel, the output
    # projection row-parallel, like the decoder
    (r".*attn/q_bias$", (M, None)),
    (r".*attn/v_bias$", (M, None)),
    (r".*attn/proj_kernel$", (M, None, None)),
    # everything else (layernorms, embeds, small heads): replicated
    (r".*", ()),
)

# Bloom / mPLUG-Owl rules: Bloom's fused QKV is head-major [H, n, 3, d];
# the abstractor's q/k/v column-parallel, its out projection row-parallel
BLOOM_SHARDING_RULES: ShardingRules = (
    (r".*word_embeddings/embedding$", (M, None)),
    (r".*decoder/.*attn/qkv_kernel$", (None, M, None, None)),
    (r".*decoder/.*attn/qkv_bias$", (M, None, None)),
    (r".*attn/out_kernel$", (M, None, None)),
    # vision ViT fused qkv keeps the GPT-3 [D, 3, n, d] layout
    (r".*attn/qkv_kernel$", (None, None, M, None)),
    (r".*/mlp/fc1_kernel$", (None, M)),
    (r".*/mlp/fc1_bias$", (M,)),
    (r".*/mlp/fc2_kernel$", (M, None)),
    # visual abstractor
    (r".*abstractor.*/(q|k|v)_kernel$", (None, M)),
    (r".*abstractor.*/(q|k|v)_bias$", (M,)),
    (r".*abstractor.*/out_kernel$", (M, None)),
    (r".*abstractor.*/mlp/(w1|w3)_kernel$", (None, M)),
    (r".*abstractor.*/mlp/(w1|w3)_bias$", (M,)),
    (r".*abstractor.*/mlp/w2_kernel$", (M, None)),
    (r".*abstractor.*/mlp/ffn_ln/(scale|bias)$", (M,)),
    # per-frame ViT (same layout as the TimeSformer rules)
    (r".*attn/q_bias$", (M, None)),
    (r".*attn/v_bias$", (M, None)),
    (r".*attn/proj_kernel$", (M, None, None)),
    (r".*", ()),
)

# expert parallelism (``parallel/moe.py``; JAX's ``moe_rules()``): the
# leading expert dim of the expert stacks on the model axis; merged ahead
# of a rule set's catch-all
MOE_SHARDING_RULES: ShardingRules = (
    (r".*(moe|expert).*/w1$", (M, None, None)),
    (r".*(moe|expert).*/w2$", (M, None, None)),
    (r".*(moe|expert).*/b1$", (M, None)),
    (r".*(moe|expert).*/b2$", (M, None)),
)
del M


def _match(path: str, rules: ShardingRules) -> Spec:
    for pattern, spec in rules:
        if re.match(pattern, path):
            return tuple(spec)
    return ()


def spec_for(path: str, shape: Sequence[int], mesh, rules: ShardingRules
             ) -> Spec:
    """The spec of the leaf at JAX ``path`` of ``shape`` (JAX's
    ``spec_for``): the first matching rule, right-aligned to the leaf's
    rank, an axis dropped where it does not divide its dim."""
    sizes = axis_sizes(mesh)
    spec = _match(path, rules)
    ndim, n = len(shape), len(spec)
    if n < ndim:
        spec = (None,) * (ndim - n) + spec
    elif n > ndim:
        spec = spec[n - ndim:]
    return tuple(None if axis is not None and dim % sizes[axis] else axis
                 for dim, axis in zip(shape, spec))


def sharding_for_params(named_params, mesh,
                        rules: ShardingRules = GPT3_SHARDING_RULES
                        ) -> Dict[str, Spec]:
    """{port name: spec} for ``named_params`` (``module.named_parameters()``
    or a mapping of name -> tensor), after the rules on their JAX paths.
    ``mesh``: a ``Mesh`` or a mapping of axis sizes."""
    items = named_params.items() if isinstance(named_params, Mapping) \
        else named_params
    return {name: spec_for(jax_path(name), tuple(p.shape), mesh, rules)
            for name, p in items}


def _sharded_dim(spec: Spec) -> Optional[int]:
    dims = [i for i, axis in enumerate(spec) if axis == MODEL_AXIS]
    if len(dims) > 1:
        raise ValueError(f"spec {spec} splits more than one dim")
    return dims[0] if dims else None


def _owner(module: nn.Module, name: str) -> Tuple[nn.Module, str]:
    prefix, _, leaf = name.rpartition(".")
    return (module.get_submodule(prefix) if prefix else module), leaf


def _split(t: torch.Tensor, dim: int, index: int, parts: int
           ) -> torch.Tensor:
    size = t.shape[dim] // parts
    return t.narrow(dim, index * size, size).clone()


# what ``shard_params`` (and ``ops/lora.cut_adapters``) set on a module of
# a model shard besides its parameters: a module that mirrors a shard
# takes these over with ``copy_shard_state``
SHARD_STATE = ("tp", "mesh", "tp_split", "tp_partial", "lora_cut")


def copy_shard_state(src: nn.Module, dst: nn.Module) -> nn.Module:
    """Give each submodule of ``dst`` the SHARD_STATE its namesake in
    ``src`` holds (the model group, the mesh, the split and adapter
    cuts), e.g. a shallower twin of a shard (``serving/speculative.
    twin_draft``).  Returns ``dst``."""
    for name, mod in src.named_modules():
        twin = dst.get_submodule(name)
        for attr in SHARD_STATE:
            if attr in vars(mod):
                setattr(twin, attr, getattr(mod, attr))
    return dst


@torch.no_grad()
def shard_params(module: nn.Module, mesh: Mesh,
                 rules: ShardingRules = GPT3_SHARDING_RULES) -> nn.Module:
    """Keep this rank's slice of every parameter the rules split over the
    model axis (an int8 parameter's scales with it), hand the modules
    that hold a slice their ``ModelGroup`` (and the adapters on their
    split products their cut), and set ``module.mesh``,
    ``module.tp_split`` ({name: the dim cut}) and ``module.tp_partial``
    (the adapters a rank computes a share of the gradient of), and
    ``mesh`` on every submodule that declares one (the losses' data
    group, ``parallel/data_parallel.py``).
    Returns ``module``.  Under ``model == 1`` nothing is split."""
    specs = sharding_for_params(module.named_parameters(), mesh, rules)
    split = {name: d for name, spec in specs.items()
             if (d := _sharded_dim(spec)) is not None} \
        if mesh.model > 1 else {}
    if split and mesh.model_group is None:
        raise ValueError(f"a {mesh.data}x{mesh.model} mesh without process "
                         f"groups cannot hold model shards")
    tp = ModelGroup(mesh.model_group, mesh.model_index, mesh.model)
    owners = {}  # module prefix -> module
    partial = []  # replicated adapters whose gradient is a rank's share
    for name, dim in split.items():
        owner, leaf = _owner(module, name)
        if getattr(type(owner), "TP_PARAM", None) is None:
            raise NotImplementedError(
                f"{name} ({type(owner).__name__}) has no model-parallel "
                f"form")
        prefix = name.rpartition(".")[0]
        owners[prefix] = owner
        p = getattr(owner, leaf)
        if isinstance(owner, LoRAModule):
            partial += [".".join(filter(None, (prefix, a))) for a in
                        cut_adapters(owner, leaf, tuple(p.shape), dim)]
        p.data = _split(p.data, dim, mesh.model_index, mesh.model)
        scale = getattr(owner, leaf + SCALE_SUFFIX, None)
        if scale is not None and scale.shape[dim] > 1:
            setattr(owner, leaf + SCALE_SUFFIX,
                    _split(scale, dim, mesh.model_index, mesh.model))
    for prefix, owner in owners.items():
        if ".".join(filter(None, (prefix, owner.TP_PARAM))) not in split:
            raise ValueError(f"{type(owner).__name__}: its row-parallel "
                             f"{owner.TP_PARAM} is not split")
        owner.tp = tp
    for m in module.modules():
        if hasattr(type(m), "mesh"):
            m.mesh = mesh
    module.mesh, module.tp_split, module.tp_partial = mesh, split, partial
    return module


@torch.no_grad()
def gather_split(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """A model-split tensor unsharded on the CPU, on every rank:
    all-gathered over the host group and joined along ``dim`` from the
    ranks of this rank's model line, in model order."""
    local = t.detach().cpu().contiguous()
    parts = [torch.empty_like(local) for _ in range(mesh.size)]
    dist.all_gather(parts, local, group=mesh.host_group)
    line = [mesh.data_index * mesh.model + i for i in range(mesh.model)]
    return torch.cat([parts[r] for r in line], dim=dim)


def local_slice(full: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous slice along ``dim`` of an unsharded tensor
    (``shard_params``' cut)."""
    return _split(full, dim, mesh.model_index, mesh.model)


@torch.no_grad()
def unshard(module: nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The unsharded parameters {port name: CPU tensor} of a module that
    ``shard_params`` split, on every rank (``gather_split``); the others
    copied."""
    split = getattr(module, "tp_split", {})
    return {name: gather_split(p, split[name], mesh) if name in split
            else p.detach().cpu().clone()
            for name, p in module.named_parameters()}


def data_shard(batch: Dict[str, Any], mesh,
               micro: int = 1) -> Dict[str, Any]:
    """This data rank's contiguous block of a global batch: rows
    ``[i * B / D, (i + 1) * B / D)`` of every array (and list) field,
    ``i`` the data coordinate, as JAX's ``data_sharding`` places them;
    with ``micro`` U > 1 (a step's ``update_freq``) its block of each of
    the U micro-batches JAX's step splits the batch into, in order (the
    train loader's ``micro_count``)."""
    sizes = axis_sizes(mesh)
    parts = sizes[DATA_AXIS]
    index = mesh.data_index if isinstance(mesh, Mesh) else 0
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor, list, tuple)):
            n = len(v)
            if n % (parts * micro):
                raise ValueError(f"{k}: batch {n} not divisible by "
                                 f"data={parts} x {micro} micro-batches")
            size, stride = n // (parts * micro), n // micro
            pieces = [v[u * stride + index * size:
                        u * stride + (index + 1) * size]
                      for u in range(micro)]
            if micro == 1:
                v = pieces[0]
            elif isinstance(v, np.ndarray):
                v = np.concatenate(pieces)
            elif isinstance(v, torch.Tensor):
                v = torch.cat(pieces)
            else:
                v = type(v)(x for piece in pieces for x in piece)
        out[k] = v
    return out
