"""Train state: the trainable/frozen split and the optimizer.

Counterpart of ``youku_mplug_tpu/train/state.py``.  The freeze mask (on
the JAX paths, ``optim/factory.py``) splits the model's parameters:
trainable leaves stay fp32 master weights with ``requires_grad``; frozen
leaves (the GPT-3 decoder; the non-temporal vision tower under
``freeze_vit``) take no gradient, hold no optimizer state and are cast to
``frozen_dtype`` (bf16 in training: half the memory, the same numerics
contract).  Gradients still flow *through* a frozen module to its inputs.
The optimizer is any of ``optim/factory.create_optimizer``'s (AdamW, or
a zoo name): it holds state for the trainable leaves alone.

On a model that ``parallel/sharding.shard_params`` cut (its ``mesh`` and
``tp_split``), the state keeps the mesh and the JAX paths of the leaves
split over the model ranks (``split``: path -> dim): the masks read
paths and ranks, never a global shape, and AdamW's update is
elementwise, so each rank updates its slices as the (1,1) state would;
a zoo optimizer whose rule reads a whole leaf (a norm, a factored
moment) over a model-split trainable leaf raises (ROADMAP Queue 1 item
10).  ``partial`` holds the paths of the replicated LoRA adapters on a
model-split product (``tp_partial``): a rank's gradient of one is its
share, which the train step sums over the model group.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from youku_mplug_tpu_torch.bridge import jax_path
from youku_mplug_tpu_torch.optim.factory import (
    AdamW,
    OptimizerConfig,
    ZooOptimizer,
    create_optimizer,
    freeze_mask,
)


@dataclasses.dataclass
class TrainState:
    trainable: Dict[str, nn.Parameter]  # JAX path -> parameter
    frozen: Dict[str, nn.Parameter]
    optimizer: Union[AdamW, ZooOptimizer]
    step: int = 0  # train steps taken, skipped ones included
    mesh: Optional[Any] = None  # runtime/mesh.Mesh of a split model
    split: Dict[str, int] = dataclasses.field(default_factory=dict)
    partial: Tuple[str, ...] = ()


def create_train_state(model: nn.Module, config: OptimizerConfig,
                       frozen_dtype: Optional[torch.dtype] = None):
    """Split ``model``'s parameters in place (see module docstring).
    Returns (TrainState, optimizer, schedule fn)."""
    named = {jax_path(name): p for name, p in model.named_parameters()}
    frozen_tree = freeze_mask(named, config.freeze_text_decoder,
                              config.freeze_vit)
    trainable, frozen = {}, {}
    with torch.no_grad():
        for path, p in named.items():
            if frozen_tree[path]:
                p.requires_grad_(False)
                if frozen_dtype is not None and p.is_floating_point():
                    p.data = p.data.to(frozen_dtype)
                frozen[path] = p
            else:
                p.requires_grad_(True)
                trainable[path] = p
    optimizer, schedule = create_optimizer(trainable, config)
    split = {jax_path(name): d
             for name, d in getattr(model, "tp_split", {}).items()}
    if not isinstance(optimizer, AdamW) and set(split) & set(trainable):
        raise NotImplementedError(
            f"optimizer {config.opt!r} on model-split trainable leaves: "
            f"only AdamW's elementwise update runs on a model shard "
            f"(ROADMAP Queue 1 item 10)")
    partial = tuple(p for p in (jax_path(name) for name in
                                getattr(model, "tp_partial", ()))
                    if p in trainable)
    state = TrainState(trainable=trainable, frozen=frozen,
                       optimizer=optimizer,
                       mesh=getattr(model, "mesh", None), split=split,
                       partial=partial)
    return state, optimizer, schedule
