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
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

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
    state = TrainState(trainable=trainable, frozen=frozen,
                       optimizer=optimizer)
    return state, optimizer, schedule
