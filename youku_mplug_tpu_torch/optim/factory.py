"""The optimizer factory: AdamW, or any name of the timm zoo, under the
reference's parameter-group policy.

Counterpart of ``youku_mplug_tpu/optim/factory.py``.  The masks are
evaluated on the JAX package's parameter paths (``bridge.jax_path`` of
each port name), so the same leaves decay and freeze:

- no weight decay for rank <= 1 leaves and for names containing
  ``pos_embed``, ``cls_token``, ``temporal_embed`` or ``bias`` (which
  takes AttentionPool's rank-3 ``bias_k`` / ``bias_v`` too);
- the text decoder is frozen (and the non-temporal vision tower under
  ``freeze_vit``), except its LoRA adapters (``lora_`` in the path),
  which train; frozen leaves get no optimizer state;
- a per-update cosine or linear schedule with linear warmup from 0.

- a per-leaf lr scale (``leaf_scales``): the first ``lr_scale_rules``
  (regex, scale) pair whose pattern ``re.search``-es the path, else 0.1
  on the non-temporal ``visual_encoder`` leaves of a CLIP-initialized
  tower (``visual_backbone_scale``, set for a ``clip_model`` tower), else
  1; times, with ``layer_decay``, ``decay^(L + 1 - vit_layer_id)``.  The
  scale multiplies each leaf's whole update.

``adam`` and ``adamw`` take the AdamW class below.  Every other name
(``optim/zoo.py``) takes ``ZooOptimizer``: the zoo rule over two groups,
decay and no-decay by ``decay_mask`` (weight decay 0 in the second), one
update count and schedule for both, then the per-leaf scale, as JAX's
``multi_transform`` of two ``zoo_optimizer`` chains followed by its
scale tree.

``AdamW`` reproduces optax's chain ``clip -> scale_by_adam -> masked
add_decayed_weights -> scale_by_learning_rate(schedule) -> per-leaf
scale`` with ``torch.optim.AdamW`` over one parameter group per (decay,
scale) pair: each group's lr is ``schedule(count) * scale``, and torch's
decoupled decay ``p *= 1 - lr * scale * wd`` is optax's ``- lr * scale *
wd * p`` (the scale multiplies the whole update there).  The
schedule is indexed by the optimizer's own update count, which starts
at 0 (so under warmup the first applied update has lr 0) and does not
advance on a skipped step.  Clipping belongs to the train step, which
measures the gradient norm first (``train/trainer.py``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, Optional

import numpy as np
import torch

from youku_mplug_tpu_torch.optim import zoo

NO_DECAY_NAMES = ("pos_embed", "cls_token", "temporal_embed", "bias")


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """The YAML ``optimizer`` / ``schedular`` blocks (the JAX package's
    ``OptimizerConfig``, field for field)."""

    opt: str = "adamw"
    momentum: float = 0.9  # the sgd / sgdp / rmsprop / lars family
    lr: float = 1e-4
    min_lr: float = 1e-6
    weight_decay: float = 0.05
    opt_betas: tuple = (0.9, 0.98)
    opt_eps: float = 1e-8
    clip_grad: Optional[float] = 3.0
    warmup_steps: int = -1
    warmup_epochs: float = 0.0
    epochs: int = 10
    niter_per_ep: int = 1000
    sched_type: str = "cos"
    visual_backbone_scale: bool = False
    # per-leaf lr multipliers, (path regex, scale) pairs: the first match
    lr_scale_rules: tuple = ()
    # layer-wise lr decay: scale = decay^(num_layers + 1 - layer_id)
    layer_decay: Optional[float] = None
    layer_decay_num_layers: int = 12
    freeze_text_decoder: bool = True
    freeze_vit: bool = False


def decay_mask(params: Dict[str, torch.Tensor]) -> Dict[str, bool]:
    """JAX path -> True where weight decay applies."""
    return {path: p.dim() > 1 and not any(n in path for n in NO_DECAY_NAMES)
            for path, p in params.items()}


def freeze_mask(params: Dict[str, torch.Tensor], freeze_text_decoder=True,
                freeze_vit=False) -> Dict[str, bool]:
    """JAX path -> True where the leaf is frozen (``freeze_vit`` spares
    temporal/time leaves; LoRA adapters always train)."""
    def rule(path):
        if "lora_" in path:
            return False
        if freeze_text_decoder and "text_decoder" in path:
            return True
        return (freeze_vit and "visual_encoder" in path
                and "temporal" not in path and "time" not in path)
    return {path: rule(path) for path in params}


def lr_scale_tree(params: Dict[str, torch.Tensor],
                  visual_backbone_scale: bool = False,
                  lr_scale_rules=()) -> Dict[str, float]:
    """JAX path -> the leaf's lr multiplier: the first (regex, scale) of
    ``lr_scale_rules`` that matches, else 0.1 on the non-temporal
    ``visual_encoder`` leaves under ``visual_backbone_scale``, else 1."""
    def rule(path):
        for pattern, scale in lr_scale_rules:
            if re.search(pattern, path):
                return float(scale)
        if visual_backbone_scale and "visual_encoder" in path and \
                "temporal" not in path:
            return 0.1
        return 1.0
    return {path: rule(path) for path in params}


def vit_layer_id(path: str, num_max_layer: int) -> int:
    """Layer id of a leaf for layer decay: the embeddings at 0,
    ``blocks_<i>`` at i + 1, ``rel_pos_bias*`` at the top but one,
    everything else at the top."""
    for p in path.split("/"):
        if p in ("cls_token", "mask_token", "pos_embed", "temporal_embed",
                 "patch_embed"):
            return 0
        if p.startswith("rel_pos_bias"):
            return num_max_layer - 1
        if p.startswith("blocks_"):
            return int(p.split("_")[1]) + 1
    return num_max_layer


def layer_decay_scale_tree(params: Dict[str, torch.Tensor], decay: float,
                           num_layers: int) -> Dict[str, float]:
    """JAX path -> decay^(num_layers + 1 - layer_id).  A block past
    ``num_layers`` raises ValueError (JAX's list lookup raises IndexError
    there): set ``layer_decay_num_layers`` to the tower's depth."""
    values = [decay ** (num_layers + 1 - i) for i in range(num_layers + 2)]
    ids = {path: vit_layer_id(path, num_layers + 1) for path in params}
    deeper = sorted(p for p, i in ids.items() if i >= len(values))
    if deeper:
        raise ValueError(f"layer decay over {num_layers} layers, but "
                         f"{deeper[0]} sits deeper: set "
                         f"layer_decay_num_layers to the tower's depth")
    return {path: float(values[i]) for path, i in ids.items()}


def leaf_scales(params: Dict[str, torch.Tensor],
                config: "OptimizerConfig") -> Dict[str, float]:
    """The multiplier of each leaf's whole update: ``lr_scale_tree``
    times, with ``layer_decay``, ``layer_decay_scale_tree``."""
    scales = lr_scale_tree(params, config.visual_backbone_scale,
                           config.lr_scale_rules)
    if config.layer_decay is not None:
        ld = layer_decay_scale_tree(params, config.layer_decay,
                                    config.layer_decay_num_layers)
        scales = {k: scales[k] * ld[k] for k in scales}
    return scales


def schedule_of(config: "OptimizerConfig") -> Callable[[int], float]:
    return cosine_schedule(
        config.lr, config.min_lr, config.epochs, config.niter_per_ep,
        warmup_epochs=config.warmup_epochs,
        warmup_steps=config.warmup_steps, sched_type=config.sched_type)


def cosine_schedule(base_value, final_value, epochs, niter_per_ep,
                    warmup_epochs=0.0, warmup_steps=-1,
                    start_warmup_value=0.0,
                    sched_type="cos") -> Callable[[int], float]:
    """Per-update schedule: linear warmup from ``start_warmup_value``,
    then cosine (or linear) decay to ``final_value``."""
    total = int(epochs * niter_per_ep)
    warmup = int(warmup_steps) if warmup_steps and warmup_steps > 0 else \
        int(warmup_epochs * niter_per_ep)
    decay_steps = max(total - warmup, 1)
    if sched_type not in ("cos", "cosine", "linear"):
        raise NotImplementedError(sched_type)

    def fn(step: int) -> float:
        # float32 arithmetic, as the JAX package evaluates it
        step = np.float32(step)
        if step < warmup:
            # np.linspace(a, b, n)[i] = a + i * (b - a) / (n - 1)
            return float(np.float32(start_warmup_value) + step * np.float32(
                (base_value - start_warmup_value) / max(warmup - 1, 1)))
        i = np.clip(step - np.float32(warmup), np.float32(0),
                    np.float32(decay_steps))
        if sched_type == "linear":
            return float(np.float32(base_value) + np.float32(
                final_value - base_value) * (
                    i / np.float32(max(decay_steps - 1, 1))))
        return float(np.float32(final_value) + np.float32(
            0.5 * (base_value - final_value)) * (np.float32(1) + np.cos(
                np.float32(np.pi) * i / np.float32(decay_steps))))

    return fn


class AdamW:
    """optax's adamw chain over a dict of trainable parameters (JAX path
    -> fp32 tensor); see the module docstring."""

    def __init__(self, params: Dict[str, torch.Tensor],
                 config: OptimizerConfig):
        if config.opt.lower() not in ("adamw", "adam"):
            raise ValueError(f"AdamW takes adam / adamw, not {config.opt!r}"
                             " (create_optimizer dispatches the zoo)")
        self.config = config
        self.schedule = schedule_of(config)
        self.params = dict(params)
        decay = decay_mask(params)
        scales = leaf_scales(params, config)
        groups = [{"params": [params[p] for p in sorted(params)
                              if (decay[p], scales[p]) == (dec, scale)],
                   "weight_decay": config.weight_decay if dec else 0.0,
                   "lr_scale": scale}
                  for dec in (False, True)
                  for scale in sorted(set(scales.values()))]
        self.torch_optimizer = torch.optim.AdamW(
            [g for g in groups if g["params"]], lr=0.0,
            betas=tuple(config.opt_betas), eps=config.opt_eps)
        self.count = 0  # applied updates: the schedule's index

    def step(self) -> float:
        """Apply one update from the parameters' ``.grad``; returns the lr
        it used."""
        lr = self.schedule(self.count)
        for group in self.torch_optimizer.param_groups:
            group["lr"] = lr * group["lr_scale"]
        self.torch_optimizer.step()
        self.count += 1
        return lr

    def leaf_state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """JAX path -> the leaf's moments (``exp_avg``, ``exp_avg_sq``,
        ``step``); a leaf not yet updated has none."""
        out = {}
        for path, p in self.params.items():
            s = self.torch_optimizer.state.get(p)
            if s:
                out[path] = {k: s[k] for k in
                             ("exp_avg", "exp_avg_sq", "step")}
        return out

    def scalars(self) -> Dict[str, float]:
        return {}

    def load_state(self, leaves: Dict[str, Dict[str, torch.Tensor]],
                   scalars: Dict[str, float]):
        """``leaf_state``'s inverse (each tensor copied onto its leaf's
        device; torch keeps a non-capturable AdamW's step on the CPU)."""
        state = self.torch_optimizer.state
        for path, p in self.params.items():
            if path in leaves:
                saved = leaves[path]
                state[p] = {"exp_avg": saved["exp_avg"].to(p.device),
                            "exp_avg_sq": saved["exp_avg_sq"].to(p.device),
                            "step": saved["step"].cpu()}
            else:
                state.pop(p, None)


class ZooOptimizer:
    """Any zoo name (``optim/zoo.py``) over a dict of trainable parameters
    (JAX path -> fp32 tensor), with AdamW's interface: ``step()`` applies
    one update from the parameters' ``.grad`` and returns the lr it
    used."""

    def __init__(self, params: Dict[str, torch.Tensor],
                 config: OptimizerConfig):
        self.config = config
        self.schedule = schedule_of(config)
        self.params = dict(params)
        decay = decay_mask(params)
        self.scales = leaf_scales(params, config)
        self.update = zoo.ZooUpdate(
            config.opt, self.params,
            {k: config.weight_decay if decay[k] else 0.0 for k in params},
            self.schedule, momentum=config.momentum,
            betas=tuple(config.opt_betas), eps=config.opt_eps)

    @property
    def count(self) -> int:
        return self.update.count

    @count.setter
    def count(self, value: int):
        self.update.count = int(value)

    @torch.no_grad()
    def step(self) -> float:
        lr = self.schedule(self.count)
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in self.params.items()}
        updates = self.update.apply(
            {k: p.detach() for k, p in self.params.items()}, grads)
        for k, p in self.params.items():
            s = self.scales[k]
            p.add_(updates[k] if s == 1.0 else updates[k] * s)
        return lr

    def leaf_state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """JAX path -> the leaf's state tensors by name (the lookahead's
        slow weights as ``slow``)."""
        return {k: dict(v) for k, v in self.update.state.items()}

    def scalars(self) -> Dict[str, float]:
        return self.update.rule.scalars()

    def load_state(self, leaves: Dict[str, Dict[str, torch.Tensor]],
                   scalars: Dict[str, float]):
        for path, p in self.params.items():
            self.update.state[path] = {
                k: v.to(device=p.device) for k, v in leaves[path].items()}
        self.update.rule.load_scalars(scalars)


def create_optimizer(trainable: Dict[str, torch.Tensor],
                     config: OptimizerConfig):
    """-> (the optimizer over the TRAINABLE leaves, schedule fn): AdamW
    for adam / adamw, ``ZooOptimizer`` for every other name (an unknown
    one raises ValueError, adahessian NotImplementedError)."""
    if config.opt.lower() in ("adamw", "adam"):
        opt = AdamW(trainable, config)
    else:
        opt = ZooOptimizer(trainable, config)
    return opt, opt.schedule
