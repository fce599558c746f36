"""AdamW with the reference's parameter-group policy.

Counterpart of ``youku_mplug_tpu/optim/factory.py`` (the ``adamw`` path).
The masks are evaluated on the JAX package's parameter paths
(``bridge.jax_path`` of each port name), so the same leaves decay and
freeze:

- no weight decay for rank <= 1 leaves and for names containing
  ``pos_embed``, ``cls_token``, ``temporal_embed`` or ``bias`` (which
  takes AttentionPool's rank-3 ``bias_k`` / ``bias_v`` too);
- the text decoder is frozen (and the non-temporal vision tower under
  ``freeze_vit``), except its LoRA adapters (``lora_`` in the path),
  which train; frozen leaves get no optimizer state;
- a per-update cosine or linear schedule with linear warmup from 0.

- a per-leaf lr scale (``lr_scale_tree``): 0.1 on the non-temporal
  ``visual_encoder`` leaves of a CLIP-initialized tower
  (``visual_backbone_scale``, set for a ``clip_model`` tower), else 1.
  The JAX package's regex ``lr_scale_rules`` and layer decay are not
  ported (no port YAML sets them).

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
from typing import Callable, Dict, Optional

import numpy as np
import torch

NO_DECAY_NAMES = ("pos_embed", "cls_token", "temporal_embed", "bias")


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """The YAML ``optimizer`` / ``schedular`` blocks (same fields as the
    JAX package's ``OptimizerConfig``, adamw only)."""

    opt: str = "adamw"
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
                  visual_backbone_scale: bool = False) -> Dict[str, float]:
    """JAX path -> the leaf's lr multiplier: 0.1 on the non-temporal
    ``visual_encoder`` leaves under ``visual_backbone_scale``, else 1."""
    return {path: 0.1 if (visual_backbone_scale and "visual_encoder" in path
                          and "temporal" not in path) else 1.0
            for path in params}


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
            raise NotImplementedError(
                f"optimizer {config.opt!r} is not ported (adamw only)")
        self.config = config
        self.schedule = cosine_schedule(
            config.lr, config.min_lr, config.epochs, config.niter_per_ep,
            warmup_epochs=config.warmup_epochs,
            warmup_steps=config.warmup_steps, sched_type=config.sched_type)
        decay = decay_mask(params)
        scales = lr_scale_tree(params, config.visual_backbone_scale)
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


def create_optimizer(trainable: Dict[str, torch.Tensor],
                     config: OptimizerConfig):
    """-> (AdamW over the TRAINABLE leaves, schedule fn)."""
    opt = AdamW(trainable, config)
    return opt, opt.schedule
