"""The train step: gradient accumulation, global-norm clipping and the
non-finite skip.

Counterpart of ``youku_mplug_tpu/train/trainer.py``.  One step:

- ``update_freq > 1`` splits the batch's leading dim into that many
  micro-batches, sums their gradients and divides by ``update_freq``
  (the loss and scalar metrics are micro-batch means);
- ``grad_norm`` is the global L2 norm over the trainable leaves, taken
  before clipping;
- a non-finite loss or ``grad_norm`` skips the update whole: parameters,
  the optimizer's moments and its update count stay as they were (the
  step counter still advances);
- otherwise the gradients are clipped to ``clip_grad`` (optax's
  ``g / norm * clip`` when ``norm >= clip``) and the optimizer steps;
- with a ``dropout_seed``, the step's loss takes a ``torch.Generator``
  on the batch's device whose draws depend only on (seed, step counter)
  (``dropout_generator``): a resumed run draws the dropout masks an
  unbroken run would, the role of the JAX runners' ``fold_in`` of the
  epoch and step.

Under a (data, model) split (the state's ``mesh``, its model-split
leaves ``split``) the step is the (1,1) step on the global batch, as
JAX's GSPMD program is: each rank's loss is its share of the global one
(``parallel/data_parallel.py``), so the gradients and the scalar
metrics are summed over the data ranks (one ``all_reduce`` of the
flattened gradients); ``grad_norm`` is the whole model's, the squares
of the model-split leaves summed over the model ranks and the
replicated leaves counted once (model rank 0's); the gradients of the
replicated LoRA adapters on split products (the state's ``partial``),
each rank's share, are first summed over the model ranks (one more
``all_reduce``, ``ops/lora.py``); the loss and a
non-finite flag ride in the same reduction, so that clipping and the
skip are decided from the same values on every rank.  ``update_freq``
splits the rank's own rows, which the train loader orders micro-batch
by micro-batch (``parallel/sharding.data_shard(micro=)``): the rank's
micro-batch u is its block of the (1,1) step's micro-batch u, so a
micro-batch's masked mean and contrastive max are over the rows JAX's
takes.  The step's ``dropout_generator`` is the same on every rank (no
rank folded in) and every mask is drawn at the global micro-batch's
shape, each rank keeping its block (``ops/attention.py``): a split's
micro-batch u drops what the (1,1) step's micro-batch u drops.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from youku_mplug_tpu_torch.parallel.data_parallel import (
    data_group,
    sum_over_data,
)
from youku_mplug_tpu_torch.train.state import TrainState


def _split(batch: Dict, parts: int):
    """Dict of [B, ...] arrays or tensors -> ``parts`` dicts of
    micro-batches."""
    micro = [{} for _ in range(parts)]
    for key, value in batch.items():
        if value.shape[0] % parts:
            raise ValueError(f"batch dim {value.shape[0]} not divisible by "
                             f"update_freq {parts}")
        size = value.shape[0] // parts
        for i in range(parts):
            micro[i][key] = value[i * size:(i + 1) * size]
    return micro


def dropout_generator(seed: int, step: int, device,
                      stream: int = 0) -> torch.Generator:
    """A generator on ``device`` seeded from (``seed``, ``step``) alone;
    ``stream`` > 0 gives another independent one of the same step (the
    MLM masks of the BERT-family runners)."""
    entropy = [seed, step] + ([stream] if stream else [])
    mixed = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


def make_train_step(loss_fn: Callable, update_freq: int = 1,
                    dropout_seed: Optional[int] = None):
    """loss_fn(batch) -> dict with a scalar ``loss`` tensor (+ scalar
    metrics); with ``dropout_seed``, loss_fn(batch, generator), the
    step's ``dropout_generator`` (shared by its micro-batches, in order).
    Returns train_step(state, batch) -> metrics (floats)."""

    def train_step(state: TrainState, batch) -> Dict[str, float]:
        params = list(state.trainable.values())
        for p in params:
            p.grad = None
        micro = [batch] if update_freq <= 1 else _split(batch, update_freq)
        gen = None
        if dropout_seed is not None:
            device = next(v.device for v in batch.values()
                          if isinstance(v, torch.Tensor))
            gen = dropout_generator(dropout_seed, state.step, device)
        outs = []
        for mb in micro:
            out = loss_fn(mb) if gen is None else loss_fn(mb, gen)
            out["loss"].backward()
            outs.append({k: v.detach() for k, v in out.items()
                         if isinstance(v, torch.Tensor) and v.dim() == 0})
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if len(micro) > 1:
            torch._foreach_div_(grads, float(len(micro)))
        metrics = {k: torch.stack([o[k] for o in outs]).mean()
                   for k in outs[0]}
        mesh = state.mesh
        if state.partial and mesh.model > 1:
            shares = set(state.partial)
            _sum_grads([g for k, g in zip(state.trainable, grads)
                        if k in shares], mesh.model_group)
        dp = data_group(mesh)
        if dp is not None:
            _sum_grads(grads, dp.group)
            total = sum_over_data(torch.stack(list(metrics.values())), dp)
            metrics = dict(zip(metrics, total))
        grad_norm, finite = _grad_norm(state, grads, metrics["loss"])
        clip = state.optimizer.config.clip_grad
        if finite:
            if clip and grad_norm >= clip:
                torch._foreach_mul_(grads, (clip / grad_norm).item())
            for p, g in zip(params, grads):
                p.grad = g
            state.optimizer.step()
        for p in params:
            p.grad = None
        state.step += 1
        result = {k: float(v) for k, v in metrics.items()}
        result["grad_norm"] = float(grad_norm)
        result["skipped_nonfinite"] = 0.0 if finite else 1.0
        return result

    return train_step


def _sum_grads(grads: List[torch.Tensor], group) -> None:
    """Every gradient summed over the process ``group`` in place, in one
    ``all_reduce`` a dtype of the flattened tensors."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for same in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in same])
        dist.all_reduce(flat, group=group)
        for g, f in zip(same, torch.split(flat, [g.numel()
                                                 for g in same])):
            g.copy_(f.view_as(g))


def _grad_norm(state: TrainState, grads: List[torch.Tensor],
               loss: torch.Tensor):
    """(grad_norm, finite), the same on every rank: the L2 norm of the
    whole model's gradient and whether it and the loss are finite.  On a
    model split one ``all_reduce`` over the model group of [squares of
    the split leaves, squares of the replicated ones and the loss from
    model rank 0 alone, a non-finite flag]."""
    sq = torch.stack([g.float().square().sum() for g in grads])
    split = torch.tensor([k in state.split for k in state.trainable],
                         device=sq.device)
    mesh = state.mesh
    if mesh is None or mesh.model <= 1:
        grad_norm = sq.sum().sqrt()
        return grad_norm, bool(torch.isfinite(loss)
                               & torch.isfinite(grad_norm))
    first = float(mesh.model_index == 0)
    split_sq, rep_sq = sq[split].sum(), sq[~split].sum()
    vec = torch.stack([split_sq, rep_sq * first, loss.float() * first,
                       (~torch.isfinite(split_sq + rep_sq + loss)).float()])
    dist.all_reduce(vec, group=mesh.model_group)
    grad_norm = (vec[0] + vec[1]).sqrt()
    finite = bool(torch.isfinite(vec[2]) & torch.isfinite(grad_norm)
                  & (vec[3] == 0))
    return grad_norm, finite
