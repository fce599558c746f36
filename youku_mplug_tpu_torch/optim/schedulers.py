"""The timm-style learning-rate schedulers: cosine with restarts
(``t_mul``) and per-cycle decay, tanh, step and plateau, with lr noise.

Counterpart of ``youku_mplug_tpu/optim/schedulers.py``, value for value:
each scheduler is a host-side callable, ``lr = sched(t)`` for an epoch
index (``t_in_epochs``) or an update index, and ``create_scheduler(args)``
dispatches on ``args.sched`` in {cosine, cosine_step, tanh, step,
plateau} and returns (scheduler, number of epochs).  The lr noise draws
from a ``torch.Generator`` seeded ``noise_seed + t``, so one config gives
one noise trajectory.  As in the JAX package, the training runners use
the analytic per-update schedule of ``optim/factory.py``
(``cosine_schedule``); these cover the rest of timm's surface.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _noise_value(noise_type: str, noise_pct: float, noise_std: float,
                 seed: int, t: int) -> float:
    g = torch.Generator()
    g.manual_seed(seed + t)
    if noise_type == "normal":
        while True:
            noise = torch.randn(1, generator=g).item()
            if abs(noise) < noise_pct:
                return noise
    return 2 * (torch.rand(1, generator=g).item() - 0.5) * noise_pct


class _NoiseMixin:
    def _maybe_noise(self, lr: float, t: int) -> float:
        rng_t = self.noise_range_t
        if rng_t is None:
            return lr
        if isinstance(rng_t, (list, tuple)):
            apply = rng_t[0] <= t < rng_t[1]
        else:
            apply = t >= rng_t
        if not apply:
            return lr
        noise = _noise_value(self.noise_type, self.noise_pct,
                             self.noise_std, self.noise_seed, t)
        return lr + lr * noise


def _cycle(t: float, t_initial: int, t_mul: float):
    """-> (cycle index i, t_curr within cycle, cycle length t_i)."""
    if t_mul != 1:
        i = math.floor(
            math.log(1 - t / t_initial * (1 - t_mul), t_mul))
        t_i = t_mul ** i * t_initial
        t_curr = t - (1 - t_mul ** i) / (1 - t_mul) * t_initial
    else:
        i = t // t_initial
        t_i = t_initial
        t_curr = t - t_initial * i
    return i, t_curr, t_i


class CosineLRScheduler(_NoiseMixin):
    """Cosine decay with warmup, restarts (t_mul) and per-cycle decay_rate
    (SGDR, Loshchilov & Hutter 2016; reference scheduler/cosine_lr.py:19-117).
    """

    def __init__(self, base_lr: float, t_initial: int, t_mul: float = 1.0,
                 lr_min: float = 0.0, decay_rate: float = 1.0,
                 warmup_t: int = 0, warmup_lr_init: float = 0.0,
                 warmup_prefix: bool = True, cycle_limit: int = 0,
                 t_in_epochs: bool = True,
                 noise_range_t=None, noise_pct: float = 0.67,
                 noise_std: float = 1.0, noise_seed: int = 42,
                 noise_type: str = "normal"):
        assert t_initial > 0 and lr_min >= 0
        self.base_lr = base_lr
        self.t_initial = t_initial
        self.t_mul = t_mul
        self.lr_min = lr_min
        self.decay_rate = decay_rate
        self.warmup_t = warmup_t
        self.warmup_lr_init = warmup_lr_init
        self.warmup_prefix = warmup_prefix
        self.cycle_limit = cycle_limit
        self.t_in_epochs = t_in_epochs
        self.noise_range_t = noise_range_t
        self.noise_pct = noise_pct
        self.noise_std = noise_std
        self.noise_seed = noise_seed
        self.noise_type = noise_type
        self.warmup_step = ((base_lr - warmup_lr_init) / warmup_t
                            if warmup_t else 1.0)

    def _get_lr(self, t: float) -> float:
        if t < self.warmup_t:
            return self.warmup_lr_init + t * self.warmup_step
        if self.warmup_prefix:
            t = t - self.warmup_t
        i, t_curr, t_i = _cycle(t, self.t_initial, self.t_mul)
        gamma = self.decay_rate ** i
        lr_min = self.lr_min * gamma
        lr_max = self.base_lr * gamma
        if self.cycle_limit == 0 or i < self.cycle_limit:
            return lr_min + 0.5 * (lr_max - lr_min) * (
                1 + math.cos(math.pi * t_curr / t_i))
        return self.lr_min

    def __call__(self, t: float) -> float:
        return self._maybe_noise(self._get_lr(t), int(t))

    def get_cycle_length(self, cycles: int = 0) -> int:
        cycles = max(1, cycles or self.cycle_limit)
        if self.t_mul == 1.0:
            return self.t_initial * cycles
        return int(math.floor(-self.t_initial * (self.t_mul ** cycles - 1)
                              / (1 - self.t_mul)))


class TanhLRScheduler(_NoiseMixin):
    """Hyperbolic-tangent decay (Hundt et al. 2019; reference
    scheduler/tanh_lr.py:18-120).  NB: warmup here is NOT prefix by
    default and the warmup target is the post-warmup curve value."""

    def __init__(self, base_lr: float, t_initial: int, lb: float = -6.0,
                 ub: float = 4.0, t_mul: float = 1.0, lr_min: float = 0.0,
                 decay_rate: float = 1.0, warmup_t: int = 0,
                 warmup_lr_init: float = 0.0, warmup_prefix: bool = False,
                 cycle_limit: int = 0,
                 noise_range_t=None, noise_pct: float = 0.67,
                 noise_std: float = 1.0, noise_seed: int = 42,
                 noise_type: str = "normal"):
        assert t_initial > 0 and lr_min >= 0 and lb < ub
        self.base_lr = base_lr
        self.lb, self.ub = lb, ub
        self.t_initial = t_initial
        self.t_mul = t_mul
        self.lr_min = lr_min
        self.decay_rate = decay_rate
        self.warmup_t = warmup_t
        self.warmup_lr_init = warmup_lr_init
        self.warmup_prefix = warmup_prefix
        self.cycle_limit = cycle_limit
        self.noise_range_t = noise_range_t
        self.noise_pct = noise_pct
        self.noise_std = noise_std
        self.noise_seed = noise_seed
        self.noise_type = noise_type
        if warmup_t:
            target = (base_lr if warmup_prefix
                      else self._curve(float(warmup_t)))
            self.warmup_step = (target - warmup_lr_init) / warmup_t
        else:
            self.warmup_step = 1.0

    def _curve(self, t: float) -> float:
        i, t_curr, t_i = _cycle(t, self.t_initial, self.t_mul)
        if self.cycle_limit == 0 or i < self.cycle_limit:
            gamma = self.decay_rate ** i
            lr_min = self.lr_min * gamma
            lr_max = self.base_lr * gamma
            tr = t_curr / t_i
            return lr_min + 0.5 * (lr_max - lr_min) * (
                1 - math.tanh(self.lb * (1.0 - tr) + self.ub * tr))
        return self.lr_min * (self.decay_rate ** self.cycle_limit)

    def _get_lr(self, t: float) -> float:
        if t < self.warmup_t:
            return self.warmup_lr_init + t * self.warmup_step
        if self.warmup_prefix:
            t = t - self.warmup_t
        return self._curve(t)

    def __call__(self, t: float) -> float:
        return self._maybe_noise(self._get_lr(t), int(t))


class StepLRScheduler(_NoiseMixin):
    """Stair-step decay every ``decay_t`` (reference scheduler/step_lr.py)."""

    def __init__(self, base_lr: float, decay_t: float,
                 decay_rate: float = 1.0, warmup_t: int = 0,
                 warmup_lr_init: float = 0.0,
                 noise_range_t=None, noise_pct: float = 0.67,
                 noise_std: float = 1.0, noise_seed: int = 42,
                 noise_type: str = "normal"):
        self.base_lr = base_lr
        self.decay_t = decay_t
        self.decay_rate = decay_rate
        self.warmup_t = warmup_t
        self.warmup_lr_init = warmup_lr_init
        self.noise_range_t = noise_range_t
        self.noise_pct = noise_pct
        self.noise_std = noise_std
        self.noise_seed = noise_seed
        self.noise_type = noise_type
        self.warmup_step = ((base_lr - warmup_lr_init) / warmup_t
                            if warmup_t else 1.0)

    def _get_lr(self, t: float) -> float:
        if t < self.warmup_t:
            return self.warmup_lr_init + t * self.warmup_step
        return self.base_lr * (self.decay_rate ** (t // self.decay_t))

    def __call__(self, t: float) -> float:
        return self._maybe_noise(self._get_lr(t), int(t))


class PlateauLRScheduler(_NoiseMixin):
    """Decay on metric plateau — stateful by nature (reference
    scheduler/plateau_lr.py wraps torch ReduceLROnPlateau; the reduction
    logic is re-implemented here in pure python)."""

    def __init__(self, base_lr: float, decay_rate: float = 0.1,
                 patience_t: int = 10, threshold: float = 1e-4,
                 cooldown_t: int = 0, mode: str = "max",
                 lr_min: float = 0.0, warmup_t: int = 0,
                 warmup_lr_init: float = 0.0,
                 noise_range_t=None, noise_pct: float = 0.67,
                 noise_std: float = 1.0, noise_seed: int = 42,
                 noise_type: str = "normal"):
        self.lr = base_lr
        self.base_lr = base_lr
        self.decay_rate = decay_rate
        self.patience_t = patience_t
        self.threshold = threshold
        self.cooldown_t = cooldown_t
        self.mode = mode
        self.lr_min = lr_min
        self.warmup_t = warmup_t
        self.warmup_lr_init = warmup_lr_init
        self.noise_range_t = noise_range_t
        self.noise_pct = noise_pct
        self.noise_std = noise_std
        self.noise_seed = noise_seed
        self.noise_type = noise_type
        self.warmup_step = ((base_lr - warmup_lr_init) / warmup_t
                            if warmup_t else 1.0)
        self.best: Optional[float] = None
        self.num_bad = 0
        self.cooldown = 0

    def _is_better(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "max":
            return metric > self.best * (1 + self.threshold)
        return metric < self.best * (1 - self.threshold)

    def step(self, epoch: int, metric: Optional[float] = None) -> float:
        """Advance one epoch with the eval metric; returns the new lr."""
        if epoch <= self.warmup_t and self.warmup_t:
            self.lr = self.warmup_lr_init + epoch * self.warmup_step
            return self.lr
        if metric is not None:
            if self._is_better(metric):
                self.best = metric
                self.num_bad = 0
            else:
                self.num_bad += 1
            if self.cooldown > 0:
                self.cooldown -= 1
                self.num_bad = 0
            elif self.num_bad > self.patience_t:
                self.lr = max(self.lr * self.decay_rate, self.lr_min)
                self.cooldown = self.cooldown_t
                self.num_bad = 0
        return self._maybe_noise(self.lr, epoch)


def create_scheduler(args) -> tuple:
    """timm-style factory (reference scheduler/scheduler_factory.py:10-100):
    dispatch on ``args.sched`` in {cosine, cosine_step, tanh, step,
    plateau}; returns (scheduler, num_epochs).  ``args`` is any object
    with the reference's attribute names (an ``addict.Dict``-style config
    or argparse namespace)."""
    g = lambda name, default=None: getattr(args, name, default)  # noqa: E731
    num_epochs = args.epochs
    lr_noise = g("lr_noise")
    if lr_noise is not None:
        if isinstance(lr_noise, (list, tuple)):
            noise_range = [n * num_epochs for n in lr_noise]
            if len(noise_range) == 1:
                noise_range = noise_range[0]
        else:
            noise_range = lr_noise * num_epochs
    else:
        noise_range = None
    noise_kw = dict(noise_range_t=noise_range,
                    noise_pct=g("lr_noise_pct", 0.67),
                    noise_std=g("lr_noise_std", 1.0),
                    noise_seed=g("seed", 42))

    sched = args.sched
    if sched in ("cosine", "cosine_step"):
        t_initial = (num_epochs if sched == "cosine"
                     else args.num_iterations)
        s = CosineLRScheduler(
            args.lr, t_initial=t_initial, t_mul=g("lr_cycle_mul", 1.0),
            lr_min=args.min_lr, decay_rate=args.decay_rate,
            warmup_lr_init=args.warmup_lr, warmup_t=args.warmup_epochs,
            cycle_limit=g("lr_cycle_limit", 1), **noise_kw)
        num_epochs = s.get_cycle_length() + g("cooldown_epochs", 0)
        return s, num_epochs
    if sched == "tanh":
        s = TanhLRScheduler(
            args.lr, t_initial=num_epochs, t_mul=g("lr_cycle_mul", 1.0),
            lr_min=args.min_lr, warmup_lr_init=args.warmup_lr,
            warmup_t=args.warmup_epochs,
            cycle_limit=g("lr_cycle_limit", 1), **noise_kw)
        num_epochs = num_epochs + g("cooldown_epochs", 0)
        return s, num_epochs
    if sched == "step":
        return StepLRScheduler(
            args.lr, decay_t=args.decay_epochs,
            decay_rate=args.decay_rate, warmup_lr_init=args.warmup_lr,
            warmup_t=args.warmup_epochs, **noise_kw), num_epochs
    if sched == "plateau":
        mode = "min" if "loss" in g("eval_metric", "") else "max"
        return PlateauLRScheduler(
            args.lr, decay_rate=args.decay_rate,
            patience_t=args.patience_epochs, lr_min=args.min_lr,
            mode=mode, warmup_lr_init=args.warmup_lr,
            warmup_t=args.warmup_epochs,
            cooldown_t=g("cooldown_epochs", 0), **noise_kw), num_epochs
    raise ValueError(f"unknown sched: {sched}")
