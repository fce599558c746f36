"""The timm optimizer zoo as per-leaf torch updates with optax's semantics.

Counterpart of ``youku_mplug_tpu/optim/zoo.py``: every name that its
``create_zoo_optimizer`` accepts — sgd / nesterov, momentum, adam, adamw
and their ``fused*`` aliases, nadam, radam, adamp, sgdp, adadelta,
adafactor, rmsprop, rmsproptf, novograd, nvnovograd (``fusednovograd``),
lamb (``fusedlamb``) and lars — with the ``lookahead_`` prefix, and
``adahessian`` as functions (it needs Hessian-diagonal probes, so the
name raises at dispatch, as in JAX).

Each ``Rule`` holds one name's update of one leaf: ``init(p)`` gives the
leaf's state tensors (zeros, as optax's ``init`` allocates them) and
``update(g, p, st, ctx, lr, wd)`` returns the whole additive update of
that step (the learning rate folded in, ``p + u`` is the new value) and
updates ``st`` in place; ``begin(count)`` computes, once a step, what
every leaf shares (``ctx``).  Where the JAX package builds the name from
optax primitives the rule reproduces optax's chain, order of operations
and defaults, not ``torch.optim``'s:

- sgd / nesterov: L2 decay added to the gradient, then ``optax.trace``
  (``t = g + m t``; the update ``g + m t`` with nesterov, else ``t``),
  then ``-lr`` (no dampening);
- adadelta: ``optax.scale_by_adadelta(rho=0.9, eps)``; rmsprop:
  ``scale_by_rms(decay=0.9, eps outside the root, initial 0)``, rmsproptf
  the root of ``nu + eps`` over a second moment that starts at one, both
  then ``optax.trace(momentum)``;
- adafactor: ``optax.adafactor``'s chain (decay ``1 - (t+1)^-0.8``,
  epsilon 1e-30, the second moment factored over the two largest dims of
  a leaf of rank >= 2 once the smaller of them is >= 128, update clipped
  to block RMS 1, times lr, times the parameter's RMS (at least 1e-3),
  plus ``wd * p`` unscaled by lr);
- lamb: adam, plus ``wd * p``, times the trust ratio ``|p| / |u|`` (1
  where either is 0), times ``-lr``; lars: ``g + wd * p`` times ``0.001 |p|
  / |u|``, times ``-lr``, then ``optax.trace(momentum)`` on that.

The names the JAX package writes itself (nadam, radam, adamp, sgdp,
novograd, nvnovograd, lookahead, adahessian) follow its formulas line by
line.  Bias corrections ``1 - b ** t`` are evaluated in the leaf's dtype,
as JAX evaluates them (``bias_correction``); the other step scalars
(nadam's momentum schedule, radam's rectification) are Python floats, so
the updates agree with JAX's to float32 rounding.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

ScalarOrSchedule = Union[float, Callable[[int], float]]
State = Dict[str, torch.Tensor]

LOOKAHEAD_ALPHA, LOOKAHEAD_K = 0.5, 6


_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
              torch.float16: np.float16}


def bias_correction(decay: float, t, dtype: torch.dtype) -> float:
    """``1 - decay ** t`` evaluated in ``dtype`` (float32 for fp32
    leaves), as JAX evaluates it: with ``decay`` near 1 the rounding of
    ``decay`` itself moves the result by ~1e-5 relative, which the
    updates carry."""
    npdt = _NP_DTYPES.get(dtype, np.float32)
    return float(npdt(1) - npdt(decay) ** npdt(t))


def lr_at(learning_rate: ScalarOrSchedule, count: int) -> float:
    return learning_rate(count) if callable(learning_rate) else learning_rate


def _zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p, memory_format=torch.contiguous_format)


def _scalar(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=p.dtype, device=p.device)


class Rule:
    """One zoo name's update of a leaf (see the module docstring)."""

    def init(self, p: torch.Tensor) -> State:
        return {}

    def begin(self, count: int) -> dict:
        return {"count": count, "t": count + 1}

    def update(self, g, p, st: State, ctx: dict, lr: float, wd: float):
        raise NotImplementedError

    # step-level state beyond the per-leaf tensors (nadam's schedule)
    def scalars(self) -> Dict[str, float]:
        return {}

    def load_scalars(self, values: Dict[str, float]):
        pass


def _coupled(g, p, wd):
    """optax ``add_decayed_weights`` ahead of the direction (L2), only
    where the JAX chain adds it (a weight decay that is not 0)."""
    return g + wd * p if wd else g


def _ema(new, old, decay):
    """optax ``update_moment``: ``(1 - decay) new + decay old``."""
    return (1 - decay) * new + decay * old


class Trace(Rule):
    """sgd / nesterov / momentum: coupled decay, ``optax.trace``, -lr."""

    def __init__(self, momentum: float, nesterov: bool):
        self.momentum, self.nesterov = momentum, nesterov

    def init(self, p):
        return {"trace": _zeros(p)}

    def update(self, g, p, st, ctx, lr, wd):
        g = _coupled(g, p, wd)
        tr = g + self.momentum * st["trace"]
        st["trace"] = tr
        u = g + self.momentum * tr if self.nesterov else tr
        return -lr * u


def _adam_direction(g, st, b1, b2, eps, t):
    mu = _ema(g, st["mu"], b1)
    nu = _ema(g * g, st["nu"], b2)
    st["mu"], st["nu"] = mu, nu
    return (mu / bias_correction(b1, t, g.dtype)) / (
        torch.sqrt(nu / bias_correction(b2, t, g.dtype)) + eps)


class Adam(Rule):
    """optax ``scale_by_adam`` with coupled (adam) or decoupled (adamw)
    weight decay."""

    def __init__(self, b1, b2, eps, decoupled: bool):
        self.b1, self.b2, self.eps, self.decoupled = b1, b2, eps, decoupled

    def init(self, p):
        return {"mu": _zeros(p), "nu": _zeros(p)}

    def update(self, g, p, st, ctx, lr, wd):
        if not self.decoupled:
            g = _coupled(g, p, wd)
        u = _adam_direction(g, st, self.b1, self.b2, self.eps, ctx["t"])
        if self.decoupled and wd:
            u = u + wd * p
        return -lr * u


class Nadam(Rule):
    """timm's Nadam with the warming momentum schedule; coupled decay."""

    def __init__(self, b1, b2, eps, schedule_decay: float = 4e-3):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def init(self, p):
        return {"mu": _zeros(p), "nu": _zeros(p)}

    def begin(self, count):
        t, b1, sd = count + 1, self.b1, self.schedule_decay
        mu_t = b1 * (1.0 - 0.5 * 0.96 ** (t * sd))
        mu_t1 = b1 * (1.0 - 0.5 * 0.96 ** ((t + 1.0) * sd))
        new = self.m_schedule * mu_t
        self.m_schedule = new
        return {"count": count, "t": t, "mu_t": mu_t, "mu_t1": mu_t1,
                "m_new": new, "m_next": new * mu_t1}

    def update(self, g, p, st, ctx, lr, wd):
        g = _coupled(g, p, wd)
        b1, b2 = self.b1, self.b2
        mu = b1 * st["mu"] + (1 - b1) * g
        nu = b2 * st["nu"] + (1 - b2) * g * g
        st["mu"], st["nu"] = mu, nu
        denom = torch.sqrt(nu / bias_correction(b2, ctx["t"], g.dtype)) \
            + self.eps
        u = ((1.0 - ctx["mu_t"]) / (1.0 - ctx["m_new"]) * g
             + ctx["mu_t1"] / (1.0 - ctx["m_next"]) * mu) / denom
        return -lr * u

    def scalars(self):
        return {"m_schedule": self.m_schedule}

    def load_scalars(self, values):
        self.m_schedule = float(values["m_schedule"])


class RAdam(Rule):
    """timm's rectified Adam (the bias-corrected first moment alone below
    the N_sma >= 5 threshold); decoupled decay."""

    def __init__(self, b1, b2, eps):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, p):
        return {"mu": _zeros(p), "nu": _zeros(p)}

    def begin(self, count):
        t, b2 = count + 1, self.b2
        beta2_t = b2 ** t
        n_sma_max = 2.0 / (1.0 - b2) - 1.0
        n_sma = n_sma_max - 2.0 * t * beta2_t / (1.0 - beta2_t)
        rect = None
        if n_sma >= 5.0:
            rect = math.sqrt((1 - beta2_t) * (n_sma - 4) / (n_sma_max - 4)
                             * (n_sma - 2) / n_sma
                             * n_sma_max / (n_sma_max - 2))
        return {"count": count, "t": t, "rect": rect}

    def update(self, g, p, st, ctx, lr, wd):
        b1, b2 = self.b1, self.b2
        mu = b1 * st["mu"] + (1 - b1) * g
        nu = b2 * st["nu"] + (1 - b2) * g * g
        st["mu"], st["nu"] = mu, nu
        bc1 = bias_correction(b1, ctx["t"], g.dtype)
        if ctx["rect"] is None:
            u = mu / bc1
        else:
            u = ctx["rect"] * mu / (torch.sqrt(nu) + self.eps) / bc1
        if wd:
            u = u + wd * p
        return -lr * u


def _cosine_rows(x, y, eps):
    xf, yf = x.reshape(x.shape[0], -1), y.reshape(y.shape[0], -1)
    xn = torch.linalg.vector_norm(xf, dim=1) + eps
    yn = torch.linalg.vector_norm(yf, dim=1) + eps
    return (xf * yf).sum(dim=1).abs() / xn / yn


def projection(p, g, perturb, delta, wd_ratio, eps):
    """AdamP / SGDP: -> (perturb projected off the weight's radial
    direction, the decay's factor): the channel view where every row's
    cosine of (g, p) is below delta / sqrt(row size), else the layer view
    where the whole leaf's is below delta / sqrt(size), else unchanged.
    Both views are computed and selected on the device (no host sync)."""
    if p.dim() <= 1:
        return perturb, 1.0
    ch_hit = _cosine_rows(g, p, eps).max() < delta / math.sqrt(
        math.prod(p.shape[1:]))
    ly_hit = _cosine_rows(g.reshape(1, -1), p.reshape(1, -1), eps)[0] \
        < delta / math.sqrt(p.numel())
    expand = (-1,) + (1,) * (p.dim() - 1)
    pn_ch = p / (torch.linalg.vector_norm(p.reshape(p.shape[0], -1), dim=1
                                          ).reshape(expand) + eps)
    proj = (pn_ch * perturb).reshape(p.shape[0], -1).sum(dim=1)
    channel = perturb - pn_ch * proj.reshape(expand)
    pn_ly = p / (torch.linalg.vector_norm(p.reshape(1, -1)) + eps)
    layer = perturb - pn_ly * (pn_ly * perturb).sum()
    out = torch.where(ch_hit, channel, torch.where(ly_hit, layer, perturb))
    one = torch.ones((), dtype=p.dtype, device=p.device)
    wd_s = torch.where(ch_hit | ly_hit, one * wd_ratio, one)
    return out, wd_s


class AdamP(Rule):
    """AdamP: Adam's step projected off the radial direction of
    scale-invariant weights, the decay shrunk by ``wd_ratio`` there."""

    def __init__(self, b1, b2, eps, delta=0.1, wd_ratio=0.1, nesterov=True):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.delta, self.wd_ratio, self.nesterov = delta, wd_ratio, nesterov

    def init(self, p):
        return {"mu": _zeros(p), "nu": _zeros(p)}

    def update(self, g, p, st, ctx, lr, wd):
        b1, b2, t = self.b1, self.b2, ctx["t"]
        bc1 = bias_correction(b1, t, g.dtype)
        bc2 = bias_correction(b2, t, g.dtype)
        mu = b1 * st["mu"] + (1 - b1) * g
        nu = b2 * st["nu"] + (1 - b2) * g * g
        st["mu"], st["nu"] = mu, nu
        denom = torch.sqrt(nu) / math.sqrt(bc2) + self.eps
        perturb = ((b1 * mu + (1 - b1) * g) / denom if self.nesterov
                   else mu / denom)
        perturb, wd_s = projection(p, g, perturb, self.delta, self.wd_ratio,
                                   self.eps)
        step = -(lr / bc1) * perturb
        if wd > 0:
            step = step - lr * wd * wd_s * p
        return step


class SGDP(Rule):
    """SGDP: SGD with momentum under AdamP's projection."""

    def __init__(self, momentum, eps, dampening=0.0, delta=0.1,
                 wd_ratio=0.1, nesterov=True):
        self.momentum, self.eps, self.dampening = momentum, eps, dampening
        self.delta, self.wd_ratio, self.nesterov = delta, wd_ratio, nesterov

    def init(self, p):
        return {"momentum": _zeros(p)}

    def update(self, g, p, st, ctx, lr, wd):
        m = self.momentum
        buf = m * st["momentum"] + (1 - self.dampening) * g
        st["momentum"] = buf
        d_p = g + m * buf if self.nesterov else buf
        d_p, wd_s = projection(p, g, d_p, self.delta, self.wd_ratio,
                               self.eps)
        step = -lr * d_p
        if wd != 0:
            step = step - lr * wd * wd_s * p / (1 - m)
        return step


class Adadelta(Rule):
    """optax ``scale_by_adadelta``; coupled decay."""

    def __init__(self, eps, rho=0.9):
        self.eps, self.rho = eps, rho

    def init(self, p):
        return {"e_g": _zeros(p), "e_x": _zeros(p)}

    def update(self, g, p, st, ctx, lr, wd):
        g = _coupled(g, p, wd)
        e_g = _ema(g * g, st["e_g"], self.rho)
        u = torch.sqrt(st["e_x"] + self.eps) / torch.sqrt(e_g + self.eps) * g
        st["e_g"], st["e_x"] = e_g, _ema(u * u, st["e_x"], self.rho)
        return -lr * u


def factored_dims(shape, min_dim_size_to_factor: int = 128):
    """optax adafactor's factored dims (d1, d0): the two largest, when
    the smaller of them is >= ``min_dim_size_to_factor``; else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


def _rms(x):
    return torch.sqrt(torch.mean(x * x))


class Adafactor(Rule):
    """``optax.adafactor`` with its defaults (see the module docstring)."""

    def __init__(self, decay_rate=0.8, eps=1e-30, clipping=1.0,
                 min_scale=1e-3):
        self.decay_rate, self.eps = decay_rate, eps
        self.clipping, self.min_scale = clipping, min_scale

    def init(self, p):
        dims = factored_dims(tuple(p.shape))
        if dims is None:
            return {"v": _zeros(p)}
        d1, d0 = dims
        return {"v_row": _zeros(p.sum(dim=d0)),
                "v_col": _zeros(p.sum(dim=d1))}

    def begin(self, count):
        return {"count": count, "t": count + 1,
                "decay": 1.0 - float(count + 1) ** -self.decay_rate}

    def update(self, g, p, st, ctx, lr, wd):
        dec = ctx["decay"]
        g2 = g * g + self.eps
        dims = factored_dims(tuple(p.shape))
        if dims is None:
            v = dec * st["v"] + (1.0 - dec) * g2
            st["v"] = v
            u = g * v ** -0.5
        else:
            d1, d0 = dims
            v_row = dec * st["v_row"] + (1.0 - dec) * g2.mean(dim=d0)
            v_col = dec * st["v_col"] + (1.0 - dec) * g2.mean(dim=d1)
            st["v_row"], st["v_col"] = v_row, v_col
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = v_row.mean(dim=reduced_d1, keepdim=True)
            row_factor = (v_row / row_col_mean) ** -0.5
            col_factor = v_col ** -0.5
            u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
        u = u / torch.clamp(_rms(u) / self.clipping, min=1.0)
        u = lr * u
        u = u * torch.clamp(_rms(p), min=self.min_scale)
        if wd:
            u = u + wd * p
        return -u


class RMSProp(Rule):
    """optax ``scale_by_rms`` then ``trace(momentum)``: rmsprop (eps
    outside the root, the moment from 0) or rmsproptf (eps inside, from
    1); coupled decay."""

    def __init__(self, eps, momentum, tf: bool, decay=0.9):
        self.eps, self.momentum, self.tf, self.decay = eps, momentum, tf, \
            decay

    def init(self, p):
        st = {"nu": torch.full_like(p, 1.0 if self.tf else 0.0)}
        if self.momentum:
            st["trace"] = _zeros(p)
        return st

    def update(self, g, p, st, ctx, lr, wd):
        g = _coupled(g, p, wd)
        nu = _ema(g * g, st["nu"], self.decay)
        st["nu"] = nu
        if self.tf:
            u = torch.rsqrt(nu + self.eps) * g
        else:
            u = (1 / (torch.sqrt(nu) + self.eps)) * g
        if self.momentum:
            u = u + self.momentum * st["trace"]
            st["trace"] = u
        return -lr * u


class NovoGrad(Rule):
    """timm NovoGrad: the gradient normalized by an EMA of its norm, then
    the layer-wise NovoGrad moment with sqrt(bc2) / bc1 correction; the
    first step seeds the moments inside the update."""

    def __init__(self, b1, b2, eps, grad_averaging=False):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.grad_averaging = grad_averaging

    def init(self, p):
        return {"v": _scalar(p), "m": _zeros(p), "grad_ema": _scalar(p)}

    def update(self, g, p, st, ctx, lr, wd):
        b1, b2, eps = self.b1, self.b2, self.eps
        g2 = (g * g).sum()
        if ctx["count"] == 0:
            v_prior, ge = g2, g2
            m_prior = g / (torch.sqrt(g2) + eps) + wd * p
        else:
            v_prior, m_prior = st["v"], st["m"]
            ge = st["grad_ema"] * b2 + g2 * (1 - b2)
        gn = g / (torch.sqrt(ge) + eps)
        if self.grad_averaging:
            gn = gn * (1 - b1)
        v = b2 * v_prior + (1 - b2) * (gn * gn).sum()
        m = b1 * m_prior + (gn / (torch.sqrt(v) + eps) + wd * p)
        st["v"], st["m"], st["grad_ema"] = v, m, ge
        t = ctx["t"]
        return -lr * ((math.sqrt(bias_correction(b2, t, g.dtype))
                       / bias_correction(b1, t, g.dtype)) * m)


class NvNovoGrad(Rule):
    """NVIDIA NovoGrad: a per-leaf scalar second moment that starts at the
    first gradient's squared norm (its running max with ``amsgrad``),
    decay after the normalization, no bias correction."""

    def __init__(self, b1, b2, eps, grad_averaging=False, amsgrad=False):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.grad_averaging, self.amsgrad = grad_averaging, amsgrad

    def init(self, p):
        return {"v": _scalar(p), "m": _zeros(p), "vmax": _scalar(p)}

    def update(self, g, p, st, ctx, lr, wd):
        b1, b2 = self.b1, self.b2
        norm = (g * g).sum()
        v = torch.where(st["v"] == 0, norm, st["v"] * b2 + norm * (1 - b2))
        vmax = torch.maximum(st["vmax"], v) if self.amsgrad else st["vmax"]
        gn = g / (torch.sqrt(vmax if self.amsgrad else v) + self.eps) \
            + wd * p
        if self.grad_averaging:
            gn = gn * (1 - b1)
        m = b1 * st["m"] + gn
        st["v"], st["m"], st["vmax"] = v, m, vmax
        return -lr * m


def _trust(u, p, coefficient):
    pn, un = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
    ratio = coefficient * pn / un
    return torch.where((pn == 0) | (un == 0), torch.ones_like(ratio), ratio)


class Lamb(Rule):
    """``optax.lamb``: adam, + wd p, times the trust ratio, times -lr."""

    def __init__(self, b1, b2, eps):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, p):
        return {"mu": _zeros(p), "nu": _zeros(p)}

    def update(self, g, p, st, ctx, lr, wd):
        u = _adam_direction(g, st, self.b1, self.b2, self.eps, ctx["t"])
        u = u + wd * p
        return -lr * (u * _trust(u, p, 1.0))


class Lars(Rule):
    """``optax.lars``: (g + wd p) times 0.001 |p| / |u|, times -lr, then
    ``trace(momentum)``."""

    def __init__(self, momentum, trust_coefficient=0.001):
        self.momentum, self.coefficient = momentum, trust_coefficient

    def init(self, p):
        return {"trace": _zeros(p)}

    def update(self, g, p, st, ctx, lr, wd):
        u = g + wd * p
        u = -lr * (u * _trust(u, p, self.coefficient))
        tr = u + self.momentum * st["trace"]
        st["trace"] = tr
        return tr


def create_rule(opt: str, momentum: float = 0.9,
                betas: Optional[tuple] = None, eps: Optional[float] = None,
                **kwargs) -> Rule:
    """timm name -> its ``Rule`` (JAX ``create_zoo_optimizer``'s dispatch:
    the last ``_``-separated part names the optimizer)."""
    name = opt.lower().split("_")[-1]
    b1, b2 = betas if betas is not None else (0.9, 0.999)
    eps_ = 1e-8 if eps is None else eps
    if name in ("sgd", "nesterov", "fusedsgd"):
        return Trace(momentum, nesterov=True)
    if name in ("momentum", "fusedmomentum"):
        return Trace(momentum, nesterov=False)
    if name in ("adam", "fusedadam"):
        return Adam(b1, b2, eps_, decoupled=False)
    if name in ("adamw", "fusedadamw"):
        return Adam(b1, b2, eps_, decoupled=True)
    if name == "nadam":
        return Nadam(b1, b2, eps_)
    if name == "radam":
        return RAdam(b1, b2, eps_)
    if name == "adamp":
        return AdamP(b1, b2, eps_, delta=kwargs.get("delta", 0.1),
                     wd_ratio=kwargs.get("wd_ratio", 0.1),
                     nesterov=kwargs.get("nesterov", True))
    if name == "sgdp":
        return SGDP(momentum, eps_, delta=kwargs.get("delta", 0.1),
                    wd_ratio=kwargs.get("wd_ratio", 0.1),
                    nesterov=kwargs.get("nesterov", True))
    if name == "adadelta":
        return Adadelta(1e-6 if eps is None else eps)
    if name == "adafactor":
        return Adafactor()
    if name in ("rmsprop", "rmsproptf"):
        return RMSProp(eps_, momentum, tf=name == "rmsproptf")
    if name == "novograd":
        return NovoGrad(b1 if betas else 0.95, b2 if betas else 0.98, eps_,
                        grad_averaging=kwargs.get("grad_averaging", False))
    if name in ("nvnovograd", "fusednovograd"):
        b1n, b2n = (0.95, 0.98) if betas is None else (b1, b2)
        return NvNovoGrad(b1n, b2n, eps_,
                          grad_averaging=kwargs.get("grad_averaging", False),
                          amsgrad=kwargs.get("amsgrad", False))
    if name in ("lamb", "fusedlamb"):
        return Lamb(b1, b2, eps_)
    if name == "lars":
        return Lars(momentum)
    if name == "adahessian":
        raise NotImplementedError(
            "adahessian needs Hessian-diagonal estimates; use "
            "youku_mplug_tpu_torch.optim.zoo.adahessian() with "
            "hutchinson_hessian_diag (second order: not a gradient-only "
            "update)")
    raise ValueError(f"unknown optimizer: {opt}")


def is_lookahead(opt: str) -> bool:
    return opt.lower().split("_")[0] == "lookahead"


ZOO_NAMES = ("sgd", "nesterov", "fusedsgd", "momentum", "fusedmomentum",
             "adam", "fusedadam", "adamw", "fusedadamw", "nadam", "radam",
             "adamp", "sgdp", "adadelta", "adafactor", "rmsprop",
             "rmsproptf", "novograd", "nvnovograd", "fusednovograd",
             "lamb", "fusedlamb", "lars")


class ZooUpdate:
    """One zoo optimizer over named leaves (JAX path -> tensor): the rule,
    each leaf's state and weight decay, the optional lookahead (slow
    weights, alpha 0.5, k 6; the first sync takes the fast weights, as
    the reference creates the slow buffer there) and the update count.
    ``apply(grads, lr)`` returns each leaf's additive update and advances
    the count; the caller adds it (times its per-leaf scale)."""

    def __init__(self, opt: str, params: Dict[str, torch.Tensor],
                 weight_decay: Dict[str, float], learning_rate:
                 ScalarOrSchedule, **kw):
        self.opt = opt
        self.rule = create_rule(opt, **kw)
        self.lookahead = is_lookahead(opt)
        self.learning_rate = learning_rate
        self.weight_decay = dict(weight_decay)
        self.state: Dict[str, State] = {}
        with torch.no_grad():
            for path, p in params.items():
                st = self.rule.init(p.detach())
                if self.lookahead:
                    st["slow"] = p.detach().clone()
                self.state[path] = st
        self.count = 0

    def apply(self, params: Dict[str, torch.Tensor],
              grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        lr = lr_at(self.learning_rate, self.count)
        ctx = self.rule.begin(self.count)
        k = self.count + 1
        sync = self.lookahead and k % LOOKAHEAD_K == 0
        out = {}
        for path, p in params.items():
            st = self.state[path]
            u = self.rule.update(grads[path], p, st, ctx, lr,
                                 self.weight_decay[path])
            if self.lookahead:
                fast = p + u
                if sync:
                    st["slow"] = (fast if k == LOOKAHEAD_K else st["slow"]
                                  + LOOKAHEAD_ALPHA * (fast - st["slow"]))
                    u = st["slow"] - p
                else:
                    u = fast - p
            out[path] = u
        self.count += 1
        return out


# ---------------------------------------------------------------------------
# AdaHessian: second order, so a pair of functions rather than a name
# ---------------------------------------------------------------------------


def hutchinson_hessian_diag(loss_fn: Callable, params: List[torch.Tensor],
                            generator: torch.Generator,
                            n_samples: int = 1) -> List[torch.Tensor]:
    """E[z * (H z)] over Rademacher z drawn from ``generator``: the
    Hutchinson estimate of the Hessian's diagonal, by a Hessian-vector
    product (double backward) of ``loss_fn()`` at ``params`` (tensors
    that require grad).  An op that cannot be differentiated twice (the
    flash kernels, the fp32 LayerNorm, dropout attention: all
    ``once_differentiable``) raises here, never returns zeros."""
    loss = loss_fn()
    grads = torch.autograd.grad(loss, params, create_graph=True)
    _refuse_once_differentiable(grads)
    acc = None
    for _ in range(n_samples):
        zs = [torch.randint(0, 2, p.shape, generator=generator,
                            device=p.device).to(p.dtype) * 2 - 1
              for p in params]
        hz = torch.autograd.grad(grads, params, grad_outputs=zs,
                                 retain_graph=True)
        est = [z * h for z, h in zip(zs, hz)]
        acc = est if acc is None else [a + e for a, e in zip(acc, est)]
    return [a / n_samples for a in acc]


def _refuse_once_differentiable(grads):
    """Raise if the gradients' graph passes a once-differentiable
    Function: autograd would drop that path from the Hessian-vector
    product without a word."""
    stack = [g.grad_fn for g in grads if g.grad_fn is not None]
    seen = set()
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if type(fn).__name__ in ("Error", "DelayedError"):
            raise RuntimeError(
                "the Hessian probe passes a once_differentiable Function "
                "(a flash kernel, the fp32 LayerNorm or dropout "
                "attention): it cannot be differentiated twice")
        stack.extend(n for n, _ in fn.next_functions)


class AdaHessian:
    """AdaHessian's update given the gradients and a Hessian-diagonal
    estimate: ``update(grads, state, params, hessian_diag)`` -> (the
    additive updates, the new state); ``init(params)`` -> zero moments."""

    def __init__(self, learning_rate: ScalarOrSchedule, b1=0.9, b2=0.999,
                 eps=1e-8, weight_decay=0.0, hessian_power=1.0):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.hessian_power = weight_decay, hessian_power

    def init(self, params: List[torch.Tensor]) -> dict:
        return {"count": 0, "mu": [_zeros(p) for p in params],
                "nu": [_zeros(p) for p in params]}

    def update(self, grads, state, params, hessian_diag):
        count = state["count"]
        t, lr = count + 1, lr_at(self.learning_rate, count)
        b1, b2 = self.b1, self.b2
        mu = [b1 * m + (1 - b1) * g for m, g in zip(state["mu"], grads)]
        nu = [b2 * v + (1 - b2) * h * h
              for v, h in zip(state["nu"], hessian_diag)]
        out = []
        for p, m, v in zip(params, mu, nu):
            bc1 = bias_correction(b1, t, p.dtype)
            bc2 = bias_correction(b2, t, p.dtype)
            denom = torch.sqrt(v / bc2) ** self.hessian_power + self.eps
            step = -lr * (m / bc1) / denom
            if self.weight_decay:
                step = step - lr * self.weight_decay * p
            out.append(step)
        return out, {"count": t, "mu": mu, "nu": nu}


def adahessian(learning_rate: ScalarOrSchedule, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-8,
               weight_decay: float = 0.0, hessian_power: float = 1.0
               ) -> AdaHessian:
    return AdaHessian(learning_rate, b1, b2, eps, weight_decay,
                      hessian_power)
