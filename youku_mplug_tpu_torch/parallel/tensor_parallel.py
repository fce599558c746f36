"""Megatron's tensor-parallel collectives, over the mesh's model group.

GSPMD writes these for the JAX package (its rules in
``parallel/sharding.py`` say where the parameters are split, XLA inserts
the reductions); the reference writes them by hand
(``models/distributed_utils.py``: Column / Row / VocabParallel layers).
The port writes them by hand too, and only with ``all_reduce``, the one
collective that NCCL and gloo both run on device tensors (gloo through
the host), so the same code runs across cards, with several ranks on one
card, and on CPU processes:

- ``reduce_from_model``: the sum over the model ranks of a row-parallel
  product (after the attention output or the MLP's second projection;
  the bias is added once, after it);
- ``vocab_parallel_embedding``: each rank looks up the ids inside its
  contiguous vocab slice, zeros elsewhere, and the sum gives every rank
  the rows (exact: one non-zero term);
- ``gather_vocab_logits``: each rank writes its vocab slice of the logits
  into a zeroed fp32 ``[N, V]`` and the sum gives every rank the
  unsharded logits bitwise, so greedy and sampled picks agree across the
  model ranks;
- ``copy_to_model`` (Megatron's *f*): the identity forward whose
  backward sums the gradient over the model ranks; it goes on the input
  of every column-parallel product (the qkv and fc1 projections, and the
  tied logits of the vocab-parallel loss), so that the gradient below a
  sharded block is the whole one and not one rank's share of it.  Its
  twin ``reduce_from_model`` (*g*) sums forward and passes the gradient
  through unchanged;
- ``sum_over_model``: a sum whose backward sums too, for a sum whose
  result every rank then uses on its own slice (the statistics of a
  LayerNorm over a split width: each rank's gradient with respect to the
  sum is its slice's share, and the whole is their sum).

f and g take any axis's group (an ``AxisGroup``, ``runtime/mesh.py``,
of which ``ModelGroup`` is a name): ``copy_to`` and ``reduce_over`` are
their names where the axis is not the model's (``parallel/pipeline.py``
runs them over the ``pipe`` and ``data`` axes).
A module that holds a sharded parameter carries ``tp``, its
``ModelGroup`` (set by ``parallel/sharding.shard_params``); with ``tp``
None (or one model rank) each function is the identity and issues no
collective.  Under autograd every collective of a forward has its
mirror in the backward, issued in the same order on every rank (a
checkpointed block reruns its forward collectives inside the backward,
in the same order everywhere too).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn

from youku_mplug_tpu_torch.runtime.mesh import AxisGroup

# the model-axis process group of a rank, its index and size
ModelGroup = AxisGroup


def _active(tp: Optional[ModelGroup]) -> bool:
    return tp is not None and tp.size > 1


def _summed(x: torch.Tensor, group, copy: bool = False) -> torch.Tensor:
    """``x`` summed over ``group``: in place on a fresh contiguous
    tensor, a view (or with ``copy``, any tensor) copied first."""
    out = x if (not copy and x.is_contiguous() and x._base is None) \
        else x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


class _Reduce(torch.autograd.Function):
    """g: sum forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group, copy=True)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Copy(torch.autograd.Function):
    """f: identity forward, sum backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group, copy=True), None


def reduce_from_model(x: torch.Tensor, tp: Optional[ModelGroup]
                      ) -> torch.Tensor:
    """The sum of ``x`` over the model ranks (a new tensor; ``x`` itself
    without a model group); its gradient passes through unchanged."""
    if not _active(tp):
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _Reduce.apply(x, tp.group)
    return _summed(x, tp.group)


class _SumBoth(torch.autograd.Function):
    """Sum forward, sum backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group, copy=True)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group, copy=True), None


def sum_over_model(x: torch.Tensor, tp: Optional[ModelGroup]
                   ) -> torch.Tensor:
    """The sum of ``x`` over the model ranks whose gradient is summed
    over them too (``x`` itself without a model group)."""
    if not _active(tp):
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _SumBoth.apply(x, tp.group)
    return _summed(x, tp.group, copy=True)


def copy_to_model(x: torch.Tensor, tp: Optional[ModelGroup]
                  ) -> torch.Tensor:
    """``x`` itself forward; under autograd its gradient is summed over
    the model ranks (the input of a column-parallel product)."""
    if not _active(tp) or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _Copy.apply(x, tp.group)


# f and g over any axis (the pipeline's pipe and data axes)
copy_to, reduce_over = copy_to_model, reduce_from_model


def vocab_parallel_embedding(tokens: torch.Tensor, rows: int,
                             lookup: Callable[[torch.Tensor], torch.Tensor],
                             tp: Optional[ModelGroup]) -> torch.Tensor:
    """Embedding rows of ``tokens`` from a table split by rows: ``lookup``
    maps local ids (in [0, rows)) to this rank's rows; ids outside this
    rank's slice ``[index * rows, (index + 1) * rows)`` give zeros, and
    the sum over the model ranks fills them in.  Backward: each rank's
    table slice takes the gradient of its own ids' rows alone."""
    if not _active(tp):
        return lookup(tokens)
    local = tokens - tp.index * rows
    inside = (local >= 0) & (local < rows)
    out = lookup(local.clamp(0, rows - 1))
    out = out * inside[..., None].to(out.dtype)
    return reduce_from_model(out, tp)


def gather_vocab_logits(logits: torch.Tensor, tp: Optional[ModelGroup]
                        ) -> torch.Tensor:
    """[..., V / m] fp32 logits of this rank's vocab slice -> the full
    [..., V] on every rank (zeros elsewhere, summed: exact).  Under
    autograd the backward keeps this rank's slice of the gradient."""
    if not _active(tp):
        return logits
    rows = logits.shape[-1]
    full = logits.new_zeros(*logits.shape[:-1], rows * tp.size)
    if torch.is_grad_enabled() and logits.requires_grad:
        full = torch.cat([full[..., :tp.index * rows], logits,
                          full[..., (tp.index + 1) * rows:]], dim=-1)
        return _Reduce.apply(full, tp.group)
    full[..., tp.index * rows:(tp.index + 1) * rows] = logits
    dist.all_reduce(full, group=tp.group)
    return full


def agree_over_model(flag: bool, tp: Optional[ModelGroup],
                     device=None) -> bool:
    """``flag``, checked equal on every model rank (one all_reduce of two
    ints): a host decision that steers the ranks' collectives, such as
    whether a decode loop runs another round, must be the same on all of
    them, or their collectives pair up wrongly.  Raises when the ranks
    disagree."""
    if not _active(tp):
        return flag
    both = torch.tensor([int(flag), -int(flag)], dtype=torch.int64,
                        device=device)
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=tp.group)
    if int(both[0]) != -int(both[1]):
        raise RuntimeError(f"model rank {tp.index}: the model ranks disagree "
                           f"on a host flag ({flag} here)")
    return flag


def model_parallel(module: nn.Module) -> bool:
    """Whether any submodule of ``module`` runs on a model shard."""
    return any(_active(getattr(m, "tp", None)) for m in module.modules())
