"""Pipeline parallelism: the GPipe schedule over a ``pipe`` mesh axis.

Counterpart of ``youku_mplug_tpu/parallel/pipeline.py``.  A layer stack
kept as leading-``[L]`` tensors (the GPT-3 decoder's, ``models/gpt3.py``)
is cut into P stages of L/P layers (``stack_to_stages``: this rank's
slice); ``gpipe`` marches the microbatches through them tick by tick as
JAX's ``shard_map`` program does: ``M + P - 1`` ticks, stage 0 takes
microbatch ``t`` (clamped past the last), every stage applies its layers
to what it holds, the last stage emits microbatch ``t - (P - 1)``, and
one exchange a tick (``parallel/collectives.ppermute``) hands each
stage's output to the next.  A final sum over the pipe axis leaves the
``[M, mb, ...]`` outputs on every rank.

Under autograd every rank runs every tick's exchange in both directions,
as the backward of JAX's single program does: each rank takes what it
received through ``torch.where`` (stage 0 its feed), and each rank's
share of the final sum is ``where(last stage, its emitted outputs, 0)``,
so that the backward on every rank reaches every tick.  The rank's
gradient of the microbatches is summed over the pipe axis (the input is
replicated: ``tensor_parallel``'s f, ``copy_to``), and with
``data_axis`` the stage parameters' gradient over the data axis (they
are replicated there; the caller's step does not sum it again).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.utils._pytree import tree_map

from youku_mplug_tpu_torch.parallel.collectives import ppermute
from youku_mplug_tpu_torch.parallel.tensor_parallel import copy_to, reduce_over
from youku_mplug_tpu_torch.runtime.mesh import ONE_RANK, AxisGroup


def stack_to_stages(stacked: Any, axis: Optional[AxisGroup]) -> Any:
    """This rank's ``[L/P, ...]`` stage of a pytree of layer-stacked
    ``[L, ...]`` tensors (copies; L must divide by P)."""
    ax = axis or ONE_RANK
    p, i = ax.size, ax.index

    def cut(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.shape[0] % p:
            raise ValueError(f"{x.shape[0]} layers do not split into {p} "
                             f"stages")
        n = x.shape[0] // p
        return x[i * n:(i + 1) * n].clone()

    return tree_map(cut, stacked)


def gpipe(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
          stage_params: Any, microbatches: torch.Tensor, *,
          axis: Optional[AxisGroup],
          data_axis: Optional[AxisGroup] = None) -> torch.Tensor:
    """``microbatches`` [M, mb, ...] through the P stages of ``axis``.

    ``stage_fn(params, x)`` applies one stage (its slice of the layer
    stack, ``stage_params``) to a microbatch [mb, ...] and returns the
    same shape.  With ``data_axis`` the microbatches' rows are this data
    rank's.  Returns [M, mb, ...], the whole pipeline applied to every
    microbatch, on every rank of ``axis``."""
    ax = axis or ONE_RANK
    p, idx = ax.size, ax.index
    n_micro = microbatches.shape[0]
    ticks = n_micro + p - 1
    if data_axis is not None:
        stage_params = tree_map(
            lambda x: copy_to(x, data_axis)
            if isinstance(x, torch.Tensor) else x, stage_params)
    xs = copy_to(microbatches, axis)
    first = torch.tensor(idx == 0, device=xs.device)
    state = torch.zeros_like(xs[0])
    emitted = []
    for t in range(ticks):
        feed = xs[min(t, n_micro - 1)]
        cur = feed if p == 1 else torch.where(first, feed, state)
        y = stage_fn(stage_params, cur).to(xs.dtype)
        if t >= p - 1:
            emitted.append(y)
        if t < ticks - 1:
            (state,) = ppermute([y], axis)
    outs = torch.stack(emitted)
    if p == 1:
        return outs
    last = torch.tensor(idx == p - 1, device=xs.device)
    return reduce_over(torch.where(last, outs, torch.zeros_like(outs)), axis)
