"""Data parallelism over the mesh's data group: the step of a (data,
model) split equals the (1,1) step on the global batch.

GSPMD gives the JAX package this for free: its losses are means over the
global batch array, whatever its placement.  The port writes it out,
with ``all_reduce`` alone (the one collective NCCL and gloo both run on
device tensors):

- ``sum_over_data``: a sum over the data ranks that takes no gradient
  (a token count, a metric, the gradients themselves);
- ``gather_rows``: the rows of every data rank in data order, under
  autograd (a zero-filled buffer plus ``all_reduce``; the backward sums
  the gradient over the data ranks and keeps this rank's rows): the
  contrastive loss's per-query max over the global batch, the
  retrieval NCE's features, the ITM pairs' query features, and integer
  rows that take no gradient (the retrieval ``idx``: its soft targets
  are global);
- ``data_group_of``: the ``DataGroup`` a module's losses reduce over,
  set on a model by ``parallel/sharding.shard_params`` and only in
  training mode, so that evaluation keeps its per-rank losses.

Each rank's loss is its share of the global one (its rows' sum over the
global count), so the global loss and its gradient are sums over the
data ranks: the trainer sums the gradients and the metrics
(``train/trainer.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from youku_mplug_tpu_torch.runtime.mesh import AxisGroup

# the data-axis process group of a rank, its index and size
DataGroup = AxisGroup


def data_group(mesh) -> Optional[DataGroup]:
    """The ``DataGroup`` of a mesh with more than one data rank, else
    None."""
    if mesh is None or mesh.data <= 1:
        return None
    return DataGroup(mesh.group("data"), mesh.data_index, mesh.data)


def data_group_of(module) -> Optional[DataGroup]:
    """The data group a training loss of ``module`` reduces over: its
    mesh's, in training mode; None in evaluation or without a split."""
    return data_group(getattr(module, "mesh", None)) \
        if module.training else None


def sum_over_data(x: torch.Tensor, dp: Optional[DataGroup]) -> torch.Tensor:
    """``x`` (detached) summed over the data ranks; ``x`` itself without
    a data group."""
    if dp is None:
        return x
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=dp.group)
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp, ctx.rows = dp, x.shape[0]
        full = x.new_zeros(dp.size * x.shape[0], *x.shape[1:])
        full[dp.index * x.shape[0]:(dp.index + 1) * x.shape[0]] = x
        dist.all_reduce(full, group=dp.group)
        return full

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.dp.group)
        i, n = ctx.dp.index, ctx.rows
        return grad[i * n:(i + 1) * n], None


def share(rows: torch.Tensor, dp: Optional[DataGroup]) -> torch.Tensor:
    """This rank's share of the mean over the global batch of per-row
    values ``rows`` (its rows' sum over the global count); the mean
    without a data group."""
    return rows.mean() if dp is None else \
        rows.sum() / (rows.shape[0] * dp.size)


def gather_rows(x: torch.Tensor, dp: Optional[DataGroup]) -> torch.Tensor:
    """[B, ...] rows of this data rank -> [D * B, ...], every data rank's
    rows in data order, on every rank; differentiable (integer rows go
    through too, taking no gradient)."""
    if dp is None:
        return x
    return _GatherRows.apply(x, dp)

