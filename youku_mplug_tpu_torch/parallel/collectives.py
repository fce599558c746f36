"""Collectives on device tensors along one named mesh axis, under autograd.

The JAX package's context, pipeline and expert parallelism run
``jax.lax.ppermute``, ``all_to_all`` and ``psum`` inside ``shard_map``
and let autodiff transpose them.  The port writes each as a
``torch.autograd.Function`` over an ``AxisGroup`` (``runtime/mesh.py``):

- ``ppermute``: each rank sends its tensors ``shift`` places along the
  axis (rank ``i`` to ``(i + shift) % P``) and receives the ones sent to
  it; the backward sends the gradients the other way.  One
  ``batch_isend_irecv`` a call, every tensor under its own tag, so no
  order of the ranks can deadlock;
- ``all_to_all``: JAX's tiled ``all_to_all`` (``split_dim`` cut into P
  chunks, chunk ``j`` to rank ``j``, the received chunks joined along
  ``concat_dim`` in rank order); the backward is the inverse
  ``all_to_all``.

JAX's ``psum`` under autodiff is ``parallel/tensor_parallel``'s f / g
pair, over any axis ``copy_to`` and ``reduce_over``.

NCCL takes CUDA tensors for all of these.  gloo takes CUDA tensors for
``all_reduce`` only (it copies them through the host itself); for the
exchanges and ``all_to_all`` this module copies them to the host and
back.  Without a group (one rank on the axis) each is the identity and
issues nothing.  ``Counts`` counts this process's exchanges and
``all_to_all`` calls and the bytes they send.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from youku_mplug_tpu_torch.parallel.tensor_parallel import _active
from youku_mplug_tpu_torch.runtime.mesh import AxisGroup


class Counts:
    """This process's exchanges and ``all_to_all`` calls, and the bytes
    they sent (both directions of autograd alike)."""

    calls = 0
    bytes_sent = 0

    @classmethod
    def reset(cls) -> None:
        cls.calls = cls.bytes_sent = 0


def _through_host(t: torch.Tensor, group) -> bool:
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _exchange(tensors: Sequence[torch.Tensor], ax: AxisGroup,
              shift: int) -> List[torch.Tensor]:
    to = dist.get_global_rank(ax.group, (ax.index + shift) % ax.size)
    frm = dist.get_global_rank(ax.group, (ax.index - shift) % ax.size)
    host = _through_host(tensors[0], ax.group)
    sends = [(t.cpu() if host else t).contiguous() for t in tensors]
    recvs = [torch.empty_like(t, memory_format=torch.contiguous_format)
             for t in sends]
    ops = []
    for tag, (s, r) in enumerate(zip(sends, recvs)):
        ops += [dist.P2POp(dist.isend, s, to, ax.group, tag),
                dist.P2POp(dist.irecv, r, frm, ax.group, tag)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    Counts.calls += 1
    Counts.bytes_sent += sum(s.numel() * s.element_size() for s in sends)
    return [r.to(t.device) if host else r for r, t in zip(recvs, tensors)]


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, shift, *tensors):
        ctx.ax, ctx.shift = ax, shift
        return tuple(_exchange(tensors, ax, shift))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *_exchange(grads, ctx.ax, -ctx.shift))


def ppermute(tensors: Sequence[torch.Tensor], ax: Optional[AxisGroup],
             shift: int = 1) -> List[torch.Tensor]:
    """``tensors`` sent ``shift`` ranks on along ``ax`` (rank ``i`` to
    ``(i + shift) % P``); returns the ones this rank received, in order.
    Every rank of the axis calls it with tensors of the same shapes."""
    if not _active(ax):
        return list(tensors)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return list(_Permute.apply(ax, shift, *tensors))
    return _exchange(tensors, ax, shift)


def _a2a(x: torch.Tensor, ax: AxisGroup, split_dim: int,
         concat_dim: int) -> torch.Tensor:
    if x.shape[split_dim] % ax.size:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not split {ax.size} ways")
    host = _through_host(x, ax.group)
    send = torch.stack(x.chunk(ax.size, split_dim))
    send = send.cpu() if host else send.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=ax.group)
    Counts.calls += 1
    Counts.bytes_sent += send.numel() * send.element_size()
    if host:
        recv = recv.to(x.device)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, split_dim, concat_dim):
        ctx.args = ax, concat_dim, split_dim
        return _a2a(x, ax, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        return _a2a(grad, *ctx.args), None, None, None


def all_to_all(x: torch.Tensor, ax: Optional[AxisGroup], split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """JAX's ``all_to_all(x, axis, split_dim, concat_dim, tiled=True)``
    along ``ax`` (see the module docstring)."""
    if not _active(ax):
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllToAll.apply(x, ax, split_dim, concat_dim)
    return _a2a(x, ax, split_dim, concat_dim)
