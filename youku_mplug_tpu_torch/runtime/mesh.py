"""The (data, model) device mesh over ``torch.distributed`` ranks.

Counterpart of ``youku_mplug_tpu/runtime/mesh.py``.  The reference builds
explicit process groups for tensor and data parallelism (Megatron's
``initialize_model_parallel``); the JAX package lays the same structure
out as one ``jax.sharding.Mesh`` and lets GSPMD write the collectives.
The port is back on process groups: one process (a rank) per model
shard, launched by ``python -m torch.distributed.run``.

- ``data``: each data coordinate serves (or reads) its own shard of the
  requests or batches.
- ``model``: tensor parallelism of the attention heads, the MLP width and
  the vocabulary (``parallel/sharding.py``, ``parallel/tensor_parallel.py``).

``model`` varies fastest over the ranks, as the JAX mesh lays its devices
out: rank ``r`` sits at ``(r // model, r % model)``.  ``make_mesh``
returns a ``Mesh``: the resolved degrees, this rank's coordinate, a
``torch.distributed.device_mesh.DeviceMesh`` with dims ``("data",
"model")`` and its per-dim process groups (on the default backend: NCCL
on the card, or gloo where the caller asks for it), and a CPU gloo group
over every rank for host merges (records, counters, parameter gathers).
In one process without a process group the mesh is (1, 1) and holds no
group; a YAML asking for more raises ``MeshConfig.resolve``'s error.

Which collectives run where: the model's own collectives are
``all_reduce`` (and nothing else) on device tensors over the model
group, which NCCL runs between cards and gloo runs for CUDA tensors by
copying them through the host (several ranks on one card, as NCCL
refuses); everything host-side goes over the gloo host group.

Axes beyond (data, model): the JAX package's context, pipeline and
expert parallelism name their own mesh axes (``sp``, ``pipe``; experts
stay on ``model``).  ``named_axes`` lays the run's ranks out as a mesh
of such named dims and returns each dim's ``AxisGroup`` (this rank's
process group along it, its index and the size), which
``parallel/collectives.py`` and the modules on it (``ring_attention``,
``pipeline``, ``moe``) take.  Their collectives on device tensors add
point-to-point exchanges and ``all_to_all`` to ``all_reduce``; under
gloo those copy CUDA tensors through the host explicitly.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
DEFAULT_TIMEOUT_S = 600.0  # a lost rank fails the run after this long


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Parallelism degrees. -1 for ``data`` means "all remaining ranks"."""

    data: int = -1
    model: int = 1

    def resolve(self, n_devices: int) -> "MeshConfig":
        model = self.model if self.model > 0 else 1
        data = self.data
        if data <= 0:
            if n_devices % model != 0:
                raise ValueError(
                    f"n_devices={n_devices} not divisible by model={model}")
            data = n_devices // model
        if data * model != n_devices:
            raise ValueError(
                f"mesh {data}x{model} != n_devices {n_devices}")
        return MeshConfig(data=data, model=model)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A resolved (data, model) mesh and this rank's place in it.
    ``device_mesh`` and ``host_group`` are None in one process without a
    process group."""

    data: int = 1
    model: int = 1
    rank: int = 0
    device_mesh: Optional[object] = None  # DeviceMesh
    host_group: Optional[object] = None   # gloo ProcessGroup, every rank

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def coord(self) -> tuple:
        """(data index, model index) of this rank."""
        return divmod(self.rank, self.model)

    @property
    def data_index(self) -> int:
        return self.coord[0]

    @property
    def model_index(self) -> int:
        return self.coord[1]

    @property
    def distributed(self) -> bool:
        return self.device_mesh is not None

    def index(self, axis: str) -> int:
        return self.coord[(DATA_AXIS, MODEL_AXIS).index(axis)]

    def group(self, axis: str):
        """The process group of this rank's line along ``axis`` (the
        default backend's), or None where the axis has one rank."""
        if self.shape[axis] == 1 or self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    @property
    def model_group(self):
        return self.group(MODEL_AXIS)


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """One mesh axis of a rank: the process group of this rank's line
    along it (None where the axis has one rank), this rank's index on it
    and its size.  The model group (``tensor_parallel.ModelGroup``) and
    the data group (``data_parallel.DataGroup``) are this record too."""

    group: Optional[object]
    index: int
    size: int


# what an axis of None stands for: one rank, no group
ONE_RANK = AxisGroup(None, 0, 1)


def named_axes(shape: Sequence[Tuple[str, int]]) -> Dict[str, AxisGroup]:
    """The run's ranks as a mesh of the named dims ``shape`` (``(name,
    size)`` pairs; the last varies fastest over the ranks, as a JAX mesh
    reshapes its devices; a ``model`` dim must be that last one) -> {name:
    this rank's ``AxisGroup``}.  The sizes' product must be the world's
    size; in one process without a process group every size must be 1,
    and no group is made.  Every rank of the run calls it (it makes the
    groups)."""
    names = tuple(n for n, _ in shape)
    sizes = tuple(int(n) for _, n in shape)
    if MODEL_AXIS in names and names[-1] != MODEL_AXIS:
        raise ValueError(f"axes {names}: {MODEL_AXIS!r} must vary fastest")
    world = run_world_size()
    if int(np.prod(sizes)) != world:
        raise ValueError(f"mesh {dict(shape)} != {world} "
                         f"rank{'s' if world != 1 else ''}")
    if not dist.is_initialized():
        return {n: ONE_RANK for n in names}
    from torch.distributed.device_mesh import DeviceMesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = DeviceMesh(device_type, torch.arange(world).reshape(sizes),
                    mesh_dim_names=names)
    coord = np.unravel_index(dist.get_rank(), sizes)
    return {n: AxisGroup(dm.get_group(n) if size > 1 else None, int(i),
                         size)
            for n, size, i in zip(names, sizes, coord)}


def axis_sizes(mesh: Union[Mesh, Mapping[str, int]]) -> dict:
    """{"data": D, "model": M} of a Mesh, or of a mapping of axis sizes
    (a layout without ranks: the specs of ``parallel/sharding.py``)."""
    if isinstance(mesh, Mesh):
        return mesh.shape
    return {DATA_AXIS: int(mesh.get(DATA_AXIS, 1)),
            MODEL_AXIS: int(mesh.get(MODEL_AXIS, 1))}


def run_world_size() -> int:
    """Ranks of the run's process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(config: Optional[MeshConfig] = None,
              world_size: Optional[int] = None) -> Mesh:
    """The mesh of ``config`` over this run's ranks (the process group's
    world; one rank without a process group).  ``world_size``, when
    given, must be that world's size.  Raises ``MeshConfig.resolve``'s
    error where the mesh does not cover the world exactly (a model > 1
    YAML in one process among them)."""
    world = run_world_size()
    if world_size is not None and world_size != world:
        raise ValueError(f"world_size={world_size}, but the run has {world} "
                         f"rank{'s' if world != 1 else ''}")
    cfg = (config or MeshConfig()).resolve(world)
    if not dist.is_initialized():
        return Mesh(cfg.data, cfg.model)
    from torch.distributed.device_mesh import DeviceMesh

    backend = dist.get_backend()
    # the device type only names the mesh: its groups are the backend's
    device_type = "cuda" if backend == "nccl" else "cpu"
    layout = torch.arange(world).reshape(cfg.data, cfg.model)
    device_mesh = DeviceMesh(device_type, layout,
                             mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    host = dist.new_group(backend="gloo") if backend != "gloo" \
        else dist.group.WORLD
    return Mesh(cfg.data, cfg.model, dist.get_rank(), device_mesh, host)


def launched() -> bool:
    """Whether ``torch.distributed.run`` (or the same environment) started
    this process."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                         "MASTER_ADDR", "MASTER_PORT"))


def local_rank() -> Optional[int]:
    """``LOCAL_RANK`` as ``torch.distributed.run`` sets it, or None."""
    value = os.environ.get("LOCAL_RANK")
    return None if value is None else int(value)


def distributed_init(backend: str, timeout: float = DEFAULT_TIMEOUT_S,
                     device: Optional[torch.device] = None) -> bool:
    """Join the run's process group from the environment
    ``torch.distributed.run`` sets (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), with ``backend``
    and an explicit ``timeout`` (seconds), so that a lost rank fails the
    run instead of hanging it.  In a process started without that
    environment it does nothing, as JAX's does on one host; a process
    group that already exists is kept (its backend must be ``backend``).
    ``device``: the rank's card, made current before NCCL starts.  Ends
    in a barrier: NCCL ranks that share a card raise there (NCCL's own
    error; nothing falls back to gloo).  Returns whether a process group
    is up."""
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"a {dist.get_backend()} process group exists; "
                             f"asked for {backend}")
        return True
    if not launched():
        return False
    if device is not None and device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend,
                            timeout=datetime.timedelta(seconds=timeout))
    # every rank is up before the model is built; NCCL starts here, so
    # ranks sharing a card fail now, with NCCL's own error
    if backend == "nccl" and device is not None and device.index is not None:
        dist.barrier(device_ids=[device.index])
    else:
        dist.barrier()
    return True


def distributed_shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def local_batch_size(global_batch_size: int,
                     mesh: Union[Mesh, Mapping[str, int]]) -> int:
    """The batch each rank reads when the global batch is sharded over the
    data axis: every rank of one model group reads the same one.  (JAX's
    divides by the process count, a process feeding all of a host's
    devices; here a process is one rank.)"""
    data = axis_sizes(mesh)[DATA_AXIS]
    if global_batch_size % data != 0:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by data={data}")
    return global_batch_size // data


def mfu(flops_per_step: float, step_time_s: float,
        peak_flops: Optional[float] = None) -> float:
    """Model-flops-utilization of a step: one card per rank."""
    if peak_flops is None:
        peak_flops = device_peak_flops() * run_world_size()
    return flops_per_step / (step_time_s * peak_flops)


# the CUDA device's full name -> dense bf16 peak FLOP/s of one card (the
# SXM part; the PCIe and NVL parts also say "H100" and peak lower)
_PEAK_FLOPS_BF16 = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def device_peak_flops(device: Optional[torch.device] = None) -> float:
    """The dense bf16 peak of the card, keyed on its full name; a card
    not in the table raises (no other card's figure is assumed)."""
    name = torch.cuda.get_device_name(device)
    if name not in _PEAK_FLOPS_BF16:
        raise ValueError(f"no bf16 peak known for {name!r}; known: "
                         f"{sorted(_PEAK_FLOPS_BF16)}")
    return _PEAK_FLOPS_BF16[name]
