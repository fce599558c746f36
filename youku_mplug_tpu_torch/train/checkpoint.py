"""Checkpoints of the train state, one directory per step.

Counterpart of ``youku_mplug_tpu/train/checkpoint.py`` (an orbax
``CheckpointManager`` there) in a torch format of its own.  The
directory ``<step>/`` holds ``state.pt`` and, when given, the metadata
as ``metadata.json``.  ``state.pt`` is a dict of tensors and ints that
``torch.load(weights_only=True)`` reads:

- ``trainable``: the fp32 master weights, ``frozen``: the frozen leaves
  in their dtype (bf16 in training), both keyed by JAX path
  (``bridge.jax_path``);
- ``optim``: per trainable path, the optimizer's state tensors of that
  leaf by name (AdamW: torch's ``exp_avg``, ``exp_avg_sq`` and ``step``,
  none before the leaf's first update; a zoo optimizer: its rule's
  tensors, e.g. adafactor's ``v_row`` / ``v_col``, and a lookahead's
  slow weights as ``slow``), so a restore matches state to leaves by
  path and never by parameter order; ``optim_scalars``, the optimizer's
  step-level floats (nadam's momentum schedule); ``opt``, its name;
- ``count`` (the optimizer's update count, the schedule's index) and
  ``step`` (train steps taken, skipped ones included).

Checkpoints written before the zoo was ported hold AdamW's moments under
``adam`` instead of ``optim``; they restore as before.

``save`` also takes a plain dict of tensors in place of a state: the
serving export (``cli/export_serving.py``) writes ``{"params",
"qscales"}`` so, and ``restore_raw`` reads it back.

A save writes a hidden temporary directory and then renames it into
place, so a save that is killed part-way leaves no step that
``latest_step`` lists.  As orbax does, a save at a step no later than the
latest one writes nothing, and only the newest ``keep`` steps stay
(10 by default).

``async_save=True`` (the YAML's ``async_checkpointing``): ``save``
returns once every tensor of the state has been copied to the host (a
snapshot: the train step updates the parameters in place right after),
and a background thread writes the snapshot.  Every read (``all_steps``,
``latest_step``, ``rollback_step``, the restores), the next save,
``close`` and the end of the process wait for that write first, and an
error in it is raised there.

Under a (data, model) split (a state with a distributed ``mesh``) the
file is the unsharded one, as JAX's orbax checkpoint of a sharded tree
is: every rank takes part in gathering the model-split leaves and their
optimizer moments over the host group (``parallel/sharding.
gather_split``), rank 0 alone writes (in the background too), and a
restore reads the whole file on every rank and keeps the rank's slices,
whatever split wrote it.  Every wait ends in a barrier of the host
group, so every rank lists the same steps.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from youku_mplug_tpu_torch.optim.factory import AdamW
from youku_mplug_tpu_torch.parallel.sharding import gather_split, local_slice

STATE_FILE = "state.pt"
METADATA_FILE = "metadata.json"


def state_dict(state) -> Dict[str, Any]:
    """A ``TrainState`` as the dict ``state.pt`` holds (tensors detached,
    on their device)."""
    opt = state.optimizer
    return {"trainable": {k: p.detach() for k, p in state.trainable.items()},
            "frozen": {k: p.detach() for k, p in state.frozen.items()},
            "optim": {path: {k: v.detach() for k, v in leaf.items()}
                      for path, leaf in opt.leaf_state().items()},
            "optim_scalars": dict(opt.scalars()),
            "opt": str(opt.config.opt), "count": int(opt.count),
            "step": int(state.step)}


def _sharded(state) -> bool:
    mesh = getattr(state, "mesh", None)
    return mesh is not None and mesh.distributed and mesh.size > 1


def _unsharded(tree, state):
    """``state_dict(state)`` with every model-split leaf, and its
    optimizer tensors of the leaf's shape, gathered (collective: every
    rank of the mesh calls it)."""
    mesh, split = state.mesh, state.split
    for part in ("trainable", "frozen"):
        for k in sorted(tree[part]):
            if k in split:
                tree[part][k] = gather_split(tree[part][k], split[k], mesh)
    for path in sorted(tree["optim"]):
        if path not in split:
            continue
        shape = state.trainable[path].shape
        leaf = tree["optim"][path]
        for name in sorted(leaf):
            if leaf[name].shape == shape:
                leaf[name] = gather_split(leaf[name], split[path], mesh)
    return tree


def _local(raw, state):
    """A whole checkpoint's tensors cut to this rank's slices of the
    state's model-split leaves (a tensor whose split dim is the local
    one times the model degree; anything else kept, for the shape checks
    to judge)."""
    mesh, split = state.mesh, state.split
    for part in ("trainable", "frozen"):
        for k, d in split.items():
            t = raw[part].get(k)
            local = getattr(state, part).get(k)
            if t is not None and local is not None and t.dim() > d and \
                    t.shape[d] == local.shape[d] * mesh.model:
                raw[part][k] = local_slice(t, d, mesh)
    opt = raw.get("optim", raw.get("adam", {}))
    for path, leaf in opt.items():
        if path not in split or path not in state.trainable:
            continue
        d, local = split[path], state.trainable[path]
        for name, t in leaf.items():
            if t.dim() == local.dim() and t.shape[d] == \
                    local.shape[d] * mesh.model:
                leaf[name] = local_slice(t, d, mesh)
    return raw


def _host_copy(tree):
    """Every tensor of a nested dict copied to host memory (a fresh copy
    even where it already lies there)."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 10,
                 async_save: bool = False, mesh=None):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        self.async_save = async_save
        # a distributed mesh: rank 0 writes, every wait ends in a barrier
        self.mesh = mesh if mesh is not None and mesh.distributed \
            and mesh.size > 1 else None
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def save(self, step: int, state, metadata: Optional[dict] = None
             ) -> bool:
        """Write ``state`` (a ``TrainState``, or a dict saved as it is) as
        step ``step``; with ``async_save``, snapshot it to the host and
        write it in the background.  Returns False, writing nothing, when
        ``step`` is not later than the latest step saved."""
        latest = self.latest_step()  # waits for a write in flight
        if latest is not None and int(step) <= latest:
            return False
        tree = state if isinstance(state, dict) else state_dict(state)
        if not isinstance(state, dict) and _sharded(state):
            tree = _unsharded(tree, state)
        if self.mesh is not None and self.mesh.rank != 0:
            return True  # rank 0 writes the gathered tree
        if not self.async_save:
            self._write(int(step), tree, metadata)
            return True
        snapshot = _host_copy(tree)
        self._writer = threading.Thread(
            target=self._write_in_background,
            args=(int(step), snapshot, metadata),
            name=f"checkpoint-{int(step)}")
        self._writer.start()  # not a daemon: the process waits for it
        return True

    def _write_in_background(self, step, tree, metadata):
        try:
            self._write(step, tree, metadata)
        except BaseException as e:  # raised by the next wait
            self._error = e

    def _write(self, step: int, tree, metadata):
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)  # and the directory itself on the first save
        torch.save(tree, os.path.join(tmp, STATE_FILE))
        if metadata is not None:
            with open(os.path.join(tmp, METADATA_FILE), "w") as f:
                json.dump(metadata, f)
        os.replace(tmp, self._step_dir(step))
        for old in self._steps()[:-self.keep]:
            shutil.rmtree(self._step_dir(old))

    def wait_until_finished(self):
        """Block until a background write is on disk; raise its error."""
        writer, self._writer = self._writer, None
        if writer is not None:
            writer.join()
        error, self._error = self._error, None
        if self.mesh is not None:
            dist.barrier(group=self.mesh.host_group)
        if error is not None:
            raise RuntimeError("the background checkpoint write failed"
                               ) from error

    def all_steps(self) -> List[int]:
        self.wait_until_finished()
        return self._steps()

    def _steps(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(
                          os.path.join(self.directory, d, STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def rollback_step(self) -> Optional[int]:
        """The second-latest step (the target of the non-finite watchdog's
        rollback), else the latest."""
        steps = self.all_steps()
        if len(steps) >= 2:
            return steps[-2]
        return steps[-1] if steps else None

    def restore_raw(self, step: int, map_location=None) -> Dict[str, Any]:
        """The saved dict of step ``step`` as written (``state_dict``),
        its tensors on ``map_location`` (default: where they were)."""
        self.wait_until_finished()
        return torch.load(os.path.join(self._step_dir(step), STATE_FILE),
                          map_location=map_location, weights_only=True)

    def restore_raw_for(self, step: int, state, map_location=None
                        ) -> Dict[str, Any]:
        """``restore_raw`` for ``state``: under a split on the CPU, its
        model-split tensors cut to the rank's slices."""
        if _sharded(state):
            return _local(self.restore_raw(step, map_location="cpu"), state)
        return self.restore_raw(step, map_location=map_location)

    def restore(self, step: int, state):
        """Load step ``step`` into ``state`` in place and return it: every
        parameter (cast to its dtype, on its device), the optimizer's
        state by path, its count and the step counter.  Raises
        ValueError, before changing anything, when the saved leaves or
        their shapes differ from the state's, or the optimizer state
        names a leaf that does not train or was written by another
        optimizer."""
        device = next(iter({**state.trainable, **state.frozen}.values())
                      ).device
        raw = self.restore_raw_for(step, state, device)
        for part in ("trainable", "frozen"):
            want, got = getattr(state, part), raw[part]
            if set(want) != set(got):
                raise ValueError(
                    f"checkpoint step {step}: {part} leaves differ: "
                    f"{sorted(set(want) ^ set(got))[:8]}")
            bad = [k for k in want if tuple(want[k].shape)
                   != tuple(got[k].shape)]
            if bad:
                raise ValueError(
                    f"checkpoint step {step}: {part} shapes differ at "
                    + ", ".join(f"{k} {tuple(got[k].shape)} vs "
                                f"{tuple(want[k].shape)}" for k in bad[:8]))
        opt = state.optimizer
        leaves = raw["optim"] if "optim" in raw else raw["adam"]
        extra = set(leaves) - set(state.trainable)
        if extra:
            raise ValueError(f"checkpoint step {step}: optimizer moments "
                             f"of leaves that do not train: "
                             f"{sorted(extra)[:8]}")
        saved_opt = raw.get("opt", "adamw")
        same_family = ({saved_opt.lower(), opt.config.opt.lower()}
                       <= {"adam", "adamw"})
        if saved_opt.lower() != opt.config.opt.lower() and not same_family:
            raise ValueError(f"checkpoint step {step}: optimizer state of "
                             f"{saved_opt!r}, not {opt.config.opt!r}")
        want_names = {k: set(v) for k, v in opt.leaf_state().items()}
        if not isinstance(opt, AdamW) and any(
                set(leaves.get(k, ())) != want_names[k] for k in want_names):
            raise ValueError(f"checkpoint step {step}: optimizer state "
                             f"tensors differ from {opt.config.opt!r}'s")
        with torch.no_grad():
            for part in ("trainable", "frozen"):
                for k, p in getattr(state, part).items():
                    p.copy_(raw[part][k])
        opt.load_state(leaves, raw.get("optim_scalars", {}))
        opt.count = int(raw["count"])
        state.step = int(raw["step"])
        return state

    def restore_metadata(self, step: int) -> Optional[dict]:
        self.wait_until_finished()
        path = os.path.join(self._step_dir(step), METADATA_FILE)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def close(self):
        """Wait for a background write (nothing else is held open)."""
        self.wait_until_finished()
