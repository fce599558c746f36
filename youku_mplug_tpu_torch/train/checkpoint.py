"""Checkpoints of the train state, one directory per step.

Counterpart of ``youku_mplug_tpu/train/checkpoint.py`` (an orbax
``CheckpointManager`` there) in a torch format of its own.  The
directory ``<step>/`` holds ``state.pt`` and, when given, the metadata
as ``metadata.json``.  ``state.pt`` is a dict of tensors and ints that
``torch.load(weights_only=True)`` reads:

- ``trainable``: the fp32 master weights, ``frozen``: the frozen leaves
  in their dtype (bf16 in training), both keyed by JAX path
  (``bridge.jax_path``);
- ``adam``: per trainable path, torch AdamW's ``exp_avg``,
  ``exp_avg_sq`` and ``step`` of that leaf (none before the first
  update), so a restore matches moments to leaves by path and never by
  torch's parameter order;
- ``count`` (the optimizer's update count, the schedule's index) and
  ``step`` (train steps taken, skipped ones included).

A save writes a hidden temporary directory and then renames it into
place, so a save that is killed part-way leaves no step that
``latest_step`` lists.  As orbax does, a save at a step no later than the
latest one writes nothing, and only the newest ``keep`` steps stay
(10 by default).  Saving is synchronous: ``async_checkpointing`` is not
ported and raises.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional

import torch

STATE_FILE = "state.pt"
METADATA_FILE = "metadata.json"


def state_dict(state) -> Dict[str, Any]:
    """A ``TrainState`` as the dict ``state.pt`` holds (tensors detached,
    on their device)."""
    opt = state.optimizer
    adam = {}
    for path, p in state.trainable.items():
        s = opt.torch_optimizer.state.get(p)
        if s:
            adam[path] = {k: s[k].detach() for k in
                          ("exp_avg", "exp_avg_sq", "step")}
    return {"trainable": {k: p.detach() for k, p in state.trainable.items()},
            "frozen": {k: p.detach() for k, p in state.frozen.items()},
            "adam": adam, "count": int(opt.count), "step": int(state.step)}


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 10,
                 async_save: bool = False):
        if async_save:
            raise NotImplementedError(
                "async_checkpointing is not ported yet: set it false")
        self.directory = os.path.abspath(directory)
        self.keep = keep

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def save(self, step: int, state, metadata: Optional[dict] = None
             ) -> bool:
        """Write ``state`` (a ``TrainState``) as step ``step``.  Returns
        False, writing nothing, when ``step`` is not later than the latest
        step saved."""
        latest = self.latest_step()
        if latest is not None and int(step) <= latest:
            return False
        tmp = os.path.join(self.directory, f".tmp-{int(step)}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)  # and the directory itself on the first save
        torch.save(state_dict(state), os.path.join(tmp, STATE_FILE))
        if metadata is not None:
            with open(os.path.join(tmp, METADATA_FILE), "w") as f:
                json.dump(metadata, f)
        os.replace(tmp, self._step_dir(step))
        for old in self.all_steps()[:-self.keep]:
            shutil.rmtree(self._step_dir(old))
        return True

    def wait_until_finished(self):
        """Saves are synchronous: nothing is in flight."""

    def all_steps(self) -> List[int]:
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
        return torch.load(os.path.join(self._step_dir(step), STATE_FILE),
                          map_location=map_location, weights_only=True)

    def restore(self, step: int, state):
        """Load step ``step`` into ``state`` in place and return it: every
        parameter (cast to its dtype, on its device), the AdamW moments by
        path, the optimizer's count and the step counter.  Raises
        ValueError, before changing anything, when the saved leaves or
        their shapes differ from the state's or a moment names no
        trainable leaf."""
        device = next(iter({**state.trainable, **state.frozen}.values())
                      ).device
        raw = self.restore_raw(step, map_location=device)
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
        extra = set(raw["adam"]) - set(state.trainable)
        if extra:
            raise ValueError(f"checkpoint step {step}: optimizer moments "
                             f"of leaves that do not train: "
                             f"{sorted(extra)[:8]}")
        with torch.no_grad():
            for part in ("trainable", "frozen"):
                for k, p in getattr(state, part).items():
                    p.copy_(raw[part][k])
        opt = state.optimizer
        adam_state = opt.torch_optimizer.state
        for path, p in state.trainable.items():
            if path in raw["adam"]:
                # torch keeps a non-capturable AdamW's step on the CPU
                saved = raw["adam"][path]
                adam_state[p] = {"exp_avg": saved["exp_avg"].to(p.device),
                                 "exp_avg_sq": saved["exp_avg_sq"].to(
                                     p.device),
                                 "step": saved["step"].cpu()}
            else:
                adam_state.pop(p, None)
        opt.count = int(raw["count"])
        state.step = int(raw["step"])
        return state

    def restore_metadata(self, step: int) -> Optional[dict]:
        path = os.path.join(self._step_dir(step), METADATA_FILE)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def close(self):
        """Nothing is held open between calls."""
