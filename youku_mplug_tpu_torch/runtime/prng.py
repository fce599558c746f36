"""Randomness over a mesh: generators derived from the run seed.

Counterpart of ``youku_mplug_tpu/runtime/prng.py``.  The reference keeps
ranks' draws decorrelated with per-rank seed offsets and a CUDA RNG
tracker; the JAX package folds static integers (the step, a mesh axis
index) into one key, so the same program draws the same numbers whatever
the device count.  The port does the same with seeds: ``fold_in`` mixes
integers into a seed (``numpy.random.SeedSequence``, the counterpart of
``jax.random.fold_in``), ``fold_in_axes`` mixes in this rank's
coordinates on the named mesh axes only, and ``make_rngs`` gives a step's
``torch.Generator`` per name.

Which axes a draw folds decides who draws alike: serving's sampling
folds the data coordinate only, so every model rank of a data rank draws
the same Gumbel noise over the (gathered, full) vocabulary and picks the
same token; dropout under tensor parallelism will fold the model axis
too, as JAX's ``fold_in_axes(key, "model")`` does (with training under
the mesh).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from youku_mplug_tpu_torch.runtime.mesh import Mesh


def fold_in(seed: int, *values: int) -> int:
    """A seed (63 bits) mixing ``seed`` with ``values`` (non-negative
    ints): a different value gives an unrelated seed."""
    state = np.random.SeedSequence([int(seed), *map(int, values)]
                                   ).generate_state(2, np.uint32)
    return int(state[0]) << 31 ^ int(state[1])


def fold_in_axes(seed: int, mesh: Mesh, *axis_names: str) -> int:
    """``seed`` with this rank's coordinate on each of ``axis_names``
    folded in, in order (the other axes leave it alike)."""
    for name in axis_names:
        seed = fold_in(seed, mesh.index(name))
    return seed


def make_rngs(seed: int, step: int, names: Sequence[str] = ("dropout",),
              device="cpu", mesh: Mesh = None,
              axes: Sequence[str] = ()) -> Dict[str, torch.Generator]:
    """Per-step generators, one per name, on ``device``: the run ``seed``
    with ``step``, the name's position and (with a ``mesh``) the rank's
    coordinates on ``axes`` folded in."""
    base = fold_in(seed, step)
    if mesh is not None:
        base = fold_in_axes(base, mesh, *axes)
    return {name: torch.Generator(device=device).manual_seed(
        fold_in(base, i)) for i, name in enumerate(names)}
