"""Resizing of the vision embeddings a checkpoint was trained with.

The part of ``youku_mplug_tpu/models/importers.py`` that resuming needs
(``cli/common.restore_with_resize``): a checkpoint at another image size
or frame count loads with its position embedding interpolated bilinearly
over the patch grid and its temporal embedding linearly over the frames,
both with torch ``F.interpolate``'s half-pixel sampling
(``align_corners=False``).  numpy in, numpy out.
"""

from __future__ import annotations

import numpy as np


def _interp_linear_axis(x: np.ndarray, new_len: int,
                        axis: int) -> np.ndarray:
    """1-D linear interpolation along ``axis`` with half-pixel
    sampling."""
    old = x.shape[axis]
    if old == new_len:
        return x
    src = (np.arange(new_len) + 0.5) * old / new_len - 0.5
    lo = np.clip(np.floor(src).astype(int), 0, old - 1)
    hi = np.clip(lo + 1, 0, old - 1)
    w = np.clip(src - lo, 0.0, 1.0)
    shape = [1] * x.ndim
    shape[axis] = new_len
    w = w.reshape(shape)
    return (np.take(x, lo, axis=axis) * (1 - w)
            + np.take(x, hi, axis=axis) * w)


def resize_pos_embed(posemb: np.ndarray, num_patches_new: int) -> np.ndarray:
    """[1, 1 + N_old, D] -> [1, 1 + N_new, D]: the cls row kept, the
    patch grid resized bilinearly (two separable half-pixel passes)."""
    tok, grid = posemb[:, :1], posemb[0, 1:]
    gs_old = int(np.sqrt(len(grid)))
    gs_new = int(np.sqrt(num_patches_new))
    if gs_old == gs_new:
        return posemb
    grid = grid.reshape(gs_old, gs_old, -1).astype(np.float32)
    grid = _interp_linear_axis(grid, gs_new, axis=0)
    grid = _interp_linear_axis(grid, gs_new, axis=1)
    return np.concatenate(
        [tok, grid.reshape(1, gs_new * gs_new, -1)], axis=1)


def resize_temporal_embed(temb: np.ndarray, t_new: int) -> np.ndarray:
    """[1, T_old, D] -> [1, T_new, D], linear over the frames."""
    return _interp_linear_axis(temb, t_new, axis=1)
