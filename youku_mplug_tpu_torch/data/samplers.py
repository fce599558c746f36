"""Frame-index samplers.

Counterpart of ``youku_mplug_tpu/data/samplers.py``, the same indices
for the same generator: ``rand`` picks one frame in each of
``num_frames`` equal intervals, ``middle`` the intervals' midpoints,
``fps<k>`` frames at k a second (at most ``max_num_frames``), and
``interval`` a clip of fixed stride at a random start.  Too few frames
pad with the last index.  Every random draw comes from the ``rng``
given, so a sample's frames depend on its own generator only.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def get_frame_indices(num_frames: int, vlen: int, sample: str = "rand",
                      fix_start: Optional[int] = None, input_fps: float = 1.0,
                      max_num_frames: int = -1,
                      rng: Optional[np.random.Generator] = None) -> List[int]:
    """``num_frames`` indices into a video of ``vlen`` frames at
    ``input_fps`` (``fps<k>`` returns as many as the rate gives)."""
    rng = rng or np.random.default_rng()
    if sample in ("rand", "middle"):
        acc = min(num_frames, vlen)
        intervals = np.linspace(0, vlen, acc + 1).astype(int)
        ranges = [(intervals[i], intervals[i + 1] - 1) for i in range(acc)]
        if fix_start is not None:
            idx = [lo + fix_start for lo, _ in ranges]
        elif sample == "rand":
            if all(hi > lo for lo, hi in ranges):
                idx = [int(rng.integers(lo, hi)) for lo, hi in ranges]
            else:  # an interval of one frame: a sorted random subset
                idx = sorted(rng.permutation(vlen)[:acc].tolist())
        else:
            idx = [(lo + hi) // 2 for lo, hi in ranges]
        if len(idx) < num_frames:
            idx = idx + [idx[-1]] * (num_frames - len(idx))
        return [int(i) for i in idx]

    if sample.startswith("fps"):
        output_fps = float(sample[3:])
        duration = float(vlen) / input_fps
        delta = 1.0 / output_fps
        seconds = np.arange(delta / 2, duration + delta / 2, delta)
        idx = np.around(seconds * input_fps).astype(int)
        idx = [int(e) for e in idx if e < vlen]
        if max_num_frames > 0 and len(idx) > max_num_frames:
            idx = idx[:max_num_frames]
        return idx

    if "interval" in sample:
        if num_frames == 1:
            return [int(rng.integers(0, vlen))]
        interval = 8
        clip_length = num_frames * interval * input_fps / 30.0
        max_idx = max(vlen - clip_length, 0)
        start = rng.uniform(0, max_idx)
        idx = np.linspace(start, start + clip_length - 1, num_frames)
        return np.clip(idx, 0, vlen - 1).astype(int).tolist()

    raise ValueError(f"unknown sample mode: {sample}")


def get_frame_indices_start_end(num_frames: int, vlen: int, fps: float,
                                start_time: float, end_time: float,
                                rng: Optional[np.random.Generator] = None
                                ) -> List[int]:
    """``rand`` sampling inside [start_time, end_time) seconds."""
    rng = rng or np.random.default_rng()
    start = max(int(fps * start_time), 0)
    end = min(int(fps * end_time), vlen)
    clip_len = max(end - start, 1)
    acc = min(num_frames, clip_len)
    intervals = np.linspace(start, end, acc + 1).astype(int)
    ranges = [(intervals[i], intervals[i + 1] - 1) for i in range(acc)]
    if all(hi > lo for lo, hi in ranges):
        idx = [int(rng.integers(lo, hi)) for lo, hi in ranges]
    else:
        pool = np.arange(start, max(end, start + 1))
        idx = sorted(rng.permutation(pool)[:acc].tolist())
    if len(idx) < num_frames:
        idx = idx + [idx[-1]] * (num_frames - len(idx))
    return [int(i) for i in idx]
