"""Video frames from a file, decoded by OpenCV.

Counterpart of ``youku_mplug_tpu/data/video_decode.py`` on its cv2 path
(the one the JAX package takes where its native libav reader does not
load): ``read_frames`` probes the frame count and rate, samples indices
(``data/samplers.py``; a start and end time take the ``rand`` sampling
inside that span), decodes those frames as (T, H, W, 3) uint8 RGB,
resized (bicubic) to ``width`` x ``height`` or, with ``short_side``, to
that short side at the source's aspect (never up).  An
``archive.tar/member.mp4`` path reads the member from the tar, extracted
once into a cache under the temporary directory.  The native reader is
not ported (ROADMAP.md, Queue 1): there is no other decoder to fall back
on, and a file cv2 cannot open raises.

``_read_cv2`` reads every frame up to the last index it needs (no seek),
so a clip costs decode time in proportion to where its last sampled
frame lies.
"""

from __future__ import annotations

import hashlib
import os
import tarfile
import tempfile
from typing import Optional, Sequence

import cv2
import numpy as np

from youku_mplug_tpu_torch.data.samplers import (
    get_frame_indices,
    get_frame_indices_start_end,
)

TAR_CACHE = "youku_mplug_tpu_torch_videos"  # under tempfile.gettempdir()


def _read_cv2(video_path: str, indices: Sequence[int], width: int = 0,
              height: int = 0) -> np.ndarray:
    """The frames at ``indices`` (repeats allowed; an index past the
    end takes the last frame decoded) as (T, H, W, 3) uint8 RGB."""
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise IOError(f"cannot open video: {video_path}")
    try:
        order = sorted(set(int(i) for i in indices))
        frames = {}
        pos = 0
        want = iter(order)
        nxt = next(want, None)
        while nxt is not None:
            ok, frame = cap.read()
            if not ok:
                break
            if pos == nxt:
                frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                if width and height:
                    frame = cv2.resize(frame, (width, height),
                                       interpolation=cv2.INTER_CUBIC)
                frames[pos] = frame
                nxt = next(want, None)
            pos += 1
        if not frames:
            raise IOError(f"no frames decoded: {video_path}")
        last = frames[max(frames)]
        return np.stack([frames.get(int(i), last) for i in indices])
    finally:
        cap.release()


def _probe_cv2(video_path: str):
    """-> (frame count, frames a second (30 when the file says 0),
    (height, width))."""
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise IOError(f"cannot open video: {video_path}")
    vlen = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    fps = float(cap.get(cv2.CAP_PROP_FPS)) or 30.0
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    cap.release()
    return vlen, fps, (h, w)


def _resolve_tar(video_path: str) -> str:
    """``archive.tar/member.mp4`` -> the member extracted once into a
    cache directory of its archive (written to a temporary file and
    renamed, so a concurrent reader never sees part of it); any other
    path as given."""
    if ".tar/" not in video_path:
        return video_path
    archive, member = video_path.split(".tar/", 1)
    archive += ".tar"
    cache = os.path.join(tempfile.gettempdir(), TAR_CACHE,
                         hashlib.md5(archive.encode()).hexdigest())
    out = os.path.join(cache, member)
    if not os.path.exists(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(out),
                                   prefix=".tarx_")
        try:
            with tarfile.open(archive) as tf:
                with tf.extractfile(member) as src, \
                        os.fdopen(fd, "wb") as dst:
                    dst.write(src.read())
            os.replace(tmp, out)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
    return out


def _short_side_dims(h: int, w: int, short_side: int):
    """(out_w, out_h) that bring the short side to ``short_side`` at the
    source's aspect; (0, 0), the source size, where it is no larger."""
    if short_side <= 0 or min(h, w) <= short_side:
        return 0, 0
    if h <= w:
        return int(round(w * short_side / h)), short_side
    return short_side, int(round(h * short_side / w))


def read_frames(video_path: str, num_frames: int = 8, sample: str = "rand",
                fix_start: Optional[int] = None, max_num_frames: int = -1,
                start_time: Optional[float] = None,
                end_time: Optional[float] = None,
                width: int = 0, height: int = 0, short_side: int = 0,
                rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """``num_frames`` sampled frames -> (T, H, W, 3) uint8 RGB (see the
    module docstring)."""
    video_path = _resolve_tar(video_path)
    vlen, fps, (h, w) = _probe_cv2(video_path)
    if short_side:
        width, height = _short_side_dims(h, w, short_side)
    vlen = max(vlen, 1)
    if start_time is not None and end_time is not None:
        indices = get_frame_indices_start_end(
            num_frames, vlen, fps, start_time, end_time, rng=rng)
    else:
        indices = get_frame_indices(
            num_frames, vlen, sample=sample, fix_start=fix_start,
            input_fps=fps, max_num_frames=max_num_frames, rng=rng)
    return _read_cv2(video_path, indices, width=width, height=height)
