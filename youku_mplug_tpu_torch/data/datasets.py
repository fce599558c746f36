"""Synthetic clips for smoke runs and tests.

The clips of ``youku_mplug_tpu.data.datasets.SyntheticVideoDataset``, bit
for bit (the same per-index numpy generator), without importing the JAX
package.  Decoding real video files is not ported yet.
"""

from __future__ import annotations

import numpy as np


class SyntheticVideoDataset:
    """Procedural uint8 (T, H, W, 3) clips, one per index."""

    def __init__(self, length: int = 64, num_frames: int = 8,
                 size: int = 224):
        self.length = length
        self.num_frames = num_frames
        self.size = size

    def __len__(self):
        return self.length

    def __getitem__(self, index):
        rng = np.random.default_rng(index)
        t, s = self.num_frames, self.size
        base = rng.integers(0, 255, size=(1, s, s, 3), dtype=np.uint8)
        drift = np.arange(t, dtype=np.int16)[:, None, None, None] * 3
        clip = ((base.astype(np.int16) + drift) % 256).astype(np.uint8)
        return {"video": clip, "video_id": str(index)}
