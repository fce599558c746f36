"""Synthetic clips and captions for smoke runs and tests.

The samples of ``youku_mplug_tpu.data.datasets.SyntheticVideoDataset``,
bit for bit (the same per-index numpy generator, the same caption,
``label`` (index mod ``num_classes``), ``match_id`` and ``index``
fields), without importing the JAX package; ``SyntheticRetrievalSplit``
adds the fields the retrieval evaluations read from a split, as the JAX
retrieval runner sets them on its synthetic val and test splits.
Decoding real video files is not ported yet.
"""

from __future__ import annotations

import numpy as np


class SyntheticVideoDataset:
    """Procedural uint8 (T, H, W, 3) clips with a caption, one per
    index."""

    def __init__(self, length: int = 64, num_frames: int = 8,
                 size: int = 224, num_classes: int = 5):
        self.length = length
        self.num_frames = num_frames
        self.size = size
        self.num_classes = num_classes

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return self.length

    def __getitem__(self, index):
        rng = np.random.default_rng(index)
        t, s = self.num_frames, self.size
        base = rng.integers(0, 255, size=(1, s, s, 3), dtype=np.uint8)
        drift = np.arange(t, dtype=np.int16)[:, None, None, None] * 3
        clip = ((base.astype(np.int16) + drift) % 256).astype(np.uint8)
        label = index % self.num_classes
        return {"video": clip,
                "text": f"synthetic clip {index} class {label}",
                "label": label, "match_id": index, "index": index,
                "golden": [f"synthetic clip {index}"],
                "video_id": str(index)}


class SyntheticRetrievalSplit(SyntheticVideoDataset):
    """A retrieval evaluation split of synthetic clips: ``text`` (clip i's
    caption ``synthetic clip i``), and ``vid2txt`` / ``txt2vid``, each clip
    matching its own text (JAX ``cli/run_retrieval.py:31-40``)."""

    def __init__(self, length: int = 16, num_frames: int = 8,
                 size: int = 224):
        super().__init__(length=length, num_frames=num_frames, size=size)
        self.text = [f"synthetic clip {i}" for i in range(length)]
        self.vid2txt = {i: [i] for i in range(length)}
        self.txt2vid = {i: [i] for i in range(length)}
