"""Single-process batch loader in ``ShardedLoader``'s order.

Counterpart of ``youku_mplug_tpu.data.loader.ShardedLoader`` on one host
(which there reads the process index from jax), with the options the
training and evaluation loops use: the epoch's order is
``np.random.default_rng(seed * 100_003 + epoch).permutation(n)``, or
the dataset's own with ``shuffle=False``; the
last partial batch is dropped (kept with ``drop_last=False``, as the
evaluations read every sample), and samples are collated the same way
(arrays stacked, ints to int32, floats to float32, anything else kept
as a list).  No worker threads: the host makes each batch between two
train steps.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List

import numpy as np


def collate(samples: List[dict]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(vals[0], (int, np.integer)):
            out[key] = np.asarray(vals, np.int32)
        elif isinstance(vals[0], float):
            out[key] = np.asarray(vals, np.float32)
        else:
            out[key] = vals
    return out


class Loader:
    def __init__(self, dataset, batch_size: int, *, seed: int = 0,
                 shuffle: bool = True, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        n = len(self.dataset)
        order = (np.random.default_rng(self.seed * 100_003 + self.epoch)
                 .permutation(n) if self.shuffle else np.arange(n))
        for i in range(len(self)):
            idx = order[i * self.batch_size:(i + 1) * self.batch_size]
            yield collate([self.dataset[int(j)] for j in idx])
