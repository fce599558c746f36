"""Batches of a dataset in ``ShardedLoader``'s order, decoded by a pool
of workers ahead of the consumer.

Counterpart of ``youku_mplug_tpu/data/loader.py``: the epoch's order
is ``np.random.default_rng(seed * 100_003 + epoch).permutation(n)``, or
the dataset's own with ``shuffle=False``, the same on every rank; a
loader given ``shard_index`` / ``shard_count`` (``ShardedLoader``'s
process index and count, which JAX reads from jax: here the runner
passes the rank's data coordinate, so the ranks of one model group read
the same batches) wrap-pads that order to a multiple of the count and
takes every ``shard_count``-th index from ``shard_index`` on (the
DistributedSampler contract: every shard yields as many batches); the
last partial batch is
dropped (kept with ``drop_last=False``, as the evaluations read every
sample).  A loader given ``block_index`` / ``block_count`` (training
under a data split: the rank's data coordinate and the data degree)
yields only its contiguous block of each of those batches, rows
``[i * B / D, (i + 1) * B / D)`` (JAX's ``put_batch`` placement), so the
blocks of step k together are the unsplit run's batch k and a rank
decodes its own rows alone; with ``micro_count`` U > 1 (the step's
``update_freq``) the rank takes its block of each of the batch's U
micro-batches (rows ``[u * B / U, (u + 1) * B / U)``, JAX's split),
in order, so that its u-th micro-batch is its block of the unsplit
step's u-th.  Samples are collated the same way (arrays
stacked, ints to int32, floats to float32, anything else kept as a list).

``num_workers=0`` makes each batch in the consumer's thread when it asks
for it.  ``num_workers >= 1`` runs JAX's pipeline: a producer thread
submits each batch's samples to a pool of ``num_workers`` decode threads
(cv2's decode and resize release the GIL), or with
``workers_impl="process"`` of worker processes, two batches ahead of the
one it collates, and puts collated batches on a queue of ``prefetch``.
The batches are the same either way: every random draw of a sample comes
from the sample's own generator.  A consumer that stops early stops the
producer and waits for it and its pool; an error in a worker is raised in
the consumer.

The worker processes are spawned, each given the dataset once (pickled,
as it stands after ``set_epoch``), where JAX forks them: a fork of a
process that runs threads (the producer, the consumer's CUDA or JAX
threads) can leave a child on a lock no thread of its own will release,
and such a child hangs the pool's shutdown (seen in the CPU tests under
pytest-xdist).  A spawned worker starts from a fresh interpreter and
imports the dataset's modules (about a second).

``MetaLoader`` interleaves several loaders in a seeded order (JAX's
``MetaLoader``), yielding (loader index, batch).  ``LengthBalancedLoader``
(JAX's) orders an epoch by ``length_balanced_shard_indices``: buckets of
similar ``get_item_length``, dealt so each step sees every bucket.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Sequence

import numpy as np

_AHEAD = 2  # batches submitted beyond the one being collated
_worker_dataset = None  # a worker process's copy of the dataset


def _init_worker(dataset):
    global _worker_dataset
    _worker_dataset = dataset


def _fetch(index: int):
    return _worker_dataset[index]


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


class _Failed:
    """A worker's exception, carried through the queue to the consumer."""

    def __init__(self, error: BaseException):
        self.error = error


class Loader:
    def __init__(self, dataset, batch_size: int, *, seed: int = 0,
                 shuffle: bool = True, drop_last: bool = True,
                 num_workers: int = 0, prefetch: int = 4,
                 workers_impl: str = "thread", shard_index: int = 0,
                 shard_count: int = 1, block_index: int = 0,
                 block_count: int = 1, micro_count: int = 1):
        if workers_impl not in ("thread", "process"):
            raise ValueError(f"workers_impl must be 'thread' or 'process', "
                             f"got {workers_impl!r}")
        if not 0 <= shard_index < shard_count:
            raise ValueError(f"shard {shard_index} of {shard_count}")
        self.shard_index, self.shard_count = shard_index, shard_count
        if not 0 <= block_index < block_count or micro_count < 1 \
                or batch_size % (block_count * micro_count):
            raise ValueError(f"block {block_index} of {block_count} of "
                             f"{micro_count} micro-batches of a batch of "
                             f"{batch_size}")
        self.block_index, self.block_count = block_index, block_count
        self.micro_count = micro_count
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.workers_impl = workers_impl
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self):
        n = -(-len(self.dataset) // self.shard_count)  # this shard's
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def shard_indices(self) -> np.ndarray:
        """This epoch's dataset indices of this shard, in order (JAX's
        ``_shard_indices``)."""
        n, count = len(self.dataset), self.shard_count
        order = (np.random.default_rng(self.seed * 100_003 + self.epoch)
                 .permutation(n) if self.shuffle else np.arange(n))
        total = -(-n // count) * count
        if total > n:  # wrap: every shard the same length
            order = np.concatenate([order, order[:total - n]])
        return order[self.shard_index::count]

    def batch_indices(self) -> List[np.ndarray]:
        """This epoch's batches of dataset indices, in order."""
        order = self.shard_indices()
        return [np.concatenate([
            np.array_split(micro, self.block_count)[self.block_index]
            for micro in np.array_split(
                order[i * self.batch_size:(i + 1) * self.batch_size],
                self.micro_count)]) for i in range(len(self))]

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if self.num_workers <= 0:
            for idx in self.batch_indices():
                yield collate([self.dataset[int(j)] for j in idx])
            return
        yield from self._pipelined(self.batch_indices())

    def _pool(self):
        """-> (the worker pool, a function submitting one index)."""
        if self.workers_impl == "process":
            pool = ProcessPoolExecutor(
                self.num_workers, mp_context=mp.get_context("spawn"),
                initializer=_init_worker, initargs=(self.dataset,))
            return pool, lambda i: pool.submit(_fetch, i)
        pool = ThreadPoolExecutor(self.num_workers)
        return pool, lambda i: pool.submit(self.dataset.__getitem__, i)

    def _pipelined(self, batches) -> Iterator[Dict[str, Any]]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def produce():
            pool, submit = self._pool()
            try:
                pending = []
                for idx in batches:
                    pending.append([submit(int(i)) for i in idx])
                    while len(pending) > _AHEAD:
                        if stop.is_set() or not put(collate(
                                [f.result() for f in pending.pop(0)])):
                            return
                for futs in pending:
                    if stop.is_set() or not put(collate(
                            [f.result() for f in futs])):
                        return
                put(None)
            except BaseException as e:  # raised again in the consumer
                put(_Failed(e))
            finally:
                pool.shutdown(wait=True, cancel_futures=True)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, _Failed):
                    raise item.error
                yield item
        finally:
            stop.set()
            thread.join()


def length_balanced_shard_indices(lengths, epoch: int, rank: int,
                                  world: int, num_bucket: int = 20,
                                  seed: int = 0) -> np.ndarray:
    """Length-bucketed balanced sharding (JAX ``loader.py:206-228``):
    sort by length into ``num_bucket`` buckets (a seeded subset of the
    rows, so that they divide evenly), shuffle within the buckets each
    epoch, and deal them so that every rank sees each bucket every
    ``num_bucket`` rows; rank ``rank`` of ``world`` gets its share in a
    shuffled order."""
    lengths = np.asarray(lengths)
    order = np.argsort(lengths, kind="stable")
    per_bucket = len(order) // num_bucket
    samples = per_bucket // world
    total = samples * world * num_bucket
    g = np.random.default_rng(seed + 810975)
    keep = np.sort(g.choice(len(order), total, replace=False))
    order = order[keep]

    g2 = np.random.default_rng(seed + epoch)
    grid = order.reshape(num_bucket, samples * world).T  # [L, B]
    grid = grid[g2.permutation(grid.shape[0])]
    grid = grid.reshape(world, samples, num_bucket)
    mine = grid[rank].reshape(-1)
    return mine[g2.permutation(len(mine))]


class LengthBalancedLoader(Loader):
    """``Loader`` whose epoch order is ``length_balanced_shard_indices``
    (rank ``shard_index`` of ``shard_count``); the dataset must expose
    ``get_item_length(i)``.  JAX's ``LengthBalancedLoader`` at the same
    process index and count gives the same batches."""

    def __init__(self, dataset, batch_size, *, num_bucket: int = 20, **kw):
        super().__init__(dataset, batch_size, **kw)
        self.num_bucket = num_bucket
        self._lengths = [dataset.get_item_length(i)
                         for i in range(len(dataset))]

    def __len__(self):
        samples = len(self.dataset) // self.num_bucket // self.shard_count
        n = samples * self.num_bucket
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def shard_indices(self) -> np.ndarray:
        return length_balanced_shard_indices(
            self._lengths, self.epoch, self.shard_index, self.shard_count,
            num_bucket=self.num_bucket, seed=self.seed)


class MetaLoader:
    """Several loaders interleaved: each epoch takes every batch of every
    loader, in the order ``default_rng(seed * 7_919 + epoch)`` permutes
    the loaders' indices (each repeated ``len(loader)`` times)."""

    def __init__(self, loaders: Sequence[Loader], seed: int = 0):
        self.loaders = list(loaders)
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        for ld in self.loaders:
            ld.set_epoch(epoch)

    def __len__(self):
        return sum(len(ld) for ld in self.loaders)

    def __iter__(self):
        order = []
        for i, ld in enumerate(self.loaders):
            order += [i] * len(ld)
        order = np.random.default_rng(
            self.seed * 7_919 + self.epoch).permutation(order)
        its = [iter(ld) for ld in self.loaders]
        try:
            for src in order:
                yield int(src), next(its[src])
        finally:
            for it in its:
                it.close()
