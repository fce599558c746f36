"""The port's multi-process pieces against the JAX package's
(``tests/test_multihost.py``): the loader's per-rank shard, and the host
merges of ``cli/common.py``.

- ``Loader(shard_index=i, shard_count=n)`` yields JAX's
  ``ShardedLoader(process_index=i, process_count=n)`` batches bitwise
  (shuffled or not, every epoch, drop_last or not), and
  ``LengthBalancedLoader`` JAX's at the same index and count; JAX's
  contracts hold on the port's shards: disjoint and covering, the same
  number of batches on every rank, one global permutation across ranks;
- ``gather_eval_rows``, ``sum_across_hosts`` and ``collect_records`` over
  two gloo processes (``tests/torch_mesh_worker.py``) give the JAX
  two-process tests' results on both ranks, and JAX's single-process
  results without a process group.
"""

import json
import os
import sys

import numpy as np
import pytest

from youku_mplug_tpu.data.loader import LengthBalancedLoader as JLB
from youku_mplug_tpu.data.loader import ShardedLoader
from youku_mplug_tpu_torch.cli.common import (
    collect_records,
    gather_eval_rows,
    sum_across_hosts,
)
from youku_mplug_tpu_torch.data.loader import LengthBalancedLoader, Loader

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_serve_mesh as serve_mesh  # noqa: E402


class _IdxDataset:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"idx": i}

    def get_item_length(self, i):
        return (i * 7919) % 97


def _port_batches(n_items, batch, world, epoch=0, shuffle=True,
                  drop_last=True, seed=7):
    per_rank = []
    for rank in range(world):
        loader = Loader(_IdxDataset(n_items), batch, seed=seed,
                        shuffle=shuffle, drop_last=drop_last,
                        shard_index=rank, shard_count=world)
        loader.set_epoch(epoch)
        per_rank.append([b["idx"] for b in loader])
    return per_rank


@pytest.mark.parametrize("world,n_items,batch", [(4, 64, 4), (3, 50, 4),
                                                 (2, 7, 2), (1, 10, 3)])
@pytest.mark.parametrize("shuffle,drop_last,epoch", [
    (True, True, 0), (True, False, 1), (False, True, 0), (False, False, 2)])
def test_loader_shards_equal_jax_sharded_loader(world, n_items, batch,
                                                shuffle, drop_last, epoch):
    got = _port_batches(n_items, batch, world, epoch, shuffle, drop_last)
    for rank in range(world):
        j = ShardedLoader(_IdxDataset(n_items), batch, shuffle=shuffle,
                          seed=7, drop_last=drop_last, num_workers=1,
                          process_index=rank, process_count=world)
        j.set_epoch(epoch)
        want = [b["idx"] for b in j]
        assert len(got[rank]) == len(want) == len(j) == len(
            Loader(_IdxDataset(n_items), batch, drop_last=drop_last,
                   shard_index=rank, shard_count=world))
        for g, w in zip(got[rank], want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("world,rank", [(1, 0), (2, 1), (4, 3)])
def test_length_balanced_shards_equal_jax(world, rank):
    ds = _IdxDataset(200)
    port = LengthBalancedLoader(ds, 4, num_bucket=5, seed=3,
                                shard_index=rank, shard_count=world)
    jax_ = JLB(ds, 4, num_bucket=5, seed=3, num_workers=1,
               process_index=rank, process_count=world)
    for epoch in (0, 1):
        port.set_epoch(epoch)
        jax_.set_epoch(epoch)
        want = [b["idx"] for b in jax_]
        got = [b["idx"] for b in port]
        assert len(got) == len(want) == len(port) == len(jax_)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("world,n_items,batch", [(4, 64, 4), (3, 50, 4)])
def test_loader_shards_disjoint_and_covering(world, n_items, batch):
    per_rank = _port_batches(n_items, batch, world)
    assert len({len(b) for b in per_rank}) == 1  # no rank waits on another
    seen = [int(i) for rank in per_rank for b in rank for i in b.ravel()]
    uniq, cnt = np.unique(seen, return_counts=True)
    n_pad = ((n_items + world - 1) // world) * world - n_items
    assert (cnt > 1).sum() <= n_pad + world * batch
    assert len(uniq) >= n_items - world * batch
    e1 = _port_batches(n_items, batch, world, epoch=1)
    assert not all(np.array_equal(a, b)
                   for ra, rb in zip(per_rank, e1) for a, b in zip(ra, rb))


def test_loader_same_seed_same_order_across_ranks():
    world, n = 4, 32
    shards = [np.concatenate(b) for b in _port_batches(n, 8, world,
                                                       seed=3)]
    interleaved = np.stack(shards, axis=1).ravel()  # undo order[rank::n]
    np.testing.assert_array_equal(
        interleaved, np.random.default_rng(3 * 100_003).permutation(n))


def test_host_merges_single_process_as_jax():
    rows = np.arange(8, dtype=np.float32).reshape(4, 2)
    merged, idx = gather_eval_rows(rows, np.array([2, 0, 1, 0]))
    np.testing.assert_array_equal(idx, [0, 1, 2])
    np.testing.assert_array_equal(merged[0], rows[1])  # first occurrence
    np.testing.assert_array_equal(merged[2], rows[0])
    recs = [{"video_id": "a", "pred": "x"}, {"video_id": "b", "pred": "y"},
            {"video_id": "a", "pred": "z"}]
    got = collect_records(recs, dedup_key="video_id")
    assert [r["video_id"] for r in got] == ["a", "b"]
    assert got[0]["pred"] == "x"
    np.testing.assert_array_equal(sum_across_hosts(np.array([1.0, 2.0])),
                                  [1.0, 2.0])


@pytest.fixture(scope="module")
def merges(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("merges"))
    serve_mesh.spawn("merges", 2, d, {}, deadline=120)
    out = {}
    for r in range(2):
        with open(os.path.join(d, f"merges_rank{r}.json")) as f:
            out[r] = json.load(f)
    return out


@pytest.mark.parametrize("rank", [0, 1])
def test_host_merges_over_two_processes_as_jax(merges, rank):
    got = merges[rank]
    assert got["coord"] == [rank, 0]
    assert sorted(r["video_id"] for r in got["records"]) == \
        ["v0", "v1", "v2", "v3"]
    caps = {r["video_id"]: r["cap"] for r in got["records"]}
    assert caps["v0"] == "你好" and caps["v3"] == "世界"
    np.testing.assert_allclose(got["sum"], [3.0, 20.0])
    assert got["order"] == list(range(6))
    np.testing.assert_array_equal(np.asarray(got["rows"])[:, 0],
                                  np.arange(6))
    assert got["shard"] == list(range(rank, 16, 2))  # JAX's per-process
    assert got == merges[0] | {"coord": got["coord"],
                               "shard": got["shard"]}  # the same merge
