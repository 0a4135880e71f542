"""The port's ``paddle.io`` against the JAX package's, on the CPU.

Datasets, samplers (``DistributedBatchSampler`` with its replicas and
rank given), ``default_collate_fn`` and ``random_split``'s lengths
against the JAX package's; ``DataLoader`` batches with two worker
processes (the ``/dev/shm`` transport) equal to those with none and to
the JAX loader's (``shuffle=False``), in order, as Tensors on the
loader's device; a worker's error raises in the parent; the workers'
seeds and ``random_split`` draw from the port's generator.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.core import random as trandom
from test_torch_tensor import port_on_cpu  # noqa: F401

jio, tio = jpaddle.io, tpaddle.io


class _Seq:
    """A map-style dataset of both packages' base class: (a row of
    floats, a big row for the shm path, an int label, a dict)."""

    def __init__(self, base, n=23):
        rng = np.random.default_rng(1)
        self.x = rng.standard_normal((n, 3)).astype(np.float32)
        self.big = rng.standard_normal((n, 5000)).astype(np.float32)
        self.base = base
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.x[i], self.big[i], int(i), {"k": np.float32(i) / 2}


def _dataset(pkg):
    class D(_Seq, pkg.io.Dataset):
        def __init__(self):
            _Seq.__init__(self, pkg)
    return D()


def _np(batch):
    """A batch of either package as numpy, structure kept."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(_np(b) for b in batch)
    if isinstance(batch, dict):
        return {k: _np(v) for k, v in batch.items()}
    if isinstance(batch, tpaddle.Tensor):
        return batch.numpy()
    return np.asarray(batch)


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("batch_size,drop_last", [(4, False), (5, True)])
def test_loader_workers_match_no_workers_and_jax(batch_size, drop_last):
    kw = dict(batch_size=batch_size, drop_last=drop_last)
    got2 = list(tio.DataLoader(_dataset(tpaddle), num_workers=2, **kw))
    got0 = list(tio.DataLoader(_dataset(tpaddle), num_workers=0, **kw))
    want = list(jio.DataLoader(_dataset(jpaddle), num_workers=0, **kw))
    assert len(got2) == len(got0) == len(want) == \
        len(tio.DataLoader(_dataset(tpaddle), **kw))
    for a, b, c in zip(got2, got0, want):
        assert isinstance(a[0], tpaddle.Tensor)
        assert a[0].place == tpaddle.CPUPlace()
        _same(_np(a), _np(b))
        _same(_np(a), _np(c))


def test_loader_puts_batches_on_the_named_place():
    b = next(iter(tio.DataLoader(_dataset(tpaddle), batch_size=2,
                                 places=tpaddle.CPUPlace())))
    assert all(isinstance(t, tpaddle.Tensor) for t in b[:3])
    assert b[1]._t.dtype == torch.float32 and b[2]._t.dtype == torch.int64


class _Stream:
    def __init__(self, pkg, n=10):
        self.pkg, self.n = pkg, n

    def __iter__(self):
        info = self.pkg.io.get_worker_info()
        wid, nw = (0, 1) if info is None else (info.id, info.num_workers)
        for i in range(wid, self.n, nw):
            yield np.float32([i, i * i])


def test_iterable_dataset_shards_over_workers():
    class S(_Stream, tio.IterableDataset):
        def __init__(self):
            _Stream.__init__(self, tpaddle)
    rows = sorted(float(r[0]) for b in tio.DataLoader(S(), batch_size=2,
                                                      num_workers=2)
                  for r in b.numpy())
    assert rows == [float(i) for i in range(10)]
    one = [b.numpy() for b in tio.DataLoader(S(), batch_size=3)]
    assert [len(b) for b in one] == [3, 3, 3, 1]


def test_worker_error_raises_in_the_parent():
    class Bad(tio.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise ValueError("bad sample")
            return np.float32([i])
    with pytest.raises(RuntimeError, match="bad sample"):
        list(tio.DataLoader(Bad(), batch_size=1, num_workers=2))


def test_worker_seeds_draw_from_the_port_generator():
    class Seeds(tio.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            return np.int64([tio.get_worker_info().seed])

    def seeds():
        return sorted({int(v) for b in tio.DataLoader(
            Seeds(), batch_size=1, num_workers=2)
            for v in b.numpy().reshape(-1)})
    tpaddle.seed(9)
    d0 = trandom.draws()
    a = seeds()
    assert trandom.draws() == d0 + 1
    tpaddle.seed(9)
    assert seeds() == a and len(a) == 2


def test_collate_matches_jax():
    samples = [(np.float32([i, i + 1]), i, 0.5 * i, "s",
                {"a": np.int64(i), "b": [np.float32(i)]}) for i in range(3)]
    got = tio.default_collate_fn(samples)
    want = jio.default_collate_fn(samples)
    _same(got[:3] + (got[4],), want[:3] + (want[4],))
    assert got[3] == want[3] == ["s"] * 3
    t = tio.default_collate_fn([tpaddle.to_tensor([1.0, 2.0])] * 2)
    assert isinstance(t, tpaddle.Tensor) and t.shape == [2, 2]


def test_datasets_match_jax():
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    y = np.arange(6)
    td = [tio.TensorDataset([x, y]), jio.TensorDataset([x, y])]
    assert len(td[0]) == len(td[1]) == 6
    _same(td[0][4], td[1][4])
    cd = [io.ComposeDataset([t, t]) for io, t in ((tio, td[0]),
                                                   (jio, td[1]))]
    _same(cd[0][2], cd[1][2])
    cc = [io.ConcatDataset([t, t]) for io, t in ((tio, td[0]),
                                                 (jio, td[1]))]
    assert len(cc[0]) == len(cc[1]) == 12
    for i in (0, 5, 6, 11, -1):
        _same(cc[0][i], cc[1][i])
    sub = [io.Subset(t, [5, 0, 3]) for io, t in ((tio, td[0]),
                                                 (jio, td[1]))]
    assert sub[0][0][1] == 5 and len(sub[0]) == 3
    _same(sub[0][1], sub[1][1])
    ch = tio.ChainDataset([[1, 2], [3]])
    # iterated, not list(): len() of an IterableDataset raises
    assert [v for v in ch] == [v for v in jio.ChainDataset([[1, 2], [3]])]


@pytest.mark.parametrize("lengths", [[3, 7, 13], [0.5, 0.25, 0.25]])
def test_random_split_lengths_match_jax(lengths):
    ds = _dataset(tpaddle)
    tpaddle.seed(4)
    d0 = trandom.draws()
    parts = tio.random_split(ds, lengths)
    assert trandom.draws() == d0 + 1
    want = jio.random_split(_dataset(jpaddle), lengths)
    assert [len(p) for p in parts] == [len(p) for p in want]
    idx = sorted(i for p in parts for i in p.indices)
    assert idx == list(range(len(ds)))
    tpaddle.seed(4)
    again = tio.random_split(ds, lengths)
    assert [p.indices for p in again] == [p.indices for p in parts]
    with pytest.raises(ValueError):
        tio.random_split(ds, [1, 2])


def test_samplers_match_jax():
    ds = list(range(11))
    assert list(tio.SequenceSampler(ds)) == list(jio.SequenceSampler(ds))
    r = list(tio.RandomSampler(ds))
    assert sorted(r) == ds and len(tio.RandomSampler(ds)) == 11
    rr = list(tio.RandomSampler(ds, replacement=True, num_samples=20))
    assert len(rr) == 20 and set(rr) <= set(ds)
    sub = list(tio.SubsetRandomSampler([3, 5, 9]))
    assert sorted(sub) == [3, 5, 9]
    w = list(tio.WeightedRandomSampler([0.0, 1.0, 0.0], 5))
    assert w == [1] * 5
    for kw in (dict(batch_size=3), dict(batch_size=3, drop_last=True)):
        got = list(tio.BatchSampler(ds, **kw))
        want = list(jio.BatchSampler(ds, **kw))
        assert got == want
        assert len(tio.BatchSampler(ds, **kw)) == len(want)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_distributed_batch_sampler_matches_jax(shuffle, drop_last):
    ds = list(range(11))
    for rank in range(3):
        kw = dict(batch_size=2, num_replicas=3, rank=rank, shuffle=shuffle,
                  drop_last=drop_last)
        t, j = tio.DistributedBatchSampler(ds, **kw), \
            jio.DistributedBatchSampler(ds, **kw)
        for epoch in (0, 1):
            t.set_epoch(epoch)
            j.set_epoch(epoch)
            assert list(t) == list(j)
        assert len(t) == len(j)
    assert list(tio.DistributedBatchSampler(ds, 4)) == \
        list(tio.BatchSampler(ds, batch_size=4))
    with pytest.raises(ValueError):
        tio.DistributedBatchSampler(ds, 2, num_replicas=2, rank=2)
