"""DataLoader of the port: batches from worker processes, put on the
loader's device.

The port of ``paddle_tpu/io/dataloader.py``. ``num_workers > 0`` forks
worker processes (``io/worker.py``) that run ``dataset.__getitem__`` and
the collate function off the main process, shipping big arrays back
through ``/dev/shm``; at most ``prefetch_factor * num_workers`` index
batches are in flight and results come back in sampler order. A worker
that dies without reporting raises instead of hanging.

Where the JAX loader yields numpy, this one yields the batch's arrays
as port Tensors on the loader's device: ``places`` when given, else
the current device (``core.device``: the card unless
``set_device("cpu")``). float64 arrays take the default dtype, as
``to_tensor`` makes them. On the card each array is copied from pinned
memory without blocking, so fetching a batch never waits for the
device. A dataset must return host data (numpy, Python values, CPU
tensors) when it runs in workers.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..core.tensor import Tensor
from .sampler import BatchSampler

__all__ = ["DataLoader", "default_collate_fn"]


def default_collate_fn(batch):
    """Stack samples into batched numpy arrays, keeping the samples'
    structure (Tensors stack into a Tensor)."""
    sample = batch[0]
    if isinstance(sample, Tensor):
        return Tensor(torch.stack([s._t for s in batch]))
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (bool, int, float, np.number)):
        return np.asarray(batch)
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, dict):
        return {k: default_collate_fn([s[k] for s in batch])
                for k in sample}
    if isinstance(sample, (list, tuple)):
        transposed = list(zip(*batch))
        return type(sample)(default_collate_fn(list(t)) for t in transposed)
    return batch


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    if device.type == "cuda":
        if t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)
    return t.to(device)


def _place(obj, device):
    """Every array and tensor of a collated batch as a Tensor on
    ``device``; other values pass through."""
    from ..core.dtype import get_default_dtype
    from ..core.tensor import _numpy_to_torch
    if isinstance(obj, Tensor):
        return Tensor(_to_device(obj._t, device))
    if isinstance(obj, torch.Tensor):
        return Tensor(_to_device(obj, device))
    if isinstance(obj, np.ndarray) and obj.dtype.kind in "biufc" or (
            isinstance(obj, np.ndarray) and obj.dtype.name == "bfloat16"):
        t = _numpy_to_torch(obj)
        if obj.dtype == np.float64:
            t = t.to(get_default_dtype())
        return Tensor(_to_device(t, device))
    if isinstance(obj, dict):
        return {k: _place(v, device) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(_place(v, device) for v in obj)
    if isinstance(obj, list):
        return [_place(v, device) for v in obj]
    return obj


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        from ..core import device as device_mod
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = int(num_workers)
        self.prefetch_factor = max(prefetch_factor, 2)
        self.use_shared_memory = use_shared_memory
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.persistent_workers = persistent_workers
        if isinstance(places, (list, tuple)):
            places = places[0] if places else None
        self.device = device_mod._parse(places) if places is not None \
            else device_mod.current_device()
        from .dataset import IterableDataset
        self._iterable = isinstance(dataset, IterableDataset)
        if self._iterable:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable:
            raise TypeError("IterableDataset has no fixed length")
        return len(self.batch_sampler)

    def __iter__(self):
        for batch in self._batches():
            yield _place(batch, self.device)

    def _batches(self):
        """Collated host batches in order."""
        if self.num_workers > 0:
            yield from self._iter_multiprocess()
        elif self._iterable:
            batch = []
            for sample in self.dataset:
                batch.append(sample)
                if len(batch) == self.batch_size:
                    yield self.collate_fn(batch)
                    batch = []
            if batch and not self.drop_last:
                yield self.collate_fn(batch)
        else:
            for idx_batch in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in idx_batch])

    def _iter_multiprocess(self):
        import multiprocessing as mp
        import queue as queue_mod
        import shutil
        import tempfile

        from ..core import random as random_mod
        from .worker import _decode, _release_shm, _shm_ok, _worker_loop

        ctx = mp.get_context("fork")
        result_q = ctx.Queue()
        base_seed = int(torch.randint(
            0, 2 ** 31 - 1, (1,), generator=random_mod.generator_for("cpu")))
        workers, index_qs = [], []
        iterable = self._iterable
        # one /dev/shm directory a run: removed at teardown, so an early
        # exit or a worker killed mid-handoff leaks no tmpfs files
        shm_dir = None
        if self.use_shared_memory and _shm_ok():
            shm_dir = tempfile.mkdtemp(dir="/dev/shm", prefix="ptt_dl_")
        timeout = self.timeout if self.timeout and self.timeout > 0 \
            else None
        poll = min(timeout, 5.0) if timeout else 5.0
        ended = set()

        def get_result():
            waited = 0.0
            while True:
                try:
                    return result_q.get(timeout=poll)
                except queue_mod.Empty:
                    waited += poll
                    dead = [w.name for i, w in enumerate(workers)
                            if not w.is_alive() and i not in ended]
                    if dead:
                        raise RuntimeError(
                            f"DataLoader worker(s) {dead} died without "
                            f"reporting (killed? out of memory?): batches "
                            f"are lost") from None
                    if timeout and waited >= timeout:
                        raise RuntimeError(
                            f"DataLoader timed out after {timeout}s "
                            f"waiting for a worker batch") from None

        try:
            for wid in range(self.num_workers):
                iq = ctx.Queue()
                index_qs.append(iq)
                w = ctx.Process(
                    target=_worker_loop,
                    args=(self.dataset, self.collate_fn, iq, result_q, wid,
                          self.num_workers, base_seed, self.worker_init_fn,
                          shm_dir, iterable,
                          self.batch_size if iterable else 0,
                          self.drop_last if iterable else False),
                    daemon=True)
                w.start()
                workers.append(w)

            if iterable:
                for iq in index_qs:
                    for _ in range(self.prefetch_factor):
                        iq.put(True)
                live = self.num_workers
                while live:
                    msg = get_result()
                    if msg[0] == "end":
                        ended.add(msg[1])
                        live -= 1
                    elif msg[0] == "error":
                        raise RuntimeError(f"DataLoader worker {msg[1]} "
                                           f"failed:\n{msg[2]}")
                    else:
                        _, wid, payload = msg
                        index_qs[wid].put(True)  # return the token
                        yield _decode(payload)
                return

            sampler_it = enumerate(iter(self.batch_sampler))
            window = self.prefetch_factor * self.num_workers
            n_sent = 0
            exhausted = False
            owner = {}

            def send_next(wid):
                nonlocal n_sent, exhausted
                if exhausted:
                    return False
                try:
                    bidx, idx_batch = next(sampler_it)
                except StopIteration:
                    exhausted = True
                    for iq in index_qs:
                        iq.put(None)
                    return False
                index_qs[wid].put((bidx, list(idx_batch)))
                owner[bidx] = wid
                n_sent += 1
                return True

            for i in range(window):
                if not send_next(i % self.num_workers):
                    break
            buf, next_idx, received = {}, 0, 0
            live = self.num_workers
            while not exhausted or next_idx < n_sent:
                if next_idx in buf:
                    yield buf.pop(next_idx)
                    next_idx += 1
                    continue
                if received >= n_sent and exhausted:
                    break
                msg = get_result()
                if msg[0] == "end":
                    ended.add(msg[1])
                    live -= 1
                    if live == 0 and (not exhausted or received < n_sent):
                        raise RuntimeError("DataLoader workers exited "
                                           "before producing all batches")
                    continue
                if msg[0] == "error":
                    raise RuntimeError(f"DataLoader worker {msg[1]} "
                                       f"failed:\n{msg[2]}")
                bidx, data = msg
                received += 1
                buf[bidx] = _decode(data)
                send_next(owner.pop(bidx))
        finally:
            for w in workers:
                if w.is_alive():
                    w.terminate()
            for w in workers:
                w.join(timeout=5)
            while True:
                try:
                    msg = result_q.get_nowait()
                except Exception:
                    break
                if msg and msg[0] not in ("end", "error"):
                    _release_shm(msg[-1])
            if shm_dir is not None:
                shutil.rmtree(shm_dir, ignore_errors=True)
