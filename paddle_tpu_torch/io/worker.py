"""DataLoader worker processes and their shared-memory transport.

The port of ``paddle_tpu/io/worker.py``: workers are forked CPU
processes that run ``dataset.__getitem__`` and the collate function
(numpy and file IO: device state stays in the parent); arrays of 16 KiB
and more travel through ``/dev/shm`` memmap files instead of the queue
pipe, and the parent reads and unlinks each file, so a segment lives
for one batch. Each worker seeds numpy, ``random`` and the port's
generator from the loader's base seed plus its id; the base seed is
drawn from the port's generator (``core.random``), so ``paddle.seed``
makes the workers' draws repeatable.
"""
from __future__ import annotations

import os
import random
import tempfile

import numpy as np

__all__ = ["WorkerInfo", "get_worker_info"]

_SHM_DIR = "/dev/shm"
_SHM_MIN_BYTES = 16 * 1024  # below this, pipe pickling is cheaper


class WorkerInfo:
    """The calling worker's id, worker count, seed and dataset (None in
    the main process)."""

    def __init__(self, id, num_workers, seed, dataset):
        self.id = id
        self.num_workers = num_workers
        self.seed = seed
        self.dataset = dataset

    def __repr__(self):
        return (f"WorkerInfo(id={self.id}, num_workers={self.num_workers},"
                f" seed={self.seed})")


_worker_info = None


def get_worker_info():
    """The current worker's :class:`WorkerInfo` inside a DataLoader
    worker, None in the main process (an IterableDataset shards itself
    with its ``id`` / ``num_workers``)."""
    return _worker_info


def _shm_ok():
    return os.name == "posix" and os.path.isdir(_SHM_DIR)


def _encode(obj, use_shm):
    """Structure-preserving encode for the result queue: big arrays ->
    /dev/shm memmap descriptors, Tensors and torch tensors -> tagged
    arrays (the parent puts every array on the loader's device).
    ``use_shm`` is the run's segment directory, or None."""
    import torch
    from ..core.tensor import Tensor
    if isinstance(obj, Tensor):
        obj = obj._t
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.float()
        return ("__tensor__", name, _encode(t.numpy(), use_shm))
    if isinstance(obj, np.ndarray):
        if use_shm and obj.nbytes >= _SHM_MIN_BYTES:
            fd, path = tempfile.mkstemp(dir=use_shm, prefix="ptt_dl_")
            os.close(fd)
            mm = np.memmap(path, dtype=obj.dtype, mode="w+",
                           shape=obj.shape if obj.shape else (1,))
            mm[...] = obj if obj.shape else obj.reshape(1)
            mm.flush()
            del mm
            return ("__shm__", path, str(obj.dtype), obj.shape)
        return obj
    if isinstance(obj, dict):
        return {k: _encode(v, use_shm) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(_encode(v, use_shm) for v in obj)
    if isinstance(obj, list):
        return ["__list__"] + [_encode(v, use_shm) for v in obj]
    return obj


def _tag(obj):
    return obj[0] if (isinstance(obj, tuple) and obj
                      and isinstance(obj[0], str)) else None


def _decode(obj):
    """The inverse of :func:`_encode` (a tagged tensor comes back as a
    CPU torch tensor of its dtype)."""
    tag = _tag(obj)
    if tag == "__tensor__":
        import torch
        t = torch.from_numpy(np.ascontiguousarray(_decode(obj[2])))
        return t.to(getattr(torch, obj[1]))
    if tag == "__shm__":
        _, path, dtype, shape = obj
        mm = np.memmap(path, dtype=np.dtype(dtype), mode="r",
                       shape=shape if shape else (1,))
        arr = np.array(mm)  # own the data before the file goes away
        del mm
        try:
            os.unlink(path)
        except OSError:
            pass
        return arr if shape else arr.reshape(())
    if isinstance(obj, dict):
        return {k: _decode(v) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(_decode(v) for v in obj)
    if isinstance(obj, list) and obj and isinstance(obj[0], str) and \
            obj[0] == "__list__":
        return [_decode(v) for v in obj[1:]]
    return obj


def _release_shm(obj):
    """Unlink every /dev/shm segment of a message that was never
    decoded (early exit, errors)."""
    tag = _tag(obj)
    if tag == "__shm__":
        try:
            os.unlink(obj[1])
        except OSError:
            pass
        return
    if tag == "__tensor__":
        _release_shm(obj[2])
        return
    if isinstance(obj, dict):
        for v in obj.values():
            _release_shm(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _release_shm(v)


def _seed_worker(worker_id, base_seed):
    from ..core import random as random_mod
    seed = (base_seed + worker_id) % (2 ** 31)
    np.random.seed(seed)
    random.seed(seed)
    random_mod.seed(seed)
    return seed


def _worker_loop(dataset, collate_fn, index_queue, result_queue, worker_id,
                 num_workers, base_seed, worker_init_fn, use_shm,
                 iterable, batch_size, drop_last):
    """Consume index batches and post collated results until the None
    sentinel; an IterableDataset worker iterates its own (by
    :func:`get_worker_info`) stream, one flow-control token per batch."""
    global _worker_info
    seed = _seed_worker(worker_id, base_seed)
    _worker_info = WorkerInfo(worker_id, num_workers, seed, dataset)
    try:
        if worker_init_fn is not None:
            worker_init_fn(worker_id)
        if iterable:
            batch = []
            for sample in dataset:
                batch.append(sample)
                if len(batch) == batch_size:
                    index_queue.get()
                    result_queue.put(
                        ("data", worker_id,
                         _encode(collate_fn(batch), use_shm)))
                    batch = []
            if batch and not drop_last:
                index_queue.get()
                result_queue.put(
                    ("data", worker_id,
                     _encode(collate_fn(batch), use_shm)))
        else:
            while True:
                item = index_queue.get()
                if item is None:
                    break
                bidx, idxs = item
                data = collate_fn([dataset[i] for i in idxs])
                result_queue.put((bidx, _encode(data, use_shm)))
    except KeyboardInterrupt:
        pass
    except Exception:  # the traceback goes to the parent, which raises
        import traceback
        result_queue.put(("error", worker_id, traceback.format_exc()))
    finally:
        result_queue.put(("end", worker_id))
