"""Datasets of the port (``paddle_tpu/io/dataset.py``).

``random_split`` draws its permutation from the port's generator
(``core.random``), so ``paddle.seed`` makes it repeatable; the split
differs from the JAX package's (a JAX key is not a torch generator),
its lengths do not.
"""
from __future__ import annotations

import bisect

import numpy as np
import torch

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            if isinstance(sample, (list, tuple)):
                out.extend(sample)
            else:
                out.append(sample)
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum(
            [len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx = len(self) + idx
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = 0 if ds_idx == 0 else self.cumulative_sizes[ds_idx - 1]
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Split ``dataset`` into Subsets of ``lengths`` (counts, or
    fractions whose last part takes the remainder) over one random
    permutation from ``generator`` (a ``torch.Generator``), else the
    port's generator."""
    from ..core import random as random_mod
    n = len(dataset)
    if all(isinstance(v, float) for v in lengths):
        lengths = [int(np.floor(n * v)) for v in lengths]
        lengths[-1] = n - sum(lengths[:-1])
    if sum(lengths) != n:
        raise ValueError("sum of lengths must equal dataset size")
    g = generator if generator is not None \
        else random_mod.generator_for("cpu")
    perm = torch.randperm(n, generator=g).tolist()
    out, off = [], 0
    for length in lengths:
        out.append(Subset(dataset, perm[off:off + length]))
        off += length
    return out
