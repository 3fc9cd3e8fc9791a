"""Datasets (the JAX package's ``io/dataset.py``; ref
``python/paddle/io/dataloader/dataset.py``)."""

from __future__ import annotations

import bisect
from typing import List, Sequence


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
    def __init__(self, tensors: Sequence):
        assert all(t.shape[0] == tensors[0].shape[0] for t in tensors)
        self.tensors = list(tensors)

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets: List[Dataset]):
        self.datasets = list(datasets)
        assert all(len(d) == len(self.datasets[0]) for d in self.datasets)

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            out.extend(sample if isinstance(sample, (list, tuple)) else [sample])
        return tuple(out)


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = []
        total = 0
        for d in self.datasets:
            total += len(d)
            self.cumulative_sizes.append(total)

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = self.cumulative_sizes[ds_idx - 1] if ds_idx > 0 else 0
        return self.datasets[ds_idx][idx - prev]


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Split ``dataset`` into non-overlapping ``Subset``s of ``lengths``
    (fractions that sum to 1 are allowed) over a random permutation drawn
    from ``generator`` (a ``torch.Generator``; default the CPU's default
    generator, seeded by ``paddle.seed``).  The JAX package draws the
    permutation from its PRNG key, so the two packages split differently
    from the same seed."""
    import torch

    from ..core import random as core_random
    if sum(lengths) != len(dataset):
        # fraction support
        if all(0 < l < 1 for l in lengths):
            n = len(dataset)
            lengths = [int(l * n) for l in lengths]
            lengths[-1] = n - sum(lengths[:-1])
        else:
            raise ValueError("sum of lengths must equal dataset size")
    gen = generator if generator is not None else \
        core_random.default_generator("cpu")
    perm = torch.randperm(len(dataset), generator=gen).tolist()
    out, offset = [], 0
    for l in lengths:
        out.append(Subset(dataset, perm[offset:offset + l]))
        offset += l
    return out
