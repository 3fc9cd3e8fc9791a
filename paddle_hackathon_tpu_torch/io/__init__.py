"""paddle.io (the JAX package's ``io/``): Dataset, Sampler, DataLoader.

Ref ``python/paddle/io/`` + ``fluid/reader.py:275`` (DataLoader).  Batches
are assembled on the host by worker threads (or processes) and copied to
the current place; with the native runtime built, the buffered iterator
stages them through the native ring's page-locked slots
(``core/native.py``, ``native/runtime.cc``).
"""

from .dataset import (ChainDataset, ComposeDataset, ConcatDataset, Dataset,  # noqa: F401
                      IterableDataset, Subset, TensorDataset, random_split)
from .sampler import (BatchSampler, DistributedBatchSampler, RandomSampler,  # noqa: F401
                      Sampler, SequenceSampler, SubsetRandomSampler,
                      WeightedRandomSampler)
from .dataloader import (DataLoader, default_collate_fn, device_prefetch,  # noqa: F401
                         get_worker_info)
from .transfer import TransferRing, finish_d2h, start_d2h  # noqa: F401
