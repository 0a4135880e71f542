"""The port's ``paddle.io``: datasets, samplers and the DataLoader (the
counterpart of ``paddle_tpu.io``, pure Python and numpy apart from the
last step, which puts each batch on the loader's device)."""
from .dataset import (  # noqa: F401
    Dataset, IterableDataset, TensorDataset, ComposeDataset, ChainDataset,
    ConcatDataset, Subset, random_split,
)
from .sampler import (  # noqa: F401
    Sampler, SequenceSampler, RandomSampler, SubsetRandomSampler,
    WeightedRandomSampler, BatchSampler, DistributedBatchSampler,
)
from .dataloader import DataLoader, default_collate_fn  # noqa: F401
from .worker import WorkerInfo, get_worker_info  # noqa: F401
