"""Gluon data API (`incubator_mxnet_tpu/gluon/data/`): datasets, samplers,
the DataLoader and `vision` (datasets read from local files, the
transforms). `RecordFileDataset` waits for the data layer (ROADMAP Queue
A 6d)."""
from .dataset import ArrayDataset, Dataset, SimpleDataset  # noqa: F401
from .sampler import (BatchSampler, RandomSampler, Sampler,  # noqa: F401
                      SequentialSampler)
from .dataloader import DataLoader  # noqa: F401
from . import vision  # noqa: F401
