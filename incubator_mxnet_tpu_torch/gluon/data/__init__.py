"""Gluon data API (`incubator_mxnet_tpu/gluon/data/`): datasets, samplers
and the DataLoader. `RecordFileDataset` and `vision` wait for the data
layer (ROADMAP Queue A 6)."""
from .dataset import ArrayDataset, Dataset, SimpleDataset  # noqa: F401
from .sampler import (BatchSampler, RandomSampler, Sampler,  # noqa: F401
                      SequentialSampler)
from .dataloader import DataLoader  # noqa: F401
