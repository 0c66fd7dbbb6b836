"""Gluon's data API of the port: datasets, samplers, the DataLoader and
the vision datasets and transforms."""
from . import vision  # noqa: F401
from .dataloader import DataLoader  # noqa: F401
from .dataset import (ArrayDataset, Dataset, RecordFileDataset,  # noqa: F401
                      SimpleDataset)
from .sampler import (BatchSampler, RandomSampler, Sampler,  # noqa: F401
                      SequentialSampler)

__all__ = ["Dataset", "ArrayDataset", "SimpleDataset", "RecordFileDataset",
           "Sampler",
           "SequentialSampler", "RandomSampler", "BatchSampler",
           "DataLoader", "vision"]
