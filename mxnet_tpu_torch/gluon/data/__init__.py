"""Gluon's data API of the port: datasets, samplers, the DataLoader and
the vision datasets and transforms."""
from . import vision  # noqa: F401
from .dataloader import DataLoader  # noqa: F401
from .dataset import ArrayDataset, Dataset, SimpleDataset  # noqa: F401
from .sampler import (BatchSampler, RandomSampler, Sampler,  # noqa: F401
                      SequentialSampler)

__all__ = ["Dataset", "ArrayDataset", "SimpleDataset", "Sampler",
           "SequentialSampler", "RandomSampler", "BatchSampler",
           "DataLoader", "vision"]
