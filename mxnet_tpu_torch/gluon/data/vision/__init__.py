"""Vision datasets and transforms of the port."""
from . import transforms  # noqa: F401
from .datasets import (CIFAR10, CIFAR100, MNIST, FashionMNIST,  # noqa: F401
                       ImageFolderDataset, ImageRecordDataset)

__all__ = ["transforms", "MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageFolderDataset", "ImageRecordDataset"]
