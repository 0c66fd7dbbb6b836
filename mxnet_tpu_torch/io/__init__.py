"""``mx.io``: the data iterators (:mod:`.io`)."""
from .io import (  # noqa: F401
    DataDesc, DataBatch, DataIter, NDArrayIter, ResizeIter, PrefetchingIter,
    MXDataIter, ImageRecordIter, ImageDetRecordIter, DetRecordIter,
    MNISTIter, CSVIter, LibSVMIter,
)
