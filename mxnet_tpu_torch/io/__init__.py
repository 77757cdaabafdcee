"""Data iterators: ``DataDesc``, ``DataBatch``, ``DataIter``,
``NDArrayIter``, ``ResizeIter``, ``PrefetchingIter`` and
``ImageRecordIter`` (JPEG records decoded and augmented on the card)."""
from .io import (DataBatch, DataDesc, DataIter, NDArrayIter,  # noqa: F401
                 PrefetchingIter, ResizeIter)
from .image_record_iter import ImageRecordIter  # noqa: F401
