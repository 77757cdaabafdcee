"""Data iterators: ``DataDesc``, ``DataBatch``, ``DataIter`` and
``NDArrayIter``."""
from .io import DataBatch, DataDesc, DataIter, NDArrayIter  # noqa: F401
