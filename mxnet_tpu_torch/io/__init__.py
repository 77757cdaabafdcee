"""Data iterators: ``DataDesc``, ``DataBatch``, ``DataIter``,
``NDArrayIter``, ``ResizeIter``, ``PrefetchingIter``, ``LibSVMIter``
(CSR batches), ``MNISTIter`` and ``ImageRecordIter`` (JPEG records
decoded and augmented on the card)."""
from .io import (DataBatch, DataDesc, DataIter, LibSVMIter,  # noqa: F401
                 NDArrayIter, PrefetchingIter, ResizeIter)
from .image_record_iter import ImageRecordIter  # noqa: F401


def MNISTIter(image="train-images-idx3-ubyte",
              label="train-labels-idx1-ubyte", batch_size=128, shuffle=True,
              flat=False, **kwargs):
    """The MNIST idx files (raw, or gzipped when the name ends in
    ``.gz``) as an ``NDArrayIter``: images scaled to [0, 1] in float32,
    ``(N, 1, H, W)`` or flat ``(N, H * W)``, labels as float32."""
    import gzip
    import struct
    import numpy as np

    def read_idx(path):
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rb") as f:
            magic = struct.unpack(">I", f.read(4))[0]
            ndim = magic & 0xFF
            dims = [struct.unpack(">I", f.read(4))[0] for _ in range(ndim)]
            dt = {8: np.uint8, 9: np.int8, 11: np.int16, 12: np.int32,
                  13: np.float32, 14: np.float64}[(magic >> 8) & 0xFF]
            return np.frombuffer(f.read(), dtype=dt).reshape(dims)

    imgs = read_idx(image).astype(np.float32) / 255.0
    labs = read_idx(label).astype(np.float32)
    if flat:
        imgs = imgs.reshape(imgs.shape[0], -1)
    else:
        imgs = imgs.reshape(imgs.shape[0], 1, imgs.shape[1], imgs.shape[2])
    return NDArrayIter(imgs, labs, batch_size=batch_size, shuffle=shuffle,
                       label_name="softmax_label")
