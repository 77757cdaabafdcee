"""Vision datasets (counterpart of
``mxnet_tpu/gluon/data/vision/datasets.py``): MNIST, FashionMNIST,
CIFAR10, CIFAR100, ImageRecordDataset, ImageFolderDataset.

They read files already under ``root``, in the standard formats (the
idx-ubyte files, CIFAR's binary batches, im2rec's records, a folder a
class); nothing is downloaded, and a missing file raises. The arrays are
made as the JAX package makes them, on ``current_context()``: wrap the
construction in ``with mxnet_tpu_torch.cpu():`` to keep them on the
host. Images are decoded on the host by cv2 (HWC, RGB, uint8), which
these two datasets need; ``mx.image`` itself waits for ROADMAP A5b.
"""
from __future__ import annotations

import gzip
import os
import struct
import warnings

import numpy as _np

from ....base import MXNetError
from ....ndarray import ndarray as _nd
from ..dataset import Dataset, RecordFileDataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset"]


def _imdecode(buf, flag):
    """Image bytes -> an HWC uint8 NDArray, RGB (cv2's decode, as the JAX
    package's ``image.imdecode``)."""
    try:
        import cv2
    except ImportError:
        raise MXNetError("decoding an image on the host needs OpenCV (cv2); "
                         "the port's own mx.image waits for ROADMAP A5b") \
            from None
    img = cv2.imdecode(_np.frombuffer(bytes(buf), dtype="uint8"), flag)
    if img is None:
        raise MXNetError("imdecode failed")
    if img.ndim == 3 and img.shape[2] == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if img.ndim == 2:
        img = img[:, :, None]
    return _nd.array(img, dtype="uint8")


class _DownloadedDataset(Dataset):
    def __init__(self, root, transform):
        self._transform = transform
        self._data = None
        self._label = None
        root = os.path.expanduser(root)
        self._root = root
        if not os.path.isdir(root):
            os.makedirs(root, exist_ok=True)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


def _maybe_gzip(path):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


class MNIST(_DownloadedDataset):
    """MNIST from idx-ubyte files (gzipped or raw) under root."""

    _files = {True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
              False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")}

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _find(self, base):
        for cand in (base, base + ".gz"):
            p = os.path.join(self._root, cand)
            if os.path.exists(p):
                return p
        raise IOError("%s not found under %s (nothing is downloaded: place "
                      "the standard idx files there)" % (base, self._root))

    def _get_data(self):
        img_f, lab_f = self._files[self._train]
        with _maybe_gzip(self._find(lab_f)) as fin:
            struct.unpack(">II", fin.read(8))
            label = _np.frombuffer(fin.read(), dtype="uint8") \
                .astype(_np.int32)
        with _maybe_gzip(self._find(img_f)) as fin:
            _, n, rows, cols = struct.unpack(">IIII", fin.read(16))
            data = _np.frombuffer(fin.read(), dtype="uint8")
            data = data.reshape(n, rows, cols, 1)
        self._data = _nd.array(data, dtype="uint8")
        self._label = label


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR10 from the binary version (data_batch_*.bin) under root."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar10"),
                 train=True, transform=None):
        self._train = train
        self._archive_dir = "cifar-10-batches-bin"
        super().__init__(root, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            data = _np.frombuffer(fin.read(), dtype="uint8") \
                .reshape(-1, 3072 + 1)
        return data[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
            data[:, 0].astype(_np.int32)

    def _batch_files(self):
        if self._train:
            return ["data_batch_%d.bin" % i for i in range(1, 6)]
        return ["test_batch.bin"]

    def _get_data(self):
        roots = [self._root, os.path.join(self._root, self._archive_dir)]
        files = self._batch_files()
        for base in roots:
            if all(os.path.exists(os.path.join(base, f)) for f in files):
                data, label = zip(*[
                    self._read_batch(os.path.join(base, f)) for f in files])
                self._data = _nd.array(_np.concatenate(data),
                                       dtype="uint8")
                self._label = _np.concatenate(label)
                return
        raise IOError("CIFAR binary batches %s not found under %s (nothing "
                      "is downloaded: place the binary-version files there)"
                      % (files, roots))


class CIFAR100(CIFAR10):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"),
                 fine_label=False, train=True, transform=None):
        self._fine_label = fine_label
        super().__init__(root, train, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            data = _np.frombuffer(fin.read(), dtype="uint8") \
                .reshape(-1, 3072 + 2)
        return data[:, 2:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
            data[:, 0 + int(self._fine_label)].astype(_np.int32)

    def _batch_files(self):
        return ["train.bin"] if self._train else ["test.bin"]

    def _get_data(self):
        self._archive_dir = "cifar-100-binary"
        super()._get_data()


class ImageRecordDataset(RecordFileDataset):
    """Images and labels from a RecordIO file (im2rec's format)."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from .... import recordio
        header, img = recordio.unpack(super().__getitem__(idx))
        img = _imdecode(img, self._flag)
        label = header.label
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageFolderDataset(Dataset):
    """root/category/image.jpg layout; labels in sorted folder order."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                warnings.warn("Ignoring %s, which is not a directory." % path)
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                filepath = os.path.join(path, filename)
                ext = os.path.splitext(filename)[1]
                if ext.lower() not in self._exts:
                    warnings.warn(
                        "Ignoring %s of type %s. Only support %s"
                        % (filepath, ext, ", ".join(self._exts)))
                    continue
                self.items.append((filepath, label))

    def __getitem__(self, idx):
        with open(self.items[idx][0], "rb") as f:
            img = _imdecode(f.read(), self._flag)
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
