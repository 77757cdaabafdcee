"""RecordIO files (counterpart of ``mxnet_tpu/recordio.py``).

The binary format is dmlc-core's: each part is the magic 0xced7230a, a
little-endian ``cflag:3 | length:29`` word, the payload and zero padding
to 4 bytes; a payload longer than the 29-bit length goes out as several
parts (cflag 1 first, 2 middle, 3 last). A ``.idx`` sidecar holds one
``key<TAB>offset`` line per record. Files written here are byte for byte
the JAX package's, and either package reads the other's.

``pack_img``/``unpack_img`` encode and decode through OpenCV (``cv2``),
imported when called; without it they raise. The port decodes images
on the card with nvJPEG instead (``io.ImageRecordIter``); an encoder of
its own waits for ROADMAP A5b.
"""
from __future__ import annotations

import numbers
import os
import struct
from collections import namedtuple

import numpy as _np

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_MAGIC = 0xced7230a
_MAGIC_BYTES = struct.pack("<I", _MAGIC)


def _encode_lrec(cflag, length):
    return (cflag << 29) | length


def _decode_lrec(rec):
    return rec >> 29, rec & ((1 << 29) - 1)


class MXRecordIO:
    """Sequential RecordIO reader (``flag="r"``) or writer (``"w"``)."""

    # the length field is 29 bits; a longer payload is split into parts
    _MAX_PART = (1 << 29) - 1

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.pid = None
        self.is_open = False
        self.open()

    def open(self):
        if self.flag == "w":
            self.fp = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.fp = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.pid = os.getpid()
        self.is_open = True

    def close(self):
        if not self.is_open:
            return
        self.fp.close()
        self.is_open = False
        self.pid = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __getstate__(self):
        """Pickled closed; the copy reopens (a DataLoader worker)."""
        is_open = self.is_open
        self.close()
        d = dict(self.__dict__)
        d["is_open"] = is_open
        d.pop("fp", None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.is_open = False
        if d["is_open"]:
            self.open()

    def _check_pid(self):
        # a forked child reopens, for a file offset of its own
        if self.pid != os.getpid():
            if self.is_open:
                self.close()
            self.open()

    def _write_part(self, cflag, part):
        self.fp.write(_MAGIC_BYTES)
        self.fp.write(struct.pack("<I", _encode_lrec(cflag, len(part))))
        self.fp.write(part)
        pad = (4 - len(part) % 4) % 4
        if pad:
            self.fp.write(b"\x00" * pad)

    def write(self, buf):
        assert self.writable
        self._check_pid()
        if len(buf) <= self._MAX_PART:
            self._write_part(0, buf)
            return
        view = memoryview(buf)
        n_parts = (len(buf) + self._MAX_PART - 1) // self._MAX_PART
        for i in range(n_parts):
            cflag = 1 if i == 0 else (3 if i == n_parts - 1 else 2)
            self._write_part(cflag,
                             view[i * self._MAX_PART:(i + 1) * self._MAX_PART])

    def _read_part(self):
        lrec, = struct.unpack("<I", self.fp.read(4))
        cflag, length = _decode_lrec(lrec)
        buf = self.fp.read(length)
        pad = (4 - length % 4) % 4
        if pad:
            self.fp.read(pad)
        return cflag, buf

    def read(self):
        """The next record's payload, or None at the end of the file."""
        assert not self.writable
        self._check_pid()
        magic = self.fp.read(4)
        if len(magic) < 4:
            return None
        if magic != _MAGIC_BYTES:
            raise IOError("Invalid RecordIO magic in %s" % self.uri)
        cflag, buf = self._read_part()
        if cflag == 0:
            return buf
        parts = [buf]
        while cflag in (1, 2):
            self.fp.read(4)
            cflag, part = self._read_part()
            parts.append(part)
        return b"".join(parts)

    def reset(self):
        self.close()
        self.open()

    def tell(self):
        return self.fp.tell()


class MXIndexedRecordIO(MXRecordIO):
    """RecordIO with a ``.idx`` sidecar for random access by key."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if not self.writable and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    if len(parts) < 2:
                        continue
                    key = self.key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)

    def close(self):
        if not self.is_open:
            return
        if self.writable:
            with open(self.idx_path, "w") as fout:
                for key in self.keys:
                    fout.write("%s\t%d\n" % (str(key), self.idx[key]))
        super().close()

    def seek(self, idx):
        assert not self.writable
        self._check_pid()
        self.fp.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        assert self.writable
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.idx[key] = pos
        self.keys.append(key)


IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """A header and raw bytes -> a record payload. A scalar label writes
    flag 0; an array label writes its length as the flag and its f32
    values after the header."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        head = struct.pack(_IR_FORMAT, 0, header.label, header.id,
                           header.id2)
    else:
        label = _np.asarray(header.label, dtype=_np.float32).reshape(-1)
        head = struct.pack(_IR_FORMAT, label.size, 0.0, header.id,
                           header.id2)
        head += label.tobytes()
    return head + s


def unpack(s):
    """A record payload -> (IRHeader, raw bytes)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = _np.frombuffer(s[:header.flag * 4], dtype=_np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def _cv2(what):
    try:
        import cv2
    except ImportError:
        raise MXNetError(
            "recordio.%s needs OpenCV (cv2), which is not installed; the "
            "port's own image encoder waits for ROADMAP A5b" % what) from None
    return cv2


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """A header and an HWC BGR image -> a record payload, encoded by cv2."""
    cv2 = _cv2("pack_img")
    if img_fmt in (".jpg", ".jpeg"):
        encode_params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    elif img_fmt == ".png":
        encode_params = [cv2.IMWRITE_PNG_COMPRESSION, quality]
    else:
        encode_params = None
    ret, buf = cv2.imencode(img_fmt, img, encode_params)
    if not ret:
        raise MXNetError("failed to encode image")
    return pack(header, buf.tobytes())


def unpack_img(s, iscolor=-1):
    """A record payload -> (IRHeader, the image decoded by cv2, HWC BGR)."""
    cv2 = _cv2("unpack_img")
    header, s = unpack(s)
    img = cv2.imdecode(_np.frombuffer(s, dtype=_np.uint8), iscolor)
    return header, img
