"""JPEG decode on the card through nvJPEG (``csrc/nvjpeg_decode.cu``),
finished by the ``jpeg_color`` kernel.

No TPU kernel stands behind it: the JAX package decodes with cv2 on the
host. The port reads each JPEG's header on the host (:func:`image_info`,
for the crop draws, which depend on the image's size), has nvJPEG decode
it on the card to its planes (Y, Cb, Cr as stored), and turns those into
cv2's layout, ``(h, w, 3)`` uint8 B, G, R rows, with libjpeg-turbo's
chroma upsampling and colour conversion
(:mod:`~mxnet_tpu_torch.kernels.jpeg_color`): :class:`BatchDecoder`,
one batched nvJPEG call and one ``jpeg_color`` launch a batch.
nvJPEG's inverse DCT is not libjpeg's ``ISLOW``, so its pixels differ
from cv2's by a few levels (PERF.md states the bound measured on the
fixture of ``tests/data/jpeg_fixture``).

There is no CPU form: a record that nvJPEG cannot read (PNG, CMYK, a
corrupt stream), a grey JPEG, or one whose subsampling the port does
not finish (4:4:0, 4:1:1, 4:1:0) raises ``MXNetError`` naming the
record; nothing falls back to cv2. ``decodes`` counts the images nvJPEG
decoded.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as _np
import torch

from ..base import MXNetError
from . import _build
from . import jpeg_color

__all__ = ["image_info", "BatchDecoder", "allocations", "decodes",
           "reset_decodes"]

# nvjpegChromaSubsampling_t -> the subsampling names of jpeg_color.MODES
_SUBSAMPLING = {0: "444", 1: "422", 2: "420", 3: "440", 4: "411", 5: "410",
                6: "gray", 7: "410V", -1: "unknown"}

decodes = 0
_count_lock = threading.Lock()

_P = ctypes.c_void_p
_SIGNATURES = {
    "mxj_image_info": (ctypes.c_int, (
        ctypes.c_char_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_int))),
    "mxj_state_create": (ctypes.c_int, (ctypes.POINTER(_P),)),
    "mxj_state_destroy": (ctypes.c_int, (_P,)),
    "mxj_decode_batch": (ctypes.c_int, (
        _P, ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(_P),
        ctypes.POINTER(ctypes.c_int), _P)),
    "mxj_counts": (None, (ctypes.POINTER(ctypes.c_longlong),)),
    "mxj_status_string": (ctypes.c_char_p, (ctypes.c_int,)),
}


def reset_decodes():
    global decodes
    with _count_lock:
        decodes = 0


def _lib():
    return _build.load("nvjpeg_decode", _SIGNATURES)


def _what(record):
    return "" if record is None else " (record %d)" % record


def image_info(data, record=None):
    """The header of JPEG ``data`` -> (subsampling, height, width), the
    subsampling one of ``jpeg_color.MODES``. Raises ``MXNetError`` when
    nvJPEG cannot read it or the port does not finish its layout."""
    lib = _lib()
    info = (ctypes.c_int * 10)()
    rc = lib.mxj_image_info(bytes(data), len(data), info)
    if rc != 0:
        raise MXNetError(
            "nvJPEG cannot read the image%s: %s; PNG and other formats on "
            "the card wait for ROADMAP A5b" % (
                _what(record), lib.mxj_status_string(rc).decode()))
    n, ss, w, h = info[0], _SUBSAMPLING.get(info[1], str(info[1])), \
        info[2], info[6]
    if (n, ss) not in ((3, "444"), (3, "422"), (3, "420")):
        raise MXNetError("JPEG%s with %d components and %s subsampling is "
                         "not decoded on the card; ROADMAP A5b"
                         % (_what(record), n, ss))
    want = jpeg_color.chroma_shape(h, w, jpeg_color.MODES[ss])
    got = [(info[6 + c], info[2 + c]) for c in (1, 2)]
    if any(g != want for g in got):
        raise MXNetError("JPEG%s: chroma planes %s for a %dx%d %s image, "
                         "not libjpeg's %s; ROADMAP A5b"
                         % (_what(record), got, h, w, ss, want))
    return ss, h, w


def allocations():
    """The binding's allocator calls so far: device allocations, device
    frees, pinned blocks made, pinned blocks handed out again."""
    out = (ctypes.c_longlong * 4)()
    _lib().mxj_counts(out)
    return list(out)


class BatchDecoder:
    """One batched-decode state of the binding, for one pipeline: its
    decodes run one at a time (from any thread) on the caller's stream.
    :meth:`close` frees it; the caller first makes sure the work of its
    last decode has run (the state's buffers go back to the allocator)."""

    def __init__(self):
        self._lib = _lib()
        state = _P()
        rc = self._lib.mxj_state_create(ctypes.byref(state))
        if rc != 0:
            raise MXNetError("nvJPEG: no decode state: %s"
                             % self._lib.mxj_status_string(rc).decode())
        self._state = state

    def decode(self, datas, infos, device, records=None):
        """Decode JPEGs ``datas`` (with their :func:`image_info`) on the
        current stream of ``device``: one batched nvJPEG call for all of
        them, then one ``jpeg_color`` launch. -> (one uint8 buffer
        holding every image's planes and then its B, G, R pixels, the
        byte offset of each image's ``(h, w, 3)`` pixels in it). The
        buffer must be kept until whatever reads the pixels has run."""
        global decodes
        n = len(datas)
        if n == 0:
            raise MXNetError("nvjpeg: no images to decode")
        if device.type != "cuda":
            raise MXNetError("nvjpeg: the decode runs on a card, not %s (the "
                             "CPU path decodes with cv2)" % device)
        if self._state is None:
            raise MXNetError("nvjpeg: the decoder is closed")
        mode = _np.array([jpeg_color.MODES[ss] for ss, _h, _w in infos])
        h = _np.array([i[1] for i in infos], _np.int64)
        w = _np.array([i[2] for i in infos], _np.int64)
        ch = _np.where(mode == 3, (h + 1) // 2, h)
        cw = _np.where(mode >= 2, (w + 1) // 2, w)
        plane = h * w + 2 * ch * cw
        poff = _np.concatenate([[0], _np.cumsum(plane)[:-1]])
        boff = plane.sum() + _np.concatenate([[0],
                                              _np.cumsum(3 * h * w)[:-1]])
        buf = torch.empty(int(plane.sum() + (3 * h * w).sum()),
                          dtype=torch.uint8, device=device)
        base = buf.data_ptr()
        y = base + poff
        cb = y + h * w
        cr = cb + ch * cw
        planes = _np.stack([y, cb, cr], 1).reshape(-1)
        pitch = _np.stack([w, cw, cw], 1).reshape(-1)
        with torch.cuda.device(device):
            rc = self._lib.mxj_decode_batch(
                self._state, n, (ctypes.c_char_p * n)(*datas),
                (ctypes.c_longlong * n)(*[len(d) for d in datas]),
                (_P * (3 * n))(*planes.tolist()),
                (ctypes.c_int * (3 * n))(*pitch.tolist()),
                torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise MXNetError(
                "nvJPEG failed to decode a batch of records %s: %s"
                % (list(records if records is not None else range(n)),
                   self._lib.mxj_status_string(rc).decode()))
        with _count_lock:
            decodes += n
        jpeg_color._launch_table(
            jpeg_color.descriptors(y, cb, cr, base + boff, h, w, mode), device)
        return buf, boff

    def close(self):
        if self._state is not None:
            self._lib.mxj_state_destroy(self._state)
            self._state = None

