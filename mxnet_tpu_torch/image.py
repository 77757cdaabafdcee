"""The imperative image API (counterpart of ``mxnet_tpu/image.py``):
``imdecode``, ``imread``, ``imresize``, ``resize_short``, the crops,
``color_normalize``, ``random_size_crop``, the ``Augmenter`` classes and
``CreateAugmenter``, ``ImageIter``, the detection augmenters,
``CreateDetAugmenter`` and ``ImageDetIter``.

Images are HWC NDArrays; their device is the context the call runs in
(``ctx=``, else ``current_context()``), and the iterators' batches lie
where the iterator's context says. The random draws are the JAX
package's, in the same order, from Python's ``random`` (the crops, the
flips, the augmenters' order) and from the key chain (the colour
jitters' ``_image_random_*`` ops).

On the CPU an image decodes with cv2, as in the JAX package, and the
geometry runs as the JAX package's does, so the batches are bitwise its
batches for the same records and seeds. On a card there is no cv2: a
JPEG decodes through nvJPEG and the ``jpeg_color`` kernel (the record
pipeline's decode, :mod:`.kernels.nvjpeg`, whose pixels match
libjpeg-turbo's within the bound PERF.md states, not bitwise), and the
geometry runs on the card's tensors with the same draws. A resize to the
size the image already has is the identity there; any other resize, and
a grey decode, raise until ROADMAP A5b brings cv2's interpolation and
formats to the card.
"""
from __future__ import annotations

import math
import os
import random as _pyrandom

import numpy as _np
import torch

from .base import MXNetError
from .context import Context, current_context, resolve_device
from .ndarray import ndarray as _nd
from .ndarray.ndarray import NDArray

__all__ = ["imdecode", "imread", "imresize", "resize_short", "fixed_crop",
           "random_crop", "center_crop", "color_normalize",
           "random_size_crop", "Augmenter", "SequentialAug",
           "RandomOrderAug", "ResizeAug", "ForceResizeAug", "RandomCropAug",
           "RandomSizedCropAug", "CenterCropAug", "HorizontalFlipAug",
           "CastAug", "BrightnessJitterAug", "ContrastJitterAug",
           "SaturationJitterAug", "HueJitterAug", "ColorJitterAug",
           "LightingAug", "ColorNormalizeAug", "RandomGrayAug",
           "CreateAugmenter", "ImageIter",
           "DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
           "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
           "CreateDetAugmenter", "ImageDetIter"]


def _ctx(ctx):
    ctx = ctx or current_context()
    return ctx if isinstance(ctx, Context) else Context(
        "gpu" if resolve_device(ctx).type == "cuda" else "cpu")


def _like(t, src):
    """A tensor as an NDArray in ``src``'s context."""
    return NDArray(t, ctx=src.context)


class _CardDecoder:
    """nvJPEG decodes on the current stream of one card, one state kept
    for its owner's images; :meth:`close` waits for the stream first."""

    def __init__(self, device):
        from .kernels import nvjpeg
        self.device = device
        self._dec = nvjpeg.BatchDecoder()

    def decode(self, data, flag, to_rgb):
        from .kernels import nvjpeg
        if flag != 1:
            raise MXNetError("imdecode on the card: flag=%r (grey) waits for "
                             "ROADMAP A5b (decode on the CPU)" % (flag,))
        info = nvjpeg.image_info(data)
        buf, boff = self._dec.decode([data], [info], self.device)
        _ss, h, w = info
        bgr = buf[int(boff[0]):int(boff[0]) + 3 * h * w].view(h, w, 3)
        # a copy either way, so the decode's buffer may go
        return bgr.flip(-1) if to_rgb else bgr.clone()

    def close(self):
        if self._dec is not None:
            torch.cuda.current_stream(self.device).synchronize()
            self._dec.close()
            self._dec = None


def imdecode(buf, flag=1, to_rgb=True, out=None, ctx=None):
    """Decode an image byte buffer to an HWC uint8 NDArray in ``ctx``:
    cv2 on the CPU, nvJPEG on a card (JPEG, colour)."""
    ctx = _ctx(ctx)
    if isinstance(buf, NDArray):
        buf = buf.asnumpy().astype(_np.uint8)
    if ctx.device_type == "gpu":
        dec = _CardDecoder(resolve_device(ctx))
        try:
            return NDArray(dec.decode(bytes(buf), flag, to_rgb), ctx=ctx)
        finally:
            dec.close()
    import cv2
    img = cv2.imdecode(_np.frombuffer(bytes(buf), dtype=_np.uint8), flag)
    if img is None:
        raise MXNetError("imdecode failed")
    if to_rgb and img.ndim == 3 and img.shape[2] == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if img.ndim == 2:
        img = img[:, :, None]
    return _nd.array(img, ctx=ctx, dtype="uint8")


def imread(filename, flag=1, to_rgb=True, ctx=None):
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag, to_rgb, ctx=ctx)


def _interp_method(interp, sizes=()):
    if interp == 9 and sizes:  # auto: area for shrink, cubic for enlarge
        oh, ow, nh, nw = sizes
        return 3 if nh < oh and nw < ow else 2
    if interp == 10:
        return _pyrandom.randint(0, 4)
    return interp


def imresize(src, w, h, interp=1):
    """Resize to (w, h): the JAX package's ``_image_resize`` on the CPU;
    on a card only the identity (the same size), until ROADMAP A5b."""
    if src.data.device.type == "cuda":
        if (h, w) == tuple(src.shape[:2]):
            return src
        raise MXNetError(
            "imresize on the card: %s -> (%d, %d) needs cv2's interpolation, "
            "which waits for ROADMAP A5b (decode and resize on the CPU)"
            % (tuple(src.shape[:2]), h, w))
    return _nd.invoke("_image_resize", [src], {"size": (w, h),
                                               "interp": interp})


def resize_short(src, size, interp=2):
    """Resize so the shorter edge equals size, keeping aspect."""
    h, w = src.shape[0], src.shape[1]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h,
                    _interp_method(interp, (h, w, new_h, new_w)))


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    out = _nd.invoke("_image_crop", [src], {"x": x0, "y": y0, "width": w,
                                            "height": h})
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1],
                       _interp_method(interp, (h, w, size[1], size[0])))
    return out


def random_crop(src, size, interp=2):
    h, w = src.shape[0], src.shape[1]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = _pyrandom.randint(0, w - new_w)
    y0 = _pyrandom.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    h, w = src.shape[0], src.shape[1]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None):
    if mean is not None:
        src = src - (mean if isinstance(mean, NDArray) else _nd.array(
            _np.asarray(mean, _np.float32), ctx=src.context))
    if std is not None:
        src = src / (std if isinstance(std, NDArray) else _nd.array(
            _np.asarray(std, _np.float32), ctx=src.context))
    return src


def random_size_crop(src, size, area, ratio, interp=2):
    h, w = src.shape[0], src.shape[1]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = _pyrandom.uniform(area[0], area[1]) * src_area
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        new_ratio = math.exp(_pyrandom.uniform(*log_ratio))
        new_w = int(round(math.sqrt(target_area * new_ratio)))
        new_h = int(round(math.sqrt(target_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = _pyrandom.randint(0, w - new_w)
            y0 = _pyrandom.randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


# ---------------------------------------------------------------------------
# Augmenters
# ---------------------------------------------------------------------------

class Augmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json
        return json.dumps([type(self).__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class SequentialAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for aug in self.ts:
            src = aug(src)
        return src


class RandomOrderAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        ts = list(self.ts)
        _pyrandom.shuffle(ts)
        for aug in ts:
            src = aug(src)
        return src


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        sizes = (src.shape[0], src.shape[1], self.size[1], self.size[0])
        return imresize(src, *self.size,
                        interp=_interp_method(self.interp, sizes))


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=2):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size = size
        self.area = area
        self.ratio = ratio
        self.interp = interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _pyrandom.random() < self.p:
            return _nd.invoke("_image_flip_left_right", [src], {})
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


class _JitterAug(Augmenter):
    """One ``_image_random_*`` op with factors in ``[1 - v, 1 + v]``."""
    _op = None

    def __init__(self, value, **kwargs):
        super().__init__(**kwargs)
        self.value = value

    def __call__(self, src):
        return _nd.invoke(self._op, [src],
                          {"min_factor": max(0, 1 - self.value),
                           "max_factor": 1 + self.value})


class BrightnessJitterAug(_JitterAug):
    _op = "_image_random_brightness"

    def __init__(self, brightness):
        super().__init__(brightness, brightness=brightness)
        self.brightness = brightness


class ContrastJitterAug(_JitterAug):
    _op = "_image_random_contrast"

    def __init__(self, contrast):
        super().__init__(contrast, contrast=contrast)
        self.contrast = contrast


class SaturationJitterAug(_JitterAug):
    _op = "_image_random_saturation"

    def __init__(self, saturation):
        super().__init__(saturation, saturation=saturation)
        self.saturation = saturation


class HueJitterAug(_JitterAug):
    _op = "_image_random_hue"

    def __init__(self, hue):
        super().__init__(hue, hue=hue)
        self.hue = hue


class ColorJitterAug(RandomOrderAug):
    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


class LightingAug(Augmenter):
    def __init__(self, alphastd, eigval=None, eigvec=None):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd

    def __call__(self, src):
        return _nd.invoke("_image_random_lighting", [src],
                          {"alpha_std": self.alphastd})


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__()
        self.mean = mean
        self.std = std

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class RandomGrayAug(Augmenter):
    _MAT = _np.array([[0.21, 0.21, 0.21], [0.72, 0.72, 0.72],
                      [0.07, 0.07, 0.07]], dtype=_np.float32)

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _pyrandom.random() < self.p:
            mat = _nd.array(self._MAT, ctx=src.context)
            src = _nd.invoke("dot", [src.astype("float32"), mat], {})
        return src


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """The standard augmenter list, in the JAX package's order."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        if not rand_crop:
            raise ValueError("rand_resize needs rand_crop")
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3.0 / 4.0, 4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        auglist.append(LightingAug(pca_noise))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = _np.array([123.68, 116.28, 103.53])
    if std is True:
        std = _np.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter:
    """Image batches from an image list or a ``.rec`` file through the
    augmenters; batches lie in ``ctx`` (default ``current_context()``),
    where the images are decoded and augmented too."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 path_imgidx=None, shuffle=False, part_index=0, num_parts=1,
                 aug_list=None, imglist=None, data_name="data",
                 label_name="softmax_label", last_batch_handle="pad",
                 ctx=None, **kw):
        if not (path_imgrec or path_imglist or isinstance(imglist, list)):
            raise ValueError("ImageIter needs path_imgrec, path_imglist or "
                             "imglist")
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.data_name = data_name
        self.label_name = label_name
        self.ctx = _ctx(ctx)
        self._decoder = None
        self._shuffle = shuffle
        self.imgrec = None
        self.imglist = {}
        self.seq = []
        if path_imgrec:
            from . import recordio
            idx_path = path_imgidx or os.path.splitext(path_imgrec)[0] + ".idx"
            if os.path.isfile(idx_path):
                self.imgrec = recordio.MXIndexedRecordIO(
                    idx_path, path_imgrec, "r")
                self.seq = list(self.imgrec.keys)
            else:
                self.imgrec = recordio.MXRecordIO(path_imgrec, "r")
                self.seq = None
        elif path_imglist:
            with open(path_imglist) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    label = _np.array(parts[1:-1], dtype=_np.float32)
                    self.imglist[int(parts[0])] = (label, parts[-1])
                self.seq = list(self.imglist.keys())
            self.path_root = path_root
        else:
            for i, (label, fname) in enumerate(imglist):
                self.imglist[i] = (_np.asarray(label, dtype=_np.float32)
                                   .reshape(-1), fname)
            self.seq = list(self.imglist.keys())
            self.path_root = path_root
        if num_parts > 1 and self.seq is not None:
            n = len(self.seq) // num_parts
            self.seq = self.seq[part_index * n:(part_index + 1) * n]
        self.auglist = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape, **{k: v for k, v in kw.items()
                                           if k in CreateAugmenter.__code__
                                           .co_varnames})
        self.cur = 0
        self.reset()

    @property
    def provide_data(self):
        from .io.io import DataDesc
        return [DataDesc(self.data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        from .io.io import DataDesc
        shape = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        return [DataDesc(self.label_name, shape)]

    def reset(self):
        if self._shuffle and self.seq is not None:
            _pyrandom.shuffle(self.seq)
        if self.imgrec is not None and self.seq is None:
            self.imgrec.reset()
        self.cur = 0

    def close(self):
        """Free the card's decoder (its stream's work waited for)."""
        if self._decoder is not None:
            self._decoder.close()
            self._decoder = None

    def next_sample(self):
        from . import recordio
        if self.seq is not None:
            if self.cur >= len(self.seq):
                raise StopIteration
            idx = self.seq[self.cur]
            self.cur += 1
            if self.imgrec is not None:
                s = self.imgrec.read_idx(idx)
                header, img = recordio.unpack(s)
                return header.label, img
            label, fname = self.imglist[idx]
            with open(os.path.join(self.path_root, fname), "rb") as f:
                return label, f.read()
        s = self.imgrec.read()
        if s is None:
            raise StopIteration
        header, img = recordio.unpack(s)
        return header.label, img

    def _decode(self, s):
        """One record's image: cv2 on the CPU; on a card the iterator's
        own nvJPEG state, kept across images."""
        if self.ctx.device_type != "gpu":
            return imdecode(s, ctx=self.ctx)
        if self._decoder is None:
            self._decoder = _CardDecoder(resolve_device(self.ctx))
        return NDArray(self._decoder.decode(bytes(s), 1, True), ctx=self.ctx)

    def _batch_data(self):
        return torch.zeros((self.batch_size,) + self.data_shape,
                           dtype=torch.float32,
                           device=resolve_device(self.ctx))

    def next(self):
        from .io.io import DataBatch
        batch_data = self._batch_data()
        shape = (self.batch_size, self.label_width) if self.label_width > 1 \
            else (self.batch_size,)
        batch_label = _np.zeros(shape, dtype=_np.float32)
        i = 0
        try:
            while i < self.batch_size:
                label, s = self.next_sample()
                img = self._decode(s)
                for aug in self.auglist:
                    img = aug(img)
                batch_data[i] = img.data.permute(2, 0, 1)  # HWC -> CHW
                batch_label[i] = label if self.label_width > 1 else \
                    _np.asarray(label).reshape(-1)[0]
                i += 1
        except StopIteration:
            if i == 0:
                raise
        pad = self.batch_size - i
        return DataBatch(data=[NDArray(batch_data, ctx=self.ctx)],
                         label=[_nd.array(batch_label, ctx=self.ctx)],
                         pad=pad)

    def __next__(self):
        return self.next()

    def __iter__(self):
        return self


# ---------------------------------------------------------------------------
# Detection augmenters and ImageDetIter. Boxes are (N, 5+) rows [cls,
# xmin, ymin, xmax, ymax, ...] in [0, 1] units on the host (numpy); the
# image stays where it lies.
# ---------------------------------------------------------------------------

class DetAugmenter:
    """Detection augmenter: __call__(src_hwc, label) -> (src, label)."""

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """An image-only augmenter; boxes pass through."""

    def __init__(self, augmenter):
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    """One randomly chosen augmenter, or none with ``skip_prob``."""

    def __init__(self, aug_list, skip_prob=0.0):
        self.aug_list = list(aug_list)
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if not self.aug_list or _pyrandom.random() < self.skip_prob:
            return src, label
        return _pyrandom.choice(self.aug_list)(src, label)


class DetHorizontalFlipAug(DetAugmenter):
    """Mirror image and boxes with probability p."""

    def __init__(self, p):
        self.p = p

    def __call__(self, src, label):
        if _pyrandom.random() < self.p:
            src = _like(src.data.flip(1), src)
            label = label.copy()
            xmax = 1.0 - label[:, 1]
            label[:, 1] = 1.0 - label[:, 3]
            label[:, 3] = xmax
        return src, label


def _box_overlap_frac(boxes, rect):
    """Fraction of each box's area inside rect (x0, y0, x1, y1)."""
    ix0 = _np.maximum(boxes[:, 1], rect[0])
    iy0 = _np.maximum(boxes[:, 2], rect[1])
    ix1 = _np.minimum(boxes[:, 3], rect[2])
    iy1 = _np.minimum(boxes[:, 4], rect[3])
    inter = _np.maximum(ix1 - ix0, 0) * _np.maximum(iy1 - iy0, 0)
    area = ((boxes[:, 3] - boxes[:, 1])
            * (boxes[:, 4] - boxes[:, 2]))
    return _np.where(area > 0, inter / _np.maximum(area, 1e-12), 0.0)


class DetRandomCropAug(DetAugmenter):
    """Random crop constrained by object coverage: a proposal must cover
    at least ``min_object_covered`` of one box; boxes covered less than
    ``min_eject_coverage`` are dropped, the rest clipped."""

    def __init__(self, min_object_covered=0.1,
                 aspect_ratio_range=(0.75, 1.33), area_range=(0.05, 1.0),
                 min_eject_coverage=0.3, max_attempts=50):
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.min_eject_coverage = min_eject_coverage
        self.max_attempts = max_attempts

    def _propose(self):
        area = _pyrandom.uniform(*self.area_range)
        ratio = _pyrandom.uniform(*self.aspect_ratio_range)
        w = min(_np.sqrt(area * ratio), 1.0)
        h = min(area / max(w, 1e-12), 1.0)
        x0 = _pyrandom.uniform(0, 1 - w)
        y0 = _pyrandom.uniform(0, 1 - h)
        return (x0, y0, x0 + w, y0 + h)

    def __call__(self, src, label):
        for _ in range(self.max_attempts):
            rect = self._propose()
            cov = _box_overlap_frac(label, rect)
            if cov.size and cov.max() >= self.min_object_covered:
                keep = cov >= self.min_eject_coverage
                if not keep.any():
                    continue
                new = label[keep].copy()
                w = rect[2] - rect[0]
                h = rect[3] - rect[1]
                new[:, 1] = _np.clip((new[:, 1] - rect[0]) / w, 0, 1)
                new[:, 3] = _np.clip((new[:, 3] - rect[0]) / w, 0, 1)
                new[:, 2] = _np.clip((new[:, 2] - rect[1]) / h, 0, 1)
                new[:, 4] = _np.clip((new[:, 4] - rect[1]) / h, 0, 1)
                H, W = src.shape[:2]
                xs, ys = int(rect[0] * W), int(rect[1] * H)
                xe = max(int(rect[2] * W), xs + 1)
                ye = max(int(rect[3] * H), ys + 1)
                return _like(src.data[ys:ye, xs:xe].clone(), src), new
        return src, label


class DetRandomPadAug(DetAugmenter):
    """Random expand-and-pad: the image placed inside a larger canvas of
    ``pad_val``, the boxes shrunk to match."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), max_attempts=50,
                 pad_val=(127, 127, 127)):
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.pad_val = pad_val

    def __call__(self, src, label):
        t = src.data
        H, W = t.shape[:2]
        for _ in range(self.max_attempts):
            scale = _pyrandom.uniform(*self.area_range)
            ratio = _pyrandom.uniform(*self.aspect_ratio_range)
            if scale < 1.0:
                continue
            nw = int(W * _np.sqrt(scale * ratio))
            nh = int(H * _np.sqrt(scale / ratio))
            if nw < W or nh < H:
                continue
            x0 = _pyrandom.randint(0, nw - W)
            y0 = _pyrandom.randint(0, nh - H)
            fill = torch.from_numpy(_np.asarray(
                self.pad_val, _np.dtype(str(t.dtype).replace("torch.", ""))))
            canvas = torch.empty((nh, nw, t.shape[2]), dtype=t.dtype,
                                 device=t.device)
            canvas[:] = fill.to(t.device)
            canvas[y0:y0 + H, x0:x0 + W] = t
            new = label.copy()
            new[:, 1] = (new[:, 1] * W + x0) / nw
            new[:, 3] = (new[:, 3] * W + x0) / nw
            new[:, 2] = (new[:, 2] * H + y0) / nh
            new[:, 4] = (new[:, 4] * H + y0) / nh
            return _like(canvas, src), new
        return src, label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0, pca_noise=0,
                       hue=0, inter_method=2, min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), min_eject_coverage=0.3,
                       max_attempts=50, pad_val=(127, 127, 127)):
    """The standard detection pipeline, in the JAX package's order:
    resize, colour jitter (borrowed), random crop and pad with their
    probabilities, mirror, the force-resize to data_shape, cast, and the
    mean/std normalization (``mean=True`` is the scalar 1, as
    ``np.asarray(True, float32)`` makes it there)."""
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(ResizeAug(resize, inter_method)))
    if brightness or contrast or saturation:
        auglist.append(DetBorrowAug(
            ColorJitterAug(brightness, contrast, saturation)))
    if hue:
        auglist.append(DetBorrowAug(HueJitterAug(hue)))
    if pca_noise > 0:
        auglist.append(DetBorrowAug(LightingAug(pca_noise)))
    if rand_gray > 0:
        auglist.append(DetBorrowAug(RandomGrayAug(rand_gray)))
    if rand_crop > 0:
        crop = DetRandomCropAug(
            min_object_covered, aspect_ratio_range,
            (min(area_range[0], 1.0), min(area_range[1], 1.0)),
            min_eject_coverage, max_attempts)
        auglist.append(DetRandomSelectAug([crop], 1 - rand_crop))
    if rand_pad > 0:
        pad_aug = DetRandomPadAug(
            aspect_ratio_range, (max(area_range[0], 1.0), area_range[1]),
            max_attempts, pad_val)
        auglist.append(DetRandomSelectAug([pad_aug], 1 - rand_pad))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    auglist.append(DetBorrowAug(ForceResizeAug(
        (data_shape[2], data_shape[1]), inter_method)))
    auglist.append(DetBorrowAug(CastAug()))
    if mean is not None or std is not None:
        mean = _np.asarray(mean if mean is not None else [0, 0, 0],
                           _np.float32)
        std = _np.asarray(std if std is not None else [1, 1, 1], _np.float32)
        auglist.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter(ImageIter):
    """Detection batches: labels packed as [header_w, obj_w, (cls, xmin,
    ymin, xmax, ymax)...] in the records, emitted as (B, max_objects,
    obj_w) padded with -1."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root="", path_imgidx=None,
                 shuffle=False, part_index=0, num_parts=1, aug_list=None,
                 imglist=None, data_name="data", label_name="label",
                 last_batch_handle="pad", ctx=None, **kwargs):
        super().__init__(batch_size=batch_size, data_shape=data_shape,
                         label_width=1, path_imgrec=path_imgrec,
                         path_imglist=path_imglist, path_root=path_root,
                         path_imgidx=path_imgidx, shuffle=shuffle,
                         part_index=part_index, num_parts=num_parts,
                         aug_list=[], imglist=imglist, data_name=data_name,
                         label_name=label_name,
                         last_batch_handle=last_batch_handle, ctx=ctx)
        self.auglist = aug_list if aug_list is not None else \
            CreateDetAugmenter(data_shape, **kwargs)
        self.label_shape = self._estimate_label_shape()
        self._estimated_label_shape = self.label_shape

    @property
    def provide_label(self):
        from .io.io import DataDesc
        return [DataDesc(self.label_name,
                         (self.batch_size,) + self.label_shape)]

    def _parse_label(self, label):
        raw = _np.asarray(label, _np.float32).ravel()
        if raw.size < 7:
            raise MXNetError("detection label too short: %d" % raw.size)
        header_w = int(raw[0])
        obj_w = int(raw[1])
        if obj_w < 5 or (raw.size - header_w) % obj_w != 0:
            raise MXNetError(
                "label of size %d inconsistent with header %d / object "
                "width %d" % (raw.size, header_w, obj_w))
        out = raw[header_w:].reshape(-1, obj_w)
        valid = (out[:, 3] > out[:, 1]) & (out[:, 4] > out[:, 2])
        out = out[valid]
        if out.shape[0] < 1:
            raise MXNetError("sample with no valid boxes")
        return out

    def _estimate_label_shape(self):
        max_count, width = 0, 5
        self.reset()
        try:
            while True:
                label, _ = self.next_sample()
                try:
                    parsed = self._parse_label(label)
                except MXNetError:
                    continue  # next() skips the same bad samples
                max_count = max(max_count, parsed.shape[0])
                width = parsed.shape[1]
        except StopIteration:
            pass
        self.reset()
        return (max_count, width)

    def reshape(self, data_shape=None, label_shape=None):
        if data_shape is not None:
            self.data_shape = tuple(data_shape)
        if label_shape is not None:
            label_shape = tuple(label_shape)
            # fewer rows than the dataset's most objects would truncate
            # ground-truth boxes in next()
            max_count, width = getattr(self, "_estimated_label_shape",
                                       (0, 0))
            if label_shape[0] < max_count:
                raise MXNetError(
                    "label_shape rows %d < dataset max object count %d: "
                    "boxes would be truncated" % (label_shape[0],
                                                  max_count))
            if width and len(label_shape) > 1 and label_shape[1] != width:
                raise MXNetError(
                    "label_shape object width %d != dataset width %d"
                    % (label_shape[1], width))
            self.label_shape = label_shape

    def next(self):
        from .io.io import DataBatch
        batch_data = self._batch_data()
        batch_label = _np.full((self.batch_size,) + self.label_shape, -1.0,
                               dtype=_np.float32)
        i = 0
        try:
            while i < self.batch_size:
                label, s = self.next_sample()
                try:
                    boxes = self._parse_label(label)
                except MXNetError:
                    continue  # bad ground truth skipped before the decode
                img = self._decode(s)
                for aug in self.auglist:
                    img, boxes = aug(img, boxes)
                batch_data[i] = img.data.permute(2, 0, 1)
                n = min(boxes.shape[0], self.label_shape[0])
                batch_label[i, :n, :boxes.shape[1]] = boxes[:n]
                i += 1
        except StopIteration:
            if i == 0:
                raise
        return DataBatch(data=[NDArray(batch_data, ctx=self.ctx)],
                         label=[_nd.array(batch_label, ctx=self.ctx)],
                         pad=self.batch_size - i)
