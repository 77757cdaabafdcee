"""ImageRecordIter: threaded JPEG decode + augment + prefetch over a
RecordIO file (counterpart of ``mxnet_tpu/io/image_record_iter.py``).

The surface, the defaults, the epoch order (``shuffle``, ``round_batch``,
``num_parts``/``part_index``) and the draws are the JAX package's: each
batch splits into P = ``preprocess_threads`` parts, and part p draws its
crops and mirrors, image after image, from ``RandomState(seed +
epoch * 1000003 + batch * 1009 + p)``. A feeder thread schedules the
parts of each batch on a ``ThreadPoolExecutor`` of P threads and puts
the finished batch into a bounded
:class:`~mxnet_tpu_torch.data.pipeline.PrefetchQueue`. (The JAX
package's native engine, record scanner and storage pool, built from
``src/``, wait for ROADMAP A5b; records are read through the ``.idx``.)

Where the batch goes decides how it is made. ``ctx`` defaults to
``gpu(0)``, by the port's rule; on a card each part thread reads its
records, reads each JPEG's size from its header and draws the crop and
mirror from it; the feeder then decodes the batch's JPEGs with one
batched nvJPEG call and one ``jpeg_color`` launch
(:mod:`~mxnet_tpu_torch.kernels.nvjpeg`), and one launch of the augment
kernel (:mod:`~mxnet_tpu_torch.kernels.image_aug`) writes the batch in
``dtype``, all on one high-priority stream, while the part threads read
the next batch. (Decoding each part on a stream of its own, image by
image, put some five small copies and kernels an image between the
training step's kernels and slowed the step by a fifth on an H100.)
The batch carries an event; ``next()`` makes the caller's current
stream wait for it. Only the JPEG bytes, the descriptor tables and the
labels cross to the card. There is no cv2 on that path: ``resize``,
the upscale of images smaller than ``data_shape`` and grey or PNG
records raise there, naming ROADMAP A5b.

With ``ctx=cpu()`` the batch is made as the JAX package makes it: cv2
decodes, and :func:`_build_augmenter` (resize -> pad -> upscale -> crop
-> mirror -> BGR->RGB -> normalize -> CHW) transforms, in numpy; the
batches are bitwise the JAX package's.
"""
from __future__ import annotations

import os
import threading

import numpy as _np
import torch

from .. import recordio as _rio
from ..base import MXNetError, normalize_dtype
from ..context import Context, gpu, resolve_device
from .io import DataBatch, DataDesc

__all__ = ["ImageRecordIter"]


def _build_augmenter(data_shape, resize=-1, rand_crop=False,
                     rand_mirror=False, mirror=False, mean_r=0.0, mean_g=0.0,
                     mean_b=0.0, std_r=1.0, std_g=1.0, std_b=1.0, scale=1.0,
                     pad=0, fill_value=255, inter_method=1):
    """numpy/cv2 sample transform: HWC BGR uint8 -> CHW float32 RGB, the
    JAX package's (short-side resize, border pad, upscale of small
    inputs, random or centre crop, mirror, per-channel mean/std, scale).
    The CPU path's transform, and the plain version the card's augment
    kernel is held against where no resize is asked."""
    import cv2
    _, th, tw = data_shape
    mean = _np.array([mean_r, mean_g, mean_b], _np.float32)
    std = _np.array([std_r, std_g, std_b], _np.float32)
    do_norm = (mean != 0).any() or (std != 1).any() or scale != 1.0

    def aug(img, rng):
        h, w = img.shape[:2]
        if resize > 0:
            if h < w:
                nh, nw = resize, max(1, w * resize // h)
            else:
                nh, nw = max(1, h * resize // w), resize
            if (nh, nw) != (h, w):
                img = cv2.resize(img, (nw, nh), interpolation=inter_method)
                h, w = nh, nw
        if pad > 0:
            img = cv2.copyMakeBorder(img, pad, pad, pad, pad,
                                     cv2.BORDER_CONSTANT,
                                     value=[fill_value] * 3)
            h, w = img.shape[:2]
        if h < th or w < tw:
            img = cv2.resize(img, (max(tw, w), max(th, h)),
                             interpolation=inter_method)
            h, w = img.shape[:2]
        if rand_crop:
            y0 = rng.randint(0, h - th + 1)
            x0 = rng.randint(0, w - tw + 1)
        else:
            y0, x0 = (h - th) // 2, (w - tw) // 2
        img = img[y0:y0 + th, x0:x0 + tw]
        if (rand_mirror and rng.rand() < 0.5) or mirror:
            img = img[:, ::-1]
        out = img[:, :, ::-1].astype(_np.float32)  # BGR -> RGB
        if do_norm:
            out = (out - mean) / std * scale
        return out.transpose(2, 0, 1)  # HWC -> CHW

    return aug


class _CardAugment:
    """The augment parameters on the card, and the draws: the same draws,
    in the same order, as :func:`_build_augmenter`'s for an image of the
    same size (no resize; the upscale refused)."""

    def __init__(self, data_shape, resize=-1, rand_crop=False,
                 rand_mirror=False, mirror=False, mean_r=0.0, mean_g=0.0,
                 mean_b=0.0, std_r=1.0, std_g=1.0, std_b=1.0, scale=1.0,
                 pad=0, fill_value=255, inter_method=1):
        if resize > 0:
            raise MXNetError("ImageRecordIter on the card: resize=%r needs "
                             "cv2's INTER_LINEAR, which waits for ROADMAP A5b "
                             "(use ctx=cpu())" % (resize,))
        _, self.th, self.tw = data_shape
        self.rand_crop, self.rand_mirror = bool(rand_crop), bool(rand_mirror)
        self.mirror = bool(mirror)
        self.mean = (mean_r, mean_g, mean_b)
        self.std = (std_r, std_g, std_b)
        self.scale = scale
        self.pad = int(pad)
        self.fill = int(fill_value)

    def draw(self, rng, h, w, record):
        """(y0, x0, mirror) in the padded image of an h x w JPEG."""
        h, w = h + 2 * self.pad, w + 2 * self.pad
        th, tw = self.th, self.tw
        if h < th or w < tw:
            raise MXNetError(
                "ImageRecordIter on the card: record %d is %dx%d (padded), "
                "smaller than the %dx%d crop; the upscale needs cv2's "
                "INTER_LINEAR, which waits for ROADMAP A5b (use ctx=cpu())"
                % (record, h, w, th, tw))
        if self.rand_crop:
            y0 = rng.randint(0, h - th + 1)
            x0 = rng.randint(0, w - tw + 1)
        else:
            y0, x0 = (h - th) // 2, (w - tw) // 2
        flip = (self.rand_mirror and rng.rand() < 0.5) or self.mirror
        return y0, x0, bool(flip)


class _Part:
    """One part of a batch read on a part thread: its JPEGs, their
    header sizes, their crops and their labels."""

    __slots__ = ("jpegs", "infos", "crops", "labels", "records")

    def __init__(self, jpegs, infos, crops, labels, records):
        self.jpegs, self.infos, self.crops = jpegs, infos, crops
        self.labels, self.records = labels, records


class _CardBatcher:
    """Make batches on the card: :meth:`parse_part` on the part threads,
    :meth:`assemble` on the feeder; shared by :class:`ImageRecordIter`
    and the streaming tier's ``ImageDecoder``."""

    def __init__(self, device, data_shape, dtype, label_width, aug_params):
        self.device = device
        self.data_shape = tuple(data_shape)
        self.dtype = dtype
        self.label_width = label_width
        self.aug = _CardAugment(self.data_shape, **aug_params)
        self._stream = None
        self._decoder = None

    def parse_part(self, payloads, records, rng):
        """Records' payloads (IRHeader + JPEG) -> a :class:`_Part`: the
        sizes from the JPEG headers, the draws from them, the labels."""
        from ..kernels import nvjpeg
        jpegs, infos, crops, labels = [], [], [], []
        w_ = self.label_width
        for payload, rec in zip(payloads, records):
            header, img = _rio.unpack(payload)
            info = nvjpeg.image_info(img, record=rec)
            jpegs.append(img)
            infos.append(info)
            crops.append(self.aug.draw(rng, info[1], info[2], rec))
            lab = _np.asarray(header.label, _np.float32).reshape(-1)
            labels.append(lab[0] if w_ == 1 else lab[:w_])
        return _Part(jpegs, infos, crops, labels, list(records))

    def assemble(self, parts):
        """Parts -> (data, label, ready event), on the batcher's stream:
        one batched nvJPEG decode and one ``jpeg_color`` launch for the
        batch, then one ``image_aug`` launch. The stream takes the card's
        high priority, so these few launches run between the training
        step's kernels instead of queueing behind them."""
        from ..kernels import image_aug, nvjpeg
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device, priority=-1)
            self._decoder = nvjpeg.BatchDecoder()
        s = self._stream
        a = self.aug
        infos = [i for p in parts for i in p.infos]
        with torch.cuda.stream(s):
            buf, boff = self._decoder.decode(
                [j for p in parts for j in p.jpegs], infos, self.device,
                records=[r for p in parts for r in p.records])
            table = _np.empty((len(infos), 6), _np.int64)
            table[:, 0] = buf.data_ptr() + boff
            table[:, 1:3] = [(h, w) for _ss, h, w in infos]
            table[:, 3:6] = [c for p in parts for c in p.crops]
            out = torch.empty((len(infos),) + self.data_shape,
                              dtype=self.dtype, device=self.device)
            image_aug.launch_table(table, out, pad=a.pad, fill=a.fill,
                                   mean=a.mean, std=a.std, scale=a.scale)
            labels = _np.asarray([l for p in parts for l in p.labels],
                                 _np.float32)
            label = torch.from_numpy(labels).pin_memory().to(
                self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(s)
        return out, label, ready

    def close(self):
        """Free the decoder once the stream's work has run (no feeder may
        be assembling)."""
        if self._decoder is not None:
            self._stream.synchronize()
            self._decoder.close()
            self._decoder = None


def _consume(batch):
    """Order the caller's current stream after a card batch's making."""
    ready = getattr(batch, "ready", None)
    if ready is None:
        return batch
    s = torch.cuda.current_stream(batch.data[0]._data.device)
    s.wait_event(ready)
    for arr in list(batch.data) + list(batch.label or []):
        arr._data.record_stream(s)
    return batch


class _RecordSource:
    """Indexed, thread-safe reads of a ``.rec`` file through its ``.idx``
    (the JAX package's native mmap scanner waits for ROADMAP A5b)."""

    def __init__(self, path_imgrec, path_imgidx=None):
        self._lock = threading.Lock()
        idx = path_imgidx or os.path.splitext(path_imgrec)[0] + ".idx"
        if not os.path.isfile(idx):
            raise MXNetError(
                "ImageRecordIter needs an index (%s); the native scanner "
                "that works without one waits for ROADMAP A5b" % idx)
        self._rec = _rio.MXIndexedRecordIO(idx, path_imgrec, "r")
        self._keys = list(self._rec.keys)

    def __len__(self):
        return len(self._keys)

    def read(self, i):
        with self._lock:   # one file handle, seeked per read
            return self._rec.read_idx(self._keys[i])

    def close(self):
        self._rec.close()


def _ctx_of(ctx):
    """(the batches' Context, their torch device): None -> gpu(0)."""
    device = resolve_device(ctx)
    if isinstance(ctx, Context):
        return ctx, device
    if device.type == "cuda":
        return gpu(device.index or 0), device
    return Context("cpu"), device


class ImageRecordIter:
    """Threaded ImageRecordIter over a ``.rec`` file (see the module
    docstring). Parameters follow the reference surface: ``path_imgrec``,
    ``data_shape`` (C, H, W), ``batch_size``, ``shuffle``, ``resize``,
    ``rand_crop``, ``rand_mirror``, ``mean_r/g/b``, ``std_r/g/b``,
    ``scale``, ``pad``, ``fill_value``, ``preprocess_threads``,
    ``prefetch_buffer``, ``num_parts``/``part_index``, ``round_batch``,
    ``seed``; ``ctx`` is where the batches are made and put (default
    ``gpu(0)``), ``dtype`` their data type (default float32)."""

    def __init__(self, path_imgrec, data_shape, batch_size,
                 path_imgidx=None, label_width=1, shuffle=False,
                 preprocess_threads=4, prefetch_buffer=4, num_parts=1,
                 part_index=0, round_batch=True, seed=0, ctx=None,
                 data_name="data", label_name="softmax_label", dtype=None,
                 **aug_params):
        from concurrent.futures import ThreadPoolExecutor
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.data_name = data_name
        self.label_name = label_name
        self._dtype = normalize_dtype(dtype or "float32")
        self._ctx, self._device = _ctx_of(ctx)
        self._shuffle = shuffle
        self._round_batch = round_batch
        self._seed = seed
        self._epoch = 0
        if self._device.type == "cuda":
            self._card = _CardBatcher(self._device, self.data_shape,
                                      self._dtype, label_width, aug_params)
            self._aug = None
        else:
            self._card = None
            self._aug = _build_augmenter(self.data_shape, **aug_params)
        self._source = _RecordSource(path_imgrec, path_imgidx)
        n = len(self._source)
        if n == 0:
            raise MXNetError("empty RecordIO file %r" % path_imgrec)
        lo = part_index * n // num_parts
        hi = (part_index + 1) * n // num_parts
        self._indices = _np.arange(lo, hi)
        shard = hi - lo
        self.num_batches = (-(-shard // batch_size) if round_batch
                            else shard // batch_size)
        self._nthreads = max(1, preprocess_threads)
        self._depth = max(2, prefetch_buffer)
        self._pool = ThreadPoolExecutor(self._nthreads)
        self._queue = None
        self._feeder = None
        self._err = None
        self.reset()

    # ------------------------------------------------------------- schedule
    def _epoch_order(self):
        order = self._indices.copy()
        if self._shuffle:
            _np.random.RandomState(self._seed + self._epoch).shuffle(order)
        B = self.batch_size
        if self._round_batch:
            # wrap cyclically as often as needed (batch_size may exceed
            # the shard)
            order = _np.resize(order, ((len(order) + B - 1) // B) * B)
        else:
            order = order[:len(order) - len(order) % B]
        return order

    def _record_err(self, exc):
        if self._err is None:
            self._err = exc

    def _decode_part(self, idxs, out_data, out_label, offset, rng):
        import cv2
        try:
            for j, i in enumerate(idxs):
                header, img_bytes = _rio.unpack(self._source.read(int(i)))
                img = cv2.imdecode(
                    _np.frombuffer(img_bytes, _np.uint8), cv2.IMREAD_COLOR)
                if img is None:
                    raise MXNetError(
                        "corrupt/undecodable image at record %d" % int(i))
                out_data[offset + j] = self._aug(img, rng)
                lab = _np.asarray(header.label).reshape(-1)
                out_label[offset + j] = lab[0] if self.label_width == 1 \
                    else lab[:self.label_width]
        except BaseException as e:
            self._record_err(e)

    def _card_part(self, idxs, rng):
        idxs = [int(i) for i in idxs]
        return self._card.parse_part([self._source.read(i) for i in idxs],
                                     idxs, rng)

    def _feed_epoch(self):
        """Producer: every batch of the epoch, bounded by the queue; the
        sentinel always arrives."""
        try:
            self._feed_epoch_inner()
        except BaseException as e:
            self._record_err(e)
        self._queue.put_sentinel()

    def _feed_epoch_inner(self):
        order = self._epoch_order()
        B = self.batch_size
        P = self._nthreads
        bounds = [(p * B // P, (p + 1) * B // P) for p in range(P)]
        # on a card the next batch's parts are scheduled before this
        # one's are waited for, so the part threads never idle at a
        # batch's end (the draws are per batch and part, not per thread)
        ahead = 1 if self._card is not None else 0
        pending = []
        for b in range(len(order) // B):
            if self._queue.stopped or self._err is not None:
                return
            idxs = order[b * B:(b + 1) * B]
            rngs = [_np.random.RandomState(
                (self._seed + self._epoch * 1000003 + b * 1009 + p))
                for p in range(P)]
            pending.append(self._schedule(idxs, bounds, rngs))
            if len(pending) > ahead and not self._finish(pending.pop(0)):
                return
        for job in pending:
            if not self._finish(job):
                return

    def _schedule(self, idxs, bounds, rngs):
        """Submit one batch's parts -> what :meth:`_finish` needs."""
        if self._card is not None:
            return [self._pool.submit(self._card_part, idxs[lo:hi], rngs[p])
                    for p, (lo, hi) in enumerate(bounds) if lo != hi]
        B = self.batch_size
        shape = (self.label_width,) if self.label_width > 1 else ()
        data = _np.empty((B,) + self.data_shape, _np.float32)
        label = _np.empty((B,) + shape, _np.float32)
        return data, label, [
            self._pool.submit(self._decode_part, idxs[lo:hi], data, label,
                              lo, rngs[p])
            for p, (lo, hi) in enumerate(bounds) if lo != hi]

    def _finish(self, job):
        """Wait for a batch's parts, make it and put it -> False when the
        feeder should stop."""
        from ..ndarray.ndarray import NDArray
        if self._card is not None:
            data, label, ready = self._card.assemble([f.result()
                                                      for f in job])
            batch = DataBatch(data=[NDArray(data, ctx=self._ctx)],
                              label=[NDArray(label, ctx=self._ctx)], pad=0)
            batch.ready = ready
        else:
            data, label, futs = job
            for f in futs:
                f.result()
            if self._err is not None:
                return False
            batch = DataBatch(
                data=[NDArray(torch.from_numpy(data).to(self._dtype),
                              ctx=self._ctx)],
                label=[NDArray(torch.from_numpy(label), ctx=self._ctx)],
                pad=0)
        return self._queue.put(batch)

    # ------------------------------------------------------------ iterator
    @property
    def provide_data(self):
        return [DataDesc(self.data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        return [DataDesc(self.label_name, shape)]

    def reset(self):
        from ..data.pipeline import PrefetchQueue
        self._drain()
        # a new queue per feeder: one left over from before holds the old
        # (stopped) queue and can never feed this one
        self._queue = PrefetchQueue(self._depth)
        self._done = False
        self._err = None
        self._feeder = threading.Thread(target=self._feed_epoch, daemon=True)
        self._feeder.start()

    def _drain(self):
        if self._queue is not None:
            self._queue.shutdown(self._feeder, timeout=30.0)

    def next(self):
        if self._done:
            raise StopIteration
        batch = self._queue.get_raw()
        if batch is None:
            self._done = True   # exhausted until reset()
            if self._err is not None:
                err, self._err = self._err, None
                raise MXNetError(
                    "ImageRecordIter pipeline failed: %r" % (err,)) from err
            self._epoch += 1
            raise StopIteration
        return _consume(batch)

    def __next__(self):
        return self.next()

    def __iter__(self):
        return self

    def queue_depth(self):
        return self._queue.qsize() if self._queue is not None else 0

    def close(self):
        self._drain()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        if self._card is not None and not self._feeder.is_alive():
            self._card.close()
        self._source.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
