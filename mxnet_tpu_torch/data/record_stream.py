"""Sharded RecordIO streams and the streaming DataIter (counterpart of
``mxnet_tpu/data/record_stream.py``).

:class:`ShardedRecordStream` partitions a RecordIO file set across
ranks so that the ranks together read every record once an epoch: the
file order and each file's record order come from ``RandomState(seed +
epoch)``, the same on every rank, and for the file at position j of the
epoch's file order rank r reads the shuffled keys ``[(r + j) % world ::
world]``. Its position is a resumable ``(epoch, shard, offset)`` cursor.

:class:`StreamingDataIter` turns it into a ``DataIter``: a feeder thread
pulls a batch's records, decodes them in P parts on a thread pool with
per-part generators seeded ``seed + epoch * 1000003 + batch * 1009 +
p`` (``ImageRecordIter``'s rule, so a cursor seek replays the
augmentation bitwise) and puts the batch, with the cursor taken right
after its records, into a bounded queue. ``get_cursor()`` is the
position of the last batch the consumer took. The short epoch tail is
dropped.

On a card (``ctx`` defaults to ``gpu(0)``) an :class:`ImageDecoder`
decodes with nvJPEG and augments with the augment kernel, as
``ImageRecordIter`` does there; a :class:`RawTensorDecoder` batch is
assembled on the host and copied over.
"""
from __future__ import annotations

import threading

import numpy as _np
import torch

from .. import recordio as _rio
from ..base import MXNetError
from ..io.image_record_iter import (_build_augmenter, _CardBatcher, _consume,
                                    _ctx_of, _RecordSource)
from ..io.io import DataBatch, DataDesc, DataIter
from .pipeline import PrefetchQueue

__all__ = ["ShardedRecordStream", "StreamingDataIter", "RawTensorDecoder",
           "ImageDecoder"]


class ShardedRecordStream:
    """Exactly-once strided reader over a sharded RecordIO file set.

    ``paths`` is one ``.rec`` path or a list, each with its ``.idx``;
    ``rank``/``world`` select this reader's stride of the records."""

    def __init__(self, paths, rank=0, world=1, shuffle=True, seed=0,
                 epoch=0):
        if isinstance(paths, str):
            paths = [paths]
        if not paths:
            raise ValueError("ShardedRecordStream needs at least one file")
        if world <= 0 or not 0 <= rank < world:
            raise ValueError("bad rank/world: %r/%r" % (rank, world))
        self._paths = list(paths)
        self._rank = int(rank)
        self._world = int(world)
        self._shuffle = bool(shuffle)
        self._seed = int(seed)
        self._sources = [_RecordSource(p) for p in self._paths]
        self._counts = [len(s) for s in self._sources]
        if sum(self._counts) == 0:
            raise MXNetError("empty RecordIO set: %r" % (self._paths,))
        self._epoch = int(epoch)
        self._shard = 0
        self._offset = 0
        self._plan = None

    @property
    def epoch(self):
        return self._epoch

    @property
    def seed(self):
        return self._seed

    def _epoch_plan(self):
        if self._plan is not None:
            return self._plan
        rs = _np.random.RandomState(self._seed + self._epoch)
        nfiles = len(self._sources)
        file_perm = rs.permutation(nfiles) if self._shuffle \
            else _np.arange(nfiles)
        plan = []
        for j, fi in enumerate(file_perm):
            fi = int(fi)
            keys = (rs.permutation(self._counts[fi]) if self._shuffle
                    else _np.arange(self._counts[fi]))
            off = (self._rank + j) % self._world
            plan.append((fi, keys[off::self._world]))
        self._plan = plan
        return plan

    def records_per_epoch(self):
        """This rank's record count in the current epoch."""
        return sum(len(keys) for _, keys in self._epoch_plan())

    def records_consumed(self):
        """Records this rank has read in the current epoch."""
        plan = self._epoch_plan()
        return sum(len(keys) for _, keys in plan[:self._shard]) \
            + self._offset

    def read_next(self):
        """The next record's bytes, or None at the epoch's end (one
        reader thread a stream)."""
        plan = self._epoch_plan()
        while self._shard < len(plan):
            fi, keys = plan[self._shard]
            if self._offset < len(keys):
                rec = self._sources[fi].read(int(keys[self._offset]))
                self._offset += 1
                return rec
            self._shard += 1
            self._offset = 0
        return None

    def __iter__(self):
        while True:
            rec = self.read_next()
            if rec is None:
                return
            yield rec

    def next_epoch(self):
        self._epoch += 1
        self._shard = 0
        self._offset = 0
        self._plan = None

    def cursor(self):
        """The resumable position, with the sharding it belongs to."""
        return {"epoch": self._epoch, "shard": self._shard,
                "offset": self._offset, "rank": self._rank,
                "world": self._world, "seed": self._seed}

    def seek(self, cursor):
        for key in ("rank", "world", "seed"):
            if key in cursor and int(cursor[key]) != getattr(
                    self, "_" + key):
                raise MXNetError(
                    "cursor %s=%r does not match this stream's %s=%r; "
                    "resharding a cursor needs a fresh epoch, not a seek"
                    % (key, cursor[key], key, getattr(self, "_" + key)))
        self._epoch = int(cursor["epoch"])
        self._shard = int(cursor["shard"])
        self._offset = int(cursor["offset"])
        self._plan = None


def _label_into(out_label, j, header, width):
    lab = _np.asarray(header.label).reshape(-1)
    out_label[j] = lab[0] if width == 1 else lab[:width]


class RawTensorDecoder:
    """Records whose payload is one sample's raw bytes in ``data_shape``
    order; the label comes from the IRHeader. No randomness."""

    randomized = False

    def __init__(self, data_shape, label_width=1, dtype=_np.float32):
        self.data_shape = tuple(data_shape)
        self.label_width = int(label_width)
        self.data_dtype = _np.dtype(dtype)

    def __call__(self, rec, out_data, out_label, j, rng):
        header, payload = _rio.unpack(rec)
        out_data[j] = _np.frombuffer(
            payload, self.data_dtype).reshape(self.data_shape)
        _label_into(out_label, j, header, self.label_width)


class ImageDecoder:
    """JPEG decode + ``ImageRecordIter``'s augmenter (HWC BGR uint8 ->
    CHW float32 RGB); ``aug_params`` as in ImageRecordIter. On the host
    through cv2 (:func:`_build_augmenter`), on a card through nvJPEG and
    the augment kernel (:meth:`card_batcher`)."""

    randomized = True

    def __init__(self, data_shape, label_width=1, **aug_params):
        self.data_shape = tuple(data_shape)
        self.label_width = int(label_width)
        self.data_dtype = _np.dtype(_np.float32)
        self._aug_params = dict(aug_params)
        self._aug = None

    def card_batcher(self, device):
        return _CardBatcher(device, self.data_shape, torch.float32,
                            self.label_width, self._aug_params)

    def __call__(self, rec, out_data, out_label, j, rng):
        import cv2
        if self._aug is None:
            self._aug = _build_augmenter(self.data_shape, **self._aug_params)
        header, img_bytes = _rio.unpack(rec)
        img = cv2.imdecode(
            _np.frombuffer(img_bytes, _np.uint8), cv2.IMREAD_COLOR)
        if img is None:
            raise MXNetError("corrupt/undecodable image record")
        out_data[j] = self._aug(img, rng)
        _label_into(out_label, j, header, self.label_width)


class StreamingDataIter(DataIter):
    """DataIter over a :class:`ShardedRecordStream` with parallel decode
    and a resumable cursor (see the module docstring)."""

    def __init__(self, stream, decoder, batch_size, decode_threads=None,
                 prefetch_depth=None, ctx=None, data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        from concurrent.futures import ThreadPoolExecutor
        from ..config import flags as _flags
        self._stream = stream
        self._decoder = decoder
        self._ctx, self._device = _ctx_of(ctx)
        self._card = None
        if self._device.type == "cuda" and hasattr(decoder, "card_batcher"):
            self._card = decoder.card_batcher(self._device)
        self.data_name = data_name
        self.label_name = label_name
        self._nthreads = max(1, int(decode_threads
                                    or _flags.data_decode_threads
                                    or _flags.cpu_worker_nthreads))
        self._depth = max(2, int(prefetch_depth or _flags.data_feed_depth))
        self._pool = ThreadPoolExecutor(self._nthreads)
        self._pq = None
        self._feeder = None
        self._done = False
        self._last_cursor = stream.cursor()
        self.seeks = 0
        self._start()

    @property
    def provide_data(self):
        return [DataDesc(self.data_name,
                         (self.batch_size,) + self._decoder.data_shape,
                         self._decoder.data_dtype)]

    @property
    def provide_label(self):
        w = self._decoder.label_width
        shape = (self.batch_size,) if w == 1 else (self.batch_size, w)
        return [DataDesc(self.label_name, shape)]

    @property
    def num_batches(self):
        return self._stream.records_per_epoch() // self.batch_size

    def queue_depth(self):
        pq = self._pq
        return pq.qsize() if pq is not None else 0

    def _start(self):
        pq = self._pq = PrefetchQueue(self._depth)
        self._feeder = threading.Thread(
            target=self._feed_epoch, args=(pq,), daemon=True)
        self._feeder.start()

    def _feed_epoch(self, pq):
        try:
            self._feed_epoch_inner(pq)
        except BaseException as e:
            pq.put(e)
        pq.put_sentinel()

    def _decode_part(self, recs, out_data, out_label, offset, rng):
        for j, rec in enumerate(recs):
            self._decoder(rec, out_data, out_label, offset + j, rng)

    def _make_batch(self, recs, b, bounds, rngs):
        from ..ndarray.ndarray import NDArray
        from ..ndarray import ndarray as _nd
        B = self.batch_size
        if self._card is not None:
            futs = [self._pool.submit(self._card.parse_part, recs[lo:hi],
                                      list(range(b * B + lo, b * B + hi)),
                                      rngs[p])
                    for p, (lo, hi) in enumerate(bounds) if lo != hi]
            data, label, ready = self._card.assemble(
                [f.result() for f in futs])
            batch = DataBatch(data=[NDArray(data, ctx=self._ctx)],
                              label=[NDArray(label, ctx=self._ctx)], pad=0)
            batch.ready = ready
            return batch
        w = self._decoder.label_width
        data = _np.empty((B,) + self._decoder.data_shape,
                         self._decoder.data_dtype)
        label = _np.empty((B,) + ((w,) if w > 1 else ()), _np.float32)
        futs = [self._pool.submit(self._decode_part, recs[lo:hi], data,
                                  label, lo, rngs[p])
                for p, (lo, hi) in enumerate(bounds) if lo != hi]
        for f in futs:
            f.result()   # decode errors raise on the feeder
        return DataBatch(data=[_nd.array(data, ctx=self._ctx)],
                         label=[_nd.array(label, ctx=self._ctx)], pad=0)

    def _feed_epoch_inner(self, pq):
        B = self.batch_size
        P = self._nthreads
        epoch = self._stream.epoch
        seed = self._stream.seed
        bounds = [(p * B // P, (p + 1) * B // P) for p in range(P)]
        b = self._stream.records_consumed() // B
        while not pq.stopped:
            recs = []
            while len(recs) < B:
                rec = self._stream.read_next()
                if rec is None:
                    return  # epoch end (the short tail dropped)
                recs.append(rec)
            # the cursor rides the batch: taken after ITS records
            cursor = self._stream.cursor()
            rngs = [_np.random.RandomState(
                (seed + epoch * 1000003 + b * 1009 + p)) for p in range(P)]
            if not pq.put((self._make_batch(recs, b, bounds, rngs),
                           cursor)):
                return
            b += 1

    def next(self):
        if self._done:
            raise StopIteration
        try:
            batch, cursor = self._pq.get()
        except StopIteration:
            self._done = True
            # a clean epoch end moves to the next epoch's plan
            self._stream.next_epoch()
            self._last_cursor = self._stream.cursor()
            raise
        self._last_cursor = cursor
        return _consume(batch)

    def get_cursor(self):
        """The position of the last batch taken (a fresh copy)."""
        return dict(self._last_cursor)

    def seek(self, cursor):
        """Reposition to a cursor: the next batch is the one that
        followed it, bitwise."""
        self._shutdown_feeder()
        self._stream.seek(cursor)
        self._last_cursor = dict(cursor)
        self._done = False
        self.seeks += 1
        self._start()

    def reset(self):
        self._shutdown_feeder()
        # rewind to the consumed position: what the feeder read ahead
        # belongs to the next generation
        self._stream.seek(self._last_cursor)
        self._done = False
        self._start()

    def _shutdown_feeder(self):
        if self._pq is not None:
            self._pq.shutdown(self._feeder, timeout=30.0)

    def close(self):
        self._shutdown_feeder()
        self._pool.shutdown(wait=True)
        if self._card is not None and not self._feeder.is_alive():
            self._card.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
