"""StagedKFeed: the K-step device feed staged ahead (counterpart of
``mxnet_tpu/data/feed.py``).

``FusedStep.run_k`` runs K steps over a window stacked ``(K, batch,
...)`` on the device. Unstaged, ``fit`` builds that window (casts, stack,
the copy to the card) in the dispatch call, serially with the steps.
:class:`StagedKFeed` moves that work onto a feeder thread, double
buffered: while window W runs, the feeder pulls window W+1's K batches
from the iterator and stacks them on the device, on a CUDA stream of
its own (``Module._stage_group``); the window carries an event that the
step's stream waits for before it reads the feed.

Not staged: the PRNG keys and the optimizer's hyperparameters. Both
advance host-side chains; drawing them ahead would put those chains
ahead of the training position. The feeder stages data only, a pure
function of the batches, so the staged path is bitwise the unstaged one.

When the iterator has ``get_cursor``, the feeder takes the cursor right
after pulling each window's batches and attaches it to the window.
"""
from __future__ import annotations

import threading

from .pipeline import PrefetchQueue

__all__ = ["StagedKFeed", "StagedWindow"]


class StagedWindow:
    """One K-step window: the host batches (labels and metadata for the
    metric and callbacks), the staged device feed (None on a short tail,
    which takes the per-step path), the iterator's cursor after these
    batches, and the window's host-to-device byte count."""

    __slots__ = ("batches", "staged", "cursor", "h2d_bytes")

    def __init__(self, batches, staged=None, cursor=None, h2d_bytes=0):
        self.batches = batches
        self.staged = staged
        self.cursor = cursor
        self.h2d_bytes = h2d_bytes


class StagedKFeed:
    """Double-buffered window stager between a DataIter and fit's grouped
    loop. ``stage_fn(batches)`` (``Module._stage_group``) returns the
    staged payload ``run_k`` takes and the window's H2D byte count;
    ``depth`` bounds the staged windows in flight (each holds K stacked
    batches of device memory). ``stream``, a CUDA stream, is the feeder
    thread's current stream for its whole run: the batches a card
    iterator hands over are ordered on it, and stacked on it."""

    def __init__(self, data_iter, k, stage_fn, depth=2, cursor_fn=None,
                 stream=None):
        self._it = data_iter
        self._k = max(2, int(k))
        self._stage_fn = stage_fn
        self._cursor_fn = cursor_fn
        self._stream = stream
        self._pq = PrefetchQueue(max(1, int(depth)))
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        if self._stream is None:
            self._feed()
            return
        import torch
        with torch.cuda.stream(self._stream):
            self._feed()

    def _feed(self):
        pq = self._pq
        try:
            while not pq.stopped:
                batches = []
                ended = False
                while len(batches) < self._k:
                    try:
                        batches.append(next(self._it))
                    except StopIteration:
                        ended = True
                        break
                if not batches:
                    break
                cursor = self._cursor_fn() if self._cursor_fn else None
                staged, nbytes = None, 0
                if len(batches) == self._k:
                    # a full window is stacked now, beside the window in
                    # flight; a tail goes unstaged to the per-step path
                    staged, nbytes = self._stage_fn(batches)
                if not pq.put(StagedWindow(batches, staged, cursor,
                                           nbytes)):
                    return
                if ended:
                    break
        except BaseException as e:
            pq.put(e)
        pq.put_sentinel()

    def next_window(self):
        """The next :class:`StagedWindow`; StopIteration at the epoch's
        end, and the feeder's error raised. The time blocked here is the
        fit loop's input stall."""
        return self._pq.get()

    def queue_depth(self):
        return self._pq.qsize()

    def close(self):
        self._pq.shutdown(self._thread, timeout=30.0)
