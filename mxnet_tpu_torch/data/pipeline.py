"""The bounded producer/consumer queue every prefetching iterator shares
(counterpart of ``mxnet_tpu/data/pipeline.py``).

A producer thread puts finished items into a bounded queue (the
pipeline's backpressure), the consumer gets them, and a reset or close
never deadlocks against a producer blocked on a full queue:

* ``put`` is bounded and keeps watching the stop flag;
* the ``None`` sentinel always arrives (unless stopped), so a dead
  producer shows as ``StopIteration`` or an error, never as a hang;
* an ``Exception`` put into the queue is raised by the consumer's
  ``get``;
* ``shutdown`` sets the stop flag first, then drains while joining, so
  a producer blocked in ``put`` finishes it and sees the flag.

One queue belongs to one producer generation: a reset shuts the old one
down and makes a new one.
"""
from __future__ import annotations

import queue as _queue
import threading
import time

__all__ = ["PrefetchQueue"]

_PUT_POLL_S = 0.1


class PrefetchQueue:
    """Bounded producer/consumer queue with the shared shutdown protocol."""

    def __init__(self, depth):
        self._q = _queue.Queue(maxsize=max(1, int(depth)))
        self._stop = threading.Event()

    # ------------------------------------------------------------- producer
    def put(self, item):
        """Bounded put that keeps watching the stop flag. False (the item
        dropped) when the queue was stopped first: the producer exits."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=_PUT_POLL_S)
                return True
            except _queue.Full:
                continue
        return False

    def put_sentinel(self):
        """The end-of-stream ``None``, through the same bounded put."""
        return self.put(None)

    # ------------------------------------------------------------- consumer
    def get(self, block=True, timeout=None):
        """One item; ``StopIteration`` on the sentinel, and an exception
        the producer put is raised here."""
        item = self._q.get(block=block, timeout=timeout)
        if item is None:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item

    def get_raw(self):
        """A blocking get that interprets nothing (for a consumer with an
        error surface of its own)."""
        return self._q.get()

    def qsize(self):
        return self._q.qsize()

    # ------------------------------------------------------------- shutdown
    @property
    def stopped(self):
        return self._stop.is_set()

    def stop(self):
        self._stop.set()

    def wait_stop(self, timeout):
        """A producer's backpressure sleep that wakes early on stop."""
        return self._stop.wait(timeout)

    def drain(self):
        """Empty the queue without blocking."""
        try:
            while True:
                self._q.get_nowait()
        except _queue.Empty:
            pass

    def shutdown(self, thread, timeout=5.0):
        """Stop, then drain while joining ``thread`` until it ends or
        ``timeout`` passes. True when the thread is dead (or never
        started)."""
        self._stop.set()
        if thread is None or not thread.is_alive():
            return True
        deadline = time.monotonic() + timeout
        while thread.is_alive() and time.monotonic() < deadline:
            self.drain()
            thread.join(timeout=0.05)
        return not thread.is_alive()
