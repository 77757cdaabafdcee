"""Bounded in-flight dispatch for the training loops (counterpart of
``mxnet_tpu/engine.py``'s ``DepthController``).

PyTorch enqueues CUDA work and returns, so an unthrottled fit loop
would run the host ahead of the card by the whole epoch, holding every
pending feed and deferring device errors to the epoch end. The
controller records one ``torch.cuda.Event`` per admitted dispatch and,
past ``depth`` pending dispatches, waits for the oldest: the host stays
at most ``depth`` dispatches ahead. CPU tensors run synchronously, so
there it does nothing.
"""
from __future__ import annotations

import torch

from .base import MXNetError
from .config import flags

__all__ = ["DepthController"]


class DepthController:
    """Bounded in-flight dispatch (the ThreadedEngine's pending-op bound,
    reduced to what one CUDA stream needs).

    ``admit`` records an event after the freshly dispatched work and,
    once more than ``depth`` dispatches are outstanding, waits for the
    OLDEST: steady state keeps ``depth`` dispatches in flight while the
    host prepares the next. ``quiesce`` drains everything: epoch ends,
    metric reads and scoring call it before reading state.

    depth <= 0 disables throttling (unbounded); depth 1 is lockstep
    (dispatch, then wait for it at the next admit).
    """

    def __init__(self, depth=None):
        if depth is None:
            depth = flags.engine_depth
        self.depth = int(depth)
        self._inflight = []   # events, oldest first

    def admit(self, handles):
        """Register one dispatch by the tensors it produced: an event is
        recorded on the current stream of the first CUDA one's device
        (none on the CPU); wait for the oldest beyond the bound."""
        dev = next((h.device for h in handles
                    if isinstance(h, torch.Tensor) and h.is_cuda), None)
        if dev is None:
            return
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        self._inflight.append(ev)
        if self.depth <= 0:
            return
        while len(self._inflight) > self.depth:
            self._wait(self._inflight.pop(0))

    def quiesce(self):
        """Wait until every admitted dispatch has completed."""
        pending, self._inflight = self._inflight, []
        for ev in pending:
            self._wait(ev)

    @staticmethod
    def _wait(ev):
        try:
            ev.synchronize()
        except RuntimeError as e:   # a device error surfaces here
            raise MXNetError(str(e)) from e
