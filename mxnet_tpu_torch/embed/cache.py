"""Hot-row embedding cache on the card with a host spill store.

Counterpart of ``mxnet_tpu/embed/cache.py``, with the same host plan:
placement (hit or miss, LRU eviction, slot assignment) is decided on
host metadata (a dict, an ``OrderedDict`` for the LRU order, a free
list, a dirty set) and never by reading the device buffer. The buffer
is one ``(capacity, dim)`` tensor, written in place: a fill uploads the
missed rows from one host tensor and copies them into their slots with
``index_copy_`` (where the JAX package donates the buffer to a jitted
scatter).
Training marks the rows a step rewrote dirty (``note_updated``); an
evicted dirty row, and ``flush``, copies rows back to the host store,
one device-to-host copy each, recorded in ``profiler``. Serving never
dirties a row, so a served lookup makes no such copy.

``stats()`` equals the JAX cache's on the same id stream. Its uploads
are padded to a multiple of ``pad_to`` rows (so its scatter compiles
few shapes) and count the padding in ``upload_bytes``; the port uploads
only the missed rows and counts the same padded bytes.

A row's update depends only on its value and its gradient, never on
its slot or on when it was evicted (the spill round trip keeps its
bits), so the same training stream lands the same tables at any
capacity.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as _np
import torch

from ..base import MXNetError, normalize_dtype
from ..context import resolve_device
from .. import profiler
from .table import row_init

__all__ = ["HotRowCache", "SpillStore"]


class SpillStore:
    """Host store of cold rows, made on first touch.

    A row lives in a dict once touched; an untouched one costs nothing
    and is made by ``init_fn(ids)``, by default :func:`row_init` with
    ``seed``. ``budget_bytes`` (``MXNET_EMBED_HOST_BUDGET_MB`` through
    the caller) bounds the resident host bytes: ``put`` raises past it.
    """

    def __init__(self, rows, dim, dtype="float32", init_fn=None, seed=0,
                 budget_bytes=None):
        self.rows = int(rows)
        self.dim = int(dim)
        self.dtype = _np.dtype(dtype)
        self.seed = int(seed)
        self._init_fn = init_fn
        self.budget_bytes = (None if budget_bytes is None
                             else int(budget_bytes))
        self._rows = {}
        self.row_bytes = self.dim * self.dtype.itemsize

    @property
    def logical_bytes(self):
        """Bytes a dense table would take."""
        return self.rows * self.row_bytes

    @property
    def resident_bytes(self):
        """Bytes held on the host now."""
        return len(self._rows) * self.row_bytes

    def _materialize(self, ids):
        if self._init_fn is not None:
            return _np.asarray(self._init_fn(ids),
                               dtype=self.dtype).reshape(len(ids),
                                                         self.dim)
        return row_init(self.seed, ids, self.dim, self.dtype)

    def _touch(self, ids):
        fresh = [i for i in ids if int(i) not in self._rows]
        if fresh:
            made = self._materialize(_np.asarray(fresh, _np.int64))
            for j, i in enumerate(fresh):
                self._rows[int(i)] = made[j]

    def take(self, ids):
        """Pop rows (ids -> (n, dim)), making the cold ones: a row moves
        to the card and leaves the host."""
        self._touch(ids)
        out = _np.empty((len(ids), self.dim), dtype=self.dtype)
        for j, i in enumerate(ids):
            out[j] = self._rows.pop(int(i))
        return out

    def put(self, ids, values):
        """Write evicted rows back (the training spill)."""
        values = _np.asarray(values, dtype=self.dtype)
        for j, i in enumerate(ids):
            self._rows[int(i)] = _np.array(values[j], copy=True)
        if (self.budget_bytes is not None
                and self.resident_bytes > self.budget_bytes):
            raise MXNetError(
                "embed: host spill store exceeded its configured budget "
                "(%d resident > %d budget bytes; logical table is %d) — "
                "raise MXNET_EMBED_HOST_BUDGET_MB or the cache capacity"
                % (self.resident_bytes, self.budget_bytes,
                   self.logical_bytes))

    def peek(self, ids):
        """Read rows without removing them (the final export)."""
        self._touch(ids)
        out = _np.empty((len(ids), self.dim), dtype=self.dtype)
        for j, i in enumerate(ids):
            out[j] = self._rows[int(i)]
        return out


def _h2d(arr, device):
    """A host array as a tensor on ``device``: one copy, asynchronous
    from pinned memory on a card."""
    t = torch.from_numpy(_np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class HotRowCache:
    """Fixed-capacity cache on ``device`` (default cuda:0) over a
    :class:`SpillStore`.

    Protocol per step (the two-tower trainer and the recommend engine)::

        slots = cache.ensure(ids)       # host plan, spill and upload
        step(cache.buf, slots, ...)     # updates cache.buf in place
        cache.note_updated(ids)         # training only: mark dirty

    ``ensure`` is the only method that moves data. The step indexes the
    buffer by slot, so its shapes follow the capacity, never the
    table's rows.
    """

    def __init__(self, store, capacity, pad_to=8, device=None):
        if capacity <= 0:
            raise MXNetError("HotRowCache: capacity must be positive")
        if capacity > store.rows:
            capacity = store.rows
        self.store = store
        self.capacity = int(capacity)
        self.dim = store.dim
        self.dtype = store.dtype
        self.pad_to = max(1, int(pad_to))
        self.device = resolve_device(device)
        self._slot_of = {}            # id -> slot
        self._lru = OrderedDict()     # id -> None, oldest first
        self._free = list(range(self.capacity - 1, -1, -1))
        self._dirty = set()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.spill_bytes = 0          # device-to-host write-back
        self.upload_bytes = 0         # host-to-device fill, padded
        self.lookups = 0
        self.buf = torch.zeros((self.capacity, self.dim),
                               dtype=normalize_dtype(self.dtype),
                               device=self.device)

    # -- the per-step plan ---------------------------------------------------
    def ensure(self, ids):
        """Make every id resident; returns np.int32 slots aligned with
        ``ids`` (a repeated id maps to one slot)."""
        ids = _np.clip(_np.asarray(ids, _np.int64).reshape(-1),
                       0, self.store.rows - 1)
        uniq = list(dict.fromkeys(int(i) for i in ids))
        if len(uniq) > self.capacity:
            raise MXNetError(
                "embed: one step touches %d distinct rows but the cache "
                "holds %d — raise capacity above the per-step working "
                "set (docs/embeddings.md cache sizing)" % (len(uniq),
                                                           self.capacity))
        self.lookups += len(ids)
        missing = []
        for i in uniq:
            if i in self._slot_of:
                self.hits += 1
                self._lru.move_to_end(i)
            else:
                self.misses += 1
                missing.append(i)
        if missing:
            self._fill(missing, protect=set(uniq))
        return _np.fromiter((self._slot_of[int(i)] for i in ids),
                            dtype=_np.int32, count=len(ids))

    def _pull(self, ids):
        """Rows of resident ``ids`` copied to the host: one recorded
        device-to-host copy."""
        slots = _np.asarray([self._slot_of[i] for i in ids], _np.int64)
        vals = self.buf.index_select(0, _h2d(slots, self.device)) \
            .cpu().numpy()
        profiler.record_host_sync("d2h", vals.nbytes)
        self.spill_bytes += vals.nbytes
        return vals

    def _fill(self, missing, protect):
        need = len(missing) - len(self._free)
        if need > 0:
            evict = []
            for i in self._lru:
                if len(evict) == need:
                    break
                if i not in protect:
                    evict.append(i)
            dirty = [i for i in evict if i in self._dirty]
            if dirty:
                self.store.put(dirty, self._pull(dirty))
            for i in evict:
                self.evictions += 1
                slot = self._slot_of.pop(i)
                self._lru.pop(i, None)
                self._dirty.discard(i)
                self._free.append(slot)
        rows = self.store.take(missing)
        slots = []
        for i in missing:
            slot = self._free.pop()
            self._slot_of[i] = slot
            self._lru[i] = None
            slots.append(slot)
        m = len(missing)
        padded = -(-m // self.pad_to) * self.pad_to
        self.upload_bytes += padded * self.store.row_bytes
        self.buf.index_copy_(0, _h2d(_np.asarray(slots, _np.int64),
                                     self.device),
                             _h2d(rows, self.device))

    def note_updated(self, ids):
        """Training: the step rewrote these rows on the card; they must
        spill before their slot is reused."""
        for i in _np.asarray(ids, _np.int64).reshape(-1):
            i = int(min(max(i, 0), self.store.rows - 1))
            if i in self._slot_of:
                self._dirty.add(i)

    def flush(self):
        """Copy every dirty row to the host store (end of training, a
        checkpoint): one device-to-host copy for the whole set."""
        dirty = sorted(self._dirty)
        if not dirty:
            return 0
        self.store.put(dirty, self._pull(dirty))
        self._dirty.clear()
        return len(dirty)

    def hit_rate(self):
        n = self.hits + self.misses
        return (self.hits / n) if n else 0.0

    def stats(self):
        """Host-held counters; reads nothing from the card."""
        return {
            "capacity": self.capacity,
            "resident": len(self._slot_of),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "hit_rate": round(self.hit_rate(), 6),
            "spill_bytes": self.spill_bytes,
            "upload_bytes": self.upload_bytes,
            "lookups": self.lookups,
            "host_resident_bytes": self.store.resident_bytes,
            "logical_bytes": self.store.logical_bytes,
        }
