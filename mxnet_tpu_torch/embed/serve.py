"""The recommend serving path: format_version 6 artifacts and the
cache-backed engine.

Counterpart of ``mxnet_tpu/embed/serve.py``. A trained two-tower
retriever is two tables: the user tower (a request's history rows,
averaged) and the item corpus it scores against. ``export_recommend``
writes both into a format_version 6 artifact as data (an npz after the
metadata); the engine streams the user table through a
:class:`~.cache.HotRowCache` and keeps the corpus dense on the card.

:class:`RecommendEngine` is what ``Server`` runs in recommend mode. Per
batch it plans slots on the host (hits, misses, spills: no device
read), uploads the misses, then scores on the card: B2 gathers the
history rows from the cache buffer by slot (``table.local_gather``),
a masked mean makes each user vector, one product scores the corpus,
and a stable descending sort takes the top k (the lower item first
among equal scores, as ``jax.lax.top_k``). The scores, viewed as int32,
and the item ids travel back in one ``(bucket, 2k)`` copy: one
device-to-host copy a response batch, recorded in ``profiler``.

``check_discipline()`` stands in for the JAX package's MXL511 pass,
which reads the lowered program: the port has none, so it runs one
batch and checks at run time that the cache buffer keeps its storage
and, on a card, that the scoring makes no host sync before its copy
(``torch.cuda.set_sync_debug_mode("error")``).

A request is charged by its gather count through
``perfmodel.recommend_request_seconds``: the admission queue bills in
gather units.
"""
from __future__ import annotations

import io
import json
import struct

import numpy as _np
import torch

from ..base import MXNetError
from ..config import flags
from ..context import resolve_device
from .. import perfmodel, profiler
from ..serving import _MAGIC, _RECOMMEND_VERSION, _read_meta
from .cache import HotRowCache, SpillStore, _h2d
from .table import local_gather

__all__ = ["export_recommend", "RecommendModel", "RecommendEngine",
           "tables_from_reference", "Diagnostic"]

_REFERENCE_MAGIC = b"MXTPUAOT"   # the JAX package's .mxtpu artifacts


def export_recommend(user_table, item_table, path, *, max_ids=64, k=10,
                     model_name="twotower"):
    """Write a format_version 6 recommend artifact.

    ``user_table`` (rows x dim) and ``item_table`` (items x dim) are
    host arrays, the trained tables (flush the training cache first).
    ``max_ids`` bounds one request's history; ``k`` is the result
    count. Returns the metadata."""
    user_table = _np.ascontiguousarray(user_table)
    item_table = _np.ascontiguousarray(item_table)
    if user_table.ndim != 2 or item_table.ndim != 2:
        raise MXNetError("export_recommend: tables must be 2-D "
                         "(rows x dim)")
    if user_table.shape[1] != item_table.shape[1]:
        raise MXNetError(
            "export_recommend: tower dims disagree (%d vs %d)"
            % (user_table.shape[1], item_table.shape[1]))
    meta = {
        "format_version": _RECOMMEND_VERSION,
        "model_name": model_name,
        "recommend": {
            "rows": int(user_table.shape[0]),
            "items": int(item_table.shape[0]),
            "dim": int(user_table.shape[1]),
            "dtype": str(user_table.dtype),
            "max_ids": int(max_ids),
            "k": int(min(k, item_table.shape[0])),
        },
    }
    buf = io.BytesIO()
    _np.savez(buf, user_table=user_table, item_table=item_table)
    meta_b = json.dumps(meta, sort_keys=True).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(meta_b)))
        f.write(meta_b)
        f.write(buf.getvalue())
    return meta


def _read_tables(f):
    with _np.load(io.BytesIO(f.read())) as z:
        return z["user_table"], z["item_table"]


def _check_version(path, meta):
    if int(meta.get("format_version", 0)) != _RECOMMEND_VERSION:
        raise MXNetError("artifact %r has format_version %s, not a "
                         "recommend artifact (6)"
                         % (path, meta.get("format_version")))


def tables_from_reference(path):
    """``(user_table, item_table)`` of a JAX package's format_version 6
    ``.mxtpu`` artifact (magic ``MXTPUAOT``, the same npz payload), as
    numpy arrays, to re-export with :func:`export_recommend`."""
    with open(path, "rb") as f:
        if f.read(8) != _REFERENCE_MAGIC:
            raise MXNetError("%r is not an mxnet_tpu artifact" % path)
        (n,) = struct.unpack("<I", f.read(4))
        _check_version(path, json.loads(f.read(n).decode()))
        return _read_tables(f)


class RecommendModel:
    """A loaded format_version 6 artifact: geometry and host tables,
    served on ``device``."""

    def __init__(self, meta, user_table, item_table, device):
        self.meta = meta
        self.spec = dict(meta["recommend"])
        self.user_table = user_table
        self.item_table = item_table
        self.device = device

    @classmethod
    def load(cls, path, device=None):
        """Load for ``device`` (default cuda:0; raises without a card
        unless the CPU is asked for)."""
        dev = resolve_device(device)
        with open(path, "rb") as f:
            meta = _read_meta(f, path)
            _check_version(path, meta)
            user, item = _read_tables(f)
        return cls(meta, user, item, dev)

    def engine(self, capacity=None, buckets=None):
        return RecommendEngine(self, capacity=capacity, buckets=buckets)


class Diagnostic:
    """One finding, in the shape of the JAX package's mxlint
    diagnostics."""

    __slots__ = ("rule", "path", "line", "col", "severity", "message",
                 "hint", "symbol", "index")

    def __init__(self, rule, path, message, hint="",
                 symbol="hlo-embedding-lookup-discipline"):
        self.rule = rule
        self.path = path
        self.line = 1
        self.col = 0
        self.severity = "error"
        self.message = message
        self.hint = hint
        self.symbol = symbol
        self.index = 0

    def format(self):
        return "%s:%d:%d: %s [%s] %s" % (self.path, self.line, self.col,
                                         self.severity, self.rule,
                                         self.message)

    def __repr__(self):
        return "Diagnostic(%s)" % self.format()


_MXL511_HINT = ("the served lookup must update the hot-row cache buffer "
                "in place and make no device-to-host copy before its one "
                "top-k fetch; hit/miss/spill accounting lives on the host")


class RecommendEngine:
    """Cache-backed scorer over one :class:`RecommendModel`.

    ``buckets`` are request-batch buckets, as the predict micro-batcher
    pads to. The user table lives in a :class:`HotRowCache` of
    ``capacity`` rows (``MXNET_EMBED_CACHE_ROWS`` by default); the item
    corpus, small by construction (the output vocabulary), is dense on
    the model's device."""

    def __init__(self, model, capacity=None, buckets=None):
        self.model = model
        spec = model.spec
        self.rows = spec["rows"]
        self.dim = spec["dim"]
        self.items = spec["items"]
        self.max_ids = int(spec["max_ids"])
        self.k = int(min(spec["k"], self.items))
        self.buckets = tuple(sorted(set(int(b) for b in
                                        (buckets or (1, 4, 16)))))
        capacity = int(capacity or flags.embed_cache_rows)
        budget = float(flags.embed_host_budget_mb or 0.0)
        user = model.user_table
        store = SpillStore(
            self.rows, self.dim, dtype=user.dtype,
            init_fn=lambda ids: user[_np.asarray(ids, _np.int64)],
            budget_bytes=int(budget * (1 << 20)) if budget > 0 else None)
        self.device = model.device
        self.cache = HotRowCache(store, capacity, device=self.device)
        self.corpus = torch.from_numpy(_np.ascontiguousarray(
            model.item_table)).to(self.device)
        self._pos = torch.arange(self.max_ids, device=self.device)
        self.requests = 0
        self.gathers = 0

    # -- the served lookup ---------------------------------------------------
    def _score(self, slots, lengths):
        """(bucket, max_ids) slots and (bucket,) lengths on the card ->
        (bucket, 2k) int32: the top-k scores' bits, then the items."""
        b = slots.shape[0]
        emb = local_gather(self.cache.buf, slots.reshape(-1))
        emb = emb.reshape(b, self.max_ids, self.dim)
        mask = (self._pos[None, :] < lengths[:, None]).to(emb.dtype)
        denom = lengths.to(emb.dtype).clamp(min=1.0)
        user = (emb * mask[..., None]).sum(dim=1) / denom[:, None]
        scores = user @ self.corpus.T
        top_s, top_i = torch.sort(scores, dim=1, descending=True,
                                  stable=True)
        return torch.cat([top_s[:, :self.k].view(torch.int32),
                          top_i[:, :self.k].to(torch.int32)], dim=1)

    def _upload(self, slots, lengths):
        return _h2d(slots, self.device), _h2d(lengths, self.device)

    def _zero_batch(self, bucket):
        """A bucket of empty requests on the device."""
        return self._upload(_np.zeros((bucket, self.max_ids), _np.int32),
                            _np.zeros((bucket,), _np.int32))

    def warm(self, bucket=None):
        """Run the scoring once on zero inputs per bucket (or one),
        touching neither the cache nor the request counters."""
        for bk in ((bucket,) if bucket else self.buckets):
            self._score(*self._zero_batch(bk))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _plan(self, id_lists, bucket):
        """Host plan of a batch padded to ``bucket``: truncate each
        request to ``max_ids``, make every row resident, return the slot
        matrix, the lengths and the gather count billed to admission."""
        slots = _np.zeros((bucket, self.max_ids), dtype=_np.int32)
        lengths = _np.zeros((bucket,), dtype=_np.int32)
        flat = []
        for ids in id_lists:
            flat.extend(list(ids)[:self.max_ids])
        all_slots = (self.cache.ensure(_np.asarray(flat, _np.int64))
                     if flat else _np.zeros((0,), _np.int32))
        off = 0
        for j, ids in enumerate(id_lists):
            n = min(len(ids), self.max_ids)
            lengths[j] = n
            slots[j, :n] = all_slots[off:off + n]
            off += n
        return slots, lengths, len(flat)

    def recommend_batch(self, id_lists, bucket=None):
        """Score a batch of ragged id lists; returns (scores, item_ids)
        host arrays, one row per request: one scoring pass and one
        device-to-host copy for the whole batch."""
        b = len(id_lists)
        if bucket is None:
            bucket = next((bk for bk in self.buckets if bk >= b),
                          self.buckets[-1])
        if b > bucket:
            raise MXNetError(
                "recommend: batch of %d exceeds bucket %d" % (b, bucket))
        slots, lengths, gathers = self._plan(id_lists, bucket)
        host = self._score(*self._upload(slots, lengths)).cpu().numpy()
        profiler.record_host_sync("d2h", host.nbytes)
        self.requests += b
        self.gathers += gathers
        k = self.k
        return (_np.ascontiguousarray(host[:b, :k]).view(_np.float32),
                _np.ascontiguousarray(host[:b, k:]))

    # -- cost model ----------------------------------------------------------
    def gather_unit_s(self):
        """Roofline seconds of one gather unit: the admission queue's
        billing rate."""
        return max(self.estimate_request_s(1), 1e-9)

    def estimate_request_s(self, gathers):
        return perfmodel.recommend_request_seconds(
            gathers, self.dim, self.items,
            dtype_bytes=self.cache.dtype.itemsize)

    # -- discipline ----------------------------------------------------------
    def check_discipline(self, bucket=None):
        """The MXL511 discipline, checked at run time on one batch of
        zero ids: the cache buffer keeps its storage, and on a card the
        scoring makes no host sync before its copy. Returns the
        diagnostics ([] = clean). The batch launches the gather like any
        other and touches no counter of the cache or the engine."""
        label = "recommend/lookup"
        args = self._zero_batch(bucket or self.buckets[0])
        ptr = self.cache.buf.data_ptr()
        diags = []
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
        try:
            self._score(*args)
        except RuntimeError as e:
            diags.append(Diagnostic(
                "MXL511", label, "the served lookup synchronizes with the "
                "host before its one copy: %s" % e, _MXL511_HINT))
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(prev)
        if self.cache.buf.data_ptr() != ptr:
            diags.append(Diagnostic(
                "MXL511", label, "hot-row cache buffer not updated in "
                "place: the served lookup moved the resident rows",
                _MXL511_HINT))
        return diags

    def stats(self):
        """Host-held snapshot: the cache counters and the requests."""
        out = self.cache.stats()
        out.update(requests=self.requests, gathers=self.gathers,
                   corpus_rows=self.items, max_ids=self.max_ids,
                   k=self.k, buckets=list(self.buckets))
        return out
