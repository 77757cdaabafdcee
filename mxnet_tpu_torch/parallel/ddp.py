"""Bucketed gradient all-reduce for data parallelism (counterpart of
``mxnet_tpu/parallel/ddp.py``).

The kvstore ``dist_sync`` path issues one collective per tensor: on a
network of many small parameters the per-collective cost dominates.
Here the gradients are partitioned into size-bounded,
dtype-homogeneous **buckets** (``partition_buckets``, the JAX package's
plan for the same entries and byte bound, walked in reverse production
order) and each bucket is flattened into ONE all-reduce over the process
group (``GradReducer.reduce``).

The JAX package reduces inside the traced step, where XLA may overlap a
bucket's psum with the rest of the backward. The port's reduce is eager:
it runs after the backward, bucket by bucket in the same order, each
bucket a blocking gloo ``all_reduce`` (a card tensor goes through host
memory; ``parallel.dist``). Nothing overlaps it, so
``estimate_overlap_ms`` is what the plan would hide on a backend that
overlaps, not what this one does.

The bucket size comes from the link the group moves bytes over
(``choose_bucket_bytes``: big enough that a collective's launch
overhead stays below ``_LAUNCH_FRACTION`` of its transfer time, clamped
to [1 MiB, 64 MiB]); ``MXNET_DDP_BUCKET_MB`` overrides. Between ranks
that share a card under gloo that link is the host link
(``perfmodel.group_link_bytes_per_s``), not a TPU's ICI.

Wiring (``MXNET_DDP=1``, ``python -m mxnet_tpu_torch.tools.launch
--ddp``): ``Module`` builds a ``GradReducer`` for its fused step, and the
Gluon ``Trainer`` and ``Module.update`` without a fused step reduce
through ``dist.allreduce_tree``; ``dist_async`` keeps the kvstore
server. The mesh functions of the JAX module (``process_mesh``,
``to_global``, ``from_global``) belong to the mesh half of the port.
"""
from __future__ import annotations

import time

import numpy as _np
import torch

from .. import perfmodel as _perfmodel
from ..config import flags

__all__ = ["Bucket", "SparseBucket", "GradReducer", "enabled",
           "choose_bucket_bytes", "partition_buckets",
           "coalesce_sparse_grad", "estimate_overlap_ms"]

_LAUNCH_OVERHEAD_S = 20e-6
_LAUNCH_FRACTION = 0.05
_MIN_BUCKET_BYTES = 1 << 20    # 1 MiB: below this, launches dominate
_MAX_BUCKET_BYTES = 64 << 20   # 64 MiB: above this, overlap disappears


def enabled():
    """True when the bucketed DDP path is switched on (``MXNET_DDP=1``)."""
    return bool(flags.ddp)


def choose_bucket_bytes(link_bytes_per_s=None):
    """Bucket size in bytes: ``MXNET_DDP_BUCKET_MB`` if set, else sized
    from the group link's bandwidth so launch overhead amortizes to <=
    ``_LAUNCH_FRACTION`` of a bucket's transfer time, clamped to
    [1 MiB, 64 MiB] (the JAX package's rule)."""
    mb = float(flags.ddp_bucket_mb or 0.0)
    if mb > 0.0:
        return max(1, int(mb * (1 << 20)))
    bw = link_bytes_per_s or _perfmodel.group_link_bytes_per_s()
    raw = bw * _LAUNCH_OVERHEAD_S / _LAUNCH_FRACTION
    return int(min(max(raw, _MIN_BUCKET_BYTES), _MAX_BUCKET_BYTES))


def _dtype(d):
    """A numpy dtype for a numpy or torch dtype; bfloat16, which numpy
    lacks, stays the torch dtype."""
    if isinstance(d, torch.dtype):
        if d == torch.bfloat16:
            return d
        return _np.dtype(str(d).rsplit(".", 1)[-1])
    return _np.dtype(d)


def _itemsize(d):
    return torch.empty((), dtype=d).element_size() \
        if isinstance(d, torch.dtype) else d.itemsize


class Bucket:
    """One fused all-reduce's worth of gradients (dtype-homogeneous)."""

    __slots__ = ("keys", "shapes", "sizes", "dtype", "nbytes")

    def __init__(self, entries):
        self.keys = tuple(k for k, _, _ in entries)
        self.shapes = tuple(tuple(s) for _, s, _ in entries)
        self.sizes = tuple(
            int(_np.prod(s, dtype=_np.int64)) if len(s) else 1
            for _, s, _ in entries)
        self.dtype = _dtype(entries[0][2])
        self.nbytes = sum(self.sizes) * _itemsize(self.dtype)

    def __repr__(self):
        return "Bucket(n=%d, dtype=%s, nbytes=%d)" % (
            len(self.keys), getattr(self.dtype, "name", self.dtype),
            self.nbytes)


class SparseBucket:
    """One embedding gradient's sparse exchange plan: each rank
    all-gathers its ``(ids, values)`` contributions (``length`` per rank)
    and every rank coalesces the global set in stable sorted-id order
    (:func:`coalesce_sparse_grad`), instead of all-reducing the dense
    ``(rows, dim)`` gradient."""

    __slots__ = ("key", "length", "dim", "rows", "dtype")

    def __init__(self, key, length, dim, rows, dtype="float32"):
        self.key = key
        self.length = int(length)
        self.dim = int(dim)
        self.rows = int(rows)
        self.dtype = _np.dtype(dtype)

    def comm_bytes(self, axis_size):
        """Gathered volume per device: ids (int32) + values."""
        return (self.length * axis_size
                * (4 + self.dim * self.dtype.itemsize))

    def densified_bytes(self):
        """What the dense bucket path would move for this grad."""
        return self.rows * self.dim * self.dtype.itemsize

    def __repr__(self):
        return ("SparseBucket(%r, L=%d, dim=%d, rows=%d)"
                % (self.key, self.length, self.dim, self.rows))


def coalesce_sparse_grad(ids, values, rows, gather=False):
    """Reduce one sparse gradient to its dense ``(rows, dim)`` form:
    with ``gather`` the contributions are first all-gathered over the
    group in rank order; then a stable sort by id and an accumulation in
    that order (each row's contributions fold in (rank, position) order,
    the left fold a one-rank dense scatter-add performs)."""
    from . import dist as _dist
    dim = values.shape[-1]
    ids = ids.to(torch.int64).reshape(-1)
    values = values.reshape(-1, dim)
    if gather:
        ids = _dist.allgather(ids).reshape(-1)
        values = _dist.allgather(values).reshape(-1, dim)
    ids = ids.clamp(0, rows - 1)
    order = torch.sort(ids, stable=True).indices
    out = torch.zeros((rows, dim), dtype=values.dtype, device=values.device)
    # accumulate=True sums each row's run in sorted order (no float
    # atomics on the card)
    return out.index_put_((ids[order],), values[order], accumulate=True)


def partition_buckets(entries, bucket_bytes=None, reverse=True):
    """Partition ``(key, shape, dtype)`` entries into size-bounded,
    dtype-homogeneous buckets (the JAX package's plan).

    ``reverse=True`` (default) walks the entries back-to-front so bucket
    0 holds the *last* parameters' gradients, the ones the backward
    produces first. A parameter larger than ``bucket_bytes`` gets a
    bucket of its own; a dtype change always closes the current
    bucket."""
    bucket_bytes = bucket_bytes or choose_bucket_bytes()
    norm = [(k, tuple(s), _dtype(d)) for k, s, d in entries]
    if reverse:
        norm = norm[::-1]
    buckets, cur, cur_bytes = [], [], 0
    for key, shape, dtype in norm:
        n = int(_np.prod(shape, dtype=_np.int64)) if len(shape) else 1
        nbytes = n * _itemsize(dtype)
        if cur and (str(dtype) != str(cur[0][2])
                    or cur_bytes + nbytes > bucket_bytes):
            buckets.append(Bucket(cur))
            cur, cur_bytes = [], 0
        cur.append((key, shape, dtype))
        cur_bytes += nbytes
        if cur_bytes >= bucket_bytes:
            buckets.append(Bucket(cur))
            cur, cur_bytes = [], 0
    if cur:
        buckets.append(Bucket(cur))
    return buckets


def reduce_bucket(b, grads, out):
    """All-reduce bucket ``b`` of ``grads`` (indexed by the bucket's
    keys) into ``out``: one tensor as it is, several flattened into one
    buffer on their device and split back into views of it."""
    from . import dist as _dist
    if len(b.keys) == 1:
        k = b.keys[0]
        out[k] = _dist.allreduce_sum(grads[k])
        return
    flat = _dist.allreduce_sum(torch.cat([grads[k].reshape(-1)
                                          for k in b.keys]), owned=True)
    off = 0
    for k, shape, size in zip(b.keys, b.shapes, b.sizes):
        out[k] = flat[off:off + size].view(shape)
        off += size


class GradReducer:
    """Bucketed all-reduce over the process group.

    Built once per step function from the gradients' (name, shape,
    dtype) entries; :meth:`reduce` runs eagerly after the backward. The
    host-held :meth:`stats` never touch the device; ``step_ms`` and
    ``collectives`` record what each reduce took."""

    def __init__(self, entries, axis_name=None, bucket_bytes=None,
                 axis_size=None, sparse=None):
        self.axis_name = axis_name or flags.ddp_axis
        self.bucket_bytes = int(bucket_bytes or choose_bucket_bytes())
        self.buckets = partition_buckets(entries, self.bucket_bytes)
        self.comm_bytes = sum(b.nbytes for b in self.buckets)
        self.axis_size = axis_size
        self.sparse = {}
        for sb in (sparse or ()):
            if not isinstance(sb, SparseBucket):
                sb = SparseBucket(*sb)
            self.sparse[sb.key] = sb
        self.sparse_comm_bytes = sum(
            sb.comm_bytes(self.axis_size or 1)
            for sb in self.sparse.values())
        self.sparse_densified_bytes = sum(
            sb.densified_bytes() for sb in self.sparse.values())
        self.step_ms = []          # host ms of each reduce
        self.collectives = 0       # all-reduces issued in all

    def reduce(self, grads):
        """Sum a ``{name: grad}`` dict over the group, one flattened
        all-reduce a bucket, in reverse production order; keys
        registered as sparse carry ``(ids, values)`` pairs and come back
        dense. Returns a dict with the same keys."""
        t0 = time.perf_counter()
        out = {}
        for key, sb in self.sparse.items():
            if key in grads:
                ids, values = grads[key]
                out[key] = coalesce_sparse_grad(
                    ids, values, sb.rows, gather=(self.axis_size or 1) > 1)
        for b in self.buckets:
            reduce_bucket(b, grads, out)
        self.collectives += len(self.buckets)
        self.step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def stats(self):
        """Host-held summary (zero device syncs)."""
        sizes = [b.nbytes for b in self.buckets]
        out = {
            "buckets": len(self.buckets),
            "bucket_bytes": sizes,
            "bucket_bytes_model": choose_bucket_bytes(),
            "bucket_bytes_plan": self.bucket_bytes,
            "comm_bytes": self.comm_bytes,
            "overlap_ms": estimate_overlap_ms(sizes, self.axis_size or 1),
        }
        if self.sparse:
            out["sparse_buckets"] = len(self.sparse)
            out["sparse_comm_bytes"] = self.sparse_comm_bytes
            out["sparse_densified_bytes"] = self.sparse_densified_bytes
            if self.sparse_comm_bytes:
                out["sparse_compression"] = round(
                    self.sparse_densified_bytes
                    / self.sparse_comm_bytes, 3)
        return out


def estimate_overlap_ms(bucket_nbytes, axis_size, link_bytes_per_s=None):
    """Model-estimated collective time a backend that overlaps could hide
    under the backward: the ring all-reduce time of every bucket but the
    last to close."""
    if axis_size <= 1 or len(bucket_nbytes) <= 1:
        return 0.0
    bw = link_bytes_per_s or _perfmodel.group_link_bytes_per_s()
    ring = 2.0 * (axis_size - 1) / axis_size
    return sum(ring * b / bw for b in bucket_nbytes[:-1]) * 1e3
