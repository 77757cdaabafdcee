"""Embedding tables: the per-row initializer and the gather.

Counterpart of ``mxnet_tpu/embed/table.py``. :func:`row_init` is the
JAX package's numpy code, bit for bit: a row has the same values
whether the spill store, a dense table or a reference run makes it.
:func:`local_gather` is the tier's row gather (B2, ``take_rows``, on a
CUDA table; its plain version on a CPU one). The mesh-sharded lookup
(``sharded_lookup``, ``ShardedEmbedding``: an all-to-all inside
``shard_map``) is distributed training, not ported yet (ROADMAP A6d);
both raise.
"""
from __future__ import annotations

import numpy as _np

from ..base import MXNetError
from ..kernels import take as _take

__all__ = ["ShardedEmbedding", "sharded_lookup", "local_gather",
           "row_init"]


def row_init(seed, row_ids, dim, dtype="float32", scale=0.01):
    """Deterministic per-row initializer: row ``r`` is
    ``standard_normal(dim) * scale`` from a Philox generator keyed by
    ``(seed, r)``, so it costs one draw per touched row and does not
    depend on the order rows are made in."""
    rows = _np.atleast_1d(_np.asarray(row_ids, dtype=_np.int64))
    out = _np.empty((rows.size, dim), dtype=_np.dtype(dtype))
    for i, r in enumerate(rows):
        g = _np.random.Generator(_np.random.Philox(key=[seed, int(r)]))
        out[i] = (g.standard_normal(dim) * scale).astype(out.dtype)
    return out


def local_gather(shard, idx):
    """Rows of ``shard`` (rows, dim) at ``idx``, ids clipped to the
    table: the kernel tier's gather (``kernels.take.gather_pages``, B2
    on a CUDA table where the tier and guard allow), else the same
    clipped gather in plain torch. Dispatch never changes the values."""
    return _take.gather_pages(shard, idx)


def sharded_lookup(*args, **kwargs):
    raise MXNetError("embed.sharded_lookup: the mesh-sharded lookup is "
                     "distributed training, not ported yet (ROADMAP A6d)")


class ShardedEmbedding:
    """Not ported yet (ROADMAP A6d): raises."""

    def __init__(self, *args, **kwargs):
        raise MXNetError("embed.ShardedEmbedding: mesh-sharded tables are "
                         "distributed training, not ported yet "
                         "(ROADMAP A6d)")
