"""Embeddings (counterpart of ``mxnet_tpu/embed/``): the per-row
initializer and the tier's gather (:mod:`.table`), the hot-row cache on
the card over a host spill store (:mod:`.cache`), and the recommend
serving path (:mod:`.serve`): format_version 6 artifacts and the
cache-backed engine that ``Server`` runs in recommend mode. The
mesh-sharded lookup raises (ROADMAP A6d)."""
from __future__ import annotations

from .table import (ShardedEmbedding, sharded_lookup, local_gather,
                    row_init)
from .cache import HotRowCache, SpillStore

__all__ = ["ShardedEmbedding", "sharded_lookup", "local_gather",
           "row_init", "HotRowCache", "SpillStore"]
