"""gluon.contrib.nn (counterpart of ``mxnet_tpu/gluon/contrib/nn/``):
``SparseEmbedding``. Its siblings (``Concurrent``, ``HybridConcurrent``,
``Identity``, ``SyncBatchNorm``) are not ported yet (ROADMAP A3b) and
raise."""
from __future__ import annotations

from ....base import MXNetError
from ...nn.basic_layers import Embedding

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm"]


class SparseEmbedding(Embedding):
    """Embedding whose weight gradient is row-sparse: the Trainer casts
    it with ``cast_storage`` and the optimizer updates only the rows it
    holds. ``gluon.nn.Embedding(sparse_grad=True)``, one gather."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(input_dim, output_dim, dtype=dtype,
                         weight_initializer=weight_initializer,
                         sparse_grad=True, **kwargs)

    def __repr__(self):
        return "SparseEmbedding(%s -> %s)" % (self._kwargs["input_dim"],
                                              self._kwargs["output_dim"])


def _not_ported(name):
    def __init__(self, *args, **kwargs):
        raise MXNetError("gluon.contrib.nn.%s is not ported yet "
                         "(ROADMAP A3b)" % name)
    return type(name, (), {"__init__": __init__,
                           "__doc__": "Not ported yet (ROADMAP A3b)."})


Concurrent = _not_ported("Concurrent")
HybridConcurrent = _not_ported("HybridConcurrent")
Identity = _not_ported("Identity")
SyncBatchNorm = _not_ported("SyncBatchNorm")
