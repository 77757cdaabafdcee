"""gluon.contrib.nn (counterpart of ``mxnet_tpu/gluon/contrib/nn/``):
the tower containers ``Concurrent`` and ``HybridConcurrent``,
``Identity`` and ``SparseEmbedding``. ``SyncBatchNorm`` is not ported
yet (ROADMAP A3b) and raises."""
from __future__ import annotations

from ....base import MXNetError
from ...block import HybridBlock
from ...nn.basic_layers import Embedding, HybridSequential, Sequential

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm"]


class Concurrent(Sequential):
    """Feeds one input to every child and concatenates their outputs
    along ``axis`` (the Inception-tower container)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        from .... import ndarray as nd
        return nd.concat(*[block(x) for block in self._children.values()],
                         dim=self.axis)


class HybridConcurrent(HybridSequential):
    """Hybridizable ``Concurrent``."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def hybrid_forward(self, F, x):
        return F.concat(*[block(x) for block in self._children.values()],
                        dim=self.axis)


class Identity(HybridBlock):
    """Pass-through block: the skip branch of a ``Concurrent`` tower."""

    def hybrid_forward(self, F, x):
        return x


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


class SyncBatchNorm:
    """Not ported yet (ROADMAP A3b)."""

    def __init__(self, *args, **kwargs):
        raise MXNetError("gluon.contrib.nn.SyncBatchNorm is not ported yet "
                         "(ROADMAP A3b)")
