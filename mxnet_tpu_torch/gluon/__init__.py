"""Gluon, the imperative API (counterpart of ``mxnet_tpu/gluon/``):
Parameter, Block, HybridBlock, Trainer, ``nn``, ``loss``, ``utils``,
``data``, ``model_zoo`` (its ResNets) and ``contrib.nn.SparseEmbedding``.
``SymbolBlock``, ``rnn`` and the rest of ``contrib`` are not ported yet
(ROADMAP A3b, A9)."""
from .parameter import (Constant, DeferredInitializationError,  # noqa: F401
                        Parameter, ParameterDict)
from .block import Block, HybridBlock  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import nn  # noqa: F401
from . import loss  # noqa: F401
from . import utils  # noqa: F401
from . import data  # noqa: F401
from . import model_zoo  # noqa: F401
from . import contrib  # noqa: F401

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError", "Block", "HybridBlock", "Trainer",
           "nn", "loss", "utils", "data", "model_zoo", "contrib"]
