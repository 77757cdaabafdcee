"""gluon.contrib (counterpart of ``mxnet_tpu/gluon/contrib/``): ``nn``
with the tower containers, ``Identity`` and ``SparseEmbedding``. Its
``rnn`` and ``data`` are not ported yet (ROADMAP A9)."""
from . import nn  # noqa: F401
