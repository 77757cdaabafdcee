"""Eager NDArray package (counterpart of ``mxnet_tpu/ndarray/``): the
``NDArray`` type, its creation functions and one eager function per
registered op (``nd.FullyConnected(...)``), with the ``contrib``
namespace (``nd.contrib.FlashAttention(...)``), ``nd.image``, the samplers
(``nd.random.uniform(...)``) and the sparse storage types
(``nd.sparse.cast_storage(...)``)."""
from .. import ops as _ops  # noqa: F401  (registers the ops)
from .ndarray import (NDArray, arange, array, asnumpy_all,  # noqa: F401
                      concat, empty, full, invoke, load, ones, save,
                      waitall, zeros, zeros_like)
from . import register as _register

_register.populate(__name__)

from . import contrib  # noqa: E402,F401
from . import image  # noqa: E402,F401
from . import random  # noqa: E402,F401
from . import sparse  # noqa: E402,F401
from .sparse import csr_matrix, row_sparse_array  # noqa: E402,F401
