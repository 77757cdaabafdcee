"""Recurrent layers and cells (counterpart of ``mxnet_tpu/gluon/rnn/``)."""
from .rnn_cell import *  # noqa: F401,F403
from .rnn_layer import *  # noqa: F401,F403

from . import rnn_cell  # noqa: F401
from . import rnn_layer  # noqa: F401
