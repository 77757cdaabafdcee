"""Neural network layers (counterpart of ``mxnet_tpu/gluon/nn/``). The
convolution layers (``conv_layers.py``) are not ported yet (ROADMAP
A3b)."""
from .activations import *  # noqa: F401,F403
from .basic_layers import *  # noqa: F401,F403

from . import activations  # noqa: F401
from . import basic_layers  # noqa: F401
