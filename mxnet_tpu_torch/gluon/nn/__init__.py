"""Neural network layers (counterpart of ``mxnet_tpu/gluon/nn/``):
the basic layers, the activations, and the convolution and pooling
layers (``conv_layers.py``)."""
from .activations import *  # noqa: F401,F403
from .basic_layers import *  # noqa: F401,F403
from .conv_layers import *  # noqa: F401,F403

from . import activations  # noqa: F401
from . import basic_layers  # noqa: F401
from . import conv_layers  # noqa: F401
