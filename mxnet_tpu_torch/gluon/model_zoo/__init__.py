"""Model zoo (counterpart of ``mxnet_tpu/gluon/model_zoo/``): the
vision networks and ``get_model``."""
from . import vision  # noqa: F401
from .vision import get_model  # noqa: F401
