"""Operator library: importing this package registers every op."""
from . import registry  # noqa: F401
from . import nn, elemwise, matrix, pallas_flash, quant_serve  # noqa: F401
from ..kernels import mlp  # noqa: F401,E402  (_contrib_FusedScaleBiasGeLU)
