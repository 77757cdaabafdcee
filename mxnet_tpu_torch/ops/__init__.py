"""Operator library: importing this package registers every op."""
from . import registry  # noqa: F401
from . import (nn, elemwise, matrix, reduce, init_ops,  # noqa: F401
               pallas_flash, quant_serve, random_ops, image_ops,
               legacy_aliases, contrib_ops, vision_ops, custom_op)
from ..kernels import mlp  # noqa: F401,E402  (_contrib_FusedScaleBiasGeLU)
from ..kernels import bn_act  # noqa: F401,E402  (_contrib_FusedBNAct)
