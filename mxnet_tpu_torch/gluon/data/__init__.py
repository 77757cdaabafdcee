"""Gluon data API (counterpart of ``mxnet_tpu/gluon/data/``): datasets,
samplers, the DataLoader, and the vision datasets and transforms."""
from .dataset import *  # noqa: F401,F403
from .sampler import *  # noqa: F401,F403
from .dataloader import *  # noqa: F401,F403

from . import dataset  # noqa: F401
from . import sampler  # noqa: F401
from . import dataloader  # noqa: F401
from . import vision  # noqa: F401
