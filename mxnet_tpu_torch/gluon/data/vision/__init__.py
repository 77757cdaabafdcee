"""Vision transforms (counterpart of ``mxnet_tpu/gluon/data/vision/``);
the datasets wait for ``recordio`` (ROADMAP A5)."""
from . import transforms  # noqa: F401
