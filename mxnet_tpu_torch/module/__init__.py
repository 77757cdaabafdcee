"""The training-loop surface: ``BaseModule.fit``, ``Module``, with the
fused single-device train step (``FusedStep``), and
``BucketingModule``."""
from .base_module import BaseModule, BatchEndParam  # noqa: F401
from .fused import FusedStep  # noqa: F401
from .module import Module  # noqa: F401
from .bucketing_module import BucketingModule  # noqa: F401
