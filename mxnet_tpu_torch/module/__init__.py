"""The training-loop surface: ``BaseModule.fit`` and ``Module``, with
the fused single-device train step (``FusedStep``)."""
from .base_module import BaseModule, BatchEndParam  # noqa: F401
from .fused import FusedStep  # noqa: F401
from .module import Module  # noqa: F401
