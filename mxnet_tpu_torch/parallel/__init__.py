"""The process group (one process, ``dist``) and sequence-parallel
attention helpers (the single-device
:func:`~.ring_attention.blockwise_attention` only)."""
from . import dist  # noqa: F401
from .ring_attention import blockwise_attention  # noqa: F401
