"""Sequence-parallel attention helpers. Only the single-device
:func:`~.ring_attention.blockwise_attention` is ported so far."""
from .ring_attention import blockwise_attention  # noqa: F401
