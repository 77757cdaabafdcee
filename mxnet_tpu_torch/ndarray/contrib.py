"""``ndarray.contrib``: every registered ``_contrib_*`` op under its
short name (``contrib.FlashAttention``), eager. The control-flow ops of
the JAX package's ``ndarray/contrib.py`` (``foreach``, ``while_loop``,
``cond``) are not ported yet (ROADMAP A3b)."""
from .. import ops as _ops  # noqa: F401  (registers the ops)
from . import register as _register

_register.populate_contrib(__name__)
