"""``symbol.contrib``: the symbolic constructor of every registered
``_contrib_*`` op under its short name (``contrib.FlashAttention``)."""
from .. import ops as _ops  # noqa: F401  (registers the ops)
from . import register as _register

_register.populate_contrib(__name__)
