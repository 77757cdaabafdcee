"""Symbolic API: ``Variable``, the graph containers, JSON save and load
(``Symbol.save``, ``load``, ``load_json``), and one
constructor per registered op (``symbol.Convolution(...)``), and the
``contrib`` namespace (``symbol.contrib.FlashAttention(...)``)."""
from .. import ops as _ops  # noqa: F401  (registers the ops)
from .symbol import (Group, Symbol, Variable, load, load_json,  # noqa: F401
                     var)
from . import register as _register

_register.populate(__name__)

from . import contrib  # noqa: E402,F401
