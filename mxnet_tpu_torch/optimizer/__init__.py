"""Optimizers: the ``Optimizer`` base, ``SGD`` (with momentum) and
``Adam``, their registry, and the eager ``Updater``."""
from .optimizer import (SGD, Adam, Optimizer, Updater, create,  # noqa: F401
                        get_updater, register)
