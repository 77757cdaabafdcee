"""Optimizers: the ``Optimizer`` base, ``SGD`` (with momentum),
``Adam``, ``AdaGrad`` and ``GroupAdaGrad`` (with their lazy row updates
for row-sparse gradients), their registry, and the eager ``Updater``."""
from .optimizer import (SGD, AdaGrad, Adam, GroupAdaGrad,  # noqa: F401
                        Optimizer, Updater, create, get_updater, register)
