"""Optimizers: the ``Optimizer`` base, ``SGD`` (with momentum),
``NAG``, ``Adam``, ``AdaGrad`` and ``GroupAdaGrad`` (with their lazy row
updates for row-sparse gradients), ``AdaDelta``, ``RMSProp``, ``Ftrl``,
``Signum``, ``SignSGD``, ``FTML``, ``Nadam``, ``DCASGD``, ``LBSGD`` and
the kvstore tests' ``Test``,
their registry, and the eager ``Updater``."""
from .optimizer import (DCASGD, FTML, LBSGD, NAG, SGD,  # noqa: F401
                        AdaDelta, AdaGrad, Adam, Ftrl, GroupAdaGrad,
                        Nadam, Optimizer, RMSProp, Signum, SignSGD, Test,
                        Updater,
                        create, get_updater, register)
