"""Legacy operator aliases (counterpart of a part of
``mxnet_tpu/ops/legacy_aliases.py``): ``_rnn_param_concat``, the concat
the Gluon RNN layers flatten their parameters with. The rest of that
file is not ported yet (ROADMAP A9)."""
from __future__ import annotations

import torch

from .registry import register


@register("_rnn_param_concat")
def rnn_param_concat(*data, dim=0):
    """Concat of the RNN parameter pieces along ``dim``."""
    return torch.cat(data, dim=dim)
