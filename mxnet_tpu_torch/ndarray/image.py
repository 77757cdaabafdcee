"""``nd.image`` (counterpart of ``mxnet_tpu/ndarray/image.py``): every
registered ``_image_X`` op as ``X`` (``resize``, ``crop``,
``to_tensor``, ``normalize``, the flips and the random colour ops),
eager."""
from .. import ops as _ops  # noqa: F401  (registers the ops)
from ..ops import registry as _registry
from . import register as _register


def _populate():
    for name in _registry.list_ops():
        if name.startswith("_image_"):
            globals()[name[len("_image_"):]] = _register._make_op_func(
                _registry.get(name))


_populate()
