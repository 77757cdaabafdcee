"""Symbolic Inception-v3 builder: the graph of the JAX package's
``models/inception_v3.py``, node for node, over the port's symbol API
(Szegedy et al., "Rethinking the Inception Architecture", 2015).

Every tower is built from ``_cb``: convolution -> BatchNorm(fix_gamma,
eps 1e-3) -> ReLU, 94 of them in the whole net; ``kernels/graph_fuse.py``
fuses each BatchNorm -> ReLU into one ``bn_act`` launch when the graph
runs. Input is the canonical 3x299x299 (works down to 3x139x139).
"""
from __future__ import annotations

from .. import symbol as sym

__all__ = ["get_symbol", "inception_v3"]


def _cb(data, num_filter, kernel, stride=(1, 1), pad=(0, 0), name=""):
    """conv + BN + relu, the unit every tower is built from."""
    c = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad, no_bias=True,
                        name="%s_conv" % name)
    b = sym.BatchNorm(c, eps=0.001, fix_gamma=True, name="%s_bn" % name)
    return sym.Activation(b, act_type="relu")


def _pool(data, kernel, stride, pad=(0, 0), pool_type="max", name=""):
    return sym.Pooling(data, kernel=kernel, stride=stride, pad=pad,
                       pool_type=pool_type, name=name)


def _tower_a(data, pool_filters, name):
    """35x35 mix: 1x1 / 5x5 / double-3x3 / pool towers."""
    t1 = _cb(data, 64, (1, 1), name=name + "_t1_1x1")
    t2 = _cb(data, 48, (1, 1), name=name + "_t2_1x1")
    t2 = _cb(t2, 64, (5, 5), pad=(2, 2), name=name + "_t2_5x5")
    t3 = _cb(data, 64, (1, 1), name=name + "_t3_1x1")
    t3 = _cb(t3, 96, (3, 3), pad=(1, 1), name=name + "_t3_3x3a")
    t3 = _cb(t3, 96, (3, 3), pad=(1, 1), name=name + "_t3_3x3b")
    t4 = _pool(data, (3, 3), (1, 1), (1, 1), "avg", name + "_t4_pool")
    t4 = _cb(t4, pool_filters, (1, 1), name=name + "_t4_1x1")
    return sym.Concat(t1, t2, t3, t4, dim=1, name=name)


def _tower_b(data, name):
    """35x35 -> 17x17 grid reduction."""
    t1 = _cb(data, 384, (3, 3), stride=(2, 2), name=name + "_t1_3x3")
    t2 = _cb(data, 64, (1, 1), name=name + "_t2_1x1")
    t2 = _cb(t2, 96, (3, 3), pad=(1, 1), name=name + "_t2_3x3a")
    t2 = _cb(t2, 96, (3, 3), stride=(2, 2), name=name + "_t2_3x3b")
    t3 = _pool(data, (3, 3), (2, 2), name=name + "_t3_pool")
    return sym.Concat(t1, t2, t3, dim=1, name=name)


def _tower_c(data, c7, name):
    """17x17 mix with factorized 7x7 (1x7 then 7x1)."""
    t1 = _cb(data, 192, (1, 1), name=name + "_t1_1x1")
    t2 = _cb(data, c7, (1, 1), name=name + "_t2_1x1")
    t2 = _cb(t2, c7, (1, 7), pad=(0, 3), name=name + "_t2_1x7")
    t2 = _cb(t2, 192, (7, 1), pad=(3, 0), name=name + "_t2_7x1")
    t3 = _cb(data, c7, (1, 1), name=name + "_t3_1x1")
    t3 = _cb(t3, c7, (7, 1), pad=(3, 0), name=name + "_t3_7x1a")
    t3 = _cb(t3, c7, (1, 7), pad=(0, 3), name=name + "_t3_1x7a")
    t3 = _cb(t3, c7, (7, 1), pad=(3, 0), name=name + "_t3_7x1b")
    t3 = _cb(t3, 192, (1, 7), pad=(0, 3), name=name + "_t3_1x7b")
    t4 = _pool(data, (3, 3), (1, 1), (1, 1), "avg", name + "_t4_pool")
    t4 = _cb(t4, 192, (1, 1), name=name + "_t4_1x1")
    return sym.Concat(t1, t2, t3, t4, dim=1, name=name)


def _tower_d(data, name):
    """17x17 -> 8x8 grid reduction."""
    t1 = _cb(data, 192, (1, 1), name=name + "_t1_1x1")
    t1 = _cb(t1, 320, (3, 3), stride=(2, 2), name=name + "_t1_3x3")
    t2 = _cb(data, 192, (1, 1), name=name + "_t2_1x1")
    t2 = _cb(t2, 192, (1, 7), pad=(0, 3), name=name + "_t2_1x7")
    t2 = _cb(t2, 192, (7, 1), pad=(3, 0), name=name + "_t2_7x1")
    t2 = _cb(t2, 192, (3, 3), stride=(2, 2), name=name + "_t2_3x3")
    t3 = _pool(data, (3, 3), (2, 2), name=name + "_t3_pool")
    return sym.Concat(t1, t2, t3, dim=1, name=name)


def _tower_e(data, name):
    """8x8 mix with expanded 3x3 (1x3 + 3x1 branches concatenated)."""
    t1 = _cb(data, 320, (1, 1), name=name + "_t1_1x1")
    t2 = _cb(data, 384, (1, 1), name=name + "_t2_1x1")
    t2a = _cb(t2, 384, (1, 3), pad=(0, 1), name=name + "_t2_1x3")
    t2b = _cb(t2, 384, (3, 1), pad=(1, 0), name=name + "_t2_3x1")
    t3 = _cb(data, 448, (1, 1), name=name + "_t3_1x1")
    t3 = _cb(t3, 384, (3, 3), pad=(1, 1), name=name + "_t3_3x3")
    t3a = _cb(t3, 384, (1, 3), pad=(0, 1), name=name + "_t3_1x3")
    t3b = _cb(t3, 384, (3, 1), pad=(1, 0), name=name + "_t3_3x1")
    t4 = _pool(data, (3, 3), (1, 1), (1, 1), "avg", name + "_t4_pool")
    t4 = _cb(t4, 192, (1, 1), name=name + "_t4_1x1")
    return sym.Concat(t1, t2a, t2b, t3a, t3b, t4, dim=1, name=name)


def _stem(data):
    """Factorized stem: 299x299x3 -> 35x35x192."""
    net = _cb(data, 32, (3, 3), stride=(2, 2), name="stem1")
    net = _cb(net, 32, (3, 3), name="stem2")
    net = _cb(net, 64, (3, 3), pad=(1, 1), name="stem3")
    net = _pool(net, (3, 3), (2, 2), name="stem_pool1")
    net = _cb(net, 80, (1, 1), name="stem4")
    net = _cb(net, 192, (3, 3), name="stem5")
    return _pool(net, (3, 3), (2, 2), name="stem_pool2")


def get_symbol(num_classes=1000, dropout=0.5, **kwargs):
    net = _stem(sym.Variable("data"))
    # 3x A (35x35), reduce, 4x C (17x17), reduce, 2x E (8x8)
    net = _tower_a(net, 32, "mixed0")
    net = _tower_a(net, 64, "mixed1")
    net = _tower_a(net, 64, "mixed2")
    net = _tower_b(net, "mixed3")
    net = _tower_c(net, 128, "mixed4")
    net = _tower_c(net, 160, "mixed5")
    net = _tower_c(net, 160, "mixed6")
    net = _tower_c(net, 192, "mixed7")
    net = _tower_d(net, "mixed8")
    net = _tower_e(net, "mixed9")
    net = _tower_e(net, "mixed10")
    net = sym.Pooling(net, kernel=(8, 8), global_pool=True,
                      pool_type="avg", name="global_pool")
    if dropout:
        net = sym.Dropout(net, p=dropout)
    net = sym.Flatten(net)
    net = sym.FullyConnected(net, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(net, name="softmax")


inception_v3 = get_symbol
