"""Symbolic AlexNet builder (Krizhevsky et al. 2012): the graph of the
JAX package's ``models/alexnet.py``, node for node, over the port's
symbol API: convolutions, ReLUs, two ``LRN`` (nsize 5, alpha 1e-4,
beta 0.75, knorm 2), max pools and three FullyConnected layers with
dropout 0.5 between them. No BatchNorm, so no B1; the fusion pass
(``kernels/graph_fuse.py``) runs fc6 and fc7, each a FullyConnected with
a bias followed by a ReLU, as the FullyConnected without its bias and
one ``scale_bias_act`` kernel (B5) for bias and ReLU.
"""
from __future__ import annotations

from .. import symbol as sym

__all__ = ["get_symbol", "alexnet"]


def get_symbol(num_classes=1000, dtype="float32", **kwargs):
    data = sym.Variable("data")
    c1 = sym.Convolution(data, kernel=(11, 11), stride=(4, 4), num_filter=96,
                         name="conv1")
    r1 = sym.Activation(c1, act_type="relu")
    l1 = sym.LRN(r1, alpha=1e-4, beta=0.75, knorm=2, nsize=5)
    p1 = sym.Pooling(l1, kernel=(3, 3), stride=(2, 2), pool_type="max")
    c2 = sym.Convolution(p1, kernel=(5, 5), pad=(2, 2), num_filter=256,
                         name="conv2")
    r2 = sym.Activation(c2, act_type="relu")
    l2 = sym.LRN(r2, alpha=1e-4, beta=0.75, knorm=2, nsize=5)
    p2 = sym.Pooling(l2, kernel=(3, 3), stride=(2, 2), pool_type="max")
    c3 = sym.Convolution(p2, kernel=(3, 3), pad=(1, 1), num_filter=384,
                         name="conv3")
    r3 = sym.Activation(c3, act_type="relu")
    c4 = sym.Convolution(r3, kernel=(3, 3), pad=(1, 1), num_filter=384,
                         name="conv4")
    r4 = sym.Activation(c4, act_type="relu")
    c5 = sym.Convolution(r4, kernel=(3, 3), pad=(1, 1), num_filter=256,
                         name="conv5")
    r5 = sym.Activation(c5, act_type="relu")
    p5 = sym.Pooling(r5, kernel=(3, 3), stride=(2, 2), pool_type="max")
    f = sym.Flatten(p5)
    fc6 = sym.FullyConnected(f, num_hidden=4096, name="fc6")
    r6 = sym.Activation(fc6, act_type="relu")
    d6 = sym.Dropout(r6, p=0.5)
    fc7 = sym.FullyConnected(d6, num_hidden=4096, name="fc7")
    r7 = sym.Activation(fc7, act_type="relu")
    d7 = sym.Dropout(r7, p=0.5)
    fc8 = sym.FullyConnected(d7, num_hidden=num_classes, name="fc8")
    return sym.SoftmaxOutput(fc8, name="softmax")


alexnet = get_symbol
