"""Symbolic model builders: ``models.resnet(num_layers=50, ...)``, the
reference-style ``models.resnet_symbol(..., image_shape="3,224,224")``,
``inception_v3_symbol``, ``alexnet_symbol``, ``lenet`` and ``mlp`` (the
JAX package's ``models`` names), and the GPT language model
``models.gpt_lm(vocab, dim, heads, layers, seq_len)``."""
from . import resnet  # noqa: F401
from .alexnet import get_symbol as alexnet_symbol  # noqa: F401
from .gpt import gpt_lm, make_copy_batch  # noqa: F401
from .inception_v3 import get_symbol as inception_v3_symbol  # noqa: F401
from .resnet import get_symbol as resnet_symbol  # noqa: F401
from .resnet import resnet  # noqa: F401


def lenet(num_classes=10):
    """LeNet, the JAX package's (``train_mnist.py``'s model)."""
    from .. import symbol as sym
    data = sym.Variable("data")
    c1 = sym.Convolution(data=data, kernel=(5, 5), num_filter=20, name="conv1")
    t1 = sym.Activation(c1, act_type="tanh")
    p1 = sym.Pooling(t1, pool_type="max", kernel=(2, 2), stride=(2, 2))
    c2 = sym.Convolution(p1, kernel=(5, 5), num_filter=50, name="conv2")
    t2 = sym.Activation(c2, act_type="tanh")
    p2 = sym.Pooling(t2, pool_type="max", kernel=(2, 2), stride=(2, 2))
    f = sym.Flatten(p2)
    fc1 = sym.FullyConnected(f, num_hidden=500, name="fc1")
    t3 = sym.Activation(fc1, act_type="tanh")
    fc2 = sym.FullyConnected(t3, num_hidden=num_classes, name="fc2")
    return sym.SoftmaxOutput(fc2, name="softmax")


def mlp(num_classes=10, hidden=(128, 64)):
    """The JAX package's multilayer perceptron (``train_mnist.py``)."""
    from .. import symbol as sym
    net = sym.Variable("data")
    net = sym.Flatten(net)
    for i, h in enumerate(hidden):
        net = sym.FullyConnected(net, num_hidden=h, name="fc%d" % (i + 1))
        net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=num_classes,
                             name="fc%d" % (len(hidden) + 1))
    return sym.SoftmaxOutput(net, name="softmax")
