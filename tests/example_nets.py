"""BASELINE configurations 1 and 3's Module and Gluon examples, spelled
over a package argument so that the JAX package and the port build the
same models from the same data.

* ``sr_net(gluon, upscale)``: ``examples/super_resolution.py``'s ESPCN
  ``SuperResolutionNet`` (64-64-32-r^2 filters at 5/3/3/3, then
  ``depth_to_space``); ``synthetic_pairs`` and ``psnr`` are the
  example's, numpy only.
* ``mlp_symbol(sym)`` and ``mnist_data()``: ``examples/train_mnist.py``'s
  MLP and its synthetic stand-in (2048 images of seed 0, the last 512
  held out).
* ``cifar_data()``: ``examples/train_cifar10.py``'s synthetic stand-in;
  its network is ``models.resnet_symbol(10, 20, (3, 28, 28))`` in
  either package.

Pass ``mxnet_tpu_torch`` (as ``chip_smoke.py`` does) or ``mxnet_tpu``;
nothing here imports either. The tests hold these spellings to the
examples' own graphs (``tests/test_torch_port_super_resolution.py``).
"""
import math

import numpy as np


def sr_net(gluon, upscale_factor=2, **kwargs):
    """An ESPCN ``SuperResolutionNet`` of ``gluon``'s package."""
    class SuperResolutionNet(gluon.HybridBlock):
        def __init__(self, upscale_factor, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.conv1 = gluon.nn.Conv2D(64, (5, 5), padding=(2, 2),
                                             activation="relu")
                self.conv2 = gluon.nn.Conv2D(64, (3, 3), padding=(1, 1),
                                             activation="relu")
                self.conv3 = gluon.nn.Conv2D(32, (3, 3), padding=(1, 1),
                                             activation="relu")
                self.conv4 = gluon.nn.Conv2D(upscale_factor ** 2, (3, 3),
                                             padding=(1, 1))
            self.upscale_factor = upscale_factor

        def hybrid_forward(self, F, x):
            x = self.conv4(self.conv3(self.conv2(self.conv1(x))))
            return F.depth_to_space(x, block_size=self.upscale_factor)

    return SuperResolutionNet(upscale_factor, **kwargs)


def synthetic_pairs(n=128, size=32, factor=2, seed=0):
    """Band-limited random images (low, high resolution), as the
    example makes them."""
    rng = np.random.RandomState(seed)
    hi = []
    for _ in range(n):
        freq = rng.randn(6, 6)
        img = np.zeros((size * factor, size * factor), np.float32)
        xs = np.linspace(0, 2 * np.pi, size * factor)
        for i in range(6):
            for j in range(6):
                img += freq[i, j] * np.outer(np.sin((i + 1) * xs / 2),
                                             np.cos((j + 1) * xs / 2))
        img = (img - img.min()) / (np.ptp(img) + 1e-6)
        hi.append(img.astype(np.float32))
    hi = np.stack(hi)[:, None]
    return hi[:, :, ::factor, ::factor], hi


def psnr(pred, target):
    mse = float(np.mean((pred - target) ** 2))
    return 10 * math.log10(1.0 / max(mse, 1e-10))


def mlp_symbol(sym):
    data = sym.Variable("data")
    net = sym.Flatten(data)
    net = sym.FullyConnected(net, num_hidden=128, name="fc1")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=64, name="fc2")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=10, name="fc3")
    return sym.SoftmaxOutput(net, name="softmax")


def mnist_data(n=2048):
    """(X_train, y_train, X_val, y_val): class-dependent blobs."""
    rng = np.random.RandomState(0)
    y = rng.randint(0, 10, n).astype(np.float32)
    X = rng.rand(n, 1, 28, 28).astype(np.float32) * 0.1
    for i in range(n):
        c = int(y[i])
        X[i, 0, 2 * c:2 * c + 6, 4:24] += 0.8
    cut = n - 512
    return X[:cut], y[:cut], X[cut:], y[cut:]


def cifar_data(n=2048):
    """(X_train, y_train, X_val, y_val): class-dependent colour patches."""
    rng = np.random.RandomState(0)
    y = rng.randint(0, 10, n).astype(np.float32)
    X = rng.rand(n, 3, 28, 28).astype(np.float32) * 0.1
    for i in range(n):
        c = int(y[i])
        X[i, c % 3, 2 * (c // 3):2 * (c // 3) + 8, 6:22] += 0.9
    cut = n - 512
    return X[:cut], y[:cut], X[cut:], y[cut:]
