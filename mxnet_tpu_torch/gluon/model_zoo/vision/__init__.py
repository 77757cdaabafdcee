"""Vision model zoo (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/__init__.py``): ``get_model`` over
the JAX package's names. The ten ResNets are ported; the other networks
(AlexNet, DenseNet, Inception v3, MobileNet v1/v2, SqueezeNet, VGG) are
named here and raise (ROADMAP A3b.5b)."""
from ....base import MXNetError
from .resnet import *  # noqa: F401,F403
from . import resnet as _resnet

_NOT_PORTED = (
    "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn", "vgg16_bn",
    "vgg19_bn", "alexnet", "densenet121", "densenet161", "densenet169",
    "densenet201", "squeezenet1.0", "squeezenet1.1", "inceptionv3",
    "mobilenet1.0", "mobilenet0.75", "mobilenet0.5", "mobilenet0.25",
    "mobilenetv2_1.0", "mobilenetv2_0.75", "mobilenetv2_0.5",
    "mobilenetv2_0.25")


def get_model(name, **kwargs):
    """The model constructor of a zoo name, called with ``kwargs``."""
    models = {"resnet%d_v%d" % (n, v): getattr(_resnet,
                                                "resnet%d_v%d" % (n, v))
              for n in (18, 34, 50, 101, 152) for v in (1, 2)}
    name = name.lower()
    if name in _NOT_PORTED:
        raise MXNetError("model %s is not ported yet (ROADMAP A3b.5b); the "
                         "ResNets are" % name)
    if name not in models:
        raise ValueError(
            "Model %s is not supported. Available options are:\n\t%s"
            % (name, "\n\t".join(sorted(list(models) + list(_NOT_PORTED)))))
    return models[name](**kwargs)
