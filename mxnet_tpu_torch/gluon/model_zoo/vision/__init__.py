"""Vision model zoo (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/__init__.py``): every network of the
JAX package's zoo (ResNet v1/v2, VGG with and without BatchNorm,
AlexNet, DenseNet, SqueezeNet, Inception v3, MobileNet v1/v2) and
``get_model`` over its names. ``pretrained=True`` raises: the published
weights are files the repo does not hold."""
from .alexnet import *  # noqa: F401,F403
from .densenet import *  # noqa: F401,F403
from .inception import *  # noqa: F401,F403
from .mobilenet import *  # noqa: F401,F403
from .resnet import *  # noqa: F401,F403
from .squeezenet import *  # noqa: F401,F403
from .vgg import *  # noqa: F401,F403
from . import densenet as _densenet, resnet as _resnet, vgg as _vgg

_MODELS = {
    **{"resnet%d_v%d" % (n, v): getattr(_resnet, "resnet%d_v%d" % (n, v))
       for n in (18, 34, 50, 101, 152) for v in (1, 2)},
    **{"vgg%d%s" % (n, bn): getattr(_vgg, "vgg%d%s" % (n, bn))
       for n in (11, 13, 16, 19) for bn in ("", "_bn")},
    "alexnet": alexnet,  # noqa: F405
    **{"densenet%d" % n: getattr(_densenet, "densenet%d" % n)
       for n in (121, 161, 169, 201)},
    "squeezenet1.0": squeezenet1_0,  # noqa: F405
    "squeezenet1.1": squeezenet1_1,  # noqa: F405
    "inceptionv3": inception_v3,  # noqa: F405
    "mobilenet1.0": mobilenet1_0,  # noqa: F405
    "mobilenet0.75": mobilenet0_75,  # noqa: F405
    "mobilenet0.5": mobilenet0_5,  # noqa: F405
    "mobilenet0.25": mobilenet0_25,  # noqa: F405
    "mobilenetv2_1.0": mobilenet_v2_1_0,  # noqa: F405
    "mobilenetv2_0.75": mobilenet_v2_0_75,  # noqa: F405
    "mobilenetv2_0.5": mobilenet_v2_0_5,  # noqa: F405
    "mobilenetv2_0.25": mobilenet_v2_0_25,  # noqa: F405
}


def get_model(name, **kwargs):
    """The model constructor of a zoo name, called with ``kwargs``."""
    name = name.lower()
    if name not in _MODELS:
        raise ValueError(
            "Model %s is not supported. Available options are:\n\t%s"
            % (name, "\n\t".join(sorted(_MODELS))))
    return _MODELS[name](**kwargs)
