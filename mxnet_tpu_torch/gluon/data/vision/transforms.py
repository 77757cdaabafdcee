"""Vision transforms (counterpart of
``mxnet_tpu/gluon/data/vision/transforms.py``): Compose, Cast, ToTensor,
Normalize, Resize, CenterCrop, RandomResizedCrop, the random flips and
the colour family, over the ``_image_*`` ops. The random ones draw from
the key chain, except RandomResizedCrop, which draws its window from
Python's ``random`` module, as the JAX package's does."""
from __future__ import annotations

import random as _pyrandom

from ....ndarray import ndarray as _nd
from ...block import Block, HybridBlock
from ...nn import Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomResizedCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast",
           "RandomSaturation", "RandomHue", "RandomColorJitter",
           "RandomLighting"]


class Compose(Sequential):
    """Transforms applied in order."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return F.Cast(x, dtype=self._dtype)


class ToTensor(HybridBlock):
    """HWC uint8 [0,255] -> CHW float32 [0,1]."""

    def hybrid_forward(self, F, x):
        return F._image_to_tensor(x)


class Normalize(HybridBlock):
    def __init__(self, mean, std):
        super().__init__()
        self._mean = mean
        self._std = std

    def hybrid_forward(self, F, x):
        return F._image_normalize(x, mean=self._mean, std=self._std)


class Resize(HybridBlock):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio
        self._interpolation = interpolation

    def hybrid_forward(self, F, x):
        size = self._size
        if self._keep and isinstance(size, int):
            h, w = x.shape[-3], x.shape[-2]
            if h > w:
                size = (size, int(size * h / w))
            else:
                size = (int(size * w / h), size)
        return F._image_resize(x, size=size, interp=self._interpolation)


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        if isinstance(size, int):
            size = (size, size)
        self._size = size  # (w, h)
        self._interpolation = interpolation

    def forward(self, x):
        ow, oh = self._size
        h, w = x.shape[-3], x.shape[-2]
        if h < oh or w < ow:
            x = _nd.invoke("_image_resize", [x],
                           {"size": (max(ow, w), max(oh, h)),
                            "interp": self._interpolation})
            h, w = x.shape[-3], x.shape[-2]
        x0 = int((w - ow) / 2)
        y0 = int((h - oh) / 2)
        return _nd.invoke("_image_crop", [x],
                          {"x": x0, "y": y0, "width": ow, "height": oh})


class RandomResizedCrop(Block):
    """Random area/aspect crop then resize (reference RandomResizedCrop)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interpolation=1):
        super().__init__()
        if isinstance(size, int):
            size = (size, size)
        self._size = size
        self._scale = scale
        self._ratio = ratio
        self._interpolation = interpolation

    def forward(self, x):
        import math
        h, w = int(x.shape[-3]), int(x.shape[-2])
        area = h * w
        for _ in range(10):
            target_area = _pyrandom.uniform(*self._scale) * area
            log_ratio = (math.log(self._ratio[0]), math.log(self._ratio[1]))
            aspect = math.exp(_pyrandom.uniform(*log_ratio))
            cw = int(round(math.sqrt(target_area * aspect)))
            ch = int(round(math.sqrt(target_area / aspect)))
            if cw <= w and ch <= h:
                x0 = _pyrandom.randint(0, w - cw)
                y0 = _pyrandom.randint(0, h - ch)
                crop = _nd.invoke("_image_crop", [x],
                                  {"x": x0, "y": y0, "width": cw,
                                   "height": ch})
                return _nd.invoke("_image_resize", [crop],
                                  {"size": self._size,
                                   "interp": self._interpolation})
        # fallback: center crop
        return CenterCrop(self._size, self._interpolation)(x)


class RandomFlipLeftRight(HybridBlock):
    def hybrid_forward(self, F, x):
        return F._image_random_flip_left_right(x)


class RandomFlipTopBottom(HybridBlock):
    def hybrid_forward(self, F, x):
        return F._image_random_flip_top_bottom(x)


class RandomBrightness(HybridBlock):
    def __init__(self, brightness):
        super().__init__()
        self._args = (max(0.0, 1 - brightness), 1 + brightness)

    def hybrid_forward(self, F, x):
        return F._image_random_brightness(x, min_factor=self._args[0],
                                          max_factor=self._args[1])


class RandomContrast(HybridBlock):
    def __init__(self, contrast):
        super().__init__()
        self._args = (max(0.0, 1 - contrast), 1 + contrast)

    def hybrid_forward(self, F, x):
        return F._image_random_contrast(x, min_factor=self._args[0],
                                        max_factor=self._args[1])


class RandomSaturation(HybridBlock):
    def __init__(self, saturation):
        super().__init__()
        self._args = (max(0.0, 1 - saturation), 1 + saturation)

    def hybrid_forward(self, F, x):
        return F._image_random_saturation(x, min_factor=self._args[0],
                                          max_factor=self._args[1])


class RandomHue(HybridBlock):
    def __init__(self, hue):
        super().__init__()
        self._args = (max(0.0, 1 - hue), 1 + hue)

    def hybrid_forward(self, F, x):
        return F._image_random_hue(x, min_factor=self._args[0],
                                   max_factor=self._args[1])


class RandomColorJitter(HybridBlock):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._args = {"brightness": brightness, "contrast": contrast,
                      "saturation": saturation, "hue": hue}

    def hybrid_forward(self, F, x):
        return F._image_random_color_jitter(x, **self._args)


class RandomLighting(HybridBlock):
    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F._image_random_lighting(x, alpha_std=self._alpha)
