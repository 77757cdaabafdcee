"""Port parity for ``gluon.data`` (datasets, samplers, DataLoader), the
vision transforms and the 14 ``_image_*`` ops against the JAX package,
on the CPU.

Batches are bitwise equal to the JAX package's, with ``num_workers`` 0
and 2 (the workers batchify to numpy; the main process places the
batch), and so is ``RandomSampler``'s order under ``np.random.seed``.
Of the image ops, the flips (random or not), brightness, saturation,
hue, ``to_tensor``, ``normalize``, the crop and every uint8 or nearest
resize are bitwise under the same seed. Contrast (and the colour jitter
that contains it) reduces a mean, and a float resize contracts its
weights, in other orders than XLA: their draws are bitwise and their
values within ``RTOL`` = 1e-6 of the largest magnitude (measured: 2e-7
for jitter, 5.3e-7 for a cubic resize). Lighting is built on three
normal draws and takes the normal tolerance of
``test_torch_port_random.py``, 4 f32 ulp on its weights, which is well
inside ``RTOL`` of the image.
"""
import random

import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt

CPU = mt.cpu()
RTOL = 1e-6
IMG = np.random.RandomState(0).randint(0, 256, (6, 9, 11, 3)).astype(
    np.uint8)
IMGF = np.random.RandomState(1).rand(6, 9, 11, 3).astype(np.float32) * 255
LABELS = np.arange(6, dtype=np.int64) * 3


def _arr(pkg, a, dtype=None):
    if pkg is mt:
        return mt.nd.array(a, ctx=CPU, dtype=dtype)
    return mx.nd.array(a, dtype=dtype)


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _rel_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(float(np.abs(want.astype(np.float64)).max()), 1e-30)
    np.testing.assert_allclose(got.astype(np.float64),
                               want.astype(np.float64), rtol=0,
                               atol=RTOL * scale)


# ------------------------------------------------------------ datasets
def test_datasets_and_their_transforms():
    outs = {}
    for pkg in (mx, mt):
        gd = pkg.gluon.data
        ds = gd.ArrayDataset(_arr(pkg, IMGF[:, 0, 0, :]), LABELS,
                             [1, 2, 3, 4, 5, 6])
        simple = gd.SimpleDataset([10, 20, 30, 40])
        tf = ds.transform(lambda x, y, z: (x * 2, y + 1, z))
        tff = ds.transform_first(lambda x: x + 1, lazy=False)
        outs[pkg] = [
            len(ds), _np(ds[2][0]), ds[2][1], ds[2][2],
            len(simple), simple[1], len(simple.take(2)), simple.take(9)[3],
            [simple.filter(lambda v: v > 15)[i] for i in range(3)],
            [simple.sample(pkg.gluon.data.SequentialSampler(2))[i]
             for i in range(2)],
            _np(tf[1][0]), tf[1][1], _np(tff[3][0]), tff[3][1],
        ]
        with pytest.raises(IndexError):
            simple.take(2)[2]
        with pytest.raises(AssertionError):
            gd.ArrayDataset(np.ones(3), np.ones(4))
    for a, b in zip(outs[mt], outs[mx]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------ samplers
@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_batch_sampler_modes(last_batch):
    for n, bs in ((10, 3), (9, 3), (2, 4)):
        got = []
        for pkg in (mx, mt):
            s = pkg.gluon.data.BatchSampler(
                pkg.gluon.data.SequentialSampler(n), bs, last_batch)
            got.append([list(s), len(s), list(s), len(s)])
        assert got[0] == got[1]
    with pytest.raises(ValueError, match="last_batch"):
        mt.gluon.data.BatchSampler(mt.gluon.data.SequentialSampler(3), 2,
                                   "drop")


def test_random_sampler_order_under_np_seed():
    orders = []
    for pkg in (mx, mt):
        np.random.seed(5)
        s = pkg.gluon.data.RandomSampler(17)
        orders.append([list(s), list(s), len(s)])
    assert orders[0] == orders[1]
    assert sorted(orders[1][0]) == list(range(17))


# ---------------------------------------------------------- DataLoader
def _double(x):
    return x * 2


def _batches(pkg, num_workers, shuffle, transform=None, batch_size=4,
             last_batch="keep"):
    ds = pkg.gluon.data.ArrayDataset(IMG.astype(np.float32), LABELS)
    if transform is not None:
        ds = ds.transform_first(transform)
    pkg.random.seed(8)
    loader = pkg.gluon.data.DataLoader(ds, batch_size=batch_size,
                                       shuffle=shuffle,
                                       last_batch=last_batch,
                                       num_workers=num_workers)
    if pkg is mt:
        with CPU:
            got = [[_np(a) for a in b] for b in loader]
    else:
        got = [[_np(a) for a in b] for b in loader]
    return got, len(loader)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_dataloader_batches_equal_the_jax_packages(num_workers):
    for shuffle, last_batch in ((False, "keep"), (True, "discard"),
                                (True, "rollover")):
        want, n_want = _batches(mx, 0, shuffle, _double,
                                last_batch=last_batch)
        got, n_got = _batches(mt, num_workers, shuffle, _double,
                              last_batch=last_batch)
        assert n_got == n_want and len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert a.dtype == b.dtype, (a.dtype, b.dtype)
                np.testing.assert_array_equal(a, b)


def test_dataloader_of_ndarrays_with_random_transforms():
    """A CPU NDArray dataset through the slice's transform chain, in the
    main process: the same flips and the same batches."""
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    got = []
    for pkg in (mx, mt):
        T = pkg.gluon.data.vision.transforms
        ds = pkg.gluon.data.ArrayDataset(_arr(pkg, IMG, dtype="uint8"),
                                         LABELS)
        ds = ds.transform_first(T.Compose([
            T.RandomFlipLeftRight(), T.ToTensor(), T.Normalize(mean, std)]))
        pkg.random.seed(0)
        loader = pkg.gluon.data.DataLoader(ds, batch_size=4, shuffle=True,
                                           last_batch="discard")
        with (CPU if pkg is mt else mx.cpu()):
            got.append([[_np(a) for a in b] for b in loader]
                       + [np.asarray(pkg.random.get_state()[0])])
    for g, w in zip(got[1][:-1], got[0][:-1]):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1][-1], got[0][-1])


def test_mp_batchify_gives_numpy_and_the_main_process_places_it():
    ds = mt.gluon.data.ArrayDataset(mt.nd.array(IMGF, ctx=CPU), LABELS)
    b = mt.gluon.data.default_mp_batchify_fn([ds[0], ds[1]])
    assert isinstance(b[0], np.ndarray) and b[0].shape == (2, 9, 11, 3)
    with CPU:
        batches = list(mt.gluon.data.DataLoader(ds, batch_size=3,
                                                num_workers=2))
    assert all(isinstance(x, mt.nd.NDArray) and x.context == CPU
               for bb in batches for x in bb)
    assert batches[1][1].dtype == mt.nd.array(LABELS, ctx=CPU).dtype


# ----------------------------------------------------------- transforms
def _transform(pkg, make, x, dtype=None, seed=2):
    pkg.random.seed(seed)
    random.seed(seed)
    return _np(make(pkg.gluon.data.vision.transforms)(
        _arr(pkg, x, dtype=dtype)))


TRANSFORMS = {
    "cast": (lambda T: T.Cast("float16"), IMGF[0], None, True),
    "to_tensor": (lambda T: T.ToTensor(), IMG[0], "uint8", True),
    "normalize": (lambda T: T.Normalize((0.1, 0.2, 0.3), (0.4, 0.5, 0.6)),
                  IMGF[0].transpose(2, 0, 1) / 255, None, True),
    "resize": (lambda T: T.Resize((5, 7)), IMG[0], "uint8", True),
    "resize_keep": (lambda T: T.Resize(6, keep_ratio=True), IMGF[0], None,
                    False),
    "center_crop": (lambda T: T.CenterCrop(5), IMG[0], "uint8", True),
    "center_crop_up": (lambda T: T.CenterCrop((12, 10)), IMG[0], "uint8",
                       True),
    "random_resized_crop": (lambda T: T.RandomResizedCrop(6), IMG[0],
                            "uint8", True),
    "flip_lr": (lambda T: T.RandomFlipLeftRight(), IMG[0], "uint8", True),
    "flip_tb": (lambda T: T.RandomFlipTopBottom(), IMG[0], "uint8", True),
    "brightness": (lambda T: T.RandomBrightness(0.4), IMG[0], "uint8",
                   True),
    "contrast": (lambda T: T.RandomContrast(0.4), IMGF[0], None, False),
    "saturation": (lambda T: T.RandomSaturation(0.4), IMGF[0], None, True),
    "hue": (lambda T: T.RandomHue(0.4), IMGF[0], None, True),
    "color_jitter": (lambda T: T.RandomColorJitter(0.3, 0.3, 0.3, 0.3),
                     IMGF[0], None, False),
    "lighting": (lambda T: T.RandomLighting(0.1), IMGF[0], None, False),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_every_transform(name):
    make, x, dtype, bitwise = TRANSFORMS[name]
    for seed in (2, 3):
        want = _transform(mx, make, x, dtype, seed)
        got = _transform(mt, make, x, dtype, seed)
        if bitwise:
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        else:
            _rel_close(got, want)


# ------------------------------------------------------------ image ops
IMAGE_OPS = [
    ("_image_to_tensor", {}, IMG[:2], True),
    ("_image_normalize", dict(mean=(0.1, 0.2, 0.3), std=(0.5, 0.6, 0.7)),
     IMGF[:2].transpose(0, 3, 1, 2) / 255, True),
    ("_image_flip_left_right", {}, IMG[:2], True),
    ("_image_flip_top_bottom", {}, IMG[0], True),
    ("_image_random_flip_left_right", {}, IMG[:2], True),
    ("_image_random_flip_top_bottom", {}, IMG[:2], True),
    ("_image_random_brightness", dict(min_factor=0.5, max_factor=1.5),
     IMG[:2], True),
    ("_image_random_contrast", dict(min_factor=0.5, max_factor=1.5),
     IMGF[:2], False),
    ("_image_random_saturation", dict(min_factor=0.5, max_factor=1.5),
     IMGF[:2], True),
    ("_image_random_hue", dict(min_factor=0.5, max_factor=1.5), IMGF[:2],
     True),
    ("_image_random_color_jitter", dict(brightness=0.3, contrast=0.3,
                                        saturation=0.3, hue=0.3),
     IMGF[:2], False),
    ("_image_random_lighting", dict(alpha_std=0.1), IMGF[:2], False),
    ("_image_crop", dict(x=2, y=1, width=5, height=4), IMG[:2], True),
    ("_image_crop", dict(x=9, y=-1, width=5, height=4), IMG[0], True),
]
for _interp in range(5):
    for _size in ((5, 4), (20, 17), 7):
        IMAGE_OPS.append(("_image_resize", dict(size=_size, interp=_interp),
                          IMG[:2], True))
        IMAGE_OPS.append(("_image_resize", dict(size=_size, interp=_interp),
                          IMGF[0], _interp == 0))


@pytest.mark.parametrize("i", range(len(IMAGE_OPS)))
def test_every_image_op(i):
    name, kw, x, bitwise = IMAGE_OPS[i]
    outs = []
    for pkg in (mx, mt):
        pkg.random.seed(1)
        outs.append(_np(getattr(pkg.nd, name)(_arr(pkg, x, dtype=x.dtype),
                                              **kw)))
        outs.append(np.asarray(pkg.random.get_state()[0]))
    np.testing.assert_array_equal(outs[3], outs[1])
    if bitwise:
        assert outs[2].dtype == outs[0].dtype
        np.testing.assert_array_equal(outs[2], outs[0])
    else:
        _rel_close(outs[2], outs[0])
