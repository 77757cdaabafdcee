"""Port parity for ``mt.image`` against the JAX package's ``mx.image``,
on the CPU, over the committed detection fixture
(``tests/data/det_fixture``, packed into records at run time): the
augmenter lists, ``ImageIter`` and ``ImageDetIter``.

Both iterators decode with cv2 on the CPU and draw from Python's
``random`` (seeded alike before each is built) and from their package's
key chain (the colour jitters). Tolerances:
- labels and pad counts bitwise everywhere, mirror flips and crops
  included;
- pixels bitwise where only geometry and casts touch them (crops, flips,
  identity resizes, the mean/std normalization: the same f32
  operations), as at ``examples/train_ssd.py``'s settings;
- after a real resize (``_image_resize``, the JAX package's
  ``jax.image.resize`` spelled in torch, rounded back to uint8): at most
  one level (one level over std where normalized) on at most 1 pixel in
  2000, where the interpolated value lies within float error of a
  rounding boundary (ROADMAP R-det-1; measured here: 1 pixel in 27648);
- after a colour jitter (f32 blending in each framework's order): within
  ``rtol=1e-5`` and 1e-3 absolute on pixel values up to 255.
The iterators with resizes read a part of the fixture (``num_parts``):
each new image shape compiles a JAX resize.
"""
import os
import random
import sys

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import detection_graphs as dg  # noqa: E402

fixture = dg.det_fixture()


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    return fixture.write_records(str(tmp_path_factory.mktemp("det") / "d"),
                                 mt.recordio)


def batches(pkg, make, epochs=2, seed=3):
    """Every batch of ``epochs`` epochs of the iterator ``make(pkg)``
    builds, as numpy (data, label, pad)."""
    random.seed(seed)
    np.random.seed(seed)
    pkg.random.seed(seed)
    if pkg is mt:
        with mt.cpu():
            it = make(pkg)
    else:
        it = make(pkg)
    out = []
    for _ in range(epochs):
        it.reset()
        for b in it:
            out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
    return out


def same(got, want, pixels="exact", level=1.0):
    """``pixels``: "exact", "resized" (``level`` is one uint8 level in
    the batch's units) or "jitter"; see the module docstring."""
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        np.testing.assert_array_equal(gl, wl)
        if pixels == "exact":
            np.testing.assert_array_equal(gd, wd)
        elif pixels == "resized":
            d = np.abs(gd - wd)
            assert d.max() <= level * (1 + 1e-5)
            assert (d > 0).sum() <= max(1, gd.size // 2000)
        else:
            np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-3)


def test_image_det_iter_the_ssd_example_settings(rec):
    """train_ssd.py's iterator: shuffled, mirrored, mean=True/std=True
    (the scalar 1 there, as ``np.asarray(True, float32)`` makes it)."""
    def make(pkg):
        return pkg.image.ImageDetIter(
            batch_size=8, data_shape=(3, 64, 64), path_imgrec=rec,
            shuffle=True, rand_mirror=True, mean=True, std=True)
    got, want = batches(mt, make), batches(mx, make)
    same(got, want)
    data, label, _ = got[0]
    assert data.shape == (8, 3, 64, 64) and label.shape == (8, 2, 5)
    # padded to the most objects an image holds, with -1 rows
    assert (label[:, 1] == -1).all(axis=1).any()
    jpegs, labels = fixture.load()
    assert max((len(l) - 2) // 5 for l in labels) == 2


@pytest.mark.parametrize("kw,level", [
    (dict(rand_crop=1, min_object_covered=0.5, area_range=(0.3, 1.0)),
     1.0),
    (dict(rand_pad=1, area_range=(1.0, 2.0), rand_mirror=True), 1.0),
    (dict(rand_crop=0.5, rand_pad=0.5, rand_mirror=True,
          mean=(100, 110, 120), std=(50, 60, 70)), 1.0 / 50),
])
def test_image_det_iter_crop_pad_and_resize(rec, kw, level):
    def make(pkg):
        return pkg.image.ImageDetIter(
            batch_size=4, data_shape=(3, 48, 48), path_imgrec=rec,
            shuffle=True, num_parts=6, **kw)
    same(batches(mt, make, epochs=1), batches(mx, make, epochs=1),
         "resized", level)


def test_det_augmenters_mirror_the_boxes():
    label = np.array([[1, 0.1, 0.2, 0.4, 0.6], [0, 0.5, 0.5, 0.9, 0.8]],
                     np.float32)
    img = np.random.RandomState(0).randint(0, 255, (6, 8, 3), np.uint8)
    random.seed(0)
    with mt.cpu():
        out, lab = mt.image.DetHorizontalFlipAug(1.0)(mt.nd.array(
            img, dtype="uint8"), label)
    random.seed(0)
    jout, jlab = mx.image.DetHorizontalFlipAug(1.0)(mx.nd.array(
        img, dtype=np.uint8), label)
    np.testing.assert_array_equal(out.asnumpy(), jout.asnumpy())
    np.testing.assert_array_equal(lab, jlab)
    np.testing.assert_allclose(lab[:, [1, 3]], 1 - label[:, [3, 1]])


@pytest.mark.parametrize("kw,pixels,level", [
    (dict(rand_crop=True, rand_mirror=True), "exact", 0),
    (dict(resize=40, rand_crop=True, rand_mirror=True, mean=True, std=True),
     "resized", 1.0 / 57.12),
    (dict(rand_resize=True, rand_crop=True), "resized", 1.0),
    (dict(rand_mirror=True, brightness=0.3, contrast=0.3, saturation=0.3),
     "jitter", 0),
])
def test_image_iter_and_augmenters(rec, kw, pixels, level):
    def make(pkg):
        return pkg.image.ImageIter(
            batch_size=4, data_shape=(3, 32, 32), path_imgrec=rec,
            shuffle=True, num_parts=1 if pixels == "exact" else 6, **kw)
    same(batches(mt, make, epochs=1), batches(mx, make, epochs=1), pixels,
         level)


def test_create_augmenter_lists_match():
    for kw in (dict(), dict(resize=10, rand_crop=True, rand_mirror=True,
                            brightness=0.1, hue=0.1, pca_noise=0.1,
                            rand_gray=0.2, mean=True, std=True)):
        t = mt.image.CreateAugmenter((3, 8, 8), **kw)
        j = mx.image.CreateAugmenter((3, 8, 8), **kw)
        assert [type(a).__name__ for a in t] == [type(a).__name__ for a in j]
    for kw in (dict(), dict(rand_crop=0.5, rand_pad=0.5, rand_mirror=True,
                            brightness=0.1, mean=True)):
        t = mt.image.CreateDetAugmenter((3, 8, 8), **kw)
        j = mx.image.CreateDetAugmenter((3, 8, 8), **kw)
        assert [type(a).__name__ for a in t] == [type(a).__name__ for a in j]
