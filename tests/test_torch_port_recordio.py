"""Port parity for RecordIO (``recordio``), ``io.ImageRecordIter`` on the
CPU, the card path's plain kernels (``kernels.image_aug``,
``kernels.jpeg_color``), the Gluon record and vision datasets, and the
kernel build's per-source flags, against the JAX package.

Everything here is bitwise: the ``.rec``/``.idx`` bytes either package
writes, the iterators' batches (cv2 decodes in both), the plain augment
against ``_build_augmenter``, and the plain YCbCr -> BGR against cv2 on
JPEGs whose blocks are constant (a DC-only block decodes exactly, so the
only arithmetic left is libjpeg-turbo's upsampling and conversion).
"""
import io
import os
import struct
import warnings

import cv2
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import recordio as jrio
from mxnet_tpu.io.image_record_iter import _build_augmenter as j_augmenter

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import recordio as trio
from mxnet_tpu_torch.kernels import _build, image_aug, jpeg_color

CPU = mt.cpu()
SHAPE = (3, 16, 16)


def _images(n, seed):
    """n BGR uint8 images of 14..30 rows and columns, smooth with noise."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        h, w = rng.randint(14, 31, 2)
        base = rng.randint(0, 256, (h // 4 + 1, w // 4 + 1, 3)).astype(
            np.uint8)
        img = cv2.resize(base, (int(w), int(h)),
                         interpolation=cv2.INTER_LINEAR)
        noise = rng.randint(-8, 9, img.shape)
        out.append(np.clip(img.astype(int) + noise, 0, 255).astype(np.uint8))
    return out


def _write_rec(pkg_rio, path, images, label_width=1, seed=0):
    rng = np.random.RandomState(seed)
    w = pkg_rio.MXIndexedRecordIO(os.path.splitext(path)[0] + ".idx", path,
                                  "w")
    for i, img in enumerate(images):
        ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90])
        assert ok
        label = float(i % 7) if label_width == 1 else \
            rng.rand(label_width).astype(np.float32)
        w.write_idx(i, pkg_rio.pack(pkg_rio.IRHeader(0, label, i, 0),
                                    buf.tobytes()))
    w.close()
    return path


@pytest.fixture(scope="module")
def recs(tmp_path_factory):
    d = tmp_path_factory.mktemp("rec")
    imgs = _images(23, 0)
    return {"plain": _write_rec(jrio, str(d / "a.rec"), imgs),
            "wide": _write_rec(jrio, str(d / "b.rec"), imgs, label_width=3),
            "images": imgs}


# ------------------------------------------------------------- the format
def test_rec_and_idx_bytes_cross_both_ways(tmp_path):
    rng = np.random.RandomState(1)
    payloads = [rng.bytes(int(n)) for n in rng.randint(0, 40, 9)]
    headers = [(0, 1.5, 3, 4), (0, np.arange(3, dtype=np.float32), 7, 0)]
    files = {}
    for name, pkg in (("j", jrio), ("t", trio)):
        rec = str(tmp_path / (name + ".rec"))
        w = pkg.MXIndexedRecordIO(str(tmp_path / (name + ".idx")), rec, "w")
        for i, p in enumerate(payloads):
            w.write_idx(i, pkg.pack(pkg.IRHeader(*headers[i % 2]), p))
        w.close()
        files[name] = [open(str(tmp_path / (name + ext)), "rb").read()
                       for ext in (".rec", ".idx")]
    assert files["j"] == files["t"]
    for writer, reader in (("j", trio), ("t", jrio)):
        r = reader.MXIndexedRecordIO(str(tmp_path / (writer + ".idx")),
                                     str(tmp_path / (writer + ".rec")), "r")
        for i in reversed(range(len(payloads))):
            header, s = reader.unpack(r.read_idx(i))
            assert s == payloads[i]
            want = headers[i % 2]
            np.testing.assert_array_equal(np.asarray(header.label),
                                          np.asarray(want[1], np.float32))
            assert (header.id, header.id2) == want[2:]
        r.close()
        seq = reader.MXRecordIO(str(tmp_path / (writer + ".rec")), "r")
        assert [reader.unpack(seq.read())[1] for _ in payloads] == payloads
        assert seq.read() is None


def test_a_record_longer_than_the_length_field_splits_into_parts(tmp_path,
                                                                 monkeypatch):
    """The multi-part form (cflag 1, 2, 3), at a part size cut to 10."""
    payload = bytes(range(37))
    out = {}
    for name, pkg in (("j", jrio), ("t", trio)):
        monkeypatch.setattr(pkg.MXRecordIO, "_MAX_PART", 10)
        path = str(tmp_path / (name + ".rec"))
        w = pkg.MXRecordIO(path, "w")
        w.write(payload)
        w.write(b"xy")
        w.close()
        out[name] = open(path, "rb").read()
        flags = [struct.unpack("<I", out[name][o + 4:o + 8])[0] >> 29
                 for o in (0, 20, 40, 60)]
        assert flags == [1, 2, 2, 3]
    assert out["j"] == out["t"]
    r = trio.MXRecordIO(str(tmp_path / "j.rec"), "r")
    assert r.read() == payload and r.read() == b"xy" and r.read() is None


def test_pack_img_and_unpack_img_match_the_jax_package():
    img = _images(1, 3)[0]
    header = mx.recordio.IRHeader(0, 2.0, 5, 0)
    assert trio.pack_img(header, img, quality=80) == \
        jrio.pack_img(header, img, quality=80)
    h1, a = trio.unpack_img(jrio.pack_img(header, img))
    h2, b = jrio.unpack_img(jrio.pack_img(header, img))
    assert h1 == h2
    np.testing.assert_array_equal(a, b)


# ------------------------------------------------------- ImageRecordIter
def _batches(pkg, path, epochs=1, **kw):
    ctx = {"ctx": CPU} if pkg is mt else {}
    it = pkg.io.ImageRecordIter(path, SHAPE, 5, **ctx, **kw)
    out = []
    try:
        for e in range(epochs):
            if e:
                it.reset()
            out.append([(b.data[0].asnumpy(), b.label[0].asnumpy())
                        for b in it])
    finally:
        it.close()
    return out, it.num_batches, it.provide_data, it.provide_label


CASES = {
    "centre": {},
    "shuffle_crop_mirror": dict(shuffle=True, rand_crop=True,
                                rand_mirror=True, seed=3),
    "pad_fill_norm": dict(pad=4, fill_value=17, rand_crop=True,
                          mean_r=120.5, mean_g=110.0, mean_b=100.25,
                          std_r=60.0, std_g=61.5, std_b=62.0, scale=0.5),
    "resize_mirror": dict(resize=20, mirror=True),
    "upscale": dict(resize=12, rand_crop=True),
    "parts": dict(num_parts=3, part_index=1, shuffle=True, rand_crop=True),
    "no_round": dict(round_batch=False, shuffle=True),
    "threads3": dict(preprocess_threads=3, rand_crop=True, rand_mirror=True,
                     shuffle=True),
    "threads1": dict(preprocess_threads=1, rand_crop=True, rand_mirror=True,
                     prefetch_buffer=1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_image_record_iter_batches_are_the_jax_packages(recs, case):
    kw = CASES[case]
    got = _batches(mt, recs["plain"], epochs=2, **kw)
    want = _batches(mx, recs["plain"], epochs=2, **kw)
    assert got[1] == want[1] and len(got[0][0]) == got[1]
    assert [tuple(d.shape) for d in got[2]] == [tuple(d.shape)
                                               for d in want[2]]
    assert [tuple(d.shape) for d in got[3]] == [tuple(d.shape)
                                               for d in want[3]]
    for ge, we in zip(got[0], want[0]):
        assert len(ge) == len(we)
        for (gd, gl), (wd, wl) in zip(ge, we):
            assert gd.dtype == wd.dtype == np.float32
            np.testing.assert_array_equal(gd, wd)
            np.testing.assert_array_equal(gl, wl)
    if kw.get("shuffle") or kw.get("rand_crop"):
        # the second epoch draws anew
        assert not all(np.array_equal(a[0], b[0])
                       for a, b in zip(got[0][0], got[0][1]))


def test_label_width_above_one(recs):
    got = _batches(mt, recs["wide"], label_width=3, shuffle=True)
    want = _batches(mx, recs["wide"], label_width=3, shuffle=True)
    assert got[3][0].shape == (5, 3)
    for (gd, gl), (wd, wl) in zip(got[0][0], want[0][0]):
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)


def test_dtype_and_context(recs):
    it = mt.io.ImageRecordIter(recs["plain"], SHAPE, 4, ctx=CPU,
                               dtype="bfloat16")
    b = next(it)
    assert b.data[0].dtype == torch.bfloat16 and b.data[0].context == CPU
    want = _batches(mx, recs["plain"])[0][0][0][0][:4]
    np.testing.assert_array_equal(
        b.data[0].asnumpy(),
        torch.from_numpy(want.copy()).to(torch.bfloat16).float().numpy())
    it.close()
    with pytest.raises(mt.MXNetError):
        mt.io.ImageRecordIter(recs["plain"], SHAPE, 4)   # gpu(0), no card


def test_errors_surface_as_the_jax_packages(tmp_path, recs):
    bad = str(tmp_path / "bad.rec")
    w = trio.MXIndexedRecordIO(str(tmp_path / "bad.idx"), bad, "w")
    w.write_idx(0, trio.pack(trio.IRHeader(0, 1.0, 0, 0), b"not a jpeg"))
    w.close()
    for pkg in (mt, mx):
        ctx = {"ctx": CPU} if pkg is mt else {}
        it = pkg.io.ImageRecordIter(bad, SHAPE, 2, **ctx)
        with pytest.raises(pkg.base.MXNetError, match="undecodable"):
            next(it)
        it.close()
    with pytest.raises(mt.MXNetError, match="index"):
        mt.io.ImageRecordIter(str(tmp_path / "none.rec"), SHAPE, 2, ctx=CPU)


# ------------------------------------------- the card path's plain kernels
def _aug_case(seed, n, pad):
    rng = np.random.RandomState(seed)
    imgs = _images(n, seed + 1)
    crops = []
    for img in imgs:
        h, w = img.shape[0] + 2 * pad, img.shape[1] + 2 * pad
        crops.append((rng.randint(0, h - SHAPE[1] + 1),
                      rng.randint(0, w - SHAPE[2] + 1), rng.rand() < 0.5))
    return imgs, crops


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("norm", [False, True])
def test_plain_augment_is_the_jax_augmenter(dtype, norm):
    """On cv2-decoded images, under the draws the augmenter takes."""
    pad = 3 if norm else 0
    kw = dict(pad=pad, fill_value=200, rand_crop=True, rand_mirror=True)
    if norm:
        kw.update(mean_r=123.68, mean_g=116.28, mean_b=103.53, std_r=58.395,
                  std_g=57.12, std_b=57.375, scale=1 / 255.0)
    imgs = [cv2.imdecode(cv2.imencode(".jpg", im)[1], cv2.IMREAD_COLOR)
            for im in _images(16, 9) if min(im.shape[:2]) >= 16][:6]
    aug = j_augmenter(SHAPE, **kw)
    rng = np.random.RandomState(5)
    want = np.stack([aug(im, rng) for im in imgs])
    rng = np.random.RandomState(5)
    crops = []
    for im in imgs:
        h, w = im.shape[0] + 2 * pad, im.shape[1] + 2 * pad
        crops.append((rng.randint(0, h - 15), rng.randint(0, w - 15),
                      rng.rand() < 0.5))
    out = torch.empty((6,) + SHAPE, dtype=dtype)
    image_aug.augment([torch.from_numpy(im) for im in imgs], crops, out,
                      pad=pad, fill=200,
                      mean=(kw.get("mean_r", 0), kw.get("mean_g", 0),
                            kw.get("mean_b", 0)),
                      std=(kw.get("std_r", 1), kw.get("std_g", 1),
                           kw.get("std_b", 1)), scale=kw.get("scale", 1.0))
    ref = torch.from_numpy(want).to(dtype)
    assert torch.equal(out.view(torch.int16) if dtype != torch.float32
                       else out.view(torch.int32),
                       ref.view(torch.int16) if dtype != torch.float32
                       else ref.view(torch.int32))
    assert image_aug.launches == 0


def test_augment_refuses_what_the_kernel_does_not_take():
    imgs, crops = _aug_case(0, 2, 0)
    srcs = [torch.from_numpy(im) for im in imgs]
    with pytest.raises(mt.MXNetError, match="does not fit"):
        image_aug.augment(srcs, [(99, 0, False)] * 2,
                          torch.empty((2,) + SHAPE))
    with pytest.raises(mt.MXNetError, match="contiguous"):
        image_aug.augment(srcs, crops, torch.empty((2,) + SHAPE,
                                                   dtype=torch.int32))
    with pytest.raises(mt.MXNetError, match="2 images"):
        image_aug.augment(srcs, crops, torch.empty((3,) + SHAPE))


def _block_jpeg(h, w, sub, rng):
    """A JPEG (quality 100, PIL's encoder from YCbCr planes) whose luma is
    constant on each 8 x 8 block and whose chroma is constant on each
    stored 8 x 8 block, and those stored planes."""
    from PIL import Image
    hs, vs = {"444": (1, 1), "422": (2, 1), "420": (2, 2)}[sub]
    y = np.kron(rng.randint(16, 236, (h // 8 + 1, w // 8 + 1)),
                np.ones((8, 8), int))[:h, :w]
    cb_blocks = rng.randint(16, 241, (h // (8 * vs) + 1, w // (8 * hs) + 1))
    cr_blocks = rng.randint(16, 241, cb_blocks.shape)
    full = [np.kron(b, np.ones((8 * vs, 8 * hs), int))[:h, :w]
            for b in (cb_blocks, cr_blocks)]
    f = io.BytesIO()
    Image.fromarray(np.stack([y] + full, 2).astype(np.uint8),
                    "YCbCr").save(f, "JPEG", quality=100,
                                  subsampling={"444": 0, "422": 1,
                                               "420": 2}[sub])
    ch, cw = jpeg_color.chroma_shape(h, w, jpeg_color.MODES[sub])
    stored = [np.kron(b, np.ones((8, 8), int))[:ch, :cw].astype(np.uint8)
              for b in (cb_blocks, cr_blocks)]
    return f.getvalue(), y.astype(np.uint8), stored


@pytest.mark.parametrize("sub", ["444", "422", "420"])
def test_plain_ycbcr_to_bgr_is_libjpeg_turbos(sub):
    rng = np.random.RandomState(int(sub))
    images = []
    for h, w in ((48, 64), (41, 57), (9, 9), (17, 3)):
        jpeg, y, (cb, cr) = _block_jpeg(h, w, sub, rng)
        want = cv2.imdecode(np.frombuffer(jpeg, np.uint8), cv2.IMREAD_COLOR)
        out = torch.empty((h, w, 3), dtype=torch.uint8)
        images.append((torch.from_numpy(y), torch.from_numpy(cb),
                       torch.from_numpy(cr), out, jpeg_color.MODES[sub]))
        jpeg_color.ycc_to_bgr(images[-1:])
        np.testing.assert_array_equal(out.numpy(), want)
    y = torch.from_numpy(y)
    with pytest.raises(mt.MXNetError, match="chroma planes"):
        jpeg_color.ycc_to_bgr([(y, y, y, out, 3)])
    assert jpeg_color.launches == 0


# ------------------------------------------------------------ the datasets
def test_record_file_and_image_record_datasets(recs):
    for cls in ("RecordFileDataset",):
        a = getattr(mt.gluon.data, cls)(recs["plain"])
        b = getattr(mx.gluon.data, cls)(recs["plain"])
        assert len(a) == len(b) == 23
        assert a[4] == b[4] and a[-1] == b[-1]
    with mt.cpu():
        a = mt.gluon.data.vision.ImageRecordDataset(recs["plain"])
        img, label = a[3]
    b = mx.gluon.data.vision.ImageRecordDataset(recs["plain"])
    img2, label2 = b[3]
    assert img.dtype == torch.uint8 and img.context == CPU
    np.testing.assert_array_equal(img.asnumpy(), img2.asnumpy())
    assert label == label2
    t = mt.gluon.data.vision.ImageRecordDataset(
        recs["plain"], transform=lambda x, y: (x.shape, y + 1))
    with mt.cpu():
        assert t[3] == (img.shape, label + 1)


def _write_vision_files(root, rng):
    """MNIST idx files (train gzipped), CIFAR-10 and CIFAR-100 batches, an
    image folder."""
    import gzip
    os.makedirs(os.path.join(root, "mnist"))
    for prefix, n, op in (("train", 5, gzip.open), ("t10k", 3, open)):
        imgs = rng.randint(0, 256, (n, 4, 6)).astype(np.uint8)
        labs = rng.randint(0, 10, n).astype(np.uint8)
        ext = ".gz" if op is gzip.open else ""
        with op(os.path.join(root, "mnist", "%s-images-idx3-ubyte%s"
                             % (prefix, ext)), "wb") as f:
            f.write(struct.pack(">IIII", 2051, n, 4, 6) + imgs.tobytes())
        with op(os.path.join(root, "mnist", "%s-labels-idx1-ubyte%s"
                             % (prefix, ext)), "wb") as f:
            f.write(struct.pack(">II", 2049, n) + labs.tobytes())
    d10 = os.path.join(root, "c10", "cifar-10-batches-bin")
    os.makedirs(d10)
    for name in ["data_batch_%d.bin" % i for i in range(1, 6)] + [
            "test_batch.bin"]:
        rows = rng.randint(0, 256, (2, 3073)).astype(np.uint8)
        rows[:, 0] %= 10
        rows.tofile(os.path.join(d10, name))
    d100 = os.path.join(root, "c100")
    os.makedirs(d100)
    for name in ("train.bin", "test.bin"):
        rows = rng.randint(0, 256, (3, 3074)).astype(np.uint8)
        rows[:, :2] %= 100
        rows.tofile(os.path.join(d100, name))
    for cls in ("b", "a"):
        os.makedirs(os.path.join(root, "folder", cls))
        for i, img in enumerate(_images(2, ord(cls))):
            cv2.imwrite(os.path.join(root, "folder", cls, "%d.png" % i), img)
    open(os.path.join(root, "folder", "a", "skip.txt"), "w").close()


def test_vision_datasets_read_their_files_as_the_jax_package(tmp_path):
    _write_vision_files(str(tmp_path), np.random.RandomState(2))
    vision = {pkg: pkg.gluon.data.vision for pkg in (mt, mx)}
    makers = [
        lambda v: v.MNIST(str(tmp_path / "mnist")),
        lambda v: v.MNIST(str(tmp_path / "mnist"), train=False),
        lambda v: v.FashionMNIST(str(tmp_path / "mnist"),
                                 transform=lambda x, y: (x, y * 2)),
        lambda v: v.CIFAR10(str(tmp_path / "c10")),
        lambda v: v.CIFAR10(str(tmp_path / "c10"), train=False),
        lambda v: v.CIFAR100(str(tmp_path / "c100"), fine_label=True),
        lambda v: v.CIFAR100(str(tmp_path / "c100"), train=False),
        lambda v: v.ImageFolderDataset(str(tmp_path / "folder")),
    ]
    for build in makers:
        with mt.cpu(), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            a = build(vision[mt])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            b = build(vision[mx])
        assert len(a) == len(b)
        for i in range(len(a)):
            with mt.cpu():    # the folder's images decode when read
                xa, ya = a[i]
            xb, yb = b[i]
            assert xa.context == CPU
            np.testing.assert_array_equal(xa.asnumpy(), xb.asnumpy())
            assert ya == yb
    with pytest.warns(UserWarning, match="skip.txt"):
        folder = vision[mt].ImageFolderDataset(str(tmp_path / "folder"))
    assert folder.synsets == ["a", "b"]
    with pytest.raises(IOError, match="not found"):
        vision[mt].MNIST(str(tmp_path / "empty"))
    with pytest.raises(IOError, match="not found"):
        vision[mt].CIFAR10(str(tmp_path / "empty"))


# --------------------------------------------------------- the kernel build
def test_a_sources_own_flags_reach_nvcc_and_its_library_name(monkeypatch):
    monkeypatch.setattr(_build, "_nvcc", lambda: "cuda/bin/nvcc")
    cmd = _build.command("nvjpeg_decode", "out.so")
    assert cmd[0] == "cuda/bin/nvcc"
    assert cmd[1:1 + len(_build.NVCC_FLAGS)] == list(_build.NVCC_FLAGS)
    assert "-lnvjpeg" in cmd
    i = cmd.index("-rpath")
    assert cmd[i - 1] == "-Xlinker" and cmd[i + 2] == "cuda/lib64"
    assert cmd[-3:] == ["-o", "out.so",
                        os.path.join(_build.CSRC_DIR, "nvjpeg_decode.cu")]
    aug = _build.command("image_aug", "x.so")
    assert "-fmad=false" in aug and "-rpath" not in aug
    plain = _build.command("take_rows", "x.so")
    assert plain[1:-3] == list(_build.NVCC_FLAGS)
    # the flags are in the library's name: a changed flag builds anew
    before = _build._target("image_aug")
    monkeypatch.setitem(_build.EXTRA_FLAGS, "image_aug", ("-fmad=true",))
    assert _build._target("image_aug") != before
    assert set(_build.sources()) >= {"nvjpeg_decode", "jpeg_color",
                                     "image_aug"}


def test_a_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_nvcc", lambda: "/bin/false")
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    with pytest.raises(mt.MXNetError, match="nvcc failed for image_aug"):
        _build.build(["image_aug"])
