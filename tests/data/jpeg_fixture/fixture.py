"""The JPEG fixture: 16 synthetic JPEGs and the pixels OpenCV decoded
from them, for the record pipeline's tests and ``chip_smoke.py``, and 4
"block" JPEGs that decode exactly.

    python3 tests/data/jpeg_fixture/fixture.py    # writes the files
                                                  # (cv2 and PIL)

Each image is a smooth sinusoid per channel, one to three filled circles
or rectangles and a mild low-frequency noise field, made from
``RandomState(0)``; sizes run from 224 to 300 (four are 256 x 256),
qualities from 75 to 95, even images 4:2:0 and odd ones 4:4:4. Beside
``img_NN.jpg``, ``index.json`` lists each image's size, quality and
subsampling, and ``pixels.xz`` holds what ``cv2.imdecode(...,
IMREAD_COLOR)`` gave (HWC, B, G, R): per image the planes C x H x W of
the second difference along rows and columns mod 256, concatenated and
compressed with lzma (the whole fixture stays under 1 MB).

The block JPEGs ``blk_NN.jpg`` (4:4:4, 4:2:2 and 4:2:0 at 41 x 57, and
4:2:0 at 256 x 256) are written by PIL at quality 100 from YCbCr planes
that are constant on every stored 8 x 8 block: such a block has only a
DC coefficient, which any inverse DCT gives back exactly, so a decoder
that upsamples and converts as libjpeg-turbo does matches cv2's pixels
bit for bit. Their pixels follow the images' in ``pixels.xz``.
:func:`load` and :func:`load_blocks` need only numpy, so a machine
without OpenCV reads them.
"""
import json
import lzma
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N_IMAGES = 16


def _synth(h, w, rng):
    import cv2
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.empty((h, w, 3), np.float32)
    phase = rng.uniform(0, 2 * np.pi, 3)
    for c in range(3):
        img[..., c] = 128 + 80 * np.sin(
            x / w * np.pi * rng.uniform(0.5, 1.5) + phase[c]) * np.cos(
            y / h * np.pi * rng.uniform(0.5, 1.5))
    for _ in range(rng.randint(1, 4)):
        col = rng.randint(0, 256, 3).tolist()
        if rng.rand() < 0.5:
            cv2.circle(img, (int(rng.randint(0, w)), int(rng.randint(0, h))),
                       int(rng.randint(15, 70)), col, -1)
        else:
            p = rng.randint(0, min(h, w), 4)
            cv2.rectangle(img, (int(p[0]), int(p[1])), (int(p[2]), int(p[3])),
                          col, -1)
    field = rng.normal(0, 4.0, (h // 16 + 1, w // 16 + 1, 3))
    img += cv2.resize(field.astype(np.float32), (w, h),
                      interpolation=cv2.INTER_CUBIC)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def _encode(dec):
    """HWC uint8 -> the stored second differences (C, H, W) as bytes."""
    d = dec.astype(np.int32).transpose(2, 0, 1)
    sub = d.copy()
    sub[:, :, 1:] -= d[:, :, :-1]
    g = sub.copy()
    g[:, 1:, :] -= sub[:, :-1, :]
    return (g % 256).astype(np.uint8).tobytes()


def _decode(raw, h, w):
    g = np.frombuffer(raw, np.uint8).reshape(3, h, w).astype(np.int64)
    sub = np.cumsum(g, axis=1) % 256
    return np.ascontiguousarray(
        (np.cumsum(sub, axis=2) % 256).astype(np.uint8).transpose(1, 2, 0))


BLOCKS = (("444", 41, 57), ("422", 41, 57), ("420", 41, 57),
          ("420", 256, 256))


def _block_jpeg(sub, h, w, rng):
    import io
    from PIL import Image
    hs, vs = {"444": (1, 1), "422": (2, 1), "420": (2, 2)}[sub]
    y = np.kron(rng.randint(16, 236, (h // 8 + 1, w // 8 + 1)),
                np.ones((8, 8), int))[:h, :w]
    chroma = [np.kron(rng.randint(16, 241, (h // (8 * vs) + 1,
                                            w // (8 * hs) + 1)),
                      np.ones((8 * vs, 8 * hs), int))[:h, :w]
              for _ in range(2)]
    f = io.BytesIO()
    Image.fromarray(np.stack([y] + chroma, 2).astype(np.uint8),
                    "YCbCr").save(f, "JPEG", quality=100,
                                  subsampling={"444": 0, "422": 1,
                                               "420": 2}[sub])
    return f.getvalue()


def make():
    import cv2
    rng = np.random.RandomState(0)
    index, stream = [], []
    for i in range(N_IMAGES):
        h, w = (224 + 76 * rng.uniform(0, 1, 2) ** 3).astype(int)
        if i % 4 == 0:
            h = w = 256
        if i == 3:
            h = w = 224
        if i == 7:
            h = w = 300
        quality = int(rng.randint(75, 96))
        sub = "420" if i % 2 == 0 else "444"
        flag = (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420 if sub == "420"
                else cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)
        ok, buf = cv2.imencode(".jpg", _synth(int(h), int(w), rng), [
            cv2.IMWRITE_JPEG_QUALITY, quality,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag])
        assert ok
        name = "img_%02d.jpg" % i
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(buf.tobytes())
        dec = cv2.imdecode(buf, cv2.IMREAD_COLOR)
        index.append({"file": name, "height": int(dec.shape[0]),
                      "width": int(dec.shape[1]), "quality": quality,
                      "subsampling": sub})
        stream.append(_encode(dec))
    blocks = []
    for i, (sub, h, w) in enumerate(BLOCKS):
        jpeg = _block_jpeg(sub, h, w, rng)
        name = "blk_%02d.jpg" % i
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(jpeg)
        dec = cv2.imdecode(np.frombuffer(jpeg, np.uint8), cv2.IMREAD_COLOR)
        blocks.append({"file": name, "height": h, "width": w,
                       "quality": 100, "subsampling": sub})
        stream.append(_encode(dec))
    with open(os.path.join(HERE, "pixels.xz"), "wb") as f:
        f.write(lzma.compress(b"".join(stream),
                              preset=9 | lzma.PRESET_EXTREME))
    with open(os.path.join(HERE, "index.json"), "w") as f:
        json.dump({"opencv": cv2.__version__, "images": index,
                   "blocks": blocks}, f, indent=1)


def _load(which):
    with open(os.path.join(HERE, "index.json")) as f:
        index = json.load(f)
    with open(os.path.join(HERE, "pixels.xz"), "rb") as f:
        raw = lzma.decompress(f.read())
    out, off = {"images": [], "blocks": []}, 0
    for kind in ("images", "blocks"):
        for e in index[kind]:
            n = 3 * e["height"] * e["width"]
            with open(os.path.join(HERE, e["file"]), "rb") as f:
                jpeg = f.read()
            out[kind].append((jpeg, _decode(raw[off:off + n], e["height"],
                                            e["width"]), e))
            off += n
    return out[which]


def load():
    """[(jpeg bytes, cv2's pixels (H, W, 3) uint8 B, G, R, entry)] of the
    16 images."""
    return _load("images")


def load_blocks():
    """The same for the 4 block JPEGs."""
    return _load("blocks")


if __name__ == "__main__":
    make()
