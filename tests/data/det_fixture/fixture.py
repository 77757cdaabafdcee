"""The detection fixture: 64 synthetic 64 x 64 JPEGs with their box
labels, for the detection tests and ``chip_smoke.py``.

    python3 tests/data/det_fixture/fixture.py    # writes the files (cv2)

The images follow ``examples/train_ssd.py``'s ``make_synthetic_rec``
recipe at its defaults (``RandomState(0)``, 3 classes): noise in
[0, 60), one or two solid rectangles in a class colour, encoded by
``cv2.imencode(".jpg")`` (quality 95, 4:2:0). ``det_NN.jpg`` holds the
bytes and ``labels.json`` each image's record label, ``[2, 5, cls, x1,
y1, x2, y2, ...]`` as float32 values (corners in [0, 1]).
:func:`write_records` packs them into a ``.rec`` and ``.idx`` at run
time with the port's ``recordio``, exactly as the recipe packs them, so
a machine without OpenCV makes the same records.
"""
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N_IMAGES, SIDE, NUM_CLASSES = 64, 64, 3


def generate():
    import cv2
    rng = np.random.RandomState(0)
    colors = [(255, 64, 64), (64, 255, 64), (64, 64, 255)]
    labels = []
    for i in range(N_IMAGES):
        im = rng.randint(0, 60, (SIDE, SIDE, 3), np.uint8)
        boxes = []
        for _ in range(rng.randint(1, 3)):
            cls = rng.randint(0, NUM_CLASSES)
            x1, y1 = rng.uniform(0.05, 0.5, 2)
            bw, bh = rng.uniform(0.25, 0.45, 2)
            x2, y2 = min(x1 + bw, 0.95), min(y1 + bh, 0.95)
            cv2.rectangle(im, (int(x1 * SIDE), int(y1 * SIDE)),
                          (int(x2 * SIDE), int(y2 * SIDE)),
                          colors[cls], -1)
            boxes.append([cls, x1, y1, x2, y2])
        header = [2, 5]
        for b in boxes:
            header.extend(b)
        ok, buf = cv2.imencode(".jpg", im)
        if not ok:
            raise RuntimeError("imencode failed")
        with open(os.path.join(HERE, "det_%02d.jpg" % i), "wb") as f:
            f.write(buf.tobytes())
        labels.append([float(v) for v in np.asarray(header, np.float32)])
    with open(os.path.join(HERE, "labels.json"), "w") as f:
        json.dump(labels, f)


def load():
    """-> (the JPEG bytes, the labels as float32 arrays), by index."""
    with open(os.path.join(HERE, "labels.json")) as f:
        labels = [np.asarray(l, np.float32) for l in json.load(f)]
    jpegs = []
    for i in range(len(labels)):
        with open(os.path.join(HERE, "det_%02d.jpg" % i), "rb") as f:
            jpegs.append(f.read())
    return jpegs, labels


def write_records(prefix, recordio):
    """Pack the fixture into ``prefix.rec`` and ``prefix.idx`` with
    ``recordio`` (a package's module) -> the ``.rec`` path."""
    jpegs, labels = load()
    rec, idx = prefix + ".rec", prefix + ".idx"
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    for i, (jpg, lab) in enumerate(zip(jpegs, labels)):
        w.write_idx(i, recordio.pack(
            recordio.IRHeader(len(lab), lab, i, 0), jpg))
    w.close()
    return rec


if __name__ == "__main__":
    generate()
