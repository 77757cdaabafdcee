"""Port parity for the streaming data tier (``data``: ``PrefetchQueue``,
``ShardedRecordStream``, ``StreamingDataIter``, ``StagedKFeed``),
``io.ResizeIter``/``io.PrefetchingIter`` and ``Module.fit``'s staged
K-step feed, against the JAX package, on the CPU.

Batches, cursors and the staged feed's windows are bitwise the JAX
package's; the port's staged ``fit`` is bitwise its unstaged one (the
feeder thread stacks the same feeds the step would), and within 1e-5 of
the JAX package's staged ``fit`` (of each tensor's largest magnitude)
after every window, on a two-convolution BatchNorm net fed by
``ImageRecordIter`` (3 x 32 x 32, batch 4, K = 2, four windows; the
bitwise case has a one-batch tail each epoch). Every test ends with the
threads it started gone.
"""
import os
import threading
import time

import cv2
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import recordio as jrio

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch.data import PrefetchQueue

CPU = mt.cpu()


@pytest.fixture(autouse=True)
def no_thread_left():
    """Every thread a test starts is gone when it ends."""
    before = set(threading.enumerate())
    yield
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        left = [t for t in threading.enumerate()
                if t not in before and t.is_alive()]
        if not left:
            return
        time.sleep(0.02)
    raise AssertionError("threads left running: %s" % left)


def _np(v):
    if hasattr(v, "asnumpy"):
        v = v.asnumpy()
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.array(v, dtype=np.float32, copy=True)


def _images(n, side, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        base = rng.randint(0, 256, (side // 4, side // 4, 3)).astype(np.uint8)
        out.append(cv2.resize(base, (side, side),
                              interpolation=cv2.INTER_LINEAR))
    return out


def _write(path, payloads, labels):
    w = jrio.MXIndexedRecordIO(os.path.splitext(path)[0] + ".idx", path, "w")
    for i, (p, lab) in enumerate(zip(payloads, labels)):
        w.write_idx(i, jrio.pack(jrio.IRHeader(0, lab, i, 0), p))
    w.close()
    return path


def _jpegs(images):
    return [cv2.imencode(".jpg", im, [cv2.IMWRITE_JPEG_QUALITY, 90])[1]
            .tobytes() for im in images]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream")
    rng = np.random.RandomState(0)
    raw = [rng.randn(2, 3).astype(np.float32) for _ in range(22)]
    out = {"raw": [_write(str(d / ("raw%d.rec" % f)),
                          [r.tobytes() for r in raw[f * 11:(f + 1) * 11]],
                          [float(i) for i in range(f * 11, (f + 1) * 11)])
                   for f in range(2)],
           "jpeg": _write(str(d / "img.rec"), _jpegs(_images(14, 20, 1)),
                          [float(i % 5) for i in range(14)]),
           "train": _write(str(d / "train.rec"), _jpegs(_images(12, 36, 2)),
                           [float(i % 10) for i in range(12)]),
           "train16": _write(str(d / "train16.rec"),
                             _jpegs(_images(16, 36, 4)),
                             [float(i % 10) for i in range(16)])}
    return out


# ------------------------------------------------------------ the queue
def test_prefetch_queue_delivers_stops_and_raises():
    q = PrefetchQueue(2)
    assert q.put(1) and q.put(2)
    blocked = threading.Thread(target=q.put, args=(3,))
    blocked.start()
    time.sleep(0.15)
    assert blocked.is_alive() and q.qsize() == 2   # bounded
    assert q.get() == 1
    blocked.join(1.0)
    assert q.get() == 2 and q.get() == 3
    q.put(ValueError("boom"))
    with pytest.raises(ValueError, match="boom"):
        q.get()
    q.put_sentinel()
    with pytest.raises(StopIteration):
        q.get()
    # shutdown unblocks a producer stuck on a full queue, which then stops
    q2 = PrefetchQueue(1)

    def produce():
        i = 0
        while q2.put(i):
            i += 1

    t = threading.Thread(target=produce)
    t.start()
    time.sleep(0.1)
    assert q2.shutdown(t, timeout=5.0) and q2.stopped
    assert not q2.put(99)


# ------------------------------------------------- ResizeIter, Prefetching
def test_resize_and_prefetching_iters_match_the_jax_package():
    X = np.arange(7 * 2, dtype=np.float32).reshape(7, 2)
    Y = np.arange(7, dtype=np.float32)
    out = {}
    for pkg in (mt, mx):
        base = pkg.io.NDArrayIter(X, Y, batch_size=3)
        rs = pkg.io.ResizeIter(base, 5)
        got = [(_np(b.data[0]), _np(b.label[0]), b.pad) for b in rs]
        rs.reset()
        got += [(_np(b.data[0]), _np(b.label[0]), b.pad) for b in rs]
        pf = pkg.io.PrefetchingIter(
            [pkg.io.NDArrayIter(X, Y, batch_size=2),
             pkg.io.NDArrayIter(X * 2, Y, batch_size=2, data_name="d2",
                                label_name="l2")],
            rename_data=[{"data": "a"}, {"d2": "b"}])
        got += [[d.name for d in pf.provide_data]]
        got += [(_np(b.data[0]), _np(b.data[1]), _np(b.label[1]), b.pad)
                for b in pf]
        pf.reset()
        got += [len(list(pf))]
        pf.close()
        out[pkg] = got
    assert len(out[mt]) == len(out[mx])
    for a, b in zip(out[mt], out[mx]):
        if isinstance(a, tuple):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
        else:
            assert a == b


# ------------------------------------------------------- record streams
def _stream_batches(pkg, stream, decoder, n=None, **kw):
    ctx = {"ctx": CPU} if pkg is mt else {}
    it = pkg.data.StreamingDataIter(stream, decoder, 4, **ctx, **kw)
    out, cursors = [], []
    try:
        for b in it:
            out.append((_np(b.data[0]), _np(b.label[0])))
            cursors.append(it.get_cursor())
            if n is not None and len(out) == n:
                break
    finally:
        it.close()
    return out, cursors, it


def _same(a, b):
    assert len(a) == len(b)
    for (d1, l1), (d2, l2) in zip(a, b):
        np.testing.assert_array_equal(d1, d2)
        np.testing.assert_array_equal(l1, l2)


@pytest.mark.parametrize("rank", [0, 1])
def test_streaming_raw_records_and_cursors_match_the_jax_package(files,
                                                                 rank):
    got, want = [], []
    for pkg, out in ((mt, got), (mx, want)):
        s = pkg.data.ShardedRecordStream(files["raw"], rank=rank, world=2,
                                         seed=4)
        b, c, it = _stream_batches(pkg, s, pkg.data.RawTensorDecoder((2, 3)),
                                   decode_threads=2)
        out.append((b, c, it.num_batches, s.records_per_epoch(),
                    [tuple(d.shape) for d in it.provide_data]))
    _same(got[0][0], want[0][0])
    assert got[0][1:] == want[0][1:]


def test_streaming_images_seek_and_reset_replay_bitwise(files):
    aug = dict(rand_crop=True, rand_mirror=True, pad=2, mean_r=100.0,
               std_g=50.0)
    full = {}
    for pkg in (mt, mx):
        s = pkg.data.ShardedRecordStream(files["jpeg"], seed=1)
        full[pkg] = _stream_batches(pkg, s, pkg.data.ImageDecoder(
            (3, 16, 16), **aug), decode_threads=3)[:2]
    _same(full[mt][0], full[mx][0])
    assert full[mt][1] == full[mx][1]
    # a fresh iterator sought to the first batch's cursor replays the rest
    s = mt.data.ShardedRecordStream(files["jpeg"], seed=1)
    it = mt.data.StreamingDataIter(s, mt.data.ImageDecoder((3, 16, 16),
                                                           **aug),
                                   4, decode_threads=3, ctx=CPU)
    it.seek(full[mt][1][0])
    assert it.seeks == 1
    _same([(_np(b.data[0]), _np(b.label[0])) for b in it], full[mt][0][1:])
    # reset after a partial read starts again from the consumed position
    it.seek(full[mt][1][0])
    first = next(it)
    it.reset()
    _same([(_np(first.data[0]), _np(first.label[0]))] + [
        (_np(b.data[0]), _np(b.label[0])) for b in it], full[mt][0][1:])
    with pytest.raises(mt.MXNetError, match="world"):
        it.seek(dict(full[mt][1][0], world=3))
    it.close()


# ------------------------------------------------------------ the feed
def test_staged_feed_windows_and_tail():
    X = np.arange(10 * 2, dtype=np.float32).reshape(10, 2)
    it = mt.io.NDArrayIter(X, np.arange(10, dtype=np.float32), batch_size=2)
    calls = []

    def stage(batches):
        calls.append(len(batches))
        return {"n": len(batches)}, 7

    feed = mt.data.StagedKFeed(iter(it), 2, stage, depth=2,
                               cursor_fn=lambda: "c")
    wins = []
    while True:
        try:
            wins.append(feed.next_window())
        except StopIteration:
            break
    feed.close()
    assert [len(w.batches) for w in wins] == [2, 2, 1]
    assert [w.staged for w in wins] == [{"n": 2}, {"n": 2}, None]
    assert [w.h2d_bytes for w in wins] == [7, 7, 0] and calls == [2, 2]
    assert all(w.cursor == "c" for w in wins)


def _net(sym):
    data = sym.Variable("data")
    net = data
    for i in (1, 2):
        net = sym.Convolution(net, num_filter=8, kernel=(3, 3), pad=(1, 1),
                              stride=(2, 2), name="conv%d" % i)
        net = sym.BatchNorm(net, fix_gamma=False, name="bn%d" % i)
        net = sym.Activation(net, act_type="relu", name="relu%d" % i)
    net = sym.Pooling(net, global_pool=True, pool_type="avg", kernel=(1, 1),
                      name="pool")
    net = sym.FullyConnected(sym.Flatten(net), num_hidden=10, name="fc")
    return sym.SoftmaxOutput(net, name="softmax")


def _weights(sym):
    rng = np.random.RandomState(3)
    shapes, _, _ = sym.infer_shape(data=(4, 3, 32, 32))
    return {n: rng.uniform(-0.3, 0.3, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def _quiet(mod):
    import logging
    log = logging.getLogger("data_pipeline_test")
    log.addHandler(logging.NullHandler())
    log.propagate = False
    mod.logger = log
    return mod


def _fit(pkg, path, staged=True):
    """fit over ImageRecordIter at batch 4 and K = 2 for 2 epochs (12
    records: a window and a one-batch tail an epoch; 16: two windows);
    the parameters after every dispatch, and the module."""
    sym = _net(pkg.sym)
    ctx = {"ctx": CPU} if pkg is mt else {}
    it = pkg.io.ImageRecordIter(path, (3, 32, 32), 4, shuffle=True,
                                rand_crop=True, rand_mirror=True,
                                mean_r=120.0, mean_g=115.0, mean_b=100.0,
                                std_r=60.0, std_g=60.0, std_b=60.0,
                                preprocess_threads=2, seed=5, **ctx)
    mod = _quiet(pkg.mod.Module(sym, context=mt.cpu() if pkg is mt
                                else mx.cpu()))
    snaps = []

    def snap(param):
        args, aux = mod.get_params()
        snaps.append({k: _np(v) for k, v in {**args, **aux}.items()})

    with tconfig.override(data_staged_feed=staged):
        mod.fit(it, num_epoch=2, kvstore="tpu_sync", optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                                  "wd": 1e-4},
                arg_params={k: (mx.nd.array(v) if pkg is mx else v)
                            for k, v in _weights(sym).items()},
                eval_metric=None, steps_per_dispatch=2,
                batch_end_callback=snap)
    it.close()
    # the callback fires per batch after its group: keep the snapshot of
    # each dispatch's last batch (the port counts its dispatches; the
    # JAX package's run is the same epoch plan)
    steps = mod.data_stats["steps"] if pkg is mt else \
        ([2, 2] if len(snaps) == 8 else [2, 1]) * 2
    return [snaps[i - 1] for i in np.cumsum(steps)], mod


@pytest.fixture(scope="module")
def staged_fits(files):
    return {"port": _fit(mt, files["train"]),
            "unstaged": _fit(mt, files["train"], staged=False),
            "port16": _fit(mt, files["train16"]),
            "jax16": _fit(mx, files["train16"])}


def test_staged_fit_is_bitwise_the_unstaged_fit(staged_fits):
    (got, mod), (want, mod2) = staged_fits["port"], staged_fits["unstaged"]
    assert mod.data_stats["staged"] and not mod2.data_stats["staged"]
    # per epoch: one window of 2 steps and one tail step
    assert mod.data_stats["steps"] == [2, 1, 2, 1]
    assert len(mod.data_stats["input_stall_ms"]) == 4
    assert mod.data_stats["h2d_bytes"] == [0, 0, 0, 0]   # no card
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert mod._fused.eager_steps == 6


def test_staged_fit_matches_the_jax_packages_step_by_step(staged_fits):
    got, want = staged_fits["port16"][0], staged_fits["jax16"][0]
    assert staged_fits["port16"][1].data_stats["steps"] == [2, 2, 2, 2]
    assert len(got) == len(want) == 4
    moved = False
    for step, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        for k in w:
            scale = max(float(np.abs(w[k]).max()), 1e-6)
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-5 * scale,
                                       err_msg="%s after dispatch %d"
                                       % (k, step))
        moved |= not np.array_equal(g["fc_weight"], want[0]["fc_weight"])
    assert moved
