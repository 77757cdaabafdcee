"""Port parity: BASELINE configuration 5's sparse linear classification
(``examples/sparse_linear_classification.py``): ``io.LibSVMIter`` and
the sparse ``zeros``/``dot``/``add`` against the JAX package, then the
example's loop in both packages.

``LibSVMIter`` batches are bitwise the JAX iterator's. ``dot`` and the
row_sparse ``add`` are bitwise too: both sum each output row's terms
one after another from zero in entry order, which is the order of the
JAX package's scatter-add on the CPU. The loop's accuracies are equal
and its weights within 1e-6 (the kvstore's AdaGrad is a few f32
operations a row, each package's own sqrt and division).
"""
import os
import sys

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.ndarray import sparse as jsp

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ndarray import sparse as tsp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import example_nets as en  # noqa: E402

LIBSVM = """# a comment line, then a blank one

1 0:0.5 3:-1.25 7:2
0 2:1 5:0.75
# another comment
1 1:-0.5
  0 0:1 1:2 2:3 3:4 4:5 5:6 6:7 7:8
4:0.25 6:-3
1 7:1e-3

0 3:0.125
"""
LABELS = """0:1 2:1
1:1
0:0.5 1:0.5
2:1
0:1
1:1 2:1
2:0.25
"""


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("libsvm")
    data, label = d / "data.libsvm", d / "label.libsvm"
    data.write_text(LIBSVM)
    label.write_text(LABELS)
    return str(data), str(label)


def _csr_parts(a):
    return (a.indptr.asnumpy(), a.indices.asnumpy(), a.data.asnumpy(),
            tuple(a.shape))


def _same_batches(jit, tit):
    assert tit.provide_data == jit.provide_data
    assert tit.provide_label == jit.provide_label
    n = 0
    for epoch in range(2):
        jit.reset()
        tit.reset()
        with mt.cpu():
            jb, tb = list(jit), list(tit)
        assert len(tb) == len(jb)
        for a, b in zip(jb, tb):
            assert b.pad == a.pad
            for x, y in zip(a.data + a.label, b.data + b.label):
                if isinstance(x, jsp.CSRNDArray):
                    assert isinstance(y, tsp.CSRNDArray)
                    for u, v in zip(_csr_parts(x), _csr_parts(y)):
                        np.testing.assert_array_equal(v, u)
                else:
                    np.testing.assert_array_equal(y.asnumpy(), x.asnumpy())
                    assert y.asnumpy().dtype == x.asnumpy().dtype
            n += 1
    return n


@pytest.mark.parametrize("batch,parts,part", [(3, 1, 0), (4, 2, 1),
                                              (16, 3, 0)],
                         ids=["wrap", "part", "batch>data"])
def test_libsvm_iter_matches(files, batch, parts, part):
    kw = dict(data_libsvm=files[0], data_shape=(8,), batch_size=batch,
              num_parts=parts, part_index=part)
    assert _same_batches(mx.io.LibSVMIter(**kw), mt.io.LibSVMIter(**kw)) > 0


def test_libsvm_iter_with_a_label_file_matches(files):
    kw = dict(data_libsvm=files[0], data_shape=8, label_libsvm=files[1],
              label_shape=(3,), batch_size=3)
    assert _same_batches(mx.io.LibSVMIter(**kw), mt.io.LibSVMIter(**kw)) > 0


@pytest.mark.parametrize("kw,match", [
    (dict(data_shape=(2, 4)), "dimension of data_shape"),
    (dict(data_shape=(8,), num_parts=2, part_index=2), "num_parts"),
    (dict(data_shape=(8,), round_batch=False), "round_batch"),
    (dict(data_shape=(8,), label_shape=(3,)), "label_libsvm is NULL"),
    (dict(data_shape=(8,), label_libsvm="L"), "not expected to be"),
])
def test_libsvm_iter_refuses_as_the_jax_one(files, kw, match):
    for pkg in (mx, mt):
        with pytest.raises(ValueError, match=match):
            pkg.io.LibSVMIter(data_libsvm=files[0], **kw)


def test_libsvm_batches_land_on_the_current_context(files):
    it = mt.io.LibSVMIter(files[0], (8,), batch_size=2)
    with mt.cpu():
        b = next(iter(it))
    assert b.data[0]._values.device.type == "cpu"
    assert b.label[0]._data.device.type == "cpu"
    assert isinstance(b.data[0], tsp.CSRNDArray)


# ---------------------------------------------------- zeros, dot, add
def _dense_csr(rows=40, cols=300, seed=0, empty_rows=(3, 17)):
    rng = np.random.RandomState(seed)
    d = np.zeros((rows, cols), np.float32)
    for r in range(rows):
        if r in empty_rows:
            continue
        idx = rng.choice(cols, rng.randint(1, 13), replace=False)
        d[r, idx] = rng.randn(len(idx))
    d[:, 5] = rng.randn(rows)                  # one hot column
    d[empty_rows, 5] = 0.0
    return d


@pytest.mark.parametrize("transpose_a", [False, True])
def test_csr_dot_matches_bitwise(transpose_a):
    d = _dense_csr()
    rng = np.random.RandomState(1)
    rhs = rng.randn(d.shape[0] if transpose_a else d.shape[1], 3) \
        .astype(np.float32)
    want = jsp.dot(jsp.csr_matrix(d), mx.nd.array(rhs),
                   transpose_a=transpose_a).asnumpy()
    with mt.cpu():
        got = tsp.dot(tsp.csr_matrix(d), mt.nd.array(rhs),
                      transpose_a=transpose_a)
    assert isinstance(got, mt.nd.NDArray)
    np.testing.assert_array_equal(got.asnumpy(), want)


def test_dot_of_other_operands_matches():
    """A row_sparse operand is densified; dense pairs go to the op."""
    rng = np.random.RandomState(2)
    a = rng.randn(6, 4).astype(np.float32)
    a[[1, 4]] = 0
    b = rng.randn(4, 5).astype(np.float32)
    want = jsp.dot(jsp.row_sparse_array(a), mx.nd.array(b)).asnumpy()
    want_t = jsp.dot(mx.nd.array(b), mx.nd.array(a), transpose_a=True,
                     transpose_b=True).asnumpy()
    with mt.cpu():
        got = tsp.dot(tsp.row_sparse_array(a), mt.nd.array(b)).asnumpy()
        got_t = tsp.dot(mt.nd.array(b), mt.nd.array(a), transpose_a=True,
                        transpose_b=True).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_t, want_t, rtol=1e-6, atol=1e-6)


def test_row_sparse_add_matches_bitwise():
    rng = np.random.RandomState(3)
    l, li = rng.randn(10, 4).astype(np.float32), \
        np.sort(rng.choice(50, 10, replace=False))
    r, ri = rng.randn(8, 4).astype(np.float32), \
        np.sort(rng.choice(50, 8, replace=False))
    want = jsp.add(jsp.row_sparse_array((l, li), shape=(50, 4)),
                   jsp.row_sparse_array((r, ri), shape=(50, 4)))
    with mt.cpu():
        got = tsp.add(tsp.row_sparse_array((l, li), shape=(50, 4)),
                      tsp.row_sparse_array((r, ri), shape=(50, 4)))
        dense = tsp.add(mt.nd.array(l), tsp.row_sparse_array(l))
    assert isinstance(got, tsp.RowSparseNDArray)
    np.testing.assert_array_equal(got.indices.asnumpy(),
                                  want.indices.asnumpy())
    np.testing.assert_array_equal(got.data.asnumpy(), want.data.asnumpy())
    np.testing.assert_array_equal(dense.asnumpy(), 2 * l)


@pytest.mark.parametrize("stype", ["row_sparse", "csr", "default"])
def test_sparse_zeros_match(stype):
    want = jsp.zeros(stype, (5, 3))
    with mt.cpu():
        got = tsp.zeros(stype, (5, 3))
    assert got.stype == want.stype
    assert got.shape == want.shape
    assert got.asnumpy().dtype == want.asnumpy().dtype
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    if stype != "default":
        assert got.data.shape[0] == 0


def test_the_port_exports_the_sparse_surface():
    for name in ("dot", "zeros"):
        assert name in tsp.__all__ and name in jsp.__all__
    assert mt.nd.sparse.add is tsp.add
    assert mt.io.LibSVMIter is mt.io.io.LibSVMIter


# ------------------------------------------------------------ the loop
@pytest.fixture(scope="module")
def example_file(tmp_path_factory):
    return en.make_synthetic_libsvm(
        os.path.join(str(tmp_path_factory.mktemp("lc")), "lc.libsvm"),
        n=400, dim=200)


def test_sparse_linear_classification_matches(example_file):
    """The example's loop, 2 epochs at 200 features and 400 rows: the
    same accuracies and weights after each epoch within 1e-6."""
    runs = {}
    for pkg in (mx, mt):
        ws = []
        with (mt.cpu() if pkg is mt else mx.cpu()):
            accs = en.sparse_linear(
                pkg, example_file, num_features=200, epochs=2,
                on_epoch=lambda e, w, b: ws.append(
                    (w.asnumpy().copy(), b.asnumpy().copy())))
        runs[pkg.__name__] = (accs, ws)
    (ja, jw), (ta, tw) = runs["mxnet_tpu"], runs["mxnet_tpu_torch"]
    assert ta == ja
    for (w1, b1), (w0, b0) in zip(tw, jw):
        np.testing.assert_allclose(w1, w0, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(b1, b0, rtol=1e-6, atol=1e-6)
    assert ta[-1] > ta[0]
