"""Port parity for the eager NDArray (``mxnet_tpu_torch.ndarray``) and the
registry ops it reaches: the same numpy inputs (RandomState seeds)
through the JAX package's ``mx.nd`` and the port's ``mt.nd`` on the CPU.

Tolerances: f32 rtol 1e-6, atol 1e-6 for elementwise math and
rtol/atol 1e-5 where a reduction sums in another order; comparisons,
indexing and shape ops exactly.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import registry as treg

CPU = mt.cpu()


def _pair(*arrays):
    """The same numpy arrays as JAX and port NDArrays."""
    return ([mx.nd.array(a) for a in arrays],
            [mt.nd.array(a, ctx=CPU) for a in arrays])


def _close(got, want, tol=1e-6):
    g = got.asnumpy() if hasattr(got, "asnumpy") else np.asarray(got)
    w = want.asnumpy() if hasattr(want, "asnumpy") else np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


def _data(seed=0, shape=(3, 4, 5)):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            (np.abs(rng.randn(*shape)) + 0.5).astype(np.float32))


OPS = [
    lambda a, b: a + b, lambda a, b: a - b, lambda a, b: a * b,
    lambda a, b: a / b, lambda a, b: a ** 2, lambda a, b: 2 ** a,
    lambda a, b: a + 1.5, lambda a, b: 1.5 + a, lambda a, b: a - 0.25,
    lambda a, b: 3 - a, lambda a, b: a * 0.3, lambda a, b: a / 7.0,
    lambda a, b: 2.0 / b, lambda a, b: -a, lambda a, b: abs(a),
    lambda a, b: a > 0, lambda a, b: a >= b, lambda a, b: a < 0.1,
    lambda a, b: a <= b, lambda a, b: a == a, lambda a, b: a != b,
    lambda a, b: a + b[0:1], lambda a, b: a * b[:, 1:2],
]


@pytest.mark.parametrize("i", range(len(OPS)))
def test_operators_match_the_jax_package(i):
    a, b = _data(i)
    (ja, jb), (ta, tb) = _pair(a, b)
    _close(OPS[i](ta, tb), OPS[i](ja, jb))


def test_in_place_operators_rebind_and_keep_the_old_tensor():
    a, b = _data(1)
    (ja, jb), (ta, tb) = _pair(a, b)
    old = ta.data
    for j, t in ((ja, ta),):
        j += jb
        j -= 0.5
        j *= jb
        j /= 2.0
        t += tb
        t -= 0.5
        t *= tb
        t /= 2.0
    _close(ta, ja)
    assert ta.data is not old
    np.testing.assert_array_equal(old.numpy(), a)   # untouched


KEYS = [1, -1, slice(1, 3), (slice(None), 2), (0, slice(1, None), 3),
        (slice(None), slice(2, None), slice(None)), (Ellipsis, 0),
        (slice(None, None, 2),)]


@pytest.mark.parametrize("key", KEYS, ids=range(len(KEYS)))
def test_getitem_matches_the_jax_package(key):
    a, _ = _data(2)
    (ja,), (ta,) = _pair(a)
    got, want = ta[key], ja[key]
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def test_setitem_writes_a_copy():
    a, _ = _data(3)
    (ja,), (ta,) = _pair(a)
    old = ta.data
    for x in (ja, ta):
        x[1] = 5.0
        x[:, 0:1] = x[:, 1:2] * 2
        x[0, 1:3, 2] = -1.0
    np.testing.assert_array_equal(ta.asnumpy(), ja.asnumpy())
    np.testing.assert_array_equal(old.numpy(), a)
    ta[:] = 0
    assert not ta.asnumpy().any()


@pytest.mark.parametrize("method", ["sum", "mean", "max", "min", "prod"])
@pytest.mark.parametrize("axis,keepdims", [(None, False), (None, True),
                                           (1, False), ((0, 2), True),
                                           (-1, False), ((), False)])
def test_reductions_match_the_jax_package(method, axis, keepdims):
    a, _ = _data(4)
    (ja,), (ta,) = _pair(a)
    got = getattr(ta, method)(axis=axis, keepdims=keepdims)
    want = getattr(ja, method)(axis=axis, keepdims=keepdims)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("name,kw", [
    ("sum", {"axis": 1, "exclude": True}),
    ("mean", {"axis": (0, 1), "exclude": True, "keepdims": True}),
    ("norm", {}), ("norm", {"axis": 1, "ord": 1}),
    ("norm", {"axis": (1, 2), "keepdims": True}),
])
def test_reduce_ops_match_the_jax_package(name, kw):
    a, _ = _data(5)
    (ja,), (ta,) = _pair(a)
    _close(getattr(mt.nd, name)(ta, **kw), getattr(mx.nd, name)(ja, **kw),
           1e-5)


UNARY = ["abs", "square", "sqrt", "exp", "log", "tanh", "negative",
         "sigmoid", "relu"]


@pytest.mark.parametrize("name", UNARY)
def test_unary_ops_match_the_jax_package(name):
    a, b = _data(6)
    x = b if name in ("sqrt", "log") else a
    (jx,), (tx,) = _pair(x)
    _close(getattr(mt.nd, name)(tx), getattr(mx.nd, name)(jx), 2e-6)


@pytest.mark.parametrize("name,kw", [
    ("clip", {"a_min": -0.5, "a_max": 0.7}),
    ("log_softmax", {"axis": -1}), ("log_softmax", {"axis": 1,
                                                    "temperature": 2.0}),
    ("swapaxes", {"dim1": 0, "dim2": 2}),
    ("broadcast_to", {"shape": (2, 3, 4, 5)}),
    ("LeakyReLU", {"act_type": "elu", "slope": 0.3}),
    ("LeakyReLU", {"act_type": "selu"}),
    ("InstanceNorm", {"eps": 1e-3}),
    ("Dropout", {"p": 0.0}), ("_copy", {}), ("BlockGrad", {}),
    ("zeros_like", {}), ("ones_like", {}),
    ("_rpower_scalar", {"scalar": 1.5}), ("Cast", {"dtype": "float16"}),
])
def test_more_ops_match_the_jax_package(name, kw):
    a, _ = _data(7)
    (ja,), (ta,) = _pair(a)
    extra = []
    if name == "InstanceNorm":
        g, bt = np.random.RandomState(1).rand(2, 4).astype(np.float32)
        extra = [g, bt]
    jx = [ja] + [mx.nd.array(e) for e in extra]
    tx = [ta] + [mt.nd.array(e, ctx=CPU) for e in extra]
    _close(getattr(mt.nd, name)(*tx, **kw), getattr(mx.nd, name)(*jx, **kw),
           1e-5)


def test_prelu_matches_the_jax_package():
    a, _ = _data(8)
    g = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    (ja, jg), (ta, tg) = _pair(a, g)
    _close(mt.nd.LeakyReLU(ta, tg, act_type="prelu"),
           mx.nd.LeakyReLU(ja, jg, act_type="prelu"))


@pytest.mark.parametrize("keepdims", [False, True])
@pytest.mark.parametrize("axis", [-1, 1])
def test_pick_clips_like_the_jax_package(axis, keepdims):
    a, _ = _data(9)
    n = a.shape[axis]
    shp = list(a.shape)
    del shp[axis]
    idx = np.random.RandomState(2).randint(-2, n + 3, shp).astype(np.float32)
    (ja, ji), (ta, ti) = _pair(a, idx)
    _close(mt.nd.pick(ta, ti, axis=axis, keepdims=keepdims),
           mx.nd.pick(ja, ji, axis=axis, keepdims=keepdims), 0)


@pytest.mark.parametrize("kw", [{}, {"lhs_begin": 1, "lhs_end": 3,
                                     "rhs_begin": 0, "rhs_end": 1}])
def test_reshape_like_matches_the_jax_package(kw):
    a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    b = np.zeros((6, 4), np.float32) if not kw \
        else np.zeros((12, 5), np.float32)
    (ja, jb), (ta, tb) = _pair(a, b)
    _close(mt.nd.reshape_like(ta, tb, **kw),
           mx.nd.reshape_like(ja, jb, **kw), 0)


def test_concat_dot_where_match_the_jax_package():
    a, b = _data(10, (4, 5))
    (ja, jb), (ta, tb) = _pair(a, b)
    _close(mt.nd.concat(ta, tb, dim=0), mx.nd.concat(ja, jb, dim=0), 0)
    _close(mt.nd.dot(ta, tb, transpose_b=True),
           mx.nd.dot(ja, jb, transpose_b=True), 1e-5)
    _close(ta.dot(tb.T), ja.dot(jb.T), 1e-5)
    _close(mt.nd.where(ta > 0, ta, tb), mx.nd.where(ja > 0, ja, jb), 0)
    c = (np.arange(4) % 2).astype(np.float32)
    (jc,), (tc,) = _pair(c)
    _close(mt.nd.where(tc, ta, tb), mx.nd.where(jc, ja, jb), 0)


def test_fluent_shape_methods_match_the_jax_package():
    a, _ = _data(11, (2, 3, 4))
    (ja,), (ta,) = _pair(a)
    for f in (lambda x: x.reshape((0, -1)), lambda x: x.reshape(6, 4),
              lambda x: x.flatten(), lambda x: x.transpose((2, 0, 1)),
              lambda x: x.T, lambda x: x.expand_dims(1).squeeze(1),
              lambda x: x.slice_axis(1, 1, 3),
              lambda x: x.split(2, axis=2)[1], lambda x: x.softmax(),
              lambda x: x.log_softmax(axis=0), lambda x: x.clip(-0.1, 0.1),
              lambda x: x.astype("float16").astype("float32"),
              lambda x: x.copy(), lambda x: x.broadcast_like(x)):
        _close(f(ta), f(ja), 1e-6)


def test_creation_functions_match_the_jax_package():
    pairs = [(mt.nd.zeros((2, 3), ctx=CPU), mx.nd.zeros((2, 3))),
             (mt.nd.ones(4, ctx=CPU), mx.nd.ones(4)),
             (mt.nd.full((2, 2), 3.5, ctx=CPU), mx.nd.full((2, 2), 3.5)),
             (mt.nd.empty((3,), ctx=CPU), mx.nd.empty((3,))),
             (mt.nd.arange(2, 11, 3, ctx=CPU), mx.nd.arange(2, 11, 3)),
             (mt.nd.arange(4, repeat=2, ctx=CPU), mx.nd.arange(4, repeat=2)),
             (mt.nd.array([[1, 2], [3, 4]], ctx=CPU),
              mx.nd.array([[1, 2], [3, 4]])),
             (mt.nd.array(np.arange(3, dtype=np.int64), ctx=CPU),
              mx.nd.array(np.arange(3, dtype=np.int64)))]
    for got, want in pairs:
        _close(got, want, 0)
        assert str(got.dtype).replace("torch.", "") == \
            str(np.dtype(want.dtype)), (got.dtype, want.dtype)
    assert mt.nd.array(np.float64([1.5]), ctx=CPU).dtype == torch.float32
    x = mt.nd.array([1.0, 2.0], ctx=CPU)
    assert x.context == CPU and x.shape == (2,) and x.size == 2
    assert x.ndim == 1 and len(x) == 2 and x[1].asscalar() == 2.0
    assert float(x.sum().asnumpy()) == 3.0 and x.tolist() == [1.0, 2.0]
    mt.nd.waitall()


def test_asnumpy_is_a_snapshot():
    x = mt.nd.array([1.0, 2.0], ctx=CPU)
    snap = x.asnumpy()
    with torch.no_grad():
        x.data.add_(1.0)
    np.testing.assert_array_equal(snap, [1.0, 2.0])


def test_generated_namespaces_cover_the_registry_and_contrib():
    for name in treg.list_ops():
        assert callable(getattr(mt.nd, name)), name
    assert mt.nd.contrib.FlashAttention.__name__ == "_contrib_FlashAttention"
    q = np.random.RandomState(0).randn(1, 2, 8, 4).astype(np.float32)
    (jq,), (tq,) = _pair(q)
    _close(mt.nd.contrib.FlashAttention(tq, tq, tq, causal=True),
           mx.nd.contrib.FlashAttention(jq, jq, jq, causal=True), 1e-5)


NEW_OPS = ["_minus_scalar", "_rminus_scalar", "_div_scalar", "_rdiv_scalar",
           "_power_scalar", "_equal_scalar", "_lesser_equal_scalar",
           "broadcast_sub", "broadcast_div", "broadcast_maximum",
           "broadcast_equal", "negative", "log", "exp", "abs", "square",
           "sqrt", "relu", "sigmoid", "clip", "where", "zeros_like",
           "ones_like", "sum", "mean", "max", "min", "prod", "norm",
           "broadcast_to", "broadcast_like", "pick",
           "reshape_like", "Concat", "swapaxes", "dot",
           "log_softmax", "InstanceNorm", "Dropout", "LeakyReLU", "_zeros",
           "_ones", "_full", "_arange", "_copy", "BlockGrad"]


@pytest.mark.parametrize("name", NEW_OPS)
def test_new_ops_keep_the_jax_signatures(name):
    j, t = jreg.get(name), treg.get(name)
    assert t.param_names == j.param_names
    assert t.input_names == j.input_names
    assert t.has_var_inputs == j.has_var_inputs


def test_dropout_raises_in_training_and_is_the_identity_elsewhere():
    """Dropout no longer raises in training: it draws its mask from the
    random key chain (``test_torch_port_random.py`` holds it against
    the JAX package's); at p = 0 and outside training it is the
    identity."""
    x = mt.nd.array(np.ones((2, 3), np.float32), ctx=CPU)
    with mt.autograd.train_mode():
        np.testing.assert_array_equal(mt.nd.Dropout(x, p=0.0).asnumpy(),
                                      1.0)
        y = mt.nd.Dropout(x, p=0.5).asnumpy()
    assert set(np.unique(y)) <= {0.0, 2.0}
    np.testing.assert_array_equal(mt.nd.Dropout(x, p=0.5).asnumpy(), 1.0)


def test_save_load_raise_naming_the_roadmap_item(tmp_path):
    """``save`` and ``load`` no longer raise: the ``.params`` format is
    ported (``test_torch_port_params.py`` holds its bytes against the
    JAX package's); a list and a dict round-trip here."""
    x = mt.nd.array(np.arange(3, dtype=np.float32), ctx=CPU)
    mt.nd.save(str(tmp_path / "x.params"), [x])
    mt.nd.save(str(tmp_path / "d.params"), {"w": x})
    got = mt.nd.load(str(tmp_path / "x.params"), ctx=CPU)
    np.testing.assert_array_equal(got[0].asnumpy(), x.asnumpy())
    got = mt.nd.load(str(tmp_path / "d.params"), ctx=CPU)
    np.testing.assert_array_equal(got["w"].asnumpy(), x.asnumpy())


def test_creation_defaults_to_the_card():
    if torch.cuda.is_available():
        assert mt.nd.zeros((1,)).data.device.type == "cuda"
        return
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.nd.array([1.0])
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.nd.zeros((2,))
    with mt.cpu():
        assert mt.nd.ones((2,)).context == CPU
