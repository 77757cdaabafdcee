"""Port parity for row-sparse storage and the lazy row updates.

The same numpy inputs go through the JAX package (CPU, tier off:
``jnp.take``) and the port (CPU tensors: ``take_rows``'s plain
version). Storage conversions, ``retain``/``write_rows`` and the
``.params`` bytes are exact; gradients are exact (both sum the same
few terms in batch order); optimizer steps within 1e-6 of the JAX
package's (they differ at most by the order of a row mean's sum); a row
the gradient does not hold, or holds at exactly 0.0, is bitwise
unchanged.
"""
import filecmp

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.ndarray import sparse as jsp

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ndarray import sparse as tsp

DENSE = np.array([[0, 0, 0], [1.5, 2, 0], [0, 0, 0], [3, 0, -1],
                  [0, 0, 0]], np.float32)


def _both(fn_j, fn_t):
    """(JAX result, port result) as numpy."""
    return fn_j().asnumpy(), fn_t().asnumpy()


# ------------------------------------------------------------- storage
@pytest.mark.parametrize("stype", ["row_sparse", "csr"])
def test_cast_storage_both_ways_equals_the_jax_packages(stype):
    j = jsp.cast_storage(mx.nd.array(DENSE), stype)
    t = tsp.cast_storage(mt.nd.array(DENSE, ctx=mt.cpu()), stype)
    assert t.stype == stype and t.shape == DENSE.shape
    np.testing.assert_array_equal(t.data.asnumpy(), j.data.asnumpy())
    np.testing.assert_array_equal(t.indices.asnumpy(), j.indices.asnumpy())
    assert t.indices.dtype == torch.int32
    if stype == "csr":
        np.testing.assert_array_equal(t.indptr.asnumpy(),
                                      j.indptr.asnumpy())
    back = tsp.cast_storage(t, "default")
    np.testing.assert_array_equal(back.asnumpy(), DENSE)
    np.testing.assert_array_equal(t.tostype("default").asnumpy(), DENSE)
    assert mt.nd.array(DENSE, ctx=mt.cpu()).tostype(stype).stype == stype


def test_params_files_are_byte_for_byte_the_jax_packages(tmp_path):
    ja = mx.nd.array(DENSE)
    ta = mt.nd.array(DENSE, ctx=mt.cpu())
    jpath, tpath = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    mx.nd.save(jpath, {"rsp": jsp.cast_storage(ja, "row_sparse"),
                       "csr": jsp.cast_storage(ja, "csr"), "dense": ja})
    mt.nd.save(tpath, {"rsp": tsp.cast_storage(ta, "row_sparse"),
                       "csr": tsp.cast_storage(ta, "csr"), "dense": ta})
    assert filecmp.cmp(jpath, tpath, shallow=False)
    loaded = mt.nd.load(jpath, ctx=mt.cpu())
    assert loaded["rsp"].stype == "row_sparse"
    assert loaded["csr"].stype == "csr"
    for v in loaded.values():
        np.testing.assert_array_equal(v.asnumpy(), DENSE)


def test_constructors_retain_and_write_rows():
    vals = np.arange(6, dtype=np.float64).reshape(2, 3)
    j = jsp.row_sparse_array((vals, [1, 3]), shape=(5, 3))
    t = tsp.row_sparse_array((vals, [1, 3]), shape=(5, 3), ctx=mt.cpu())
    assert t.dtype == torch.float32            # 64-bit narrows
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    np.testing.assert_array_equal(*_both(
        lambda: jsp.retain(j, mx.nd.array([3, 0, 1], dtype="int32")),
        lambda: tsp.retain(t, [3, 0, 1])))
    new = np.full((2, 3), 7.0, np.float32)
    jsp.write_rows(j, np.array([0, 3]), new)
    tsp.write_rows(t, np.array([0, 3]), new)
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    np.testing.assert_array_equal(t.indices.asnumpy(), j.indices.asnumpy())
    jc = jsp.csr_matrix((DENSE[[1, 1, 3, 3], [0, 1, 0, 2]], [0, 1, 0, 2],
                         [0, 0, 2, 2, 4, 4]), shape=DENSE.shape)
    tc = tsp.csr_matrix((DENSE[[1, 1, 3, 3], [0, 1, 0, 2]], [0, 1, 0, 2],
                         [0, 0, 2, 2, 4, 4]), shape=DENSE.shape,
                        ctx=mt.cpu())
    np.testing.assert_array_equal(tc.asnumpy(), jc.asnumpy())
    np.testing.assert_array_equal(tc.asnumpy(), DENSE)


# ------------------------------------------------------------ gradients
IDS = np.array([2, 2, 5, 7, 7, 0, 9, 11], np.float32)   # 11 clips to 9


def _coef():
    """Cotangent rows; the two rows of id 2 cancel exactly."""
    c = np.random.RandomState(2).randn(len(IDS), 4).astype(np.float32)
    c[1] = -c[0]
    return c


def _embedding_grad(pkg, ctx, sparse_op):
    w0 = np.random.RandomState(3).randn(10, 4).astype(np.float32)
    w = pkg.nd.array(w0, ctx=ctx)
    w.attach_grad()
    x = pkg.nd.array(IDS, ctx=ctx)
    with pkg.autograd.record():
        if sparse_op:
            out = pkg.nd.contrib.SparseEmbedding(x, w, input_dim=10,
                                                 output_dim=4)
        else:
            out = pkg.nd.Embedding(x, w, input_dim=10, output_dim=4,
                                   sparse_grad=True)
        loss = (out * pkg.nd.array(_coef(), ctx=ctx)).sum()
    loss.backward()
    return out.asnumpy(), w.grad.asnumpy()


@pytest.mark.parametrize("sparse_op", [True, False],
                         ids=["SparseEmbedding", "Embedding_sparse_grad"])
def test_sparse_embedding_gradients_equal_the_jax_packages(sparse_op):
    jo, jg = _embedding_grad(mx, mx.cpu(), sparse_op)
    to, tg = _embedding_grad(mt, mt.cpu(), sparse_op)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(tg, jg)
    assert not tg[2].any()             # the cancelling row
    rsp = tsp.cast_storage(mt.nd.array(tg, ctx=mt.cpu()), "row_sparse")
    assert list(rsp.indices.asnumpy()) == [0, 5, 7, 9]


# ------------------------------------------------------- lazy updates
OPTS = [("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}),
        ("sgd", {"learning_rate": 0.1, "wd": 0.01}),
        ("adam", {"learning_rate": 0.01, "wd": 0.01}),
        ("adagrad", {"learning_rate": 0.1, "wd": 0.01}),
        ("groupadagrad", {"learning_rate": 0.1})]


def _embedding_net(pkg, ctx, block):
    net = block(10, 4)
    net.initialize(pkg.init.Zero(), ctx=ctx)
    net(pkg.nd.array(IDS, ctx=ctx))
    w0 = np.random.RandomState(3).randn(10, 4).astype(np.float32)
    net.weight.set_data(pkg.nd.array(w0, ctx=ctx))
    return net, w0


def _lazy_steps(pkg, ctx, opt, params, block):
    net, w0 = _embedding_net(pkg, ctx, block)
    tr = pkg.gluon.Trainer(net.collect_params(), opt, dict(params))
    coef = pkg.nd.array(_coef(), ctx=ctx)
    weights = []
    for _ in range(3):
        with pkg.autograd.record():
            loss = (net(pkg.nd.array(IDS, ctx=ctx)) * coef).sum()
        loss.backward()
        tr.step(2)
        weights.append(net.weight.data().asnumpy().copy())
    state = tr._updaters[0].states[0]
    state = state if isinstance(state, tuple) else (state,)
    return w0, weights, [s.asnumpy() if hasattr(s, "asnumpy")
                         else s.numpy() for s in state if s is not None]


@pytest.mark.parametrize("opt,params", OPTS,
                         ids=["sgd_momentum", "sgd", "adam", "adagrad",
                              "groupadagrad"])
@pytest.mark.parametrize("sparse_block", [False, True],
                         ids=["Embedding", "SparseEmbedding"])
def test_lazy_updates_equal_the_jax_packages(opt, params, sparse_block):
    if sparse_block:
        jb, tb = (mx.gluon.contrib.nn.SparseEmbedding,
                  mt.gluon.contrib.nn.SparseEmbedding)
    else:
        jb = lambda i, o: mx.gluon.nn.Embedding(i, o, sparse_grad=True)
        tb = lambda i, o: mt.gluon.nn.Embedding(i, o, sparse_grad=True)
    w0, jw, js = _lazy_steps(mx, mx.cpu(), opt, params, jb)
    _, tw, ts = _lazy_steps(mt, mt.cpu(), opt, params, tb)
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    # rows 1, 3, 4, 6 and 8 are never looked up; row 2's gradient is
    # exactly 0: all keep their bits, weight decay and momentum included
    for r in (1, 2, 3, 4, 6, 8):
        np.testing.assert_array_equal(tw[-1][r], w0[r])
    assert (tw[-1][[0, 5, 7, 9]] != w0[[0, 5, 7, 9]]).all(axis=1).all()


@pytest.mark.parametrize("opt", ["adagrad", "groupadagrad"])
@pytest.mark.parametrize("fused", [True, False],
                         ids=["fused", "per_parameter"])
def test_dense_adagrad_updates_equal_the_jax_packages(opt, fused):
    rng = np.random.RandomState(4)
    x = rng.randn(6, 5).astype(np.float32)
    w0 = rng.randn(3, 5).astype(np.float32)
    out = []
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        with pkg.config.override(trainer_fused_update=fused):
            net = pkg.gluon.nn.Dense(3, use_bias=False, in_units=5)
            net.initialize(ctx=ctx)
            net.weight.set_data(pkg.nd.array(w0, ctx=ctx))
            tr = pkg.gluon.Trainer(net.collect_params(), opt,
                                   {"learning_rate": 0.1})
            for _ in range(3):
                with pkg.autograd.record():
                    loss = (net(pkg.nd.array(x, ctx=ctx)) ** 2).sum()
                loss.backward()
                tr.step(6)
            out.append(net.weight.data().asnumpy())
    np.testing.assert_allclose(out[1], out[0], rtol=0, atol=1e-6)


# ------------------------------------------------- matrix factorization
def synthetic_ratings(num_users=200, num_items=150, rank=6, n=20000,
                      seed=0):
    """examples/matrix_factorization.py's synthetic ratings."""
    rng = np.random.RandomState(seed)
    U = rng.randn(num_users, rank) / np.sqrt(rank)
    V = rng.randn(num_items, rank) / np.sqrt(rank)
    u = rng.randint(0, num_users, n)
    i = rng.randint(0, num_items, n)
    r = (U[u] * V[i]).sum(1) + 0.05 * rng.randn(n)
    return u.astype("f4"), i.astype("f4"), r.astype("f4")


def _mf_run(pkg, ctx, u, i, r, w_user, w_item, steps=3, batch=64):
    gluon = pkg.gluon

    class MFBlock(gluon.HybridBlock):
        """examples/matrix_factorization.py's block, for either
        package."""

        def __init__(self, num_users, num_items, factor, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.user = gluon.nn.Embedding(num_users, factor,
                                               sparse_grad=True)
                self.item = gluon.nn.Embedding(num_items, factor,
                                               sparse_grad=True)

        def hybrid_forward(self, F, users, items):
            return (self.user(users) * self.item(items)).sum(axis=1)

    net = MFBlock(w_user.shape[0], w_item.shape[0], w_user.shape[1])
    net.initialize(pkg.initializer.Normal(0.1), ctx=ctx)
    net(pkg.nd.array(u[:2], ctx=ctx), pkg.nd.array(i[:2], ctx=ctx))
    net.user.weight.set_data(pkg.nd.array(w_user, ctx=ctx))
    net.item.weight.set_data(pkg.nd.array(w_item, ctx=ctx))
    loss_fn = gluon.loss.L2Loss()
    tr = gluon.Trainer(net.collect_params(), "groupadagrad",
                       {"learning_rate": 0.05})
    losses = []
    for s in range(steps):
        sl = slice(s * batch, (s + 1) * batch)
        with pkg.autograd.record():
            pred = net(pkg.nd.array(u[sl], ctx=ctx),
                       pkg.nd.array(i[sl], ctx=ctx))
            loss = loss_fn(pred, pkg.nd.array(r[sl], ctx=ctx))
        loss.backward()
        tr.step(batch)
        losses.append(float(loss.mean().asscalar()))
    return (losses, net.user.weight.data().asnumpy(),
            net.item.weight.data().asnumpy())


def test_matrix_factorization_steps_equal_the_jax_packages():
    """The example's MFBlock at its defaults (factor 16, groupadagrad lr
    0.05, L2Loss, its synthetic ratings of seed 0): three steps of 64
    from the same weights in both packages."""
    u, i, r = synthetic_ratings()
    rng = np.random.RandomState(5)
    wu = (rng.randn(200, 16) * 0.1).astype(np.float32)
    wi = (rng.randn(150, 16) * 0.1).astype(np.float32)
    jl, ju, ji = _mf_run(mx, mx.cpu(), u, i, r, wu, wi)
    tl, tu, ti = _mf_run(mt, mt.cpu(), u, i, r, wu, wi)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    np.testing.assert_allclose(tu, ju, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ti, ji, rtol=0, atol=1e-6)
    untouched = np.setdiff1d(np.arange(200), u[:192].astype(int))
    np.testing.assert_array_equal(tu[untouched], wu[untouched])
