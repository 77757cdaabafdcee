"""Port parity for the random key chain (``mxnet_tpu_torch.random``,
``ops/random_ops.py``, ``nd.random``, Dropout and ``rrelu``) against the
JAX package, on the CPU.

After ``seed(s)`` in both packages these are bitwise equal: the raw
keys (the chain's, ``split`` and ``fold_in``), uniform, randint,
Bernoulli (Dropout) masks, ``_shuffle`` and multinomial draws. Normal
and exponential draws hash the same bits; the transcendental after the
hash is torch's ``log1p`` (and XLA's ``erf_inv`` polynomial evaluated
in torch) against XLA's, so they are held within ``ULP`` = 4 f32 units
in the last place (measured: 3 for normal, 1 for exponential, over
200000 draws).

The chain's state is compared after every kind of call, not only the
draws: an unrecorded eager random op splits the chain once, a recorded
one draws one key and folds it at site 0, a hybridized call draws one
key whether or not a random op runs in it (its ops fold it at sites
0, 1, ...), and an executor forward draws one key.
"""
import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt

CPU = mt.cpu()
ULP = 4


def _ulp(a, b):
    """Distance in f32 units in the last place (sign-aware)."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def _state(pkg):
    return np.asarray(pkg.random.get_state()[0], np.uint32)


def _seed(s):
    mx.random.seed(s)
    mt.random.seed(s)


def _j(x):
    """numpy of an NDArray (or of a port executor's tensor)."""
    if hasattr(x, "asnumpy"):
        return np.asarray(x.asnumpy())
    return x.detach().cpu().numpy()


# ----------------------------------------------------------------- keys
def test_raw_keys_split_and_fold_in_are_bitwise():
    import jax
    _seed(11)
    for _ in range(3):
        jk = np.asarray(jax.random.key_data(mx.random.next_key()))
        np.testing.assert_array_equal(mt.random.next_key(), jk)
        np.testing.assert_array_equal(_state(mt), _state(mx))
    key = jax.random.PRNGKey(123)
    pk = mt.random.prng_key(123)
    np.testing.assert_array_equal(pk, np.asarray(key))
    np.testing.assert_array_equal(mt.random.split(pk, 7),
                                  np.asarray(jax.random.split(key, 7)))
    for d in (0, 1, 2 ** 31 + 5, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            mt.random.fold_in(pk, d), np.asarray(jax.random.fold_in(key, d)))


def test_get_state_set_state_round_trip():
    _seed(5)
    snap = mt.random.get_state()
    a = mt.nd.random.uniform(shape=(4,), ctx=CPU).asnumpy()
    mt.random.set_state(snap)
    b = mt.nd.random.uniform(shape=(4,), ctx=CPU).asnumpy()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(_state(mt), mt.random.get_state()[0])
    # the numpy half comes back too, and the JAX snapshot restores the port
    jsnap = mx.random.get_state()
    mt.random.set_state(jsnap)
    np.testing.assert_array_equal(_state(mt), _state(mx))
    mt.random.set_state((None, None))
    assert mt.random.get_state()[0] is None


# ---------------------------------------------------------------- draws
BITWISE = {
    "uniform": lambda nd, c: nd.random.uniform(-2.0, 3.0, shape=(3, 40),
                                               **c),
    "uniform_default": lambda nd, c: nd.random.uniform(shape=(257,), **c),
    "randint": lambda nd, c: nd.random.randint(-7, 1000, shape=(5, 33),
                                               **c),
    "randint_full": lambda nd, c: nd.random.randint(-2 ** 31, 2 ** 31 - 1,
                                                    shape=(64,), **c),
    "randint_u8": lambda nd, c: nd.random.randint(0, 256, shape=(64,),
                                                  dtype="uint8", **c),
    "uniform_f16": lambda nd, c: nd.random.uniform(shape=(50,),
                                                   dtype="float16", **c),
}


def _ctx(pkg):
    return {"ctx": CPU} if pkg is mt else {}


@pytest.mark.parametrize("name", sorted(BITWISE))
def test_no_input_draws_are_bitwise(name):
    outs = []
    for pkg in (mx, mt):
        pkg.random.seed(42)
        outs.append([_j(BITWISE[name](pkg.nd, _ctx(pkg))) for _ in range(2)])
        if pkg is mt:
            np.testing.assert_array_equal(_state(mt), _state(mx))
    for t, j in zip(outs[1], outs[0]):
        assert t.dtype == j.dtype
        np.testing.assert_array_equal(t, j)


CLOSE = {
    "normal": lambda nd, c: nd.random.normal(shape=(4000,), **c),
    "normal_affine": lambda nd, c: nd.random.normal(0.5, 2.0, shape=(4000,),
                                                    **c),
    "randn": lambda nd, c: nd.random.randn(30, 7, **c),
    "exponential": lambda nd, c: nd.random.exponential(3.0, shape=(4000,),
                                                       **c),
}


@pytest.mark.parametrize("name", sorted(CLOSE))
def test_normal_and_exponential_draws_within_ulp(name):
    outs = []
    for pkg in (mx, mt):
        pkg.random.seed(7)
        outs.append(_j(CLOSE[name](pkg.nd, _ctx(pkg))))
    if name == "normal_affine":
        # loc + scale * z cancels near 0: hold it at the draw's ulps,
        # scaled to the output's magnitude
        atol = ULP * np.spacing(np.abs(outs[0]).max())
        np.testing.assert_allclose(outs[1], outs[0], rtol=0, atol=atol)
    else:
        assert _ulp(outs[1], outs[0]).max() <= ULP


def _arr(pkg, a):
    return pkg.nd.array(a, ctx=CPU) if pkg is mt else pkg.nd.array(a)


def test_array_parameter_samplers():
    rng = np.random.RandomState(0)
    low = rng.uniform(-1, 0, (3, 4)).astype(np.float32)
    high = low + rng.uniform(0.5, 2, (3, 4)).astype(np.float32)
    probs = rng.dirichlet(np.ones(6), 5).astype(np.float32)
    rows = rng.randn(9, 3).astype(np.float32)
    got = {}
    for pkg in (mx, mt):
        pkg.random.seed(3)
        lo, hi, pr = _arr(pkg, low), _arr(pkg, high), _arr(pkg, probs)
        draws, lp = pkg.nd.random.multinomial(pr, shape=(4,), get_prob=True)
        got[pkg] = [
            _j(pkg.nd.random.uniform(lo, hi, shape=(2,))),
            _j(pkg.nd.random.multinomial(pr)),
            _j(draws), _j(lp),
            _j(pkg.nd.random.shuffle(_arr(pkg, rows))),
            _j(pkg.nd._random_uniform_like(lo, low=1.0, high=2.0)),
            _j(pkg.nd.random.normal(lo, hi, shape=(3,))),
            _j(pkg.nd._random_normal_like(lo)),
        ]
    jx, tx = got[mx], got[mt]
    for i in range(6):
        if i == 3:
            np.testing.assert_allclose(tx[i], jx[i], rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(tx[i], jx[i])
    for i in (6, 7):
        np.testing.assert_allclose(tx[i], jx[i], rtol=1e-5, atol=1e-6)
    # a shuffle permutes whole rows
    assert sorted(map(tuple, tx[4])) == sorted(map(tuple, rows))


@pytest.mark.parametrize("fn", [
    lambda nd: nd.random.gamma(2.0, 1.0, shape=(3,), ctx=CPU),
    lambda nd: nd.random.poisson(2.0, shape=(3,), ctx=CPU),
    lambda nd: nd.random.negative_binomial(2, 0.5, shape=(3,), ctx=CPU),
    lambda nd: nd.random.generalized_negative_binomial(1.0, 0.5, shape=(3,),
                                                       ctx=CPU),
    lambda nd: nd.random.gamma(nd.array(np.ones(2), ctx=CPU),
                               nd.array(np.ones(2), ctx=CPU)),
])
def test_the_gamma_family_raises_naming_its_roadmap_item(fn):
    with pytest.raises(mt.MXNetError, match="A3b.1b"):
        fn(mt.nd)


# ------------------------------------------------------- Dropout masks
X = np.random.RandomState(1).randn(4, 6).astype(np.float32) + 3.0


def _dropout_program(pkg, kind):
    """One Dropout draw of ``kind`` after seed 9, and the chain state
    after it."""
    pkg.random.seed(9)
    x = _arr(pkg, X)
    if kind == "eager_unrecorded":
        with pkg.autograd.train_mode():
            y = pkg.nd.Dropout(x, p=0.4)
    elif kind == "eager_always":
        y = pkg.nd.Dropout(x, p=0.4, mode="always")
    elif kind == "eager_recorded":
        x.attach_grad()
        with pkg.autograd.record():
            y = pkg.nd.Dropout(x, p=0.4)
        y.backward()
    else:
        blk = pkg.gluon.nn.HybridSequential()
        blk.add(pkg.gluon.nn.Dropout(0.4), pkg.gluon.nn.Dropout(0.25))
        blk.initialize(ctx=CPU) if pkg is mt else blk.initialize()
        blk.hybridize()
        x.attach_grad()
        with pkg.autograd.record():
            y = blk(x)
        y.backward()
    out = [_j(y), _state(pkg)]
    if kind in ("eager_recorded", "hybridized"):
        out.append(_j(x.grad))
    return out


@pytest.mark.parametrize("kind", ["eager_unrecorded", "eager_always",
                                  "eager_recorded", "hybridized"])
def test_dropout_masks_are_bitwise_on_every_path(kind):
    """Masks and chain states bitwise; the kept values within 1 f32
    rounding (XLA rewrites the two divisions of the hybridized pair)."""
    j = _dropout_program(mx, kind)
    t = _dropout_program(mt, kind)
    np.testing.assert_array_equal(t[0] != 0, j[0] != 0)
    np.testing.assert_array_equal(t[1], j[1])
    for a, b in zip(t[::2], j[::2]):
        np.testing.assert_allclose(a, b, rtol=2e-7, atol=0)
    kept = j[0] != 0
    assert 0 < kept.sum() < kept.size


def test_a_hybridized_call_without_a_random_op_advances_the_chain():
    outs = []
    for pkg in (mx, mt):
        pkg.random.seed(13)
        net = pkg.gluon.nn.Dense(3, in_units=6)
        net.initialize(ctx=CPU) if pkg is mt else net.initialize()
        net.hybridize()
        x = _arr(pkg, X)
        before = _state(pkg)
        net(x)
        after_one = _state(pkg)
        net(x)
        with pkg.autograd.train_mode():
            y = pkg.nd.Dropout(x, p=0.5)
        outs.append([before, after_one, _state(pkg), _j(y)])
    for a, b in zip(outs[1], outs[0]):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(outs[1][0], outs[1][1])


def test_dropout_axes_and_an_eval_call_draw_nothing():
    outs = []
    for pkg in (mx, mt):
        pkg.random.seed(21)
        x = _arr(pkg, np.ones((2, 3, 5), np.float32))
        s0 = _state(pkg)
        pkg.nd.Dropout(x, p=0.5)            # predict mode: the identity
        s1 = _state(pkg)
        with pkg.autograd.train_mode():
            y = pkg.nd.Dropout(x, p=0.5, axes=(1,))
        outs.append([s0, s1, _j(y)])
    np.testing.assert_array_equal(outs[1][2], outs[0][2])
    np.testing.assert_array_equal(outs[1][0], outs[1][1])
    y = outs[1][2]
    assert (y == y[:, :1, :]).all()       # one mask value along axis 1


def test_an_executor_forward_draws_one_key():
    outs = []
    for pkg in (mx, mt):
        pkg.random.seed(17)
        data = pkg.sym.var("data")
        net = pkg.sym.Dropout(pkg.sym.FullyConnected(
            data, num_hidden=5, name="fc"), p=0.5)
        ex = net.simple_bind(ctx=CPU if pkg is mt else mx.cpu(),
                             data=(3, 4))
        rng = np.random.RandomState(0)
        for name in sorted(ex.arg_dict):
            val = rng.randn(*ex.arg_dict[name].shape).astype(np.float32)
            if pkg is mt:
                ex.arg_dict[name].copy_(mt.nd.array(val, ctx=CPU).data)
            else:
                ex.arg_dict[name][:] = val
        states, ys = [], []
        for is_train in (True, False, True):
            ys.append(_j(ex.forward(is_train=is_train)[0]))
            states.append(_state(pkg))
        outs.append((ys, states))
    for a, b in zip(outs[1][1], outs[0][1]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(outs[1][0], outs[0][0]):
        # the masks bitwise; the FullyConnected under them to f32 rounding
        np.testing.assert_array_equal(a != 0, b != 0)
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    assert (outs[1][0][0] == 0).any() and (outs[1][0][1] != 0).all()


def test_rrelu_matches_eager_and_hybridized():
    xin = np.random.RandomState(2).randn(3, 8).astype(np.float32)
    outs = []
    for pkg in (mx, mt):
        pkg.random.seed(4)
        x = _arr(pkg, xin)
        eager = _j(pkg.nd.LeakyReLU(x, act_type="rrelu"))
        blk = pkg.gluon.nn.HybridLambda(
            lambda F, v: F.LeakyReLU(v, act_type="rrelu", lower_bound=0.1,
                                     upper_bound=0.5))
        blk.hybridize()
        hyb = _j(blk(x))
        outs.append([eager, hyb, _state(pkg)])
    for a, b in zip(outs[1], outs[0]):
        np.testing.assert_array_equal(a, b)
    neg = xin < 0
    slope = outs[1][1][neg] / xin[neg]
    assert ((slope >= 0.1) & (slope < 0.5)).all()


@pytest.mark.parametrize("kvstore", ["tpu_sync", "local"])
def test_module_fit_with_dropout_draws_as_the_jax_package(kvstore):
    """``Module.fit`` over a graph with Dropout: one key a step's
    forward, so the chain's state and every step's parameters agree
    (the masks decide which weights move)."""
    rng = np.random.RandomState(0)
    X = rng.randn(12, 6).astype(np.float32)
    Y = rng.randint(0, 3, 12).astype(np.float32)
    W = {"fc1_weight": rng.randn(8, 6).astype(np.float32) * 0.5,
         "fc1_bias": np.zeros(8, np.float32),
         "fc2_weight": rng.randn(3, 8).astype(np.float32) * 0.5,
         "fc2_bias": np.zeros(3, np.float32)}
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    got = {}
    for pkg in (mx, mt):
        S = pkg.sym
        net = S.SoftmaxOutput(S.FullyConnected(S.Dropout(
            S.FullyConnected(S.var("data"), num_hidden=8, name="fc1"),
            p=0.5), num_hidden=3, name="fc2"), name="softmax")
        if pkg is mt:
            args, _ = mt.serving.params_from_reference(
                W, {}, net, "cpu", data_shapes={"data": (4, 6)})
            mod = mt.mod.Module(net, context=CPU)
        else:
            args = {k: mx.nd.array(v) for k, v in W.items()}
            mod = mx.mod.Module(net, context=mx.cpu())
        # seeded here: binding infers shapes through the Dropout op,
        # which draws one key in both packages
        pkg.random.seed(23)
        steps = []
        mod.fit(pkg.io.NDArrayIter(X, Y, batch_size=4), num_epoch=1,
                kvstore=kvstore, optimizer="sgd", optimizer_params=opt,
                arg_params=args, eval_metric=None,
                batch_end_callback=lambda _p: steps.append(
                    {k: _j(v) for k, v in mod.get_params()[0].items()}))
        got[pkg] = (steps, _state(pkg))
    np.testing.assert_array_equal(got[mt][1], got[mx][1])
    assert len(got[mt][0]) == len(got[mx][0]) == 3
    for t, j in zip(got[mt][0], got[mx][0]):
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-5, atol=1e-6)
