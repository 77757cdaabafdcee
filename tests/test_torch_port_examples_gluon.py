"""Port parity: the single-process examples that no other port test runs
(``nce_word2vec.py``, ``gluon_cnn.py``, ``train_dcgan.py`` and
``train_vae.py``), two steps each at narrow widths, through
``tests/example_nets.py`` in both packages from the same weights, data
and key chain.

Each test builds the JAX side once per module (a module-scoped fixture
runs the JAX package's steps and keeps what they recorded). Weights
cross from the JAX nets by relative name (``params_from_reference``);
the Gluon nets build their layers in a name scope, so no JAX ``Dense``
takes a name from the global block counter. Tolerances: the losses of
both steps within ``rtol 1e-5``, the weights after them within ``rtol
1e-5, atol 1e-6`` (Adam divides by ``sqrt(v) + eps``, so a gradient of
rounding size moves a weight by up to the learning rate: the gradients
are compared where that shows, in the NCE step). The NCE steps' inputs
and outputs are compared too, so their zipfian negatives must be the
same draws.
"""
import os
import sys

import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import example_nets as en  # noqa: E402

LOSS = dict(rtol=1e-5, atol=1e-6)
W_TOL = dict(rtol=1e-5, atol=1e-6)
STEPS = 2


def _params(net):
    return {n[len(net.prefix):]: p.data().asnumpy().copy()
            for n, p in net.collect_params().items()}


# ---------------------------------------------------------- nce_word2vec
NCE = dict(vocab=64, dim=8, num_neg=5, batch_size=16, steps=STEPS, lr=0.2)


def _nce(pkg):
    rec = []
    pkg.random.seed(4)
    with pkg.cpu():
        losses, W, _ = en.nce_train(
            pkg, pkg.cpu(), check=False,
            on_step=lambda i, ex: rec.append(
                (en.host(ex.grad_dict["embed_weight"]).copy(),
                 en.host(ex.outputs[0]).copy(),
                 en.host(ex.arg_dict["cands"]).copy())), **NCE)
    return losses, W, rec


@pytest.fixture(scope="module")
def nce_ref():
    return _nce(mx)


def test_nce_word2vec_steps_match(nce_ref):
    losses, W, rec = _nce(mt)
    jl, jW, jrec = nce_ref
    np.testing.assert_allclose(losses, jl, **LOSS)
    for (g, p, c), (jg, jp, jc) in zip(rec, jrec):
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_allclose(p, jp, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(g, jg, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(W, jW, **W_TOL)


def test_the_nce_symbol_is_the_examples():
    js = en.nce_symbol(mx.sym, 64, 8, 5)
    ts = en.nce_symbol(mt.sym, 64, 8, 5)
    assert ts.list_arguments() == js.list_arguments()
    shapes = dict(data=(16,), cands=(16, 6), softmax_label=(16, 6))
    assert ts.infer_shape(**shapes) == js.infer_shape(**shapes)


# ------------------------------------------------------------- gluon_cnn
def _cnn(pkg, ref=None):
    X, y = en.cnn_data(n=32)
    net = en.cnn_net(pkg.gluon)
    rec = []
    with pkg.cpu():
        if ref is None:
            net.initialize(pkg.init.Xavier())
            net(pkg.nd.array(X[:2]))
        else:
            pkg.gluon.utils.params_from_reference(net, ref)
        w0 = _params(net)
        net.hybridize()
        np.random.seed(3)
        en.cnn_train(pkg, net, X, y, batch_size=16, epochs=1, steps=STEPS,
                     on_step=lambda i, loss, out: rec.append(loss.copy()))
    return w0, rec, _params(net)


@pytest.fixture(scope="module")
def cnn_ref():
    return _cnn(mx)


def test_gluon_cnn_steps_match(cnn_ref):
    w0, jrec, jw = cnn_ref
    _, rec, w = _cnn(mt, w0)
    for a, b in zip(rec, jrec):
        np.testing.assert_allclose(a, b, **LOSS)
    for k in jw:
        np.testing.assert_allclose(w[k], jw[k], err_msg=k, **W_TOL)


# ------------------------------------------------------------- the DCGAN
DC = dict(ngf=4, ndf=4)
NZ, DC_BATCH = 8, 4


def _dcgan(pkg, ref=None):
    gen, disc = en.dcgan_nets(pkg.gluon, **DC)
    rng = np.random.RandomState(0)
    imgs = en.dcgan_images(2 * DC_BATCH, rng)
    rec = []
    with pkg.cpu():
        if ref is None:
            gen.initialize(pkg.init.Normal(0.02))
            disc.initialize(pkg.init.Normal(0.02))
            disc(gen(pkg.nd.zeros((1, NZ, 1, 1))))
        else:
            pkg.gluon.utils.params_from_reference(gen, ref[0])
            pkg.gluon.utils.params_from_reference(disc, ref[1])
        w0 = (_params(gen), _params(disc))
        gen.hybridize()
        disc.hybridize()
        pkg.random.seed(5)
        en.dcgan_train(pkg, pkg.cpu(), gen, disc, rng, imgs,
                       batch_size=DC_BATCH, nz=NZ, steps=STEPS,
                       on_step=lambda i, d, g: rec.append((d, g)))
    return w0, rec, (_params(gen), _params(disc))


@pytest.fixture(scope="module")
def dcgan_ref():
    return _dcgan(mx)


def test_dcgan_steps_match(dcgan_ref):
    w0, jrec, jw = dcgan_ref
    _, rec, w = _dcgan(mt, w0)
    np.testing.assert_allclose(rec, jrec, **LOSS)
    for got, want in zip(w, jw):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **W_TOL)


# --------------------------------------------------------------- the VAE
def _vae(pkg, ref=None):
    X = en.vae_images(16, np.random.RandomState(0))
    net = en.vae_net(pkg.gluon, n_hidden=16, n_latent=4, n_out=X.shape[1])
    rec = []
    with pkg.cpu():
        if ref is None:
            net.initialize(pkg.init.Xavier())
            net(pkg.nd.array(X[:2]))
        else:
            pkg.gluon.utils.params_from_reference(net, ref)
        w0 = _params(net)
        net.hybridize()
        pkg.random.seed(6)
        en.vae_train(pkg, pkg.cpu(), net, X, batch_size=8, steps=STEPS,
                     on_step=lambda i, loss: rec.append(loss))
    return w0, rec, _params(net)


@pytest.fixture(scope="module")
def vae_ref():
    return _vae(mx)


def test_vae_steps_match(vae_ref):
    """The eps of each step comes from the key chain inside the
    hybridized call, in both packages after the same seed."""
    w0, jrec, jw = vae_ref
    _, rec, w = _vae(mt, w0)
    np.testing.assert_allclose(rec, jrec, **LOSS)
    for k in jw:
        np.testing.assert_allclose(w[k], jw[k], err_msg=k, **W_TOL)
