"""Port parity for Gluon (``mxnet_tpu_torch.gluon``): blocks, losses,
Parameter, HybridBlock, Trainer and utils against the JAX package on the
same numpy inputs, on the CPU.

Each ``nn`` block and loss runs its forward and backward in both
packages from the same weights (the JAX package's, carried by
``gluon.utils.params_from_reference``), eager and hybridized in the
port: outputs, the input's gradient and every parameter's gradient
within rtol/atol 1e-5 (f32, the same math summed in other orders).

The slice as a whole: the GPT of ``examples/train_transformer_lm.py``
(``tests/gluon_gpt.py``) at vocab 64, dim 64, 4 heads, 2 layers, T 64,
batch 4, lag 17, trained 3 steps by each package through
``autograd.record()`` -> ``loss.backward()`` -> ``trainer.step(1)``
with Adam at epsilon 1e-4 (at the default 1e-8 an element whose
gradient is float noise moves by up to lr in a direction the noise
picks), the port hybridized and not, against the JAX package
hybridized at tier off and at tier auto (its kernels in interpret mode,
as its own tests run them).
Every step's loss within rtol 1e-5, every gradient within 1e-4 of the
tensor's largest magnitude (as ``test_torch_port_train.py`` holds
``Module.fit``'s: from step 2 on, each package differentiates at its own
parameters, and the qkv projection's key bias has an exactly zero
gradient that comes out as float noise), and every parameter after
every step within atol 1e-5. The hybridized GPT's Symbol JSON equals the JAX
package's.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import config as jconfig

import mxnet_tpu_torch as mt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from gluon_gpt import gpt_classes, make_copy_batch  # noqa: E402

CPU = mt.cpu()


class _Pkg:
    """One package's Gluon surface on the CPU."""

    def __init__(self, name):
        self.name = name
        self.mx = mx if name == "jax" else mt
        self.gluon = self.mx.gluon
        self.nn = self.gluon.nn
        self.ag = self.mx.autograd
        self.init = mx.initializer if name == "jax" else mt.init

    def arr(self, a):
        if self.name == "jax":
            return mx.nd.array(a)
        return mt.nd.array(a, ctx=CPU)

    def ctx(self):
        return mx.cpu() if self.name == "jax" else CPU


JAX, PORT = _Pkg("jax"), _Pkg("port")


def _np(x):
    return np.array(x.asnumpy(), dtype=np.float32, copy=True)


def _rel(block):
    return {n[len(block.prefix):]: p
            for n, p in block.collect_params().items()}


# ------------------------------------------------------ blocks and losses
def _run_block(pkg, make, inputs, hybrid, weights=None, train=True):
    """Forward and backward of ``make(pkg)`` on ``inputs`` (numpy); the
    cotangent is fixed. Returns (weights, out, dx, param grads, params
    after)."""
    blk = make(pkg)
    np.random.seed(0)
    blk.initialize(pkg.init.Xavier(), ctx=pkg.ctx())
    xs = [pkg.arr(a) for a in inputs]
    with pkg.ag.predict_mode():
        blk(*xs)                      # completes deferred shapes
    if weights is None:
        weights = {k: _np(p.data()) for k, p in _rel(blk).items()}
    else:
        mt.gluon.utils.params_from_reference(blk, weights)
    if hybrid:
        blk.hybridize()
    xs[0].attach_grad()
    with pkg.ag.record(train_mode=train):
        out = blk(*xs)
        cot = np.asarray(np.random.RandomState(9).randn(*out.shape),
                         np.float32)
        (out * pkg.arr(cot)).sum().backward()
    grads = {k: _np(p.grad()) for k, p in _rel(blk).items()
             if p.grad_req != "null"}
    after = {k: _np(p.data()) for k, p in _rel(blk).items()}
    return weights, _np(out), _np(xs[0].grad), grads, after


def _rng_inputs(*shapes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _labels(shape, n, seed=1):
    return np.random.RandomState(seed).randint(0, n, shape).astype(
        np.float32)


BLOCKS = {
    "dense": (lambda p: p.nn.Dense(5), _rng_inputs((3, 4, 2))),
    "dense_act_noflatten": (lambda p: p.nn.Dense(6, activation="tanh",
                                                 flatten=False),
                            _rng_inputs((2, 3, 4))),
    "dense_nobias": (lambda p: p.nn.Dense(4, use_bias=False, in_units=3),
                     _rng_inputs((5, 3))),
    "relu": (lambda p: p.nn.Activation("relu"), _rng_inputs((3, 4))),
    "sigmoid": (lambda p: p.nn.Activation("sigmoid"), _rng_inputs((3, 4))),
    "tanh": (lambda p: p.nn.Activation("tanh"), _rng_inputs((3, 4))),
    "softrelu": (lambda p: p.nn.Activation("softrelu"),
                 _rng_inputs((3, 4))),
    "softsign": (lambda p: p.nn.Activation("softsign"),
                 _rng_inputs((3, 4))),
    "leakyrelu": (lambda p: p.nn.LeakyReLU(0.1), _rng_inputs((3, 4))),
    "prelu": (lambda p: p.nn.PReLU(), _rng_inputs((3, 4))),
    "elu": (lambda p: p.nn.ELU(0.5), _rng_inputs((3, 4))),
    "selu": (lambda p: p.nn.SELU(), _rng_inputs((3, 4))),
    "swish": (lambda p: p.nn.Swish(1.5), _rng_inputs((3, 4))),
    "gelu": (lambda p: p.nn.GELU(), _rng_inputs((3, 4))),
    "batchnorm": (lambda p: p.nn.BatchNorm(), _rng_inputs((2, 3, 4, 4))),
    "batchnorm_noscale": (lambda p: p.nn.BatchNorm(scale=False,
                                                   momentum=0.5),
                          _rng_inputs((4, 3))),
    "instancenorm": (lambda p: p.nn.InstanceNorm(scale=True),
                     _rng_inputs((2, 3, 5))),
    "layernorm": (lambda p: p.nn.LayerNorm(), _rng_inputs((2, 3, 6))),
    "layernorm_axis1": (lambda p: p.nn.LayerNorm(axis=1),
                        _rng_inputs((2, 3, 6))),
    "embedding": (lambda p: p.nn.Embedding(10, 4),
                  [_labels((3, 5), 12)]),
    "flatten": (lambda p: p.nn.Flatten(), _rng_inputs((2, 3, 4))),
    "dropout0": (lambda p: p.nn.Dropout(0.0), _rng_inputs((2, 3))),
    "hybridsequential": (lambda p: _stack(p, p.nn.HybridSequential()),
                         _rng_inputs((3, 4))),
    "hybridlambda_fn": (lambda p: p.nn.HybridLambda(
        lambda F, x: F.relu(x) * 2), _rng_inputs((3, 4))),
    "hybridlambda_name": (lambda p: p.nn.HybridLambda("tanh"),
                          _rng_inputs((3, 4))),
}


def _stack(p, seq):
    with seq.name_scope():
        seq.add(p.nn.Dense(8, activation="relu"), p.nn.Dense(3))
    return seq


def _loss(cls, **kw):
    return lambda p: getattr(p.gluon.loss, cls)(**kw)


LOSSES = {
    "l2": (_loss("L2Loss"), _rng_inputs((4, 5), (4, 5))),
    "l1": (_loss("L1Loss"), _rng_inputs((4, 5), (4, 5))),
    "sigmoid_bce": (_loss("SigmoidBinaryCrossEntropyLoss"),
                    _rng_inputs((4, 5)) + [_labels((4, 5), 2)]),
    "sigmoid_bce_from_sigmoid": (
        _loss("SigmoidBCELoss", from_sigmoid=True),
        [1 / (1 + np.exp(-_rng_inputs((4, 5))[0])), _labels((4, 5), 2)]),
    "sigmoid_bce_weighted": (_loss("SigmoidBCELoss"),
                             _rng_inputs((4, 5)) + [_labels((4, 5), 2),
                                                    _rng_inputs((4, 1))[0]]),
    "softmax_ce": (_loss("SoftmaxCrossEntropyLoss"),
                   _rng_inputs((4, 6)) + [_labels((4,), 6)]),
    "softmax_ce_sequence": (_loss("SoftmaxCELoss"),
                            _rng_inputs((2, 5, 7)) + [_labels((2, 5), 9)]),
    "softmax_ce_dense": (_loss("SoftmaxCELoss", sparse_label=False),
                         _rng_inputs((4, 6)) + [np.abs(_rng_inputs(
                             (4, 6), seed=3)[0])]),
    "softmax_ce_logits": (_loss("SoftmaxCELoss", from_logits=True,
                                weight=0.5),
                          _rng_inputs((4, 6)) + [_labels((4,), 6)]),
    "kldiv": (_loss("KLDivLoss", from_logits=False),
              _rng_inputs((4, 6)) + [np.abs(_rng_inputs((4, 6),
                                                        seed=2)[0])]),
    "huber": (_loss("HuberLoss", rho=0.5), _rng_inputs((4, 5), (4, 5))),
    "hinge": (_loss("HingeLoss"), _rng_inputs((4, 5), (4, 5))),
    "squared_hinge": (_loss("SquaredHingeLoss"),
                      _rng_inputs((4, 5), (4, 5))),
    "logistic_signed": (_loss("LogisticLoss"),
                        _rng_inputs((4, 5)) + [2 * _labels((4, 5), 2) - 1]),
    "logistic_binary": (_loss("LogisticLoss", label_format="binary"),
                        _rng_inputs((4, 5)) + [_labels((4, 5), 2)]),
    "triplet": (_loss("TripletLoss"), _rng_inputs((4, 5), (4, 5), (4, 5))),
    "poisson_nll": (_loss("PoissonNLLLoss", compute_full=True),
                    _rng_inputs((4, 5)) + [_labels((4, 5), 4)]),
    "cosine_embedding": (_loss("CosineEmbeddingLoss", margin=0.1),
                         _rng_inputs((4, 5), (4, 5))
                         + [2 * _labels((4,), 2) - 1]),
}

_JAX_CACHE = {}


@pytest.mark.parametrize("hybrid", [False, True], ids=["eager", "hybrid"])
@pytest.mark.parametrize("name", sorted(BLOCKS) + sorted(LOSSES))
def test_block_and_loss_match_the_jax_package(name, hybrid):
    make, inputs = BLOCKS.get(name) or LOSSES[name]
    if name not in _JAX_CACHE:
        # the JAX package's hybridized block: its traced F runs the same
        # registry functions as its eager ops, one compile per block
        _JAX_CACHE[name] = _run_block(JAX, make, inputs, True)
    want = _JAX_CACHE[name]
    got = _run_block(PORT, make, inputs, hybrid, weights=want[0])
    for g, w, what in zip(got[1:3], want[1:3], ("output", "input grad")):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                   err_msg=what)
    for part in (3, 4):
        assert sorted(got[part]) == sorted(want[part])
        for k in want[part]:
            np.testing.assert_allclose(got[part][k], want[part][k],
                                       rtol=1e-5, atol=1e-5, err_msg=k)


def test_sequential_and_lambda_blocks_match_the_jax_package():
    x = _rng_inputs((3, 4))[0]

    def make(p):
        seq = p.nn.Sequential()
        with seq.name_scope():
            seq.add(p.nn.Dense(5), p.nn.Lambda("relu"),
                    p.nn.Lambda(lambda v: v * 3))
        return seq
    want = _run_block(JAX, make, [x], False)
    got = _run_block(PORT, make, [x], False, weights=want[0])
    for g, w in zip(got[1:4], want[1:4]):
        if isinstance(w, dict):
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_dropout_raises_in_training_and_ctc_loss_raises():
    """Dropout no longer raises in training: after the same seed it
    draws the JAX package's mask (``test_torch_port_random.py`` holds
    every path). CTCLoss no longer raises either: it gives the JAX
    package's loss (``test_torch_port_nn_heads.py`` holds its layouts
    and lengths)."""
    x = np.ones((2, 3), np.float32)
    outs = []
    for pkg in (JAX, PORT):
        blk = pkg.nn.Dropout(0.5)
        blk.initialize(ctx=CPU) if pkg is PORT else blk.initialize()
        pkg.mx.random.seed(3)
        np.testing.assert_array_equal(_np(blk(pkg.arr(x))), 1.0)
        with pkg.ag.record():
            outs.append(_np(blk(pkg.arr(x))))
    np.testing.assert_array_equal(outs[1], outs[0])
    assert set(np.unique(outs[1])) <= {0.0, 2.0}
    pred = np.random.RandomState(0).randn(2, 6, 4).astype(np.float32)
    label = np.array([[1, 2], [3, 3]], np.float32)
    losses = [_np(pkg.gluon.loss.CTCLoss()(pkg.arr(pred), pkg.arr(label)))
              for pkg in (JAX, PORT)]
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- the GPT
V, C, H, NL, T, B, LAG = 64, 64, 4, 2, 64, 4, 17
ADAM = {"learning_rate": 3e-3, "wd": 0.01, "epsilon": 1e-4}
_GPT_JAX = {}


def _gpt_batches():
    rng = np.random.RandomState(0)
    return [make_copy_batch(rng, B, T, V, LAG) for _ in range(4)]


def _train_gpt(pkg, hybrid, tier_val, weights=None):
    """3 steps of the example's loop; returns the initial weights and,
    per step, (loss, gradients, parameters after the update)."""
    override = jconfig.override if pkg.name == "jax" \
        else mt.config.override
    _a, _b, GPT = gpt_classes(pkg.mx, pkg.gluon, pkg.nn)
    batches = _gpt_batches()
    with override(kernel_tier=tier_val):
        net = GPT(V, C, H, NL, T)
        np.random.seed(0)
        net.initialize(pkg.init.Xavier(), ctx=pkg.ctx())
        with pkg.ag.predict_mode():
            net(pkg.arr(batches[0][0]))
        if weights is None:
            weights = {k: _np(p.data()) for k, p in _rel(net).items()}
        else:
            mt.gluon.utils.params_from_reference(net, weights)
        if hybrid:
            net.hybridize(static_alloc=True)
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        trainer = pkg.gluon.Trainer(net.collect_params(), "adam", ADAM)
        steps = []
        for xb, yb in batches[1:]:
            x, y = pkg.arr(xb), pkg.arr(yb)
            with pkg.ag.record():
                logits = net(x)
                loss = loss_fn(logits[:, LAG:, :], y[:, LAG:]).mean()
            loss.backward()
            grads = {k: _np(p.grad()) for k, p in _rel(net).items()}
            trainer.step(1)
            steps.append((float(loss.asnumpy()), grads,
                          {k: _np(p.data()) for k, p in _rel(net).items()}))
    return weights, steps


def _jax_gpt(hybrid, tier_val):
    key = (hybrid, tier_val)
    if key not in _GPT_JAX:
        _GPT_JAX[key] = _train_gpt(JAX, hybrid, tier_val)
    return _GPT_JAX[key]


# (port hybridized, port tier, JAX hybridized, JAX tier). The JAX
# package's eager GPT gives its hybridized numbers (its traced F and its
# eager ops are the same registry functions) at twice the time of the
# whole port run, so the port's eager runs are held against the JAX
# package's hybridized run at the same tier
GPT_CONFIGS = [(True, "auto", True, "auto"), (True, "off", True, "off"),
               (False, "off", True, "off"), (False, "auto", True, "auto")]


@pytest.mark.parametrize("cfg", GPT_CONFIGS,
                         ids=["hybrid-auto", "hybrid-off", "eager-off",
                              "eager-auto"])
def test_gpt_trains_like_the_jax_package_step_by_step(cfg):
    hybrid, tier_val, jhybrid, jtier = cfg
    weights, want = _jax_gpt(jhybrid, jtier)
    mt.kernels.tier.reset_stats()
    _w, got = _train_gpt(PORT, hybrid, tier_val, weights)
    st = mt.kernels.tier.stats()
    if tier_val == "auto":
        # per step: one row gather and one flash_attn a layer; the
        # Dense + ReLU pairs stay unfused (no scale_bias_act)
        assert st["dispatch"] == {"take_rows": 4, "flash_attn": 4 * NL}, st
    else:
        assert st["dispatch"] == {}
    assert len(got) == len(want) == 3
    for step, ((gl, gg, gp), (wl, wg, wp)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(gl, wl, rtol=1e-5, err_msg=str(step))
        assert sorted(gg) == sorted(wg)
        for k in wg:
            scale = float(np.abs(wg[k]).max())
            np.testing.assert_allclose(gg[k], wg[k], rtol=0,
                                       atol=1e-4 * scale + 1e-7,
                                       err_msg="step %d grad %s" % (step, k))
            np.testing.assert_allclose(gp[k], wp[k], rtol=0, atol=1e-5,
                                       err_msg="step %d param %s" % (step,
                                                                    k))


def test_gpt_symbol_json_equals_the_jax_package():
    jsons = []
    for pkg in (JAX, PORT):
        _a, _b, GPT = gpt_classes(pkg.mx, pkg.gluon, pkg.nn)
        net = GPT(V, C, H, NL, T, prefix="gpt_")
        net.initialize(pkg.init.Xavier(), ctx=pkg.ctx())
        net.hybridize()
        with pkg.mx.name.NameManager():
            out = net(pkg.mx.sym.var("data"))
        jsons.append(json.loads(out.tojson()))
    assert jsons[1] == jsons[0]
    names = [n["name"] for n in jsons[1]["nodes"] if n["op"] == "null"]
    assert "gpt_pos_weight" in names and "data" in names


def test_hybridized_gpt_reuses_its_signature_cache():
    _a, _b, GPT = gpt_classes(mt, mt.gluon, mt.gluon.nn)
    net = GPT(V, C, H, NL, T)
    net.initialize(mt.init.Xavier(), ctx=CPU)
    net.hybridize()
    x = mt.nd.array(_gpt_batches()[0][0], ctx=CPU)
    net(x)
    net(x)
    assert len(net._cached_graph) == 1
    net(x[:2])
    with mt.autograd.train_mode():
        net(x)
    with mt.config.override(kernel_tier="off"):
        net(x)
    assert len(net._cached_graph) == 4


# ---------------------------------------------------------------- Trainer
def _small_train(pkg, opt, fused, steps=4, params=None):
    rng = np.random.RandomState(0)
    X = rng.randn(16, 8).astype(np.float32)
    Y = rng.randn(16, 1).astype(np.float32)
    net = pkg.nn.Sequential()
    with net.name_scope():
        net.add(pkg.nn.Dense(16, activation="relu"), pkg.nn.Dense(1))
    net.initialize(pkg.init.Xavier(), ctx=pkg.ctx())
    x, y = pkg.arr(X), pkg.arr(Y)
    net(x)
    r2 = np.random.RandomState(5)
    for p in _rel(net).values():
        p.set_data(pkg.arr(r2.uniform(-0.1, 0.1, p.shape).astype(
            np.float32)))
    trainer = pkg.gluon.Trainer(net.collect_params(), opt[0], dict(opt[1]))
    override = jconfig.override if pkg.name == "jax" \
        else mt.config.override
    tensors = {k: p.data().data for k, p in _rel(net).items()} \
        if pkg.name == "port" else None
    with override(trainer_fused_update=fused):
        for _ in range(steps):
            with pkg.ag.record():
                loss = pkg.gluon.loss.L2Loss()(net(x), y)
            loss.backward()
            trainer.step(16)
    if tensors is not None:
        assert all(p.data().data is tensors[k]
                   for k, p in _rel(net).items())
    return {k: _np(p.data()) for k, p in _rel(net).items()}, trainer


OPTS = {"sgd": ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
                        "wd": 0.01}),
        "adam": ("adam", {"learning_rate": 0.01, "wd": 0.01})}


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_trainer_fused_and_per_parameter_updates_agree(opt):
    """The fused pass against the JAX package's fused update: rtol 1e-6,
    atol 5e-8 after 4 steps (both round lr, wd, rescale and Adam's bias
    correction to f32). Against the per-parameter path: SGD bitwise;
    Adam within rtol 1e-5, atol 1e-6, the per-parameter path computing
    the bias correction in Python floats (the JAX package's own fused
    and eager Adam differ by that rounding too: its
    ``test_trainer_fused_adam_matches_eager`` holds them at rtol
    1e-5)."""
    fused, _t = _small_train(PORT, OPTS[opt], True)
    eager, _t = _small_train(PORT, OPTS[opt], False)
    want, _t = _small_train(JAX, OPTS[opt], True)
    for k in want:
        np.testing.assert_allclose(fused[k], want[k], rtol=1e-6, atol=5e-8,
                                   err_msg=k)
        if opt == "sgd":
            np.testing.assert_array_equal(fused[k], eager[k])
        else:
            np.testing.assert_allclose(fused[k], eager[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_trainer_stale_gradients_lr_and_states(tmp_path):
    net = mt.gluon.nn.Dense(3, in_units=4)
    net.initialize(mt.init.Xavier(), ctx=CPU)
    tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.5, "momentum": 0.9})
    x = mt.nd.array(np.ones((2, 4), np.float32), ctx=CPU)
    with pytest.raises(UserWarning, match="has not been updated"):
        tr.step(1)
    before = net.weight.data().asnumpy()
    tr.step(1, ignore_stale_grad=True)
    np.testing.assert_array_equal(net.weight.data().asnumpy(), before)
    with mt.autograd.record():
        net(x).sum().backward()
    tr.step(2)
    assert tr.learning_rate == 0.5
    tr.set_learning_rate(0.25)
    assert tr.learning_rate == 0.25
    path = str(tmp_path / "t.states")
    tr.save_states(path)
    mom = {k: v.clone() for k, v in tr._updaters[0].states.items()}
    tr._updaters[0].states = {}
    tr.load_states(path)
    for k, v in mom.items():
        torch.testing.assert_close(tr._updaters[0].states[k], v)
    # a dist_* store with no coordinator to join is a one-process store
    # that updates on push (across processes: test_torch_port_dist.py).
    # No checkpoint manager: save_checkpoint saves nothing.
    import os
    from unittest import mock
    with mock.patch.dict(os.environ, {"MXNET_NUM_WORKERS": "2"}):
        tr2 = mt.gluon.Trainer(net.collect_params(), "sgd",
                               kvstore="dist_sync")
        tr2._init_kvstore()
        assert tr2._update_on_kvstore and not tr2._ddp
        assert tr2._kvstore.num_workers == 1
    assert tr.save_checkpoint() is False


def test_lr_and_wd_multipliers_are_read_from_the_parameters():
    outs = []
    for pkg in (JAX, PORT):
        net = pkg.nn.Dense(2, in_units=3)
        net.initialize(pkg.init.One(), ctx=pkg.ctx())
        net.weight.lr_mult = 0.5
        net.bias.wd_mult = 0.0
        tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "wd": 0.2})
        with pkg.ag.record():
            net(pkg.arr(np.ones((1, 3), np.float32))).sum().backward()
        tr.step(1)
        outs.append([_np(net.weight.data()), _np(net.bias.data())])
    for g, w in zip(outs[1], outs[0]):
        np.testing.assert_allclose(g, w, rtol=1e-6)


# ------------------------------------------------------ Parameter, Block
def test_parameters_defer_bind_and_refuse_the_params_format(tmp_path):
    net = mt.gluon.nn.Dense(4)
    net.initialize(mt.init.Xavier(), ctx=CPU)
    assert net.weight.shape == (4, 0)
    with pytest.raises(mt.gluon.DeferredInitializationError):
        net.weight.data()
    net(mt.nd.array(np.ones((2, 3), np.float32), ctx=CPU))
    assert net.weight.shape == (4, 3)
    t = net.weight.data().data
    net.weight.set_data(np.zeros((4, 3), np.float32))
    assert net.weight.data().data is t and not t.any()
    net.weight.zero_grad()
    net.bias.grad_req = "null"
    with pytest.raises(RuntimeError, match="grad_req='null'"):
        net.bias.grad()
    assert sorted(net.collect_params("dense.*weight").keys()) == \
        [net.weight.name]
    c = mt.gluon.Constant("c", np.arange(3, dtype=np.float32))
    c.initialize(ctx=CPU)
    np.testing.assert_array_equal(c.data().asnumpy(), [0, 1, 2])
    assert c.grad_req == "null"
    # the .params format is ported now (test_torch_port_params.py holds
    # its bytes against the JAX package's): each writer round-trips
    net.weight.set_data(np.arange(12, dtype=np.float32).reshape(4, 3))
    want = {k: v.data().asnumpy() for k, v in net.collect_params().items()}
    net.save_parameters(str(tmp_path / "n.params"))
    net.export(str(tmp_path / "n"))
    net.collect_params().save(str(tmp_path / "p"))
    for load in (lambda: net.load_parameters(str(tmp_path / "n.params")),
                 lambda: net.load_parameters(str(tmp_path / "n-0000.params")),
                 lambda: net.collect_params().load(str(tmp_path / "p"))):
        net.weight.set_data(np.zeros((4, 3), np.float32))
        load()
        for k, v in net.collect_params().items():
            np.testing.assert_array_equal(v.data().asnumpy(), want[k])


def test_name_scopes_and_shared_parameters_match_the_jax_package():
    names = []
    for pkg in (JAX, PORT):
        net = pkg.nn.HybridSequential(prefix="net_")
        with net.name_scope():
            a = pkg.nn.Dense(3)
            net.add(a, pkg.nn.Dense(3, params=a.params),
                    pkg.nn.Activation("relu"), pkg.nn.LayerNorm())
        names.append((sorted(net.collect_params().keys()),
                      [b.name for b in net]))
    assert names[0] == names[1]


def test_hooks_run_eager_and_hybridized():
    for hybrid in (False, True):
        seen = []
        net = mt.gluon.nn.Dense(2, in_units=3)
        net.initialize(ctx=CPU)
        net.register_forward_pre_hook(lambda b, a: seen.append("pre"))
        net.register_forward_hook(lambda b, a, o: seen.append(o.shape))
        if hybrid:
            net.hybridize()
        net(mt.nd.array(np.ones((4, 3), np.float32), ctx=CPU))
        assert seen == ["pre", (4, 2)]


def test_compute_dtype_casts_inside_the_hybridized_call(monkeypatch):
    """Under MXNET_COMPUTE_DTYPE=bfloat16 a hybridized call computes in
    bf16 (parameters and inputs cast inside the call), except the
    parameters marked ``_keep_f32`` (BatchNorm's); the parameters
    themselves stay f32. Output within a bf16 ulp's worth (2^-6
    relative to the largest magnitude) of the f32 call."""
    net = mt.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mt.gluon.nn.Dense(8, in_units=6), mt.gluon.nn.BatchNorm(
            in_channels=8))
    net.initialize(mt.init.Xavier(), ctx=CPU)
    net.hybridize()
    x = mt.nd.array(np.random.RandomState(0).randn(4, 6).astype(
        np.float32), ctx=CPU)
    ref = net(x).asnumpy()
    seen = {}
    bn = net[1]
    bn.register_forward_pre_hook(
        lambda b, a: seen.update(x=a[0].dtype))
    orig = bn.hybrid_forward

    def spy(F, x, gamma, beta, running_mean, running_var):
        seen.update(gamma=gamma.dtype)
        return orig(F, x, gamma, beta, running_mean, running_var)
    bn.hybrid_forward = spy
    with mt.config.override(compute_dtype="bfloat16"):
        out = net(x)
    assert out.dtype == torch.bfloat16
    assert seen == {"x": torch.bfloat16, "gamma": torch.float32}
    assert all(p.data().dtype == torch.float32
               for p in net.collect_params().values())
    err = np.abs(out.asnumpy() - ref).max() / np.abs(ref).max()
    assert err < 2 ** -6, err


# ------------------------------------------------------------------ utils
def test_split_and_clip_global_norm_match_the_jax_package():
    a = _rng_inputs((6, 4))[0]
    js = mx.gluon.utils.split_data(mx.nd.array(a), 3)
    ts = mt.gluon.utils.split_data(mt.nd.array(a, ctx=CPU), 3)
    for j, t in zip(js, ts):
        np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    ts = mt.gluon.utils.split_and_load(a, [CPU])
    np.testing.assert_array_equal(ts[0].asnumpy(), a)
    arrs = _rng_inputs((3, 4), (5,), seed=4)
    jn = mx.gluon.utils.clip_global_norm([mx.nd.array(v) for v in arrs],
                                         1.0)
    tarrs = [mt.nd.array(v, ctx=CPU) for v in arrs]
    tn = mt.gluon.utils.clip_global_norm(tarrs, 1.0)
    np.testing.assert_allclose(tn, jn, rtol=1e-6)
    jarrs = [mx.nd.array(v) for v in arrs]
    mx.gluon.utils.clip_global_norm(jarrs, 1.0)
    for t, j in zip(tarrs, jarrs):
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=1e-6,
                                   atol=1e-7)
    with pytest.raises(mt.MXNetError, match="network"):
        mt.gluon.utils.download("http://example.invalid/x")


def test_params_from_reference_names_missing_and_unknown_keys():
    net = mt.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=CPU)
    with pytest.raises(mt.MXNetError, match="missing.*bias"):
        mt.gluon.utils.params_from_reference(
            net, {"weight": np.zeros((2, 3), np.float32)})
    with pytest.raises(mt.MXNetError, match="unknown.*extra"):
        mt.gluon.utils.params_from_reference(
            net, {"weight": np.zeros((2, 3)), "bias": np.zeros(2),
                  "extra": np.zeros(1)})
