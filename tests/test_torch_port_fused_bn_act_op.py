"""Port parity for the registered op ``_contrib_FusedBNAct`` (B1's op
surface, ``kernels/bn_act.py``) against the JAX package's, on the CPU:
``nd.contrib.FusedBNAct`` eagerly and ``F.contrib.FusedBNAct`` inside a
hybridized block, in training (recorded) and in inference, with and
without the residual, ReLU and identity.

The JAX op runs its Pallas kernel in interpret mode (kernel tier auto,
as its own tests run it); the port's wrapper takes the kernel's plain
version on CPU tensors. Held: the visible output (one of the op's five),
the moving statistics written back through the aux slots (3, 4) in
training and left alone in inference, and the gradients of the data,
gamma, beta and the residual, within rtol 1e-5 / atol 1e-6 (f32, as
``test_torch_port_bn_act.py`` holds the kernel).
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import config as jconfig

import mxnet_tpu_torch as mt

CPU = mt.cpu()
TOL = dict(rtol=1e-5, atol=1e-6)
SHAPE = (2, 5, 4, 3)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    C = SHAPE[1]
    return dict(x=rng.randn(*SHAPE).astype(np.float32),
                r=rng.randn(*SHAPE).astype(np.float32),
                gamma=(rng.rand(C) + 0.5).astype(np.float32),
                beta=rng.randn(C).astype(np.float32),
                mm=(0.3 * rng.randn(C)).astype(np.float32),
                mv=(rng.rand(C) + 0.5).astype(np.float32),
                cot=rng.randn(*SHAPE).astype(np.float32))


def _arr(pkg, a):
    return mt.nd.array(a, ctx=CPU) if pkg is mt else mx.nd.array(a)


def _np(x):
    return np.array(x.asnumpy(), np.float32, copy=True)


def _eager(pkg, d, residual, training, act):
    x, g, b = _arr(pkg, d["x"]), _arr(pkg, d["gamma"]), _arr(pkg, d["beta"])
    mm, mv = _arr(pkg, d["mm"]), _arr(pkg, d["mv"])
    ins = [x, g, b, mm, mv] + ([_arr(pkg, d["r"])] if residual else [])
    diff = [x, g, b] + ins[5:]
    for v in diff:
        v.attach_grad()
    kw = dict(act=act, fix_gamma=False, eps=1e-3, momentum=0.9)
    with pkg.autograd.record(train_mode=training):
        out = pkg.nd.contrib.FusedBNAct(*ins, **kw)
        (out * _arr(pkg, d["cot"])).sum().backward()
    return [_np(out), _np(mm), _np(mv)] + [_np(v.grad) for v in diff]


@pytest.mark.parametrize("act", ["relu", "identity"])
@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("residual", [False, True])
def test_eager_op_matches_the_jax_op(residual, training, act):
    d = _inputs()
    with jconfig.override(kernel_tier="auto"):
        want = _eager(mx, d, residual, training, act)
    got = _eager(mt, d, residual, training, act)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    if training:
        assert not np.allclose(got[1], d["mm"])
    else:
        np.testing.assert_array_equal(got[1], d["mm"])
        np.testing.assert_array_equal(got[2], d["mv"])


def _block_class(pkg, residual, act):
    class FusedBlock(pkg.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            C = SHAPE[1]
            with self.name_scope():
                self.gamma = self.params.get("gamma", shape=(C,))
                self.beta = self.params.get("beta", shape=(C,))
                self.running_mean = self.params.get(
                    "running_mean", shape=(C,), grad_req="null")
                self.running_var = self.params.get(
                    "running_var", shape=(C,), grad_req="null")

        def hybrid_forward(self, F, x, *rest, gamma, beta, running_mean,
                           running_var):
            return F.contrib.FusedBNAct(x, gamma, beta, running_mean,
                                        running_var, *rest, act=act,
                                        fix_gamma=False)
    return FusedBlock


def _hybrid(pkg, d, residual, training, act):
    blk = _block_class(pkg, residual, act)(prefix="fused_")
    blk.initialize(ctx=CPU) if pkg is mt else blk.initialize()
    for name, key in (("gamma", "gamma"), ("beta", "beta"),
                      ("running_mean", "mm"), ("running_var", "mv")):
        blk.collect_params()["fused_" + name].set_data(_arr(pkg, d[key]))
    blk.hybridize()
    x = _arr(pkg, d["x"])
    ins = [x] + ([_arr(pkg, d["r"])] if residual else [])
    for v in ins:
        v.attach_grad()
    with pkg.autograd.record(train_mode=training):
        out = blk(*ins)
        (out * _arr(pkg, d["cot"])).sum().backward()
    params = blk.collect_params()
    return [_np(out)] + [_np(params["fused_" + n].data())
                         for n in ("running_mean", "running_var")] \
        + [_np(v.grad) for v in ins] \
        + [_np(params["fused_" + n].grad()) for n in ("gamma", "beta")]


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("residual", [False, True])
def test_hybridized_block_matches_the_jax_op(residual, training):
    d = _inputs(1)
    with jconfig.override(kernel_tier="auto"):
        want = _hybrid(mx, d, residual, training, "relu")
    got = _hybrid(mt, d, residual, training, "relu")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    moved = not np.allclose(got[1], d["mm"])
    assert moved == training


def test_op_metadata_matches_the_jax_op():
    jop = mx.ops.registry.get("_contrib_FusedBNAct")
    top = mt.ops.registry.get("_contrib_FusedBNAct")
    assert top.param_names == jop.param_names
    assert top.input_names == jop.input_names
    assert (top.aux_inputs, top.aux_outputs) == (jop.aux_inputs,
                                                 jop.aux_outputs)
    assert top.resolve_num_outputs({}) == jop.resolve_num_outputs({}) == 5
    assert top.resolve_num_visible_outputs({}) == 1
    with pytest.raises(ValueError, match="guard"):
        mt.nd.contrib.FusedBNAct(*[_arr(mt, np.ones(s, np.float32)) for s in
                                   ((2, 3, 4), (3,), (3,), (3,), (3,))])
