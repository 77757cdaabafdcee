"""Port parity for Python custom operators (``mt.operator``, the
``Custom`` op) against the JAX package, on the CPU: eager, under
autograd, in a bound executor and inside ``Module.fit`` at K = 1 and at
an explicit K = 3; interleaved forwards keep their own operator
instances; auxiliary states raise; integer inputs get no gradient; the
host round trips are counted; a graph with a ``Custom`` node is
dispatched uncaptured, decided from the graph.

The same Prop and CustomOp classes are spelled for each package
(:func:`ops_for`). Inputs are numpy draws from fixed seeds. Tolerances:
outputs and gradients ``rtol=1e-5, atol=1e-6``; parameters after the fit
steps the same (the steps run the same f32 arithmetic in other orders).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import custom_op as tcustom

RTOL, ATOL = 1e-5, 1e-6


def ops_for(pkg):
    """Register the test ops in ``pkg.operator``."""
    op = pkg.operator

    @op.register("t_sqr_plus")
    class SqrPlusProp(op.CustomOpProp):
        """y = x * x + c, c a keyword (reaching the Prop as a string)."""

        def __init__(self, c="0"):
            super().__init__(need_top_grad=True)
            self.c = float(c)

        def create_operator(self, ctx, shapes, dtypes):
            return SqrPlus(self.c)

    class SqrPlus(op.CustomOp):
        def __init__(self, c):
            self.c = c

        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * in_data[0]
                        + self.c)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], 2 * in_data[0] * out_grad[0])

    @op.register("t_twin")
    class TwinProp(op.CustomOpProp):
        def list_arguments(self):
            return ["a", "b"]

        def list_outputs(self):
            return ["sum", "total"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0], [1]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Twin()

    class Twin(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            s = in_data[0] + in_data[1]
            self.assign(out_data[0], req[0], s)
            self.assign(out_data[1], req[1], s.sum().reshape((1,)))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            g = out_grad[0] + out_grad[1].reshape(())
            self.assign(in_grad[0], req[0], g)
            self.assign(in_grad[1], req[1], g)

    @op.register("t_stash")
    class StashProp(op.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Stash()

    class Stash(op.CustomOp):
        """Keeps its forward's input sum for its own backward."""

        def forward(self, is_train, req, in_data, out_data, aux):
            self.total = float(in_data[0].asnumpy().sum())
            self.assign(out_data[0], req[0], in_data[0])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0] * self.total)

    @op.register("t_with_aux")
    class AuxProp(op.CustomOpProp):
        def list_auxiliary_states(self):
            return ["state"]

    @op.register("t_index_scale")
    class IndexScaleProp(op.CustomOpProp):
        """out = x * idx, idx an int32 input."""

        def list_arguments(self):
            return ["x", "idx"]

        def infer_type(self, in_type):
            return [np.float32, np.int32], [np.float32], []

        def create_operator(self, ctx, shapes, dtypes):
            return IndexScale()

    class IndexScale(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0],
                        in_data[0] * in_data[1].astype("float32"))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0],
                        out_grad[0] * in_data[1].astype("float32"))
            self.assign(in_grad[1], req[1], in_data[1] * 0)


ops_for(mx)
ops_for(mt)


def _x(seed=0, shape=(3, 4)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_eager_forward_and_autograd_match():
    x = _x()
    jx = mx.nd.array(x)
    jx.attach_grad()
    with mx.autograd.record():
        jy = mx.nd.Custom(jx, op_type="t_sqr_plus", c=1.5)
        (jy * mx.nd.array(_x(1))).sum().backward()
    tcustom.reset_counts()
    with mt.cpu():
        tx = mt.nd.array(x)
        tx.attach_grad()
        with mt.autograd.record():
            ty = mt.nd.Custom(tx, op_type="t_sqr_plus", c=1.5)
            (ty * mt.nd.array(_x(1))).sum().backward()
    close(ty.asnumpy(), jy.asnumpy())
    close(tx.grad.asnumpy(), jx.grad.asnumpy())
    assert tcustom.round_trips == 2           # one forward, one backward
    assert ty.context == mt.cpu()


def test_multi_input_multi_output():
    a, b = _x(2), _x(3)
    ja, jb = mx.nd.array(a), mx.nd.array(b)
    ja.attach_grad()
    with mx.autograd.record():
        js, jt = mx.nd.Custom(ja, jb, op_type="t_twin")
        (js.sum() + jt.sum()).backward()
    with mt.cpu():
        ta, tb = mt.nd.array(a), mt.nd.array(b)
        ta.attach_grad()
        with mt.autograd.record():
            ts, tt = mt.nd.Custom(ta, tb, op_type="t_twin")
            (ts.sum() + tt.sum()).backward()
    close(ts.asnumpy(), js.asnumpy())
    close(tt.asnumpy(), jt.asnumpy())
    assert tt.shape == (1,)
    close(ta.grad.asnumpy(), ja.grad.asnumpy())


def test_interleaved_forwards_keep_their_own_state():
    x1, x2 = _x(4), 3 * _x(5)
    with mt.cpu():
        a, b = mt.nd.array(x1), mt.nd.array(x2)
        a.attach_grad()
        b.attach_grad()
        with mt.autograd.record():
            ya = mt.nd.Custom(a, op_type="t_stash")
            yb = mt.nd.Custom(b, op_type="t_stash")
            (ya.sum() + yb.sum()).backward()
    np.testing.assert_allclose(a.grad.asnumpy(), np.full_like(x1, x1.sum()),
                               rtol=RTOL)
    np.testing.assert_allclose(b.grad.asnumpy(), np.full_like(x2, x2.sum()),
                               rtol=RTOL)


def test_auxiliary_states_raise_and_integer_inputs_get_no_gradient():
    with mt.cpu():
        with pytest.raises(NotImplementedError):
            mt.nd.Custom(mt.nd.array(_x()), op_type="t_with_aux")
    x = torch.from_numpy(_x(6)).requires_grad_(True)
    idx = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    out = mt.ops.registry.get("Custom").fn(x, idx, op_type="t_index_scale")
    # the backward runs with an int32 input and returns it no gradient
    (gx,) = torch.autograd.grad(out.sum(), [x])
    close(gx.numpy(), idx.float().numpy())
    assert not idx.requires_grad and idx.grad is None


def _mlp(pkg):
    data = pkg.sym.Variable("data")
    h = pkg.sym.FullyConnected(data, num_hidden=6, name="fc1")
    h = pkg.sym.Custom(h, op_type="t_sqr_plus", c=0.25, name="sq")
    h = pkg.sym.FullyConnected(h, num_hidden=3, name="fc2")
    return pkg.sym.SoftmaxOutput(h, name="softmax")


def test_bound_executor_forward_backward():
    rng = np.random.RandomState(7)
    vals = {"data": rng.randn(4, 5), "fc1_weight": rng.randn(6, 5) * 0.3,
            "fc1_bias": rng.randn(6) * 0.1,
            "fc2_weight": rng.randn(3, 6) * 0.3,
            "fc2_bias": rng.randn(3) * 0.1, "softmax_label": [0, 2, 1, 2]}
    vals = {k: np.asarray(v, np.float32) for k, v in vals.items()}
    jsym, tsym = _mlp(mx), _mlp(mt)
    jex = jsym.bind(mx.cpu(), {k: mx.nd.array(v) for k, v in vals.items()},
                    args_grad={k: mx.nd.zeros(v.shape)
                               for k, v in vals.items()})
    jout = jex.forward(is_train=True)[0].asnumpy()
    jex.backward()
    tex = tsym.bind(mt.cpu(), {k: torch.from_numpy(v)
                               for k, v in vals.items()},
                    args_grad={k: torch.zeros(v.shape)
                               for k, v in vals.items()})
    tout = tex.forward(is_train=True)[0]
    tex.backward()
    close(np.asarray(tout), jout)
    for k in ("fc1_weight", "fc1_bias", "fc2_weight"):
        close(tex.grad_dict[k].numpy(), jex.grad_dict[k].asnumpy())
    # shape inference passes through the op
    _, outs, _ = tsym.infer_shape(data=(4, 5))
    assert outs == [(4, 3)]


def _fit(pkg, k, kvstore, p0, steps=3, eval_metric="acc"):
    rng = np.random.RandomState(8)
    X = rng.randn(4 * steps, 5).astype(np.float32)
    Y = rng.randint(0, 3, 4 * steps).astype(np.float32)
    kw = {"context": mt.cpu()} if pkg is mt else {}
    mod = pkg.mod.Module(_mlp(pkg), **kw)
    it = pkg.io.NDArrayIter(X, Y, batch_size=4)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(arg_params={n: pkg.nd.array(v) for n, v in p0.items()},
                    aux_params={})
    mod.fit(it, num_epoch=1, optimizer="sgd", kvstore=kvstore,
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            eval_metric=eval_metric, steps_per_dispatch=k)
    return mod, {n: np.asarray(v.asnumpy() if hasattr(v, "asnumpy")
                               else v.numpy())
                 for n, v in mod.get_params()[0].items()}


@pytest.mark.parametrize("k,kvstore", [(1, "local"), (1, "tpu_sync"),
                                       (3, "tpu_sync")])
def test_module_fit_matches_at_k1_and_k3(k, kvstore):
    rng = np.random.RandomState(9)
    p0 = {"fc1_weight": rng.randn(6, 5) * 0.3, "fc1_bias": np.zeros(6),
          "fc2_weight": rng.randn(3, 6) * 0.3, "fc2_bias": np.zeros(3)}
    p0 = {n: np.asarray(v, np.float32) for n, v in p0.items()}
    _, want = _fit(mx, k, kvstore, p0)
    with mt.cpu():
        mod, got = _fit(mt, k, kvstore, p0)
    for n in want:
        close(got[n], want[n])
    if kvstore == "tpu_sync":
        # read from the graph: the Custom node's host round trip
        assert mod._fused.host_ops == ("Custom",)
        assert mod._fused.dispatch == "eager"
        assert mod._fused.captures == 0 and mod._fused.eager_steps == 3
    assert mod._fit_k == k


def test_the_automatic_k_is_one_for_a_graph_with_a_custom_node():
    rng = np.random.RandomState(10)
    p0 = {"fc1_weight": rng.randn(6, 5) * 0.3, "fc1_bias": np.zeros(6),
          "fc2_weight": rng.randn(3, 6) * 0.3, "fc2_bias": np.zeros(3)}
    p0 = {n: np.asarray(v, np.float32) for n, v in p0.items()}
    with mt.cpu():
        mod, _ = _fit(mt, None, "tpu_sync", p0, eval_metric=None)
    assert mod._fit_k == 1 and mod._fused.dispatch == "eager"


def test_staged_feed_thread_reads_in_the_callers_context():
    """A Python iterator that makes its arrays in the default context
    (as the detection examples' do), fit at K = 3 inside ``with
    mt.cpu():``: the staged feed's thread reads it in the caller's
    context (it used to make them on ``gpu(0)`` and raise here)."""
    class DefaultCtxIter(mt.io.DataIter):
        def __init__(self):
            super().__init__(4)
            self.i = 0

        @property
        def provide_data(self):
            return [("data", (4, 5))]

        @property
        def provide_label(self):
            return [("softmax_label", (4,))]

        def reset(self):
            self.i = 0

        def next(self):
            if self.i == 3:
                raise StopIteration
            self.i += 1
            rng = np.random.RandomState(self.i)
            return mt.io.DataBatch(
                data=[mt.nd.array(rng.randn(4, 5))],
                label=[mt.nd.array(rng.randint(0, 3, 4))], pad=0)

    with mt.cpu():
        net = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(
            mt.sym.Variable("data"), num_hidden=3, name="fc"), name="softmax")
        mod = mt.mod.Module(net, context=mt.cpu())
        mod.fit(DefaultCtxIter(), num_epoch=1, kvstore="tpu_sync",
                optimizer_params={"learning_rate": 0.1},
                initializer=mt.init.Xavier(), eval_metric=None,
                steps_per_dispatch=3)
    assert mod._fused.eager_steps == 3
