"""Port parity for ``mxnet_tpu_torch.autograd``: the same program, written
once over ``(nd, autograd)``, run by the JAX package and by the port on
the same numpy inputs, CPU. The gradients must agree within rtol/atol
1e-6 (f32, the same math), and the JAX package's semantics hold where
they differ from torch's defaults: 'write' overwrites and 'add'
accumulates per backward, 'null' never writes, a variable the heads do
not reach keeps its old gradient, only ops inside ``record()`` are
differentiable (``pause`` cuts the graph), and ``is_training`` is a flag
of its own.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt

X = np.array([[0.5, -1.0, 2.0], [1.5, 0.25, -0.75]], np.float32)
W = np.array([[1.0, -2.0, 0.5], [0.3, 0.7, -1.2]], np.float32)


def _both(program):
    """program(nd, ag, mk) -> list of numpy arrays, run by each package;
    ``mk`` makes an NDArray on the CPU."""
    jout = program(mx.nd, mx.autograd, lambda a: mx.nd.array(a))
    tout = program(mt.nd, mt.autograd,
                   lambda a: mt.nd.array(a, ctx=mt.cpu()))
    assert len(jout) == len(tout)
    for t, j in zip(tout, jout):
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)
    return tout


def _g(x):
    return x.grad.asnumpy().copy()


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_grad_req_over_two_backwards(req):
    def program(nd, ag, mk):
        x = mk(X)
        x.attach_grad(grad_req=req)
        out = []
        for scale in (1.0, 3.0):
            with ag.record():
                y = (x * x * scale + x * 2).sum()
            y.backward()
            out.append(_g(x))
        return out
    got = _both(program)
    first = 2 * X + 2
    if req == "null":
        assert not got[0].any() and not got[1].any()
    elif req == "write":
        np.testing.assert_allclose(got[1], 6 * X + 2, rtol=1e-6)
    else:
        np.testing.assert_allclose(got[1], first + 6 * X + 2, rtol=1e-6)


def test_an_unreached_variable_keeps_its_gradient():
    def program(nd, ag, mk):
        x, z = mk(X), mk(W)
        x.attach_grad()
        z.attach_grad()
        with ag.record():
            (x * z).sum().backward()
        first = _g(z)
        with ag.record():
            y = (x * 4).sum()
        y.backward()
        return [first, _g(z), _g(x)]
    got = _both(program)
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_allclose(got[2], np.full_like(X, 4.0))


def test_pause_cuts_the_graph_and_training_is_a_flag_of_its_own():
    def program(nd, ag, mk):
        x = mk(X)
        x.attach_grad()
        flags = []
        with ag.record():
            flags.append((ag.is_recording(), ag.is_training()))
            y = x * 2
            with ag.pause():
                flags.append((ag.is_recording(), ag.is_training()))
                c = x * 3
            z = (y * c).sum()
        z.backward()
        with ag.record(train_mode=False):
            flags.append((ag.is_recording(), ag.is_training()))
        with ag.train_mode():
            flags.append((ag.is_recording(), ag.is_training()))
            with ag.predict_mode():
                flags.append((ag.is_recording(), ag.is_training()))
        flags.append((ag.is_recording(), ag.is_training()))
        return [_g(x), np.array(flags, np.float32)]
    got = _both(program)
    np.testing.assert_allclose(got[0], 6 * X)     # c is a constant
    assert got[1].tolist() == [[1, 1], [0, 0], [1, 0], [0, 1], [0, 0],
                               [0, 0]]


def test_ops_outside_record_are_not_differentiated():
    def program(nd, ag, mk):
        x = mk(X)
        x.attach_grad()
        y = (x * 2).sum()
        y.backward()
        return [_g(x)]
    assert not _both(program)[0].any()


def test_head_gradients_and_a_leaf_head():
    def program(nd, ag, mk):
        x = mk(X)
        x.attach_grad()
        with ag.record():
            y = nd.sigmoid(x) * 3
        y.backward(mk(W))
        out = [_g(x)]
        x.backward()
        out.append(_g(x))
        return out
    got = _both(program)
    np.testing.assert_allclose(got[1], np.ones_like(X))


def test_a_second_backward_through_a_retained_graph():
    def program(nd, ag, mk):
        x = mk(X)
        x.attach_grad(grad_req="add")
        with ag.record():
            y = (nd.exp(x) * x).sum()
        y.backward(retain_graph=True)
        once = _g(x)
        y.backward()
        return [once, _g(x)]
    once, twice = _both(program)
    np.testing.assert_allclose(twice, 2 * once, rtol=1e-6)


def test_a_second_backward_through_a_freed_graph_raises():
    """The one kept divergence: the JAX package's tape frees nothing, so
    its second backward through the same graph runs and writes the
    gradient again; torch frees the graph at the first backward, and the
    port raises on the second unless the first retained it."""
    xj = mx.nd.array(X)
    xj.attach_grad()
    with mx.autograd.record():
        yj = (mx.nd.exp(xj) * xj).sum()
    yj.backward()
    first = _g(xj)
    yj.backward()
    np.testing.assert_allclose(_g(xj), first, rtol=1e-6)
    x = mt.nd.array(X, ctx=mt.cpu())
    x.attach_grad()
    with mt.autograd.record():
        y = (mt.nd.exp(x) * x).sum()
    y.backward()
    np.testing.assert_allclose(_g(x), first, rtol=1e-6, atol=1e-6)
    with pytest.raises(mt.MXNetError, match="retain_graph"):
        y.backward()


def test_grad_returns_new_arrays_and_leaves_the_buffers_alone():
    """The returned gradients equal the JAX package's, and so do the
    buffers afterwards: ``grad`` leaves the buffers of the variables it
    was asked for alone and writes the buffer of every other marked
    variable its backward reaches (the JAX package's ``grad`` runs
    ``backward`` into temporary sinks), so a Trainer reads the same
    fresh gradient in both packages."""
    def program(nd, ag, mk):
        x, z, u = mk(X), mk(W), mk(W)
        for v in (x, z, u):
            v.attach_grad()
        with ag.record():
            y = (nd.tanh(x) * z).sum()
        gx, gu = ag.grad(y, [x, u], retain_graph=True)
        after_first = [_g(x), _g(z), _g(u), float(z._ag.fresh)]
        single = ag.grad(y, z)
        return [gx.asnumpy(), gu.asnumpy(), single.asnumpy()] \
            + after_first + [_g(x), _g(z), _g(u)]
    (gx, gu, gz, x1, z1, u1, zfresh, x2, z2, u2) = _both(program)
    assert not gu.any()
    # the first call wrote z (reached, not asked for), not x or u
    assert not x1.any() and not u1.any() and zfresh == 1.0
    np.testing.assert_allclose(z1, gz, rtol=1e-6)
    # the second wrote x, and left z (asked for) as the first call left it
    np.testing.assert_allclose(x2, gx, rtol=1e-6)
    np.testing.assert_array_equal(z2, z1)
    assert not u2.any()
    with mt.autograd.record():
        x = mt.nd.array(X, ctx=mt.cpu())
        x.attach_grad()
        y = (x * x).sum()
    with pytest.raises(NotImplementedError):
        mt.autograd.grad(y, [x], create_graph=True)


def test_mark_variables_and_the_fresh_mark():
    def program(nd, ag, mk):
        x, gbuf = mk(X), mk(np.zeros_like(X))
        ag.mark_variables([x], [gbuf], grad_reqs="write")
        with ag.record():
            (x * mk(W)).sum().backward()
        return [gbuf.asnumpy(), np.array([x._ag.fresh], np.float32)]
    got = _both(program)
    np.testing.assert_allclose(got[0], W)
    assert got[1][0] == 1


def test_custom_function_forward_and_backward():
    def program(nd, ag, mk):
        class Scaled(ag.Function):
            def forward(self, a, b):
                self.save_for_backward(a, b)
                return a * b * 2

            def backward(self, dy):
                a, b = self._saved
                return dy * b * 2, dy * a * 2
        x, z = mk(X), mk(W)
        x.attach_grad()
        z.attach_grad()
        with ag.record():
            y = Scaled()(nd.sigmoid(x), z)
            out = (y * y).sum()
        out.backward()
        return [y.asnumpy(), _g(x), _g(z)]
    _both(program)


def test_in_place_update_of_a_marked_variable_keeps_it_a_leaf():
    def program(nd, ag, mk):
        x = mk(X)
        x.attach_grad()
        x += 1.0
        with ag.record():
            (x * x).sum().backward()
        return [_g(x), x.asnumpy()]
    got = _both(program)
    np.testing.assert_allclose(got[0], 2 * (X + 1), rtol=1e-6)
    xt = mt.nd.array(X, ctx=mt.cpu())
    xt.attach_grad()
    xt += 1.0
    assert xt.data.is_leaf and xt.data.requires_grad


def test_detach_and_block_grad_stop_the_gradient():
    def program(nd, ag, mk):
        x = mk(X)
        x.attach_grad()
        with ag.record():
            y = (x * x.detach() + nd.BlockGrad(x * 5) * x).sum()
        y.backward()
        return [_g(x)]
    np.testing.assert_allclose(_both(program)[0], 6 * X, rtol=1e-6)


def test_recording_leaves_torch_grad_mode_alone():
    before = torch.is_grad_enabled()
    with mt.autograd.record():
        assert torch.is_grad_enabled() == before
    x = mt.nd.array(X, ctx=mt.cpu())
    x.attach_grad()
    assert not (x * 2).data.requires_grad
    with mt.autograd.record():
        assert (x * 2).data.requires_grad


_GC_UNDER_THE_LOCK = """
import gc, sys
sys.path.insert(0, %r)
import numpy as np
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd
x = mt.nd.array(np.ones((2, 2), np.float32), ctx=mt.cpu())
x.attach_grad()
box = [x]
box.append(box)             # only the garbage collector frees x
del x, box
with autograd._marked_lock:  # a collection inside an allocation there
    gc.collect()
y = mt.nd.array(np.ones(2, np.float32), ctx=mt.cpu())
y.attach_grad()
assert len(autograd._live_variables()) == 1
print("ok")
"""


def test_a_marked_variable_collected_under_the_registry_lock_does_not_hang():
    """A marked NDArray freed by the garbage collector while its thread
    holds the marked-variable registry's lock (a collection can run in
    any allocation there) must not wait on that lock: in a process of
    its own, so that a hang fails this test alone."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _GC_UNDER_THE_LOCK % repo],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
