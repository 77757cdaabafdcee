"""Port parity for recurrent networks (the fused ``RNN`` op, the sequence
ops, ``_rnn_param_concat``, the RNN initializers and ``gluon.rnn``)
against the JAX package, on the CPU.

The same numpy inputs go through both packages at small sizes (T <= 6,
N <= 3, H <= 8, 1-2 layers):

* the ``RNN`` op in each mode (lstm, gru, rnn_tanh, rnn_relu),
  uni- and bidirectional (two layers for the unidirectional lstm, one
  elsewhere; the dropout test runs three): outputs and final states within rtol/atol
  1e-5 (the JAX op under ``jax.jit``; the port's ``state_outputs=False``
  output is its first output), and the gradients of the data, the flat
  parameters and the initial states against ``jax.grad`` within 1e-4;
* dropout between layers: the masks, recorded where each package draws
  them, bitwise equal, in training and, as the JAX op applies them
  whatever the mode, outside training; the key chain in the same state
  after the call. ``projection_size`` and the ``lstm_state_clip_*``
  arguments change nothing, in either package;
* SequenceMask, SequenceLast and SequenceReverse without lengths (on
  axis 0) and with them (on axis 1), bitwise;
* Orthogonal (after ``numpy.random.seed`` on the JAX side, the port's
  ``seed=``), LSTMBias, FusedRNN and Mixed: bitwise;
* ``gluon.rnn``: the RNN, LSTM and GRU layers in both layouts, eager
  and hybridized, against the JAX layer: outputs and states within
  1e-5; every cell's ``unroll`` with and without ``valid_length``,
  merged or not, against the JAX cell's; the hybridized port against
  the eager one, outputs, states and gradients within 1e-6; ``_unfuse``
  against the fused layer; ``begin_state`` shapes. The JAX side runs
  forward only (training mode, no recording): its recorded Gluon calls
  cost seconds each here, and the gradients through these layers are
  held against it by the training steps of
  ``test_torch_port_rnn_symbolic.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu.ops import nn as jnn

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import nn as tnn

CPU = mt.cpu()


def _np(x):
    if hasattr(x, "asnumpy"):
        x = x.asnumpy()
    elif isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.array(x, dtype=np.float32, copy=True)


def _rnn_inputs(mode, bi, T=4, N=3, I=3, H=5, L=None, seed=0):
    if L is None:       # two layers where the op's cost allows
        L = 2 if (mode == "lstm" and not bi) else 1
    rng = np.random.RandomState(seed)
    d = 2 if bi else 1
    n = jnn.rnn_param_size(mode, I, H, L, bi)
    assert n == tnn.rnn_param_size(mode, I, H, L, bi)
    args = [rng.randn(T, N, I).astype("f4"),
            (rng.randn(n) * 0.4).astype("f4"),
            rng.randn(L * d, N, H).astype("f4")]
    if mode == "lstm":
        args.append(rng.randn(L * d, N, H).astype("f4"))
    return args, dict(state_size=H, num_layers=L, mode=mode,
                      bidirectional=bi)


MODES = [(m, bi) for m in ("lstm", "gru", "rnn_tanh", "rnn_relu")
         for bi in (False, True)]


# ------------------------------------------------------------- the op
@pytest.mark.parametrize("mode,bi", MODES)
def test_rnn_op_outputs_states_and_gradients_match_jax(mode, bi):
    args, kw = _rnn_inputs(mode, bi)
    T, N, _ = args[0].shape
    H, d = kw["state_size"], 2 if bi else 1
    shapes = [(T, N, d * H)] + [args[2].shape] * (len(args) - 2)
    cot_rng = np.random.RandomState(1)
    cots = [cot_rng.randn(*s).astype("f4") for s in shapes]

    def jboth(*a):
        # one compiled program: the outputs and their vjp
        outs, vjp = jax.vjp(lambda *x: jnn.rnn(*x, state_outputs=True,
                                               **kw), *a)
        return outs, vjp(tuple(jnp.asarray(c) for c in cots))
    jouts, jgrads = jax.jit(jboth)(*args)

    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in args]
    touts = tnn.rnn(*ts, state_outputs=True, **kw)
    assert len(touts) == (3 if mode == "lstm" else 2)
    for j, t in zip(jouts, touts):
        np.testing.assert_allclose(_np(t), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(touts, cots)) \
        .backward()
    for j, t in zip(jgrads, ts):
        np.testing.assert_allclose(_np(t.grad), np.asarray(j), rtol=1e-4,
                                   atol=1e-4)
    # without state_outputs: the output alone, as the JAX op's
    alone = tnn.rnn(*[torch.from_numpy(a) for a in args], **kw)
    assert isinstance(alone, torch.Tensor)
    np.testing.assert_allclose(_np(alone), np.asarray(jouts[0]), rtol=1e-5,
                               atol=1e-5)


def test_rnn_op_surfaces_count_outputs_and_check_the_flat_length():
    args, kw = _rnn_inputs("gru", True, L=2)
    nd = [mt.nd.array(a, ctx=CPU) for a in args]
    out = mt.nd.RNN(*nd, state_outputs=True, **kw)
    assert len(out) == 2 and out[1].shape == (4, 3, 5)
    sym = mt.sym.RNN(mt.sym.Variable("data"), mt.sym.Variable("p"),
                     mt.sym.Variable("s"), state_outputs=True, **kw)
    jsym = mx.sym.RNN(mx.sym.Variable("data"), mx.sym.Variable("p"),
                      mx.sym.Variable("s"), state_outputs=True, **kw)
    assert sym.list_outputs() == jsym.list_outputs()
    shapes = sym.infer_shape(data=(4, 3, 3))
    jshapes = jsym.infer_shape(data=(4, 3, 3))
    assert [tuple(s) for s in shapes[0]] == [tuple(s) for s in jshapes[0]]
    assert [tuple(s) for s in shapes[1]] == [tuple(s) for s in jshapes[1]]
    flat = tnn.rnn_params_from_reference(args[1], "gru", 3, 5, 2, True,
                                         device="cpu")
    assert flat.device.type == "cpu"
    assert torch.equal(flat, torch.from_numpy(args[1]))
    with pytest.raises(mt.MXNetError, match="needs"):
        tnn.rnn_params_from_reference(args[1][:-1], "gru", 3, 5, 2, True,
                                      device="cpu")
    if not torch.cuda.is_available():
        # the default is the card: without one it raises, never the CPU
        with pytest.raises(mt.MXNetError, match="no CUDA device"):
            tnn.rnn_params_from_reference(args[1], "gru", 3, 5, 2, True)


def _record_masks(monkeypatch):
    """Record every Bernoulli mask each package draws."""
    jm, tm = [], []
    jbern = jax.random.bernoulli

    def jrec(*a, **k):
        m = jbern(*a, **k)
        jm.append(np.asarray(m))
        return m
    monkeypatch.setattr(jax.random, "bernoulli", jrec)
    tbern = mt.random.bernoulli

    def trec(*a, **k):
        m = tbern(*a, **k)
        tm.append(m.cpu().numpy())
        return m
    monkeypatch.setattr(mt.random, "bernoulli", trec)
    return jm, tm


@pytest.mark.parametrize("training", [True, False])
def test_rnn_dropout_masks_are_bitwise_the_jax_packages(monkeypatch,
                                                        training):
    args, kw = _rnn_inputs("lstm", False, T=2, N=2, H=6, L=3, seed=3)
    jm, tm = _record_masks(monkeypatch)
    mx.random.seed(21)
    mt.random.seed(21)
    scope = {True: (mx.autograd.train_mode, mt.autograd.train_mode),
             False: (mx.autograd.predict_mode, mt.autograd.predict_mode)}
    with scope[training][0]():
        jo = mx.nd.RNN(*[mx.nd.array(a) for a in args], p=0.4, **kw)
    with scope[training][1]():
        to = mt.nd.RNN(*[mt.nd.array(a, ctx=CPU) for a in args], p=0.4,
                       **kw)
    # two masks (between 3 layers), applied whatever the mode
    assert len(jm) == len(tm) == 2
    for a, b in zip(jm, tm):
        np.testing.assert_array_equal(a, b)
        assert 0 < (~a).sum() < a.size
    np.testing.assert_allclose(_np(to), _np(jo), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(mt.random.get_state()[0]),
                                  np.asarray(mx.random.get_state()[0]))


def test_rnn_projection_and_clip_arguments_change_nothing():
    args, kw = _rnn_inputs("lstm", True, L=1)
    extra = dict(projection_size=2, lstm_state_clip_min=-0.01,
                 lstm_state_clip_max=0.01, lstm_state_clip_nan=True)
    plain = tnn.rnn(*[torch.from_numpy(a) for a in args],
                    state_outputs=True, **kw)
    with_extra = tnn.rnn(*[torch.from_numpy(a) for a in args],
                         state_outputs=True, **extra, **kw)
    jex = jax.jit(lambda *a: jnn.rnn(*a, state_outputs=True, **extra,
                                     **kw))(*args)
    for p, e, j in zip(plain, with_extra, jex):
        assert torch.equal(p, e)
        assert np.abs(_np(e)).max() > 0.05   # the clip did not apply
        np.testing.assert_allclose(_np(e), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)


# ------------------------------------------------------- sequence ops
SEQ_CASES = [(op, lengths, 1 if lengths else 0)
             for op in ("SequenceMask", "SequenceLast", "SequenceReverse")
             for lengths in (False, True)]


@pytest.mark.parametrize("op,lengths,axis", SEQ_CASES)
def test_sequence_ops_match_the_jax_package(op, lengths, axis):
    rng = np.random.RandomState(4)
    x = rng.randn(5, 3, 2).astype("f4") if axis == 0 else \
        rng.randn(3, 5, 2).astype("f4")
    kw = {"axis": axis}
    if op == "SequenceMask":
        kw["value"] = -1.5
    ins = [x]
    if lengths:
        ins.append(np.array([2, 5, 1], "f4"))
        kw["use_sequence_length"] = True
    j = getattr(mx.nd, op)(*[mx.nd.array(a) for a in ins], **kw)
    t = getattr(mt.nd, op)(*[mt.nd.array(a, ctx=CPU) for a in ins], **kw)
    np.testing.assert_array_equal(_np(t), _np(j))
    lower = {"SequenceMask": "sequence_mask", "SequenceLast":
             "sequence_last", "SequenceReverse": "sequence_reverse"}[op]
    t2 = getattr(mt.nd, lower)(*[mt.nd.array(a, ctx=CPU) for a in ins],
                               **kw)
    np.testing.assert_array_equal(_np(t2), _np(t))


def test_rnn_param_concat_matches_the_jax_package():
    a = np.arange(6, dtype="f4").reshape(2, 3)
    b = np.ones((1, 3), "f4")
    j = mx.nd._rnn_param_concat(mx.nd.array(a), mx.nd.array(b), dim=0)
    t = mt.nd._rnn_param_concat(mt.nd.array(a, ctx=CPU),
                                mt.nd.array(b, ctx=CPU), dim=0)
    np.testing.assert_array_equal(_np(t), _np(j))


# ------------------------------------------------------- initializers
def _fill_jax(init, name, shape):
    arr = mx.nd.zeros(shape)
    init(mx.init.InitDesc(name), arr)
    return _np(arr)


def _fill_port(init, name, shape):
    arr = torch.zeros(shape)
    init(mt.init.InitDesc(name), arr)
    return _np(arr)


@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
def test_orthogonal_is_bitwise_from_the_same_seed(rand_type):
    np.random.seed(13)
    jinit = mx.init.Orthogonal(scale=1.1, rand_type=rand_type)
    j = [_fill_jax(jinit, "w_weight", s) for s in ((6, 4), (3, 2, 2))]
    tinit = mt.init.Orthogonal(scale=1.1, rand_type=rand_type, seed=13)
    t = [_fill_port(tinit, "w_weight", s) for s in ((6, 4), (3, 2, 2))]
    for a, b in zip(j, t):
        np.testing.assert_array_equal(a, b)


def test_lstm_bias_fused_rnn_and_mixed_initializers_are_bitwise():
    for name in ("h2h_bias", "h2h_weight", "other"):
        np.testing.assert_array_equal(
            _fill_port(mt.init.LSTMBias(2.5), name, (8,)),
            _fill_jax(mx.init.LSTMBias(2.5), name, (8,)))
    for mode, bi in (("lstm", True), ("gru", False)):
        n = jnn.rnn_param_size(mode, 3, 4, 2, bi)
        np.random.seed(5)
        ja = mx.nd.zeros((n,))
        mx.init.FusedRNN(mx.init.Orthogonal(), 4, 2, mode, bi,
                         forget_bias=0.7)._init_weight(
            mx.init.InitDesc("x_parameters"), ja)
        ta = torch.zeros(n)
        mt.init.FusedRNN(mt.init.Orthogonal(seed=5), 4, 2, mode, bi,
                         forget_bias=0.7)._init_weight(
            mt.init.InitDesc("x_parameters"), ta)
        np.testing.assert_array_equal(_np(ta), _np(ja))
        # the run's global initializer when the cell's is None, through
        # the packed variable's __init__ attr (as Module.init_params)
        jg = mx.init.Constant(0.25)
        tg = mt.init.Constant(0.25)
        attrs = {"__init__": mx.init.FusedRNN(None, 4, 2, mode, bi).dumps()}
        ja = mx.nd.zeros((n,))
        jg(mx.init.InitDesc("y_parameters", attrs), ja)
        ta = torch.zeros(n)
        tg(mt.init.InitDesc("y_parameters", attrs), ta)
        np.testing.assert_array_equal(_np(ta), _np(ja))
    jmix = mx.init.Mixed(["bias$", ".*"], [mx.init.One(),
                                          mx.init.Constant(3.0)])
    tmix = mt.init.Mixed(["bias$", ".*"], [mt.init.One(),
                                          mt.init.Constant(3.0)])
    for name in ("a_bias", "a_weight"):
        np.testing.assert_array_equal(_fill_port(tmix, name, (2, 3)),
                                      _fill_jax(jmix, name, (2, 3)))
    with pytest.raises(ValueError, match="did not match"):
        _fill_port(mt.init.Mixed(["bias$"], [mt.init.One()]), "w", (2,))


# ------------------------------------------------------------- gluon
class _Pkg:
    def __init__(self, name):
        self.name = name
        self.mx = mx if name == "jax" else mt
        self.rnn = self.mx.gluon.rnn
        self.ag = self.mx.autograd

    def arr(self, a):
        return mx.nd.array(a) if self.name == "jax" else \
            mt.nd.array(a, ctx=CPU)

    def ctx(self):
        return mx.cpu() if self.name == "jax" else CPU


JAX, PORT = _Pkg("jax"), _Pkg("port")


def _rel(block):
    return {n[len(block.prefix):]: p
            for n, p in block.collect_params().items()}


LAYERS = {
    "lstm_tnc_bi": (lambda p: p.rnn.LSTM(5, layout="TNC", bidirectional=True,
                                         input_size=3), (4, 3, 3)),
    "gru_ntc": (lambda p: p.rnn.GRU(4, num_layers=2, layout="NTC",
                                    input_size=2), (3, 5, 2)),
    "rnn_relu_tnc": (lambda p: p.rnn.RNN(4, activation="relu",
                                         input_size=3), (3, 2, 3)),
    "rnn_tanh_ntc_bi": (lambda p: p.rnn.RNN(3, activation="tanh",
                                            layout="NTC",
                                            bidirectional=True,
                                            input_size=3), (2, 4, 3)),
}


def _layer(pkg, make, weights=None):
    blk = make(pkg)
    np.random.seed(0)
    blk.initialize(mx.init.Xavier() if pkg is JAX else mt.init.Xavier(),
                   ctx=pkg.ctx())
    if weights is not None:
        mt.gluon.utils.params_from_reference(blk, weights)
    return blk


def _layer_inputs(blk, xshape):
    rng = np.random.RandomState(2)
    x = rng.randn(*xshape).astype("f4")
    batch = xshape[1] if blk._layout == "TNC" else xshape[0]
    return x, [rng.randn(*s["shape"]).astype("f4")
               for s in blk.state_info(batch)]


def _port_layer_grads(blk, x, st, cot, states=True):
    xs = mt.nd.array(x, ctx=CPU)
    xs.attach_grad()
    with mt.autograd.record():
        if states:
            out, new = blk(xs, [mt.nd.array(s, ctx=CPU) for s in st])
        else:
            out, new = blk(xs), []
        (out * mt.nd.array(cot, ctx=CPU)).sum().backward()
    return ([_np(out)] + [_np(s) for s in new], _np(xs.grad),
            {k: _np(p.grad()) for k, p in _rel(blk).items()})


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_rnn_layers_match_the_jax_package(name):
    """Outputs and states against the JAX layer (hybridized, in training
    mode); the port's gradients eager and hybridized alike (the op's are
    held against jax.grad above, the layer's through training in
    test_torch_port_rnn_symbolic.py)."""
    make, xshape = LAYERS[name]
    jblk = _layer(JAX, make)
    w = {k: _np(p.data()) for k, p in _rel(jblk).items()}
    x, st = _layer_inputs(jblk, xshape)
    jblk.hybridize()
    with mx.autograd.train_mode():
        jout, jnew = jblk(mx.nd.array(x), [mx.nd.array(s) for s in st])
    jouts = [_np(jout)] + [_np(s) for s in jnew]
    cot = np.random.RandomState(9).randn(*jouts[0].shape).astype("f4")
    runs = []
    for hybrid in (False, True):
        blk = _layer(PORT, make, w)
        if hybrid:
            blk.hybridize()
        runs.append(_port_layer_grads(blk, x, st, cot))
        for a, b in zip(runs[-1][0], jouts):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    (_, edx, eg), (_, hdx, hg) = runs
    np.testing.assert_allclose(hdx, edx, rtol=1e-6, atol=1e-6)
    assert sorted(eg) == sorted(w)
    for k in eg:
        np.testing.assert_allclose(hg[k], eg[k], rtol=1e-6, atol=1e-6)
    # without states: zero states, the output alone
    blk = _layer(PORT, make, w)
    zero = [np.zeros_like(s) for s in st]
    alone, _, _ = _port_layer_grads(blk, x, None, cot, states=False)
    with_zero, _, _ = _port_layer_grads(blk, x, zero, cot)
    assert len(alone) == 1
    np.testing.assert_array_equal(alone[0], with_zero[0])


def test_unfused_layer_matches_the_fused_layer_and_begin_states():
    for make, xshape in LAYERS.values():
        layer = make(PORT)
        layer.initialize(mt.init.Xavier(), ctx=CPU)
        x = mt.nd.array(np.random.RandomState(3).randn(*xshape)
                        .astype("f4"), ctx=CPU)
        fused = layer(x)
        stack = layer._unfuse()
        length = xshape[0] if layer._layout == "TNC" else xshape[1]
        out, _ = stack.unroll(length, x, layout=layer._layout,
                              merge_outputs=True)
        np.testing.assert_allclose(_np(out), _np(fused), rtol=1e-5,
                                   atol=1e-5)
        jlayer = make(JAX)
        for b in (0, 7):
            assert [tuple(s.shape) for s in layer.begin_state(b, ctx=CPU)] \
                == [tuple(s.shape) for s in jlayer.begin_state(b)]


def _cells(p):
    r = p.rnn
    seq = r.SequentialRNNCell()
    with seq.name_scope():
        seq.add(r.LSTMCell(4, prefix="a_", input_size=2))
        seq.add(r.DropoutCell(0.0))
        seq.add(r.GRUCell(3, prefix="b_", input_size=4))
    return {
        "rnn_relu": r.RNNCell(4, activation="relu", prefix="c_",
                              input_size=2),
        "lstm": r.LSTMCell(5, prefix="c_", input_size=2),
        "gru": r.GRUCell(3, prefix="c_", input_size=2),
        "sequential": seq,
        "residual": r.ResidualCell(r.GRUCell(2, prefix="c_",
                                             input_size=2)),
        "zoneout": r.ZoneoutCell(r.LSTMCell(3, prefix="c_", input_size=2),
                                 zoneout_outputs=0.3, zoneout_states=0.4),
        "bidirectional": r.BidirectionalCell(
            r.LSTMCell(3, prefix="l_", input_size=2),
            r.GRUCell(3, prefix="r_", input_size=2)),
    }


_X = np.random.RandomState(6).randn(3, 4, 2).astype("f4")       # NTC
_VL = np.array([4, 2, 3], "f4")


def _rel_cell(cell):
    return {k[k.index("_") + 1:] if k.startswith("sequentialrnncell")
            else k: p for k, p in cell.collect_params().items()}


def _wrapped(pkg, cell, merge):
    """``cell.unroll`` inside one HybridBlock, for a hybridized call."""
    class Unroll(pkg.mx.gluon.HybridBlock):
        def __init__(self):
            super().__init__(prefix="w_")
            self.cell = cell

        def hybrid_forward(self, F, x, vl=None):
            return self.cell.unroll(4, x, layout="NTC", merge_outputs=merge,
                                    valid_length=vl)
    blk = Unroll()
    blk.hybridize()
    return blk


def _unroll(pkg, cell, valid, merge, grad=False, wrap=False):
    """``cell.unroll`` over _X in training mode, the chain seeded first;
    eager, or hybridized inside one block (``wrap``) -> (outputs, states
    [, input gradient])."""
    x = pkg.arr(_X)
    args = [x] + ([pkg.arr(_VL)] if valid else [])
    pkg.mx.random.seed(4)
    if grad:
        x.attach_grad()
    with (pkg.ag.record() if grad else pkg.ag.train_mode()):
        if wrap:
            outs, states = _wrapped(pkg, cell, merge)(*args)
        else:
            outs, states = cell.unroll(4, x, layout="NTC",
                                       merge_outputs=merge,
                                       valid_length=args[1] if valid
                                       else None)
        if grad:
            merged = outs if not isinstance(outs, (list, tuple)) else \
                pkg.mx.nd.stack(*outs, axis=1)
            loss = (merged * merged).sum()
            for s in states:
                loss = loss + s.sum()
    if grad:
        loss.backward()
    outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
    res = ([_np(o) for o in outs], [_np(s) for s in states])
    return res + (_np(x.grad),) if grad else res


@pytest.mark.parametrize("kind", ["rnn_relu", "lstm", "gru", "sequential",
                                  "residual", "zoneout", "bidirectional"])
def test_cell_unroll_matches_the_jax_package(kind):
    """The unroll with ``valid_length`` and per-step outputs (the merged
    one without lengths for the residual cell, whose JAX unroll takes
    none) against the JAX cell's, hybridized inside one block in both
    packages and eager in the port; the port's other forms against it:
    merged against per step (bitwise), and every length full against no
    lengths. Gradients: the port hybridized against eager."""
    valid, merge = (False, True) if kind == "residual" else (True, False)
    jcell = _cells(JAX)[kind]
    np.random.seed(1)
    jcell.initialize(mx.init.Xavier())
    w = {k: _np(p.data()) for k, p in _rel_cell(jcell).items()}
    jo, js = _unroll(JAX, jcell, valid, merge, wrap=True)
    cell = _cells(PORT)[kind]
    cell.initialize(mt.init.Xavier(), ctx=CPU)
    tp = _rel_cell(cell)
    assert sorted(tp) == sorted(w)
    for k, p in tp.items():
        p.set_data(w[k])
    # zoneout draws its masks from the call's key when hybridized and
    # from the chain when not (as the JAX cell): eager differs by design
    forms = [True] if kind == "zoneout" else [True, False]
    for wrap in forms:
        to, ts = _unroll(PORT, cell, valid, merge, wrap=wrap)
        assert len(to) == len(jo) and len(ts) == len(js)
        for a, b in zip(to + ts, jo + js):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    if kind == "zoneout":
        return
    oo, os_ = _unroll(PORT, cell, valid, not merge)
    per_step, whole = (oo, to[0]) if merge else (to, oo[0])
    np.testing.assert_array_equal(np.stack(per_step, 1), whole)
    for a, b in zip(os_, ts):
        np.testing.assert_array_equal(a, b)
    if kind != "residual":
        full, _ = _unroll(PORT, cell, False, merge)
        global _VL
        saved, _VL = _VL, np.full(3, 4, "f4")
        try:
            all_valid, _ = _unroll(PORT, cell, True, merge)
        finally:
            _VL = saved
        for a, b in zip(all_valid, full):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    eo, es, edx = _unroll(PORT, cell, valid, merge, grad=True)
    ho, hs, hdx = _unroll(PORT, cell, valid, merge, grad=True, wrap=True)
    for a, b in zip(ho + hs + [hdx], eo + es + [edx]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    assert [tuple(s.shape) for s in cell.begin_state(2, ctx=CPU)] == \
        [tuple(s.shape) for s in jcell.begin_state(2)]
