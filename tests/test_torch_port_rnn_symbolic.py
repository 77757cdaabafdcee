"""Port parity for the symbolic recurrent stack (``mx.rnn``, its
``BucketSentenceIter``, ``BucketingModule``) and for the Gluon word
language model as a whole, against the JAX package, on the CPU.

* The ``mx.rnn`` cells unrolled into Symbols: the JSON of each (RNN,
  LSTM, GRU, sequential, bidirectional, dropout and fused cells) equals
  the JAX package's; bound and run forward on the same arguments, the
  unrolled LSTM and the fused bidirectional LSTM give the JAX package's
  outputs within 1e-5.
* ``FusedRNNCell``: ``unpack_weights``/``pack_weights`` round-trip
  bitwise and split as the JAX cell splits; ``unfuse()`` (the port's
  own) computes what the fused cell computes.
* ``BucketSentenceIter``: the same batches, bucket keys and discard
  count as the JAX package's under the same seeds; ``encode_sentences``.
* ``BucketingModule.fit``: a tiny char model (two buckets) for 2
  epochs, the running perplexity and every parameter after every step
  against the JAX package's, within 1e-5; the same through the fused
  step (``kvstore="tpu_sync"``) against the port's eager path.
* The slice as a whole: ``tests/gluon_lstm_lm.py``'s model at vocab 50,
  hidden 16, 2 layers, batch 4, bptt 5, dropout 0.5, for 3 steps of the
  example's loop: losses and every parameter after every step within
  1e-5 of the JAX package's. The LSTM layer is hybridized in both
  packages (one compiled program a step on the JAX side; the eager op is
  held against it in ``test_torch_port_rnn.py``). The JAX package cannot
  tie the decoder to the encoder (its ParameterDict refuses the decoder's
  (vocab, 0) request for the known weight); the port's tied model is
  held against the untied JAX model started with the decoder's weight
  equal to the encoder's: the same first-step logits, and the tied
  weight's gradient the sum of the JAX encoder's and decoder's.
"""
import logging
import os
import random
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from gluon_lstm_lm import lm_step, rnn_model_class  # noqa: E402

CPU = mt.cpu()


def _np(x):
    if hasattr(x, "asnumpy"):
        x = x.asnumpy()
    elif isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.array(x, dtype=np.float32, copy=True)


# ------------------------------------------------------------ mx.rnn cells
def _sym_cells(pkg):
    r = pkg.rnn
    seq = r.SequentialRNNCell()
    seq.add(r.LSTMCell(4, prefix="a_"))
    seq.add(r.DropoutCell(0.25, prefix="d_"))
    seq.add(r.GRUCell(3, prefix="b_"))
    return {
        "rnn": lambda: r.RNNCell(4, activation="relu", prefix="r_"),
        "lstm": lambda: r.LSTMCell(5, prefix="l_", forget_bias=0.5),
        "gru": lambda: r.GRUCell(3, prefix="g_"),
        "sequential": lambda: seq,
        "bidirectional": lambda: r.BidirectionalCell(
            r.LSTMCell(3, prefix="bl_"), r.GRUCell(3, prefix="br_")),
        "fused": lambda: r.FusedRNNCell(4, num_layers=2, mode="gru",
                                        bidirectional=True, dropout=0.3,
                                        get_next_state=True, prefix="f_"),
    }


def _unrolled(pkg, kind, merge=True, layout="NTC"):
    cell = _sym_cells(pkg)[kind]()
    data = pkg.sym.Variable("data")
    # fresh node-name counters, whatever ran before in this process
    with pkg.name.NameManager():
        outs, states = cell.unroll(3, inputs=data, layout=layout,
                                   merge_outputs=merge)
    if isinstance(outs, (list, tuple)):
        outs = list(outs)
    else:
        outs = [outs]
    return pkg.sym.Group(outs + list(states)), cell


@pytest.mark.parametrize("kind", ["rnn", "lstm", "gru", "sequential",
                                  "bidirectional", "fused"])
def test_symbolic_cells_unroll_to_the_jax_packages_json(kind):
    for merge in (True, False):
        jsym, _ = _unrolled(mx, kind, merge)
        tsym, _ = _unrolled(mt, kind, merge)
        assert tsym.tojson() == jsym.tojson()
        assert tsym.list_arguments() == jsym.list_arguments()


def _forward(pkg, sym, feed):
    shapes = {k: v.shape for k, v in feed.items()}
    ex = sym.simple_bind(pkg.cpu(), grad_req="null", **shapes)
    for k, v in feed.items():
        if pkg is mx:
            ex.arg_dict[k][:] = mx.nd.array(v)
        else:
            ex.arg_dict[k].copy_(torch.from_numpy(v))
    return [_np(o) for o in ex.forward(is_train=False)]


@pytest.mark.parametrize("kind", ["lstm", "fused_lstm"])
def test_symbolic_cells_compute_what_the_jax_package_computes(kind):
    rng = np.random.RandomState(0)
    if kind == "lstm":
        make = {p: (lambda p=p: p.rnn.LSTMCell(4, prefix="l_"))
                for p in (mx, mt)}
    else:
        make = {p: (lambda p=p: p.rnn.FusedRNNCell(
            4, num_layers=2, bidirectional=True, get_next_state=True,
            prefix="f_")) for p in (mx, mt)}
    outs = {}
    for pkg in (mx, mt):
        cell = make[pkg]()
        o, st = cell.unroll(3, inputs=pkg.sym.Variable("data"),
                            layout="NTC", merge_outputs=True)
        sym = pkg.sym.Group([o] + list(st))
        shapes, _, _ = sym.infer_shape(data=(2, 3, 3))
        if pkg is mx:
            feed = {n: (rng.randn(*s) * 0.5).astype("f4")
                    for n, s in zip(sym.list_arguments(), shapes)}
        outs[pkg] = _forward(pkg, sym, feed)
    for a, b in zip(outs[mt], outs[mx]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def _gate_concat(cell, per_gate):
    """Per-gate pieces (``unpack_weights``) stacked into the unfused
    cells' names, in gate order."""
    gates = cell._gate_names
    groups = {}
    for name, v in per_gate.items():
        for g in gates:
            for kind in ("i2h", "h2h"):
                mark = "_%s%s_" % (kind, g)
                if mark in name:
                    stem = name.replace(mark, "_%s_" % kind)
                    groups.setdefault(stem, {})[g] = v
    return {stem: np.concatenate([_np(by[g]) for g in gates], 0)
            for stem, by in groups.items()}


@pytest.mark.parametrize("mode,bi", [("lstm", True), ("gru", False),
                                     ("rnn_tanh", False)])
def test_fused_cell_packs_unpacks_and_unfuses(mode, bi):
    from mxnet_tpu_torch.ops.nn import rnn_param_size
    n = rnn_param_size(mode, 3, 4, 2, bi)
    flat = np.random.RandomState(1).randn(n).astype("f4") * 0.5
    jcell = mx.rnn.FusedRNNCell(4, num_layers=2, mode=mode,
                                bidirectional=bi, prefix="f_")
    tcell = mt.rnn.FusedRNNCell(4, num_layers=2, mode=mode,
                                bidirectional=bi, prefix="f_")
    jparts = jcell.unpack_weights({"f_parameters": mx.nd.array(flat)})
    for arg in (torch.from_numpy(flat), mt.nd.array(flat, ctx=CPU), flat):
        tparts = tcell.unpack_weights({"f_parameters": arg})
        assert sorted(tparts) == sorted(jparts)
        for k in jparts:
            np.testing.assert_array_equal(_np(tparts[k]), _np(jparts[k]))
        back = tcell.pack_weights(tparts)["f_parameters"]
        assert type(back) is type(arg)
        np.testing.assert_array_equal(_np(back), flat)
    # unfuse: the stack of unfused cells computes what the fused cell does
    x = np.random.RandomState(2).randn(2, 3, 3).astype("f4")
    fo, _ = tcell.unroll(3, inputs=mt.sym.Variable("data"), layout="NTC",
                         merge_outputs=True)
    fused = _forward(mt, fo, {"data": x, "f_parameters": flat})[0]
    stack = tcell.unfuse()
    uo, _ = stack.unroll(3, inputs=mt.sym.Variable("data"), layout="NTC",
                         merge_outputs=True)
    feed = {"data": x}
    feed.update(_gate_concat(tcell, tparts))
    assert sorted(feed) == sorted(uo.list_arguments())
    np.testing.assert_allclose(_forward(mt, uo, feed)[0], fused, rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------- BucketSentenceIter
def _sentences(n=40, seed=3, longest=10):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(1, 9, rng.randint(2, longest + 1)))
            for _ in range(n)]


def _seed(s):
    random.seed(s)
    np.random.seed(s)


def test_bucket_sentence_iter_matches_the_jax_package():
    sents = _sentences()
    for kw in ({"buckets": [4, 7]}, {"buckets": None, "layout": "TN"}):
        _seed(7)
        jit = mx.rnn.BucketSentenceIter(sents, 3, invalid_label=0, **kw)
        _seed(7)
        tit = mt.rnn.BucketSentenceIter(sents, 3, invalid_label=0, **kw)
        assert tit.ndiscard == jit.ndiscard
        assert tit.buckets == jit.buckets
        assert tit.default_bucket_key == jit.default_bucket_key
        assert [tuple(d.shape) for d in tit.provide_data] == \
            [tuple(d.shape) for d in jit.provide_data]
        for _ in range(2):
            jb, tb = list(jit), list(tit)
            assert len(jb) == len(tb) > 0
            for a, b in zip(jb, tb):
                assert a.bucket_key == b.bucket_key
                np.testing.assert_array_equal(_np(b.data[0]),
                                              _np(a.data[0]))
                np.testing.assert_array_equal(_np(b.label[0]),
                                              _np(a.label[0]))
            _seed(8)
            jit.reset()
            _seed(8)
            tit.reset()
    assert mt.rnn.BucketSentenceIter(sents, 3, buckets=[4]).ndiscard > 0


def test_encode_sentences_builds_and_applies_a_vocabulary():
    coded, vocab = mt.rnn.encode_sentences([["a", "b"], ["b", "c"]],
                                           invalid_label=1, start_label=0)
    assert coded == [[0, 2], [2, 3]]
    assert vocab == {"\n": 1, "a": 0, "b": 2, "c": 3}
    again, _ = mt.rnn.encode_sentences([["c", "a"]], vocab=dict(vocab))
    assert again == [[3, 0]]
    with pytest.raises(KeyError):
        mt.rnn.encode_sentences([["z"]], vocab=dict(vocab))
    unk, v2 = mt.rnn.encode_sentences([["z"]], vocab=dict(vocab),
                                      unknown_token="<unk>")
    assert unk == [[v2["<unk>"]]]


# --------------------------------------------------------- BucketingModule
N_VOCAB, NH = 9, 6


def _char_sym_gen(pkg):
    def sym_gen(seq_len):
        data = pkg.sym.Variable("data")
        label = pkg.sym.Variable("softmax_label")
        embed = pkg.sym.Embedding(data, input_dim=N_VOCAB, output_dim=5,
                                  name="embed")
        cell = pkg.rnn.LSTMCell(NH, prefix="lstm_")
        outs, _ = cell.unroll(seq_len, inputs=embed, layout="NTC",
                              merge_outputs=True)
        pred = pkg.sym.Reshape(outs, shape=(-1, NH))
        pred = pkg.sym.FullyConnected(pred, num_hidden=N_VOCAB, name="pred")
        label = pkg.sym.Reshape(label, shape=(-1,))
        return (pkg.sym.SoftmaxOutput(pred, label, name="softmax",
                                      use_ignore=True, ignore_label=0),
                ("data",), ("softmax_label",))
    return sym_gen


def _fit_char(pkg, init, kvstore="local"):
    _seed(0)
    it = pkg.rnn.BucketSentenceIter(_sentences(30, longest=6), 4,
                                    buckets=[3, 5], invalid_label=0)
    mod = pkg.mod.BucketingModule(_char_sym_gen(pkg),
                                  default_bucket_key=it.default_bucket_key,
                                  context=pkg.cpu())
    log = []

    def record(param):
        args, _ = mod.get_params()
        log.append((param.eval_metric.get()[1],
                    {k: _np(v) for k, v in args.items()}))
    arg = {k: (mx.nd.array(v) if pkg is mx else v) for k, v in init.items()}
    mod.fit(it, num_epoch=2, optimizer="adam", kvstore=kvstore,
            optimizer_params={"learning_rate": 3e-2},
            arg_params=arg, eval_metric=pkg.metric.Perplexity(ignore_label=0),
            batch_end_callback=record)
    return log, mod


def _char_init():
    rng = np.random.RandomState(5)
    shapes = {"embed_weight": (N_VOCAB, 5), "lstm_i2h_weight": (4 * NH, 5),
              "lstm_i2h_bias": (4 * NH,), "lstm_h2h_weight": (4 * NH, NH),
              "lstm_h2h_bias": (4 * NH,), "pred_weight": (N_VOCAB, NH),
              "pred_bias": (N_VOCAB,)}
    return {k: (rng.randn(*s) * 0.3).astype("f4") for k, s in shapes.items()}


def test_bucketing_module_fits_like_the_jax_package_step_by_step():
    """Every step: the running perplexity (the loss) and every
    parameter."""
    init = _char_init()
    logging.disable(logging.WARNING)
    try:
        jlog, _ = _fit_char(mx, init)
        tlog, tmod = _fit_char(mt, init)
    finally:
        logging.disable(logging.NOTSET)
    assert len(tlog) == len(jlog) >= 8
    assert len(tmod._buckets) == 2
    for step, ((jm, jp), (tm, tp)) in enumerate(zip(jlog, tlog)):
        np.testing.assert_allclose(tm, jm, rtol=1e-5)
        for k in jp:
            np.testing.assert_allclose(tp[k], jp[k], rtol=1e-5, atol=1e-5,
                                       err_msg="%s step %d" % (k, step))
    # every bucket's executor holds the same parameter tensors
    a, b = [m._exec.arg_dict["lstm_h2h_weight"]
            for m in tmod._buckets.values()]
    assert a is b


def test_bucketing_module_fused_step_matches_its_eager_step():
    """With ``kvstore="tpu_sync"`` every bucket runs the fused step over
    the shared weights, one Adam state and one update count a weight:
    step by step as the eager path, within 1e-5 (the fused update rounds
    its Adam scalars to f32, as the JAX package's fused program does;
    the eager updater keeps them in double)."""
    init = _char_init()
    logging.disable(logging.WARNING)
    try:
        elog, _ = _fit_char(mt, init)
        flog, fmod = _fit_char(mt, init, kvstore="tpu_sync")
    finally:
        logging.disable(logging.NOTSET)
    mods = list(fmod._buckets.values())
    assert all(m._fused is not None for m in mods)
    assert mods[0]._fused_opt_state is mods[1]._fused_opt_state
    assert mods[0]._optimizer is mods[1]._optimizer
    for step, ((em, ep), (fm, fp)) in enumerate(zip(elog, flog)):
        np.testing.assert_allclose(fm, em, rtol=1e-5)
        for k in ep:
            np.testing.assert_allclose(fp[k], ep[k], rtol=1e-5, atol=1e-5,
                                       err_msg="%s step %d" % (k, step))


# ------------------------------------------------- the slice: the Gluon LM
V, E, H, L, B, T = 50, 16, 16, 2, 4, 5


def _lm(pkg, tie, weights=None):
    """The example's model, its deferred shapes completed from the known
    input shapes (each layer's ``_layer_infer_shape``, no probe
    forward), its LSTM layer hybridized; ``weights`` (by relative name)
    carried into the port's."""
    ctx = pkg.cpu()
    model = rnn_model_class(pkg.gluon)(V, E, H, L, 0.5, tie)
    np.random.seed(0)
    model.initialize(pkg.init.Xavier(), ctx=ctx)
    model.rnn._layer_infer_shape((B, T, E))
    model.decoder._layer_infer_shape((B, T, H))
    hidden = model.begin_state(B, ctx)
    arr = (lambda a: mx.nd.array(a)) if pkg is mx else \
        (lambda a: mt.nd.array(a, ctx=CPU))
    model.rnn.hybridize()
    rel = {n[len(model.prefix):]: p
           for n, p in model.collect_params().items()}
    if weights is not None:
        mt.gluon.utils.params_from_reference(model, weights)
    return model, rel, hidden, arr


def _train_lm(pkg, tie, weights=None, steps=3):
    """``steps`` of the example's loop from the chain seeded at 7 ->
    (weights, [(loss, params after)], (logits, unclipped gradients) of
    step 0)."""
    model, rel, hidden, arr = _lm(pkg, tie, weights)
    if weights is None:
        weights = {k: _np(p.data()) for k, p in rel.items()}
        # the decoder starts at the encoder's values, so that the port's
        # tied model starts where this untied one does
        weights["dense0_weight"] = weights["embedding0_weight"]
        for k, p in rel.items():
            p.set_data(mx.nd.array(weights[k]))
    toks = np.random.RandomState(0).randint(0, V, (B, 3 * T + 1)) \
        .astype("f4")
    pkg.random.seed(7)
    trainer = pkg.gluon.Trainer(model.collect_params(), "sgd",
                                {"learning_rate": 2.0})
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    first = []

    def grab(out, params):
        if not first:
            first.append((_np(out), {n[len(model.prefix):]: _np(p.grad())
                                     for n, p in params.items()}))
    log = []
    for b in range(steps):
        X = arr(toks[:, b * T:(b + 1) * T])
        Y = arr(toks[:, b * T + 1:(b + 1) * T + 1])
        loss, hidden = lm_step(pkg.gluon, pkg.autograd, model, trainer,
                               loss_fn, X, Y, hidden, 0.25, B,
                               before_clip=grab)
        log.append((_np(loss), {k: _np(p.data()) for k, p in rel.items()}))
    return weights, log, first[0], model


@pytest.fixture(scope="module")
def jax_lm():
    return _train_lm(mx, False)


def test_word_language_model_trains_like_the_jax_package(jax_lm):
    weights, jlog, _, _ = jax_lm
    _, tlog, _, _ = _train_lm(mt, False, weights)
    for step, ((jl, jp), (tl, tp)) in enumerate(zip(jlog, tlog)):
        np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
        assert sorted(tp) == sorted(jp)
        for k in jp:
            np.testing.assert_allclose(tp[k], jp[k], rtol=1e-5, atol=1e-5,
                                       err_msg="%s step %d" % (k, step))
    np.testing.assert_array_equal(np.asarray(mt.random.get_state()[0]),
                                  np.asarray(mx.random.get_state()[0]))


def test_tied_word_language_model_matches_the_untied_jax_model(jax_lm):
    weights, _, (jout, jg), _ = jax_lm
    tw = {k: v for k, v in weights.items() if k != "dense0_weight"}
    tw["embedding0_bias"] = tw.pop("dense0_bias")
    _, _, (tout, tg), model = _train_lm(mt, True, tw, steps=1)
    assert model.decoder.weight is model.encoder.weight
    # 0 takes the known size; two known sizes that differ still clash
    with pytest.raises(mt.MXNetError, match="incompatible"):
        model.encoder.params.get("weight", shape=(V + 1, 0))
    np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tg["embedding0_weight"],
                               jg["embedding0_weight"] + jg["dense0_weight"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tg["embedding0_bias"], jg["dense0_bias"],
                               rtol=1e-5, atol=1e-5)
    for k in tg:
        if k.startswith("lstm"):
            np.testing.assert_allclose(tg[k], jg[k], rtol=1e-4, atol=1e-5,
                                       err_msg=k)
