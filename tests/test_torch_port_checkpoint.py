"""Port parity for checkpoints and resume: ``model.save_checkpoint``/
``load_checkpoint``, ``checkpoint.CheckpointManager`` and its helpers,
``Module.fit``'s checkpoints under ``MXNET_RESUME_DIR``, and the Gluon
``Trainer``'s ``save_checkpoint``/``restore_checkpoint``.

Both packages get the same ``RandomState`` inputs on the CPU: a small
MLP (8 -> 16 -> 4, BatchNorm between) on ``NDArrayIter`` batches of 4.
Tolerances: files and snapshots written by one package and read by the
other bitwise; a resumed port run bitwise the uninterrupted port run
(the same arithmetic in the same order, the key chain restored); the
port's 8 steps within f32 ``rtol=atol=1e-5`` of the JAX package's (the
same math summed in another order by another library).

Every key of a snapshot crosses: ``arg:``/``aux:``/``param:i:name``
arrays, ``__opt__`` (a pickle of the Updater's numpy states and the
update counts), ``__rng__`` (a pickle of the key as a numpy uint32 pair
and numpy's generator state) and ``__data_cursor__`` (JSON bytes), and
each manifest carries the ``meta["layout"]`` record both packages
reshard by (``test_torch_port_layout.py``).
"""
import json
import os
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import checkpoint as jck

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import checkpoint as tck

N, DIM, CLASSES, BATCH = 32, 8, 4, 4
OPT = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}


def _mlp(sym, dropout=0.0):
    data = sym.Variable("data")
    net = sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = sym.BatchNorm(net, name="bn1")
    net = sym.Activation(net, act_type="relu")
    if dropout:
        net = sym.Dropout(net, p=dropout)
    net = sym.FullyConnected(net, num_hidden=CLASSES, name="fc2")
    return sym.SoftmaxOutput(net, name="softmax")


def _data(n=N, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, DIM).astype(np.float32),
            rng.randint(0, CLASSES, (n,)).astype(np.float32))


def _params(seed=3):
    rng = np.random.RandomState(seed)
    shapes, _, _ = _mlp(mt.sym).infer_shape(data=(BATCH, DIM))
    names = _mlp(mt.sym).list_arguments()
    return {n: (rng.randn(*s) * 0.3).astype(np.float32)
            for n, s in zip(names, shapes)
            if n not in ("data", "softmax_label")}


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy().copy()
    return np.array(v.asnumpy(), copy=True)


# ------------------------------------------------------ checkpoint files
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_files_cross_between_packages(writer, tmp_path):
    """``prefix-symbol.json`` and ``prefix-NNNN.params`` written by either
    package's ``save_checkpoint`` load in the other's
    ``load_checkpoint`` bitwise."""
    prefix = str(tmp_path / "m")
    args = _params()
    aux = {"bn1_moving_mean": np.arange(16, dtype=np.float32),
           "bn1_moving_var": np.ones(16, np.float32) * 2}
    if writer == "jax":
        mx.model.save_checkpoint(prefix, 3, _mlp(mx.sym),
                                 {k: mx.nd.array(v) for k, v in args.items()},
                                 {k: mx.nd.array(v) for k, v in aux.items()})
    else:
        mt.model.save_checkpoint(prefix, 3, _mlp(mt.sym),
                                 {k: torch.from_numpy(v)
                                  for k, v in args.items()},
                                 {k: mt.nd.array(v, ctx=mt.cpu())
                                  for k, v in aux.items()})
    assert sorted(os.listdir(tmp_path)) == ["m-0003.params",
                                            "m-symbol.json"]
    jsym, jargs, jaux = mx.model.load_checkpoint(prefix, 3)
    tsym, targs, taux = mt.model.load_checkpoint(prefix, 3, ctx=mt.cpu())
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_auxiliary_states() == jsym.list_auxiliary_states()
    for want, j, t in ((args, jargs, targs), (aux, jaux, taux)):
        assert sorted(j) == sorted(t) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(j[k].asnumpy(), want[k])
            np.testing.assert_array_equal(t[k].asnumpy(), want[k])
    tsym.save(str(tmp_path / "again.json"))
    assert mx.sym.load(str(tmp_path / "again.json")).list_outputs() == \
        jsym.list_outputs()


def test_atomic_replace_leaves_the_old_file_on_error(tmp_path):
    path = tmp_path / "f.bin"
    tck.atomic_write_bytes(path, b"old")
    with pytest.raises(RuntimeError):
        with tck.atomic_replace(path) as tmp:
            with open(tmp, "wb") as f:
                f.write(b"torn")
            raise RuntimeError("killed")
    assert path.read_bytes() == b"old"
    assert os.listdir(tmp_path) == ["f.bin"]
    tck.atomic_write_bytes(path, b"new")
    assert path.read_bytes() == b"new"


# ------------------------------------------------------ CheckpointManager
def _state(seed=0):
    rng = np.random.RandomState(seed)
    return {"arg:w": rng.randn(3, 2).astype(np.float32),
            "aux:m": np.arange(4, dtype=np.int32),
            "__opt__": b"\x00opaque\xff",
            tck.DATA_CURSOR_KEY: tck.encode_cursor({"epoch": 1, "b": 2})}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshots_cross_between_packages(writer, tmp_path):
    """A snapshot (npz + manifest with size and CRC32) written by either
    package's manager restores in the other's, every key bitwise."""
    W = jck if writer == "jax" else tck
    W.CheckpointManager(tmp_path, async_save=False).save(
        _state(), 7, epoch=1, nbatch=3, meta={"kvstore": "local"})
    for R in (jck, tck):
        state, man = R.CheckpointManager(tmp_path).restore_latest()
        assert (man["step"], man["epoch"], man["nbatch"]) == (7, 1, 3)
        assert man["meta"]["kvstore"] == "local"
        want = _state()
        assert sorted(state) == sorted(want)
        for k, v in want.items():
            if isinstance(v, bytes):
                assert state[k] == v
            else:
                np.testing.assert_array_equal(state[k], v)
        assert R.cursor_from_state(state) == {"epoch": 1, "b": 2}


def test_torn_snapshots_are_skipped_and_retention_keeps_two(tmp_path):
    cm = tck.CheckpointManager(tmp_path, keep_n=1, async_save=True)
    assert cm.keep_n == 2
    for step in (1, 2, 3):
        cm.save(_state(step), step)
    cm.wait()
    assert cm.steps() == [3, 2]
    # a torn data file: the manifest's CRC no longer matches
    with open(os.path.join(cm.directory, "ckpt-3.npz"), "r+b") as f:
        f.truncate(40)
    for R in (jck, tck):
        state, man = R.CheckpointManager(tmp_path).restore()
        assert man["step"] == 2
        np.testing.assert_array_equal(state["arg:w"], _state(2)["arg:w"])
    # a torn manifest is no snapshot at all
    with open(os.path.join(cm.directory, "ckpt-2.json"), "w") as f:
        f.write("{")
    assert tck.CheckpointManager(tmp_path).restore() == (None, None)
    assert cm.maybe_save(lambda: _state(9), 9) is True
    cm2 = tck.CheckpointManager(tmp_path, save_every=4, async_save=False)
    assert cm2.maybe_save(lambda: 1 / 0, 10) is False


def test_env_construction_and_the_multi_process_parts(tmp_path,
                                                      monkeypatch):
    assert tck.CheckpointManager.from_env() is None
    monkeypatch.setenv("MXNET_CHECKPOINT_DIR", str(tmp_path / "a"))
    monkeypatch.setenv("MXNET_CHECKPOINT_EVERY", "3")
    monkeypatch.setenv("MXNET_CHECKPOINT_KEEP", "4")
    cm = tck.CheckpointManager.from_env()
    assert (cm.save_every, cm.keep_n, cm.root) == (3, 4, str(tmp_path / "a"))
    assert not tck.CheckpointManager.should_resume()
    monkeypatch.setenv("MXNET_RESUME_DIR", str(tmp_path / "b"))
    assert tck.CheckpointManager.should_resume()
    assert tck.CheckpointManager.from_env().root == str(tmp_path / "b")
    # the multi-process parts on a root with no snapshot: nothing to
    # reshard, nothing to restore, as in the JAX package
    from mxnet_tpu import checkpoint as jck
    for mod in (tck, jck):
        with pytest.raises(ValueError, match="no common committed step"):
            mod.reshard_checkpoint(str(tmp_path), 2)
    assert cm.restore_resharded() == (None, None)


# ------------------------------------------------- Module fit and resume
def _iter(pkg, X, Y):
    return pkg.io.NDArrayIter(X, Y, batch_size=BATCH,
                              label_name="softmax_label")


def _fit(pkg, X, Y, kvstore="tpu_sync", k=None, ckpt=None, dropout=0.0,
         seen=None, seed=0):
    """8 SGD-momentum steps (or fewer: the batches of X) of the MLP from
    ``_params``; -> the module."""
    if pkg is mt:
        mt.random.seed(seed)
        mod = mt.mod.Module(_mlp(mt.sym, dropout), context=mt.cpu())
        args = dict(_params())
    else:
        mx.random.seed(0)
        mod = mx.mod.Module(_mlp(mx.sym, dropout), context=mx.cpu())
        args = {k_: mx.nd.array(v) for k_, v in _params().items()}
    mod.fit(_iter(pkg, X, Y), num_epoch=1, optimizer="sgd",
            optimizer_params=dict(OPT), arg_params=args, initializer=None,
            kvstore=kvstore, eval_metric=None, steps_per_dispatch=k,
            checkpoint=ckpt, batch_end_callback=None if seen is None
            else lambda p: seen.append(p.nbatch))
    return mod


def _trained(mod):
    """Parameters, moving statistics and momentum as host arrays."""
    args, aux = mod.get_params()
    out = {k: _host(v) for k, v in list(args.items()) + list(aux.items())}
    mod._mirror_fused_state()
    for i, st in sorted(mod._live_updater().states.items()):
        out["mom%s" % i] = _host(st)
    return out


@pytest.mark.parametrize("kvstore,k,dropout", [
    ("tpu_sync", 1, 0.0), ("tpu_sync", 2, 0.0), ("local", 1, 0.0),
    ("tpu_sync", 1, 0.5)])
def test_resumed_fit_is_bitwise_the_uninterrupted_run(
        kvstore, k, dropout, tmp_path, monkeypatch):
    """Steps 1-4 with a snapshot every 2 steps; a new Module resumes
    under MXNET_RESUME_DIR from step 4 and runs 5-8: parameters, moving
    statistics and momentum bitwise the uninterrupted 8 steps (with
    dropout: the key chain restored too)."""
    X, Y = _data()
    full = _trained(_fit(mt, X, Y, kvstore, k, dropout=dropout))
    cm = tck.CheckpointManager(tmp_path, save_every=2, async_save=False)
    _fit(mt, X[:N // 2], Y[:N // 2], kvstore, k, ckpt=cm, dropout=dropout)
    assert cm.steps()[0] == 4
    monkeypatch.setenv("MXNET_RESUME_DIR", str(tmp_path))
    seen = []
    # another seed: the snapshot's key chain must win
    resumed = _trained(_fit(mt, X, Y, kvstore, k, dropout=dropout,
                            seen=seen, seed=123))
    assert seen == [4, 5, 6, 7]   # the batches after the snapshot only
    assert sorted(resumed) == sorted(full)
    for name in full:
        np.testing.assert_array_equal(resumed[name], full[name], name)
    assert tck.CheckpointManager(tmp_path).steps()[0] == 8


def test_port_fit_matches_the_jax_package_and_snapshots_cross(tmp_path):
    """8 steps: the port within 1e-5 of the JAX package; the JAX
    package's step-4 snapshot restored into a port Module and the port's
    into a JAX Module give the parameters and momentum bitwise."""
    X, Y = _data()
    jmod = _fit(mx, X, Y)
    tmod = _fit(mt, X, Y)
    jargs, jaux = jmod.get_params()
    targs, taux = tmod.get_params()
    for k in jargs:
        np.testing.assert_allclose(_host(targs[k]), jargs[k].asnumpy(),
                                   rtol=1e-5, atol=1e-5)
    for k in jaux:
        np.testing.assert_allclose(_host(taux[k]), jaux[k].asnumpy(),
                                   rtol=1e-5, atol=1e-5)
    jstate = jck.module_state(jmod)
    tstate = tck.module_state(tmod)
    assert sorted(jstate) == sorted(tstate)
    # port snapshot -> JAX module, JAX snapshot -> port module
    jck.restore_module(jmod, tstate)
    tck.restore_module(tmod, jstate)
    for k in jargs:
        np.testing.assert_array_equal(jmod.get_params()[0][k].asnumpy(),
                                      tstate["arg:" + k])
        np.testing.assert_array_equal(_host(tmod.get_params()[0][k]),
                                      jstate["arg:" + k])
    back = tck.module_state(tmod)
    jopt = pickle.loads(jstate["__opt__"])
    topt = pickle.loads(back["__opt__"])
    assert jopt["index_counts"] == topt["index_counts"]
    assert jopt["num_update"] == topt["num_update"]
    js = pickle.loads(jopt["states"])
    ts = pickle.loads(topt["states"])
    assert sorted(js) == sorted(ts)
    for i in js:
        np.testing.assert_array_equal(ts[i], js[i])
    # the key chain crosses too
    assert pickle.loads(back["__rng__"])[0].tolist() == \
        pickle.loads(jstate["__rng__"])[0].tolist()


# ------------------------------------------------------------ the Trainer
def _gluon_run(pkg, steps, ckpt=None, net_seed=5, restore=False):
    """``steps`` SGD steps of a Dense layer over 8 batches of 4, from the
    step ``restore_checkpoint`` returns when ``restore``."""
    X, Y = _data(8 * 4, seed=9)
    ctx = mt.cpu() if pkg is mt else mx.cpu()
    pkg.random.seed(0)
    net = pkg.gluon.nn.Dense(CLASSES, in_units=DIM)
    net.initialize(pkg.init.Xavier(), ctx=ctx)
    rng = np.random.RandomState(net_seed)
    net.weight.set_data(pkg.nd.array(
        rng.randn(CLASSES, DIM).astype(np.float32) * 0.3, ctx=ctx))
    net.bias.set_data(pkg.nd.array(np.zeros(CLASSES, np.float32), ctx=ctx))
    tr = pkg.gluon.Trainer(net.collect_params(), "sgd", dict(OPT),
                           checkpoint=ckpt)
    start = (tr.restore_checkpoint() or 0) if restore else 0
    lossf = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    for i in range(start, start + steps):
        x = pkg.nd.array(X[i * 4:(i + 1) * 4], ctx=ctx)
        y = pkg.nd.array(Y[i * 4:(i + 1) * 4], ctx=ctx)
        with pkg.autograd.record():
            loss = lossf(net(x), y)
        loss.backward()
        tr.step(4)
    upd = tr._updaters[0]
    return tr, {"w": net.weight.data().asnumpy().copy(),
                "b": net.bias.data().asnumpy().copy(),
                "mom": np.array(_host(upd.states[0])) if upd.states
                else None}


def test_trainer_checkpoints_resume_bitwise(tmp_path, monkeypatch):
    """A Trainer saves every 2 steps; a new net and Trainer restore the
    step-4 snapshot (``restore_checkpoint``) and run to 8: bitwise the
    uninterrupted port run, which is within 1e-5 of the JAX package's 8
    steps. Under MXNET_RESUME_DIR the first ``step`` restores the newest
    snapshot itself. The JAX package's Trainer restores the port's
    snapshot."""
    _, full = _gluon_run(mt, 8)
    _, jfull = _gluon_run(mx, 8)
    for k in full:
        np.testing.assert_allclose(full[k], jfull[k], rtol=1e-5, atol=1e-5)
    cm = tck.CheckpointManager(tmp_path, save_every=2, async_save=False)
    _gluon_run(mt, 4, ckpt=cm)
    assert cm.steps()[0] == 4
    tr, resumed = _gluon_run(mt, 4, ckpt=tck.CheckpointManager(
        tmp_path, async_save=False), net_seed=6, restore=True)
    assert tr._global_step == 8
    for k in full:
        np.testing.assert_array_equal(resumed[k], full[k], k)
    assert tr.save_checkpoint() is True
    monkeypatch.setenv("MXNET_RESUME_DIR", str(tmp_path))
    tr2, _ = _gluon_run(mt, 1, ckpt=tck.CheckpointManager(tmp_path),
                        net_seed=7)
    assert tr2._global_step == 9
    monkeypatch.delenv("MXNET_RESUME_DIR")
    jtr, _ = _gluon_run(mx, 0, ckpt=jck.CheckpointManager(tmp_path),
                        net_seed=7)
    assert jtr.restore_checkpoint(step=8) == 8
    np.testing.assert_array_equal(jtr._params[0].data().asnumpy(),
                                  full["w"])
    state, _ = tck.CheckpointManager(tmp_path).restore(step=8)
    assert sorted(k.split(":")[0] for k in state) == \
        ["__opt__", "__rng__", "param", "param"]
    assert json.loads(json.dumps(sorted(state))) == sorted(state)
