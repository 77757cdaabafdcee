"""Port parity for the one-process key-value store (``mxnet_tpu_torch.
kvstore``, ``mt.kv``) and the process group's one-process answers
(``parallel.dist``).

The same ``RandomState`` values go through ``mxnet_tpu.kvstore`` (JAX on
the CPU) and the port (CPU tensors). Tolerances: every store operation
(the copy, the list sum, the replace without an updater, the 2-bit
quantize with its residual, the pack and the unpack) bitwise; the
optimizer updates applied on push (SGD with momentum, Adam) within f32
``rtol=atol=1e-6``, the same update math run by two libraries.
"""
import os
import pickle
from unittest import mock

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import kvstore as jkv

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import kvstore as tkv

SHAPE = (4, 6)


def _vals(n, seed=0, shape=SHAPE):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


def _j(x):
    return mx.nd.array(x)


def _t(x):
    return mt.nd.array(x, ctx=mt.cpu())


def _np(a):
    if hasattr(a, "asnumpy"):
        return a.asnumpy()
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@pytest.mark.parametrize("name", sorted(jkv._VALID))
def test_every_name_creates_a_store(name):
    assert tkv._VALID == jkv._VALID
    assert mt.kv.create(name).type == mx.kv.create(name).type == name
    kv = mt.kv.create(name)
    assert (kv.rank, kv.num_workers) == (0, 1)


@pytest.mark.parametrize("bad", ["nope", 3, None])
def test_unknown_names_raise_the_same_value_error(bad):
    msgs = []
    for pkg in (mx, mt):
        with pytest.raises(ValueError) as err:
            pkg.kv.create(bad)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("n", [1, 2, 3])
def test_push_sums_a_list_bitwise_and_pull_copies_it(n):
    """A list push is summed left to right in f32 (``_reduce``); without
    an updater it replaces the stored value; pull and pushpull copy it
    into every output; broadcast is pull."""
    init, *vs = _vals(n + 1, seed=n)
    got = {}
    for pkg, mk in ((mx, _j), (mt, _t)):
        kv = pkg.kv.create("local")
        kv.init(3, mk(init))
        outs = [mk(np.zeros(SHAPE, np.float32)) for _ in range(2)]
        kv.pull(3, out=outs)
        np.testing.assert_array_equal(_np(outs[0]), init)
        kv.push(3, [mk(v) for v in vs])
        kv.pull(3, out=outs)
        pp = mk(np.zeros(SHAPE, np.float32))
        kv.pushpull(3, mk(vs[0]), out=pp)
        bc = mk(np.zeros(SHAPE, np.float32))
        kv.broadcast(3, out=bc)
        got[pkg] = [_np(outs[0]), _np(outs[1]), _np(pp), _np(bc)]
        assert kv._last_wire_bytes is None
    for a, b in zip(got[mx], got[mt]):
        np.testing.assert_array_equal(a, b)
    want = vs[0].copy()
    for v in vs[1:]:
        want = want + v
    np.testing.assert_array_equal(got[mt][0], want)
    np.testing.assert_array_equal(got[mt][2], vs[0])


def test_keys_as_lists_and_string_keys():
    a, b, c, d = _vals(4, seed=7)
    got = {}
    for pkg, mk in ((mx, _j), (mt, _t)):
        kv = pkg.kv.create("device")
        kv.init(["w", "b"], [mk(a), mk(b)])
        kv.push(["w", "b"], [[mk(c), mk(d)], mk(d)])
        outs = [mk(np.zeros(SHAPE, np.float32)) for _ in range(2)]
        kv.pull(["w", "b"], out=outs)
        got[pkg] = [_np(o) for o in outs]
        with pytest.raises(pkg.base.MXNetError, match="not initialized"):
            kv.pull("missing", out=outs[0])
    for x, y in zip(got[mx], got[mt]):
        np.testing.assert_array_equal(x, y)


def test_row_sparse_values_pull_and_row_sparse_pull():
    w = np.zeros((6, 3), np.float32)
    w[[1, 4]] = _vals(1, seed=2, shape=(2, 3))[0]
    got = {}
    for pkg in (mx, mt):
        ctx = {} if pkg is mx else {"ctx": mt.cpu()}
        rsp = pkg.nd.sparse.cast_storage(pkg.nd.array(w, **ctx),
                                         "row_sparse")
        kv = pkg.kv.create("local")
        kv.init("e", rsp)
        dense = pkg.nd.array(np.full((6, 3), 9, np.float32), **ctx)
        kv.pull("e", out=dense)               # skipped: ignore_sparse
        skipped = dense.asnumpy().copy()
        kv.pull("e", out=dense, ignore_sparse=False)
        rows = pkg.nd.array(np.zeros((6, 3), np.float32), **ctx)
        kv.row_sparse_pull("e", out=rows,
                           row_ids=pkg.nd.array(np.array([4, 0]), **ctx))
        got[pkg] = (skipped, dense.asnumpy(), rows.asnumpy())
        with pytest.raises(pkg.base.MXNetError, match="row_ids"):
            kv.row_sparse_pull("e", out=rows)
    for x, y in zip(got[mx], got[mt]):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(got[mt][0], 9)
    np.testing.assert_array_equal(got[mt][1], w)


def _with_optimizer(pkg, mk, opt, params, grads, updater=False):
    kv = pkg.kv.create("local")
    o = pkg.optimizer.create(opt, **params)
    if updater:
        kv._set_updater(pkg.optimizer.get_updater(o))
    else:
        kv.set_optimizer(o)
    kv.init(0, mk(grads[0] * 0 + 1))
    for g in grads:
        kv.push(0, mk(g))
    out = mk(np.zeros(SHAPE, np.float32))
    kv.pull(0, out=out)
    return kv, _np(out)


@pytest.mark.parametrize("opt,params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("adam", {"learning_rate": 0.01, "wd": 1e-3})])
@pytest.mark.parametrize("updater", [False, True])
def test_updaters_apply_on_push(opt, params, updater):
    grads = _vals(3, seed=11)
    _, want = _with_optimizer(mx, _j, opt, params, grads, updater)
    _, got = _with_optimizer(mt, _t, opt, params, grads, updater)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_optimizer_states_files_cross_between_packages(tmp_path):
    """A ``.states`` file (the Updater's pickled numpy states) written by
    either package loads in the other, and the next push agrees."""
    params = {"learning_rate": 0.1, "momentum": 0.9}
    grads = _vals(3, seed=5)
    for src, dst in (((mx, _j), (mt, _t)), ((mt, _t), (mx, _j))):
        kv, _ = _with_optimizer(src[0], src[1], "sgd", params, grads[:2])
        path = str(tmp_path / ("%s.states" % src[0].__name__))
        kv.save_optimizer_states(path)
        states = {}
        for pkg, mk in (src, dst):
            kv2 = pkg.kv.create("local")
            kv2.set_optimizer(pkg.optimizer.create("sgd", **params))
            kv2.init(0, mk(np.ones(SHAPE, np.float32)))
            kv2.load_optimizer_states(path)
            kv2.push(0, mk(grads[2]))
            out = mk(np.zeros(SHAPE, np.float32))
            kv2.pull(0, out=out)
            states[pkg] = _np(out)
        np.testing.assert_array_equal(states[src[0]], states[dst[0]])
    for pkg in (mx, mt):
        with pytest.raises(pkg.base.MXNetError, match="no optimizer"):
            pkg.kv.create("local").save_optimizer_states(
                str(tmp_path / "x"))


@pytest.mark.parametrize("thr", [0.5, 0.25])
def test_2bit_compression_over_three_pushes_is_bitwise(thr):
    """``set_gradient_compression`` quantizes each push to {-t, 0, t} with
    the residual carried per key; the pulled values after each of 3
    pushes are bitwise the JAX package's, and the residual too."""
    init, *grads = _vals(4, seed=13)
    got = {}
    for pkg, mk in ((mx, _j), (mt, _t)):
        kv = pkg.kv.create("local")
        kv.set_gradient_compression({"type": "2bit", "threshold": thr})
        kv.init("g", mk(init))
        seen = []
        for g in grads:
            kv.push("g", mk(g))
            out = mk(np.zeros(SHAPE, np.float32))
            kv.pull("g", out=out)
            seen.append(_np(out))
        seen.append(np.asarray(_np(kv._residuals["g"])))
        got[pkg] = seen
        with pytest.raises(pkg.base.MXNetError, match="compression"):
            kv.set_gradient_compression({"type": "1bit"})
    for a, b in zip(got[mx], got[mt]):
        np.testing.assert_array_equal(a, b)
    assert set(np.unique(got[mt][0])) <= {-np.float32(thr), 0, thr}


@pytest.mark.parametrize("n", [24, 23, 1])
def test_pack_2bit_and_dequantize_are_bitwise(n):
    import jax.numpy as jnp
    g, res = _vals(2, seed=n, shape=(n,))
    jp, jres = jkv._pack_2bit(jnp.asarray(g), jnp.asarray(res), 0.5)
    tp, tres = tkv._pack_2bit(torch.from_numpy(g), torch.from_numpy(res),
                              0.5)
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    np.testing.assert_array_equal(np.asarray(jres), tres.numpy())
    want = jkv._dequantize_2bit(np.asarray(jp), (n,), 0.5)
    np.testing.assert_array_equal(tkv._dequantize_2bit(tp.numpy(), (n,),
                                                       0.5), want)
    np.testing.assert_array_equal(
        tkv._dequantize_2bit(tp, (n,), 0.5).numpy(), want)


def test_dist_sync_in_one_process_updates_on_push():
    """In one process ``dist_sync`` is a store that updates on push with
    no cross-process reduce, as the JAX package's. The join follows the
    JAX package's rules: a world size without a coordinator joins
    nothing; a coordinator and a world of two without a rank raise.
    (Across processes: ``test_torch_port_dist.py``.)"""
    grads = _vals(3, seed=17)
    got = {}
    for pkg, mk in ((mx, _j), (mt, _t)):
        kv = pkg.kv.create("dist_sync")
        kv.set_optimizer(pkg.optimizer.create("sgd", learning_rate=0.1,
                                              momentum=0.9))
        kv.init("w", mk(np.ones(SHAPE, np.float32)))
        for g in grads:
            kv.push("w", mk(g))
        out = mk(np.zeros(SHAPE, np.float32))
        kv.pull("w", out=out)
        got[pkg] = _np(out)
    np.testing.assert_allclose(got[mt], got[mx], rtol=1e-6, atol=1e-6)
    from mxnet_tpu.parallel import dist as jdist
    with mock.patch.dict(os.environ, {"MXNET_NUM_WORKERS": "2"}):
        assert mt.kv.create("dist_sync").num_workers == 1
        assert mt.parallel.dist.init() is False and jdist.init() is False
    with mock.patch.dict(os.environ, {
            "MXNET_COORDINATOR_ADDRESS": "127.0.0.1:1",
            "MXNET_NUM_WORKERS": "2"}):
        for init in (mt.parallel.dist.init, jdist.init):
            with pytest.raises(ValueError, match="missing the worker rank"):
                init()


def test_server_commands_and_dead_nodes_raise():
    msgs = []
    for pkg in (mx, mt):
        with pytest.raises(pkg.base.MXNetError) as err:
            pkg.kv.create("local")._send_command_to_servers(0, "x")
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    # without a launcher's heartbeat directory nobody is dead, as in the
    # JAX package (the dead count itself: test_torch_port_dist.py)
    with mock.patch.dict(os.environ, {"MXNET_HEARTBEAT_DIR": ""}):
        assert mt.kv.create("dist_sync").get_num_dead_node(0) == \
            mx.kv.create("dist_sync").get_num_dead_node(0) == 0


def test_dist_env_spec_and_one_process_answers():
    from mxnet_tpu.parallel import dist as jdist
    env = {"DMLC_PS_ROOT_URI": "10.0.0.1", "DMLC_NUM_WORKER": "1",
           "DMLC_WORKER_ID": "0"}
    with mock.patch.dict(os.environ, env):
        assert mt.parallel.dist.env_spec() == jdist.env_spec() == \
            ("10.0.0.1:9091", 1, 0)
        assert mt.parallel.dist.init() is False
    d = mt.parallel.dist
    assert (d.initialized(), d.rank(), d.num_workers()) == (False, 0, 1)


def test_card_values_stay_where_they_came_from():
    """The store keeps a value's tensor where it lies and pulls in place:
    the output tensor stays the same object."""
    kv = mt.kv.create("local")
    src = torch.arange(6, dtype=torch.float32)
    kv.init(0, src)
    out = torch.zeros(6)
    ptr = out.data_ptr()
    kv.push(0, [src, src])
    kv.pull(0, out=out)
    assert out.data_ptr() == ptr and kv._store[0].device == src.device
    np.testing.assert_array_equal(out.numpy(), 2 * src.numpy())
    assert pickle.loads(pickle.dumps(out)).sum() == 30
