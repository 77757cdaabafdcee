"""Port parity for the ``.params`` format (``ndarray/serialization.py``,
``nd.save``/``nd.load``, ``ParameterDict.save``/``load``,
``Block.save_parameters``/``load_parameters`` and ``HybridBlock.export``)
against the JAX package, on the CPU.

The files are compared byte for byte: a list and a dict of f32, f16,
uint8, int8 and int32 arrays (int64 and f64 data narrow to 32 bits in
both packages), a 0-d array (written as shape (1,)), a Gluon block's
``save_parameters`` and its ``export``. Each package loads the other's
file to the same values, and the load options (``strip_prefix``,
``restore_prefix``, ``allow_missing``, ``ignore_extra``) and their errors
behave alike. A dtype the mshadow table lacks (bfloat16, bool) raises in
both.
"""
import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt

CPU = mt.cpu()
RNG = np.random.RandomState(0)
ARRAYS = {
    "w": RNG.randn(3, 4).astype(np.float32),
    "h": RNG.randn(5).astype(np.float16),
    "u8": RNG.randint(0, 255, (2, 3, 2)).astype(np.uint8),
    "i8": RNG.randint(-100, 100, (7,)).astype(np.int8),
    "i32": RNG.randint(-10 ** 6, 10 ** 6, (2, 2)).astype(np.int32),
    "i64": RNG.randint(-10 ** 6, 10 ** 6, (3,)).astype(np.int64),
    "f64": RNG.randn(2, 2),
    "scalar": np.array(2.5, np.float32),
}


def _arr(pkg, a):
    return mt.nd.array(a, ctx=CPU) if pkg is mt else mx.nd.array(a)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("form", ["list", "dict", "single"])
def test_nd_save_bytes_equal_the_jax_packages(tmp_path, form):
    paths = {}
    for pkg in (mx, mt):
        arrs = {k: _arr(pkg, v) for k, v in ARRAYS.items()}
        data = {"list": [arrs[k] for k in sorted(arrs)], "dict": arrs,
                "single": arrs["w"]}[form]
        paths[pkg] = str(tmp_path / ("%s.params" % pkg.__name__))
        pkg.nd.save(paths[pkg], data)
    assert _bytes(paths[mt]) == _bytes(paths[mx])


def test_each_package_loads_the_others_file(tmp_path):
    for writer, reader in ((mx, mt), (mt, mx)):
        path = str(tmp_path / ("%s.params" % writer.__name__))
        writer.nd.save(path, {k: _arr(writer, v) for k, v in ARRAYS.items()})
        if reader is mt:
            with CPU:
                got = mt.nd.load(path)
        else:
            got = mx.nd.load(path)
        want = mx.nd.load(path) if reader is mt else None
        assert sorted(got) == sorted(ARRAYS)
        for k, v in ARRAYS.items():
            g = got[k].asnumpy()
            np.testing.assert_array_equal(g.reshape(-1),
                                          v.reshape(-1).astype(g.dtype))
            if want is not None:
                assert g.dtype == want[k].asnumpy().dtype
        lst_path = str(tmp_path / "list.params")
        writer.nd.save(lst_path, [_arr(writer, ARRAYS["w"])])
        with CPU:
            lst = reader.nd.load(lst_path)
        assert isinstance(lst, list) and len(lst) == 1


@pytest.mark.parametrize("dtype", ["bfloat16", "bool"])
def test_a_dtype_outside_the_mshadow_table_raises(tmp_path, dtype):
    x = np.ones((2, 2), np.float32)
    with pytest.raises(mt.MXNetError, match="mshadow"):
        mt.nd.save(str(tmp_path / "p"), [mt.nd.array(x, ctx=CPU,
                                                     dtype=dtype)])
    with pytest.raises(mx.base.MXNetError, match="mshadow"):
        mx.nd.save(str(tmp_path / "j"), [mx.nd.array(x, dtype=dtype)])


# ---------------------------------------------------------------- Gluon
def _net(pkg, prefix="net_"):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Conv2D(4, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.GlobalAvgPool2D(),
                nn.Dense(5))
    if pkg is mt:
        net.initialize(mt.init.Xavier(), ctx=CPU)
    else:
        net.initialize(mx.init.Xavier())
    x = _arr(pkg, np.ones((2, 3, 6, 6), np.float32))
    net(x)
    return net


def _weights(net):
    return {n[len(net.prefix):]: p.data().asnumpy()
            for n, p in net.collect_params().items()}


def _pair():
    np.random.seed(1)
    jnet = _net(mx)
    # moving statistics that are not the initial ones
    with mx.autograd.record():
        jnet(mx.nd.array(np.random.RandomState(2).randn(2, 3, 6, 6)
                         .astype(np.float32)))
    tnet = _net(mt)
    mt.gluon.utils.params_from_reference(tnet, _weights(jnet))
    return jnet, tnet


def test_save_parameters_and_export_bytes_equal(tmp_path):
    jnet, tnet = _pair()
    jnet.save_parameters(str(tmp_path / "j.params"))
    tnet.save_parameters(str(tmp_path / "t.params"))
    assert _bytes(tmp_path / "t.params") == _bytes(tmp_path / "j.params")
    jnet.hybridize()
    jnet.export(str(tmp_path / "j"))
    tnet.export(str(tmp_path / "t"))
    assert _bytes(tmp_path / "t-0000.params") == \
        _bytes(tmp_path / "j-0000.params")
    jnet.collect_params().save(str(tmp_path / "jd"), strip_prefix="net_")
    tnet.collect_params().save(str(tmp_path / "td"), strip_prefix="net_")
    assert _bytes(tmp_path / "td") == _bytes(tmp_path / "jd")
    with pytest.raises(ValueError, match="stripped"):
        tnet.collect_params().save(str(tmp_path / "x"), strip_prefix="zz")


def _load_outcome(pkg, fn):
    try:
        fn()
    except Exception as e:           # noqa: BLE001 (compared across pkgs)
        return type(e).__name__, str(e).split(" in ")[0]
    return "ok", ""


def test_load_parameters_and_the_load_options_behave_alike(tmp_path):
    jnet, _ = _pair()
    jnet.save_parameters(str(tmp_path / "s.params"))
    jnet.collect_params().save(str(tmp_path / "full.params"))
    jnet.collect_params().save(str(tmp_path / "strip.params"),
                               strip_prefix="net_")
    want = _weights(jnet)
    for path in ("s.params", "full.params", "strip.params"):
        np.random.seed(3)
        tnet = _net(mt)
        tnet.load_parameters(str(tmp_path / path))
        for k, v in _weights(tnet).items():
            np.testing.assert_array_equal(v, want[k])
    # a fresh, never initialized net lands on ctx
    fresh = mt.gluon.nn.HybridSequential(prefix="net_")
    with fresh.name_scope():
        fresh.add(mt.gluon.nn.Conv2D(4, 3, padding=1),
                  mt.gluon.nn.BatchNorm(), mt.gluon.nn.Activation("relu"),
                  mt.gluon.nn.GlobalAvgPool2D(), mt.gluon.nn.Dense(5))
    fresh.load_parameters(str(tmp_path / "s.params"), ctx=CPU)
    assert all(p.data().context == CPU
               for p in fresh.collect_params().values())
    # options and errors, each package on the same file
    extra = {"net_extra_w": np.ones(2, np.float32)}
    mx.nd.save(str(tmp_path / "extra.params"), {
        **{k: mx.nd.array(v) for k, v in extra.items()},
        **{"net_" + k: mx.nd.array(v) for k, v in want.items()
           if k != "dense0_bias"}})
    cases = [
        lambda P, n: n.collect_params().load(str(tmp_path / "extra.params")),
        lambda P, n: n.collect_params().load(str(tmp_path / "extra.params"),
                                             allow_missing=True),
        lambda P, n: n.collect_params().load(str(tmp_path / "extra.params"),
                                             allow_missing=True,
                                             ignore_extra=True),
        lambda P, n: n.collect_params().load(str(tmp_path / "strip.params"),
                                             restore_prefix="net_"),
        lambda P, n: n.collect_params().load(str(tmp_path / "strip.params")),
        lambda P, n: n.load_parameters(str(tmp_path / "s.params"),
                                       ignore_extra=True),
    ]
    seen = set()
    for case in cases:
        outcomes = []
        for pkg in (mx, mt):
            np.random.seed(3)
            net = _net(pkg)
            outcomes.append(_load_outcome(pkg, lambda: case(pkg, net)))
        assert outcomes[0] == outcomes[1], outcomes
        seen.add(outcomes[1][0])
    assert seen == {"ok", "OSError"}


def test_load_missing_and_extra_in_save_parameters_files(tmp_path):
    jnet, _ = _pair()
    jnet.save_parameters(str(tmp_path / "s.params"))
    small = mx.gluon.nn.HybridSequential(prefix="net_")
    with small.name_scope():
        small.add(mx.gluon.nn.Conv2D(4, 3, padding=1))
    small.initialize()
    small(mx.nd.array(np.ones((1, 3, 4, 4), np.float32)))
    small.save_parameters(str(tmp_path / "small.params"))
    seen = set()
    for path, kw in (("small.params", {}), ("s.params", {}),
                     ("small.params", {"allow_missing": True}),
                     ("s.params", {"ignore_extra": True})):
        outcomes = []
        for pkg in (mx, mt):
            np.random.seed(3)
            net = _net(pkg) if path == "small.params" else None
            if net is None:
                net = pkg.gluon.nn.HybridSequential(prefix="net_")
                with net.name_scope():
                    net.add(pkg.gluon.nn.Conv2D(4, 3, padding=1))
                net.initialize(ctx=CPU) if pkg is mt else net.initialize()
            outcomes.append(_load_outcome(pkg, lambda: net.load_parameters(
                str(tmp_path / path), **kw)))
        assert outcomes[0] == outcomes[1], outcomes
        seen.add(outcomes[1][0])
    assert seen == {"ok", "OSError"}
