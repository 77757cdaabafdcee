"""Port parity for the int8 serving slice: the quantized ops, calibration,
the graph rewrite, the format-4 artifact and ``Server(quantized=)``.

Both packages get the same numpy inputs. What is held how:

* the int8 product helper (``_int8_matmul``, ``torch._int_mm`` behind the
  padding the card needs: more than 16 rows, K and N multiples of 8)
  against an int64 matmul, bitwise;
* each quantized op against the JAX op: the int8 input and the int32
  accumulator bitwise (integers), the output within one f32 ulp of the
  larger of |acc * scale| and |y| (both round the affine once; see
  tests/test_torch_port_int8_dequant.py), at tier off and at tier auto
  (the JAX epilogue's Pallas kernel in interpret mode);
* ``find_sites``' refusals and reasons equal; calibration deterministic
  (the same fingerprint twice) and its activation ranges within rtol
  1e-5 of the JAX package's (f32 convolutions sum in other orders, so
  a range differs by a few ulps); weight ranges equal;
* ``quantize_serving_graph`` bitwise (int8 weights, coefficients, the
  site list, the report, the graph) given the same calibration numbers;
* a CIFAR ResNet-20 int8 forward (batch 2) against the JAX package's at
  tier off and tier auto: probabilities within atol 1e-6, rtol 1e-5.
  Every integer part is exact and every epilogue rounds once on both
  sides; what differs is the f32 sum of the global average pool and the
  softmax, a few ulps, unless a pooled value lands on an int8 rounding
  tie of the FC's quantize (not the case for these seeded inputs);
* the format-4 artifact round trip, bitwise; ``Server(quantized=)``
  routing as the JAX server does.
"""
import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp
from jax import lax

import mxnet_tpu as jmx
import mxnet_tpu.models  # noqa: F401  (not imported by the package)
from mxnet_tpu import config as jconfig
from mxnet_tpu import quant as jquant
from mxnet_tpu.executor import _graph_eval_fn as jeval
from mxnet_tpu.kernels import tier as jtier
from mxnet_tpu.ops import quant_serve as jqs

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.kernels import int8_dequant as tdq
from mxnet_tpu_torch.kernels import tier as ttier
from mxnet_tpu_torch.ops import quant_serve as tqs
from mxnet_tpu_torch.serve import Server

SIDE = 32
N_SITES = 23          # ResNet-20: conv0, 18 body convs, 3 shortcuts, fc1


# --------------------------------------------------------------- helpers
def _ulp_check(got, want, acc, scale):
    prod = np.abs(acc.astype(np.float32) * scale)
    tol = np.spacing(np.maximum(prod, np.abs(want)))
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert (diff <= tol).all(), float((diff / tol).max())


def _int8(rng, *shape):
    return rng.randint(-127, 128, shape).astype(np.int8)


# ------------------------------------------------------- the int8 product
class _OpLog(TorchDispatchMode):
    """Records every aten op (name, input dtypes, shapes, strides)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        ts = [a for a in args if isinstance(a, torch.Tensor)]
        self.ops.append((str(func.overloadpacket.__name__),
                         [t.dtype for t in ts], [tuple(t.shape) for t in ts],
                         [t.stride() for t in ts]))
        return func(*args, **(kwargs or {}))


def _assert_card_operands(log):
    """Every ``_int_mm`` got what the card's cuBLASLt takes: more than 16
    rows, K and N multiples of 8, the rows row-major and the weight a
    transposed row-major (N, K) matrix (other layouts raise
    CUBLAS_STATUS_NOT_SUPPORTED there; the CPU takes any)."""
    mms = [o for o in log.ops if o[0] == "_int_mm"]
    for _name, _dt, ((am, ak), (bk, bn)), (sa, sb) in mms:
        assert am > 16 and ak % 8 == 0 and ak == bk and bn % 8 == 0
        assert sa == (ak, 1) and sb == (1, bk), (sa, sb)
    return mms


@pytest.mark.parametrize("M,K,N", [(2, 27, 10), (2, 147, 1000),
                                   (2, 27, 1000), (2, 147, 10),
                                   (40, 64, 16), (17, 8, 8)])
def test_int_mm_padding_is_exact_and_takes_the_card_shapes(M, K, N):
    rng = np.random.RandomState(M + K + N)
    a, w = _int8(rng, M, K), _int8(rng, N, K)
    with _OpLog() as log:
        acc = tqs._int8_matmul(torch.from_numpy(a), torch.from_numpy(w))
    assert acc.dtype == torch.int32 and tuple(acc.shape) == (M, N)
    assert acc.is_contiguous()
    np.testing.assert_array_equal(acc.numpy().astype(np.int64),
                                  a.astype(np.int64) @ w.astype(np.int64).T)
    assert len(_assert_card_operands(log)) == 1


_CONVS = [  # (C, H, W, O, kernel, stride, pad, dilate)
    (3, 9, 9, 16, (3, 3), (1, 1), (1, 1), (1, 1)),     # CIFAR conv0, K=27
    (3, 15, 15, 8, (7, 7), (2, 2), (3, 3), (1, 1)),    # ImageNet conv0
    (16, 8, 8, 32, (1, 1), (2, 2), (0, 0), (1, 1)),    # strided shortcut
    (8, 7, 7, 8, (1, 1), (1, 1), (0, 0), (1, 1)),      # odd HW = 49
    (4, 10, 9, 12, (3, 2), (1, 2), (2, 1), (2, 1)),    # dilated, ragged
]


def _conv_case(case, seed):
    C, H, W, O, kernel, stride, pad, dilate = case
    rng = np.random.RandomState(seed)
    x = (rng.randn(2, C, H, W) * 1.7).astype(np.float32)
    amax = float(np.abs(x).max())
    act_scale = float(np.float32(127.0) / np.float32(amax))
    w = _int8(rng, O, C, *kernel)
    sc = (rng.rand(O) * 1e-3).astype(np.float32)
    sh = rng.randn(O).astype(np.float32)
    return x, act_scale, w, sc, sh


@pytest.mark.parametrize("case", _CONVS)
@pytest.mark.parametrize("act", ["relu", "identity"])
@pytest.mark.parametrize("tier", ["off", "auto"])
def test_quantized_conv_matches_the_jax_op(case, act, tier):
    C, H, W, O, kernel, stride, pad, dilate = case
    x, act_scale, w, sc, sh = _conv_case(case, seed=H * W + O)
    kw = dict(kernel=kernel, num_filter=O, act_scale=act_scale,
              stride=stride, dilate=dilate, pad=pad, act=act)
    # the int8 input and the int32 accumulator: bitwise
    jxq = np.asarray(jqs._quantize_static(jnp.asarray(x), act_scale))
    txq = tqs._quantize_static(torch.from_numpy(x), act_scale)
    np.testing.assert_array_equal(txq.numpy(), jxq)
    jacc = np.asarray(lax.conv_general_dilated(
        jnp.asarray(jxq), jnp.asarray(w), window_strides=stride,
        padding=[(p, p) for p in pad], rhs_dilation=dilate,
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=jnp.int32))
    # NCHW and channels-innermost memory, batch 2 and 1 (one image of a
    # 1x1 convolution over NCHW memory is a column-major view)
    for memory in (torch.contiguous_format, torch.channels_last):
        for n in (2, 1):
            p = tqs._patches(txq[:n].contiguous(memory_format=memory),
                             kernel, stride, pad, dilate)
            with _OpLog() as log:
                tacc = tqs._int8_matmul(p, torch.from_numpy(w))
            assert len(_assert_card_operands(log)) == 1
            OH, OW = p.shape[1:3]
            tacc = tacc.view(n, OH, OW, O).permute(0, 3, 1, 2).numpy()
            np.testing.assert_array_equal(tacc, jacc[:n])
    # the op's output
    with jconfig.override(kernel_tier=tier):
        want = np.asarray(jqs.quantized_conv_int8(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(sc),
            jnp.asarray(sh), **kw))
    with mt.config.override(kernel_tier=tier):
        got = tqs.quantized_conv_int8(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(sc),
            torch.from_numpy(sh), **kw).numpy()
    assert got.shape == want.shape
    _ulp_check(got, want, jacc, sc.reshape(1, -1, 1, 1))


@pytest.mark.parametrize("act", ["relu", "identity"])
@pytest.mark.parametrize("flatten,shape", [(True, (2, 4, 3, 3)),
                                           (True, (5, 30)),
                                           (False, (2, 3, 20))])
def test_quantized_fc_matches_the_jax_op(act, flatten, shape):
    rng = np.random.RandomState(len(shape) + flatten)
    x = rng.randn(*shape).astype(np.float32)
    D = int(np.prod(shape[1:])) if flatten else shape[-1]
    act_scale = float(np.float32(127.0) / np.float32(np.abs(x).max()))
    w = _int8(rng, 10, D)
    sc = (rng.rand(10) * 1e-3).astype(np.float32)
    sh = rng.randn(10).astype(np.float32)
    kw = dict(num_hidden=10, act_scale=act_scale, act=act, flatten=flatten)
    want = np.asarray(jqs.quantized_fc_int8(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(sc), jnp.asarray(sh),
        **kw))
    got = tqs.quantized_fc_int8(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(sc), torch.from_numpy(sh),
                                **kw).numpy()
    assert got.shape == want.shape
    xq = np.asarray(jqs._quantize_static(
        jnp.asarray(x.reshape(x.shape[0], -1) if flatten else x),
        act_scale)).astype(np.int64)
    acc = xq @ w.astype(np.int64).T
    _ulp_check(got, want, acc, sc)


def test_quantized_conv_refuses_1d_and_3d_kernels():
    w = torch.zeros(4, 2, 3, dtype=torch.int8)
    v = torch.ones(4)
    with pytest.raises(mt.MXNetError, match="2-D NCHW convolutions only"):
        tqs.quantized_conv_int8(torch.zeros(1, 2, 9), w, v, v, kernel=(3,),
                                num_filter=4, act_scale=1.0)
    with pytest.raises(mt.MXNetError, match="2-D NCHW convolutions only"):
        tqs.quantized_conv_int8(torch.zeros(1, 2, 5, 5, 5),
                                w.reshape(4, 2, 3, 1, 1), v, v,
                                kernel=(3, 1, 1), num_filter=4,
                                act_scale=1.0)


def test_quantized_ops_infer_shapes_on_meta_tensors():
    """Shape inference runs each op on f32 meta tensors (no data, no
    launch); the op casts weight_q to int8 itself."""
    d = mt.sym.Variable("data")
    w = mt.sym.Variable("c_weight_q", shape=(8, 3, 3, 3))
    s = mt.sym.Variable("c_oscale", shape=(8,))
    b = mt.sym.Variable("c_obias", shape=(8,))
    net = mt.symbol.symbol.invoke_sym(
        "_contrib_quantized_conv_int8", [d, w, s, b],
        {"kernel": (3, 3), "num_filter": 8, "pad": (1, 1), "stride": (2, 2),
         "act_scale": 2.0, "act": "relu"})
    fw = mt.sym.Variable("f_weight_q", shape=(10, 8 * 5 * 5))
    fs = mt.sym.Variable("f_oscale", shape=(10,))
    fb = mt.sym.Variable("f_obias", shape=(10,))
    net = mt.symbol.symbol.invoke_sym("_contrib_quantized_fc_int8",
                                      [net, fw, fs, fb],
                                      {"num_hidden": 10, "act_scale": 1.0})
    before = tdq.launches
    _, out_shapes, _ = net.infer_shape(data=(3, 3, 9, 9))
    assert out_shapes == [(3, 10)]
    assert tdq.launches == before


# --------------------------------------------------- sites and calibration
def _refusal_net(sym):
    data = sym.Variable("data")
    net = sym.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1),
                          name="ok_conv")
    net = sym.Convolution(net, kernel=(3, 3), num_filter=4, pad=(1, 1),
                          num_group=2, name="grouped")
    net = sym.Convolution(net, kernel=(1, 1), num_filter=4, name="skipme")
    net = sym.Convolution(net, kernel=(1, 1), num_filter=4, no_bias=True,
                          weight=sym.Variable("scaled_w") * 2.0,
                          name="computed_w")
    net = sym.Convolution(net, kernel=(1, 1), num_filter=4,
                          bias=sym.Variable("lost_b") * 2.0,
                          name="computed_b")
    net = sym.Convolution(net, kernel=(1, 1), num_filter=4, name="half")
    net = sym.Flatten(net)
    net = sym.FullyConnected(net, num_hidden=3, name="missing_w")
    net = sym.FullyConnected(net, num_hidden=3, name="fc")
    return sym.SoftmaxOutput(net, name="softmax")


def _refusal_args(sym):
    shapes, _, _ = sym.infer_shape(data=(2, 2, 6, 6), scaled_w=(4, 4, 1, 1),
                                   lost_b=(4,))
    rng = np.random.RandomState(0)
    args = {n: rng.uniform(-0.3, 0.3, s).astype("f4")
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label", "missing_w_weight")}
    args["half_weight"] = args["half_weight"].astype(np.float16)
    return args


def test_find_sites_refusals_and_reasons_match_jax():
    jsym = _refusal_net(jmx.sym)
    tsym = mt.symbol.load_json(jsym.tojson())
    args = _refusal_args(jsym)
    jsites, jskipped = jquant.find_sites(jsym, args, excluded=("skipme",))
    tsites, tskipped = mt.quant.find_sites(tsym, args, excluded=("skipme",))
    assert [(s.name, s.kind, s.weight_name, s.bias_name) for s in tsites] \
        == [(s.name, s.kind, s.weight_name, s.bias_name) for s in jsites] \
        == [("ok_conv", "conv", "ok_conv_weight", "ok_conv_bias"),
            ("fc", "fc", "fc_weight", "fc_bias")]
    assert tskipped == jskipped
    assert set(tskipped) == {"grouped", "skipme", "computed_w",
                             "computed_b", "half", "missing_w"}


def _params(sym, seed=0):
    shapes, _, aux_shapes = sym.infer_shape(data=(2, 3, SIDE, SIDE))
    rng = np.random.RandomState(seed)
    args = {n: rng.uniform(-0.5, 0.5, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}
    aux = {}
    for n, s in zip(sym.list_auxiliary_states(), aux_shapes):
        aux[n] = ((rng.rand(*s) + 0.5) if n.endswith("var")
                  else 0.2 * rng.randn(*s)).astype(np.float32)
    return args, aux


def _calib_batches(seed=5, n=2):
    rng = np.random.RandomState(seed)
    return [{"data": rng.randn(2, 3, SIDE, SIDE).astype(np.float32)}
            for _ in range(n)]


@pytest.fixture(scope="module")
def r20(tmp_path_factory):
    """CIFAR ResNet-20 in both packages: the JAX calibration and rewrite,
    the port's rewrite from the same calibration numbers, and the port's
    f32 and int8 artifacts."""
    d = tmp_path_factory.mktemp("port_quant")
    jsym = jmx.models.resnet_symbol(num_classes=10, num_layers=20,
                                    image_shape="3,%d,%d" % (SIDE, SIDE))
    args, aux = _params(jsym)
    jcal = jquant.calibrate(jsym, args, aux, _calib_batches())
    jq = jquant.quantize_serving_graph(jsym, args, aux, jcal)
    tsym = mt.symbol.load_json(jsym.tojson())
    tsites, _ = mt.quant.find_sites(tsym, args)
    tcal = mt.quant.CalibrationResult(tsites, jcal.skipped, jcal.act_amax,
                                      jcal.weight_amax, jcal.batches,
                                      jcal.examples)
    tq = mt.quant.quantize_serving_graph(tsym, args, aux, tcal)
    f32_path = str(d / "r20.mxtorch")
    mt.serving.export_compiled(tsym, args, aux,
                               {"data": (None, 3, SIDE, SIDE)}, f32_path,
                               device="cpu")
    q_path = str(d / "r20.int8.mxtorch")
    qmeta = mt.serving.export_compiled(
        tq[0], tq[1], tq[2], {"data": (None, 3, SIDE, SIDE)}, q_path,
        device="cpu", format_version=4, extra_meta={"quant": tq[3]})
    return {"dir": d, "jsym": jsym, "tsym": tsym, "args": args, "aux": aux,
            "jcal": jcal, "jq": jq, "tq": tq, "f32": f32_path,
            "int8": q_path, "qmeta": qmeta}


def test_calibration_is_deterministic_and_tracks_jax(r20):
    tsym, args, aux = r20["tsym"], r20["args"], r20["aux"]
    c1 = mt.quant.calibrate(tsym, args, aux, _calib_batches(), device="cpu")
    c2 = mt.quant.calibrate(tsym, args, aux, _calib_batches(), device="cpu")
    assert c1.fingerprint() == c2.fingerprint()
    jcal = r20["jcal"]
    assert [s.name for s in c1.sites] == [s.name for s in jcal.sites]
    assert len(c1.sites) == N_SITES
    assert (c1.batches, c1.examples) == (jcal.batches, jcal.examples)
    names = sorted(jcal.act_amax)
    np.testing.assert_allclose([c1.act_amax[n] for n in names],
                               [jcal.act_amax[n] for n in names], rtol=1e-5)
    # the first site sees the data itself: its range is exact
    assert c1.act_amax["conv0"] == jcal.act_amax["conv0"]
    for n in names:
        np.testing.assert_array_equal(c1.weight_amax[n],
                                      jcal.weight_amax[n])
    # more data widens (or keeps) the observed range
    c_less = mt.quant.calibrate(tsym, args, aux, _calib_batches(n=1),
                                device="cpu")
    for n in names:
        assert c1.act_amax[n] >= c_less.act_amax[n]
    cut = mt.quant.calibrate(tsym, args, aux, _calib_batches(n=4),
                             num_calib_examples=3, device="cpu")
    assert (cut.batches, cut.examples) == (2, 4)


def test_calibration_refuses_what_jax_refuses(r20):
    tsym, args, aux = r20["tsym"], r20["args"], r20["aux"]
    with pytest.raises(mt.MXNetError, match="empty calibration set"):
        mt.quant.calibrate(tsym, args, aux, [], device="cpu")
    sites = [s.name for s in mt.quant.find_sites(tsym, args)[0]]
    with pytest.raises(mt.MXNetError, match="no eligible"):
        mt.quant.calibrate(tsym, args, aux, _calib_batches(),
                           excluded=sites, device="cpu")
    bare = [b["data"] for b in _calib_batches()]
    c = mt.quant.calibrate(tsym, args, aux, bare, device="cpu")
    assert c.fingerprint() == mt.quant.calibrate(
        tsym, args, aux, _calib_batches(), device="cpu").fingerprint()


def test_rewrite_is_bitwise_the_jax_rewrite(r20):
    jqsym, jargs, jaux, jrep = r20["jq"]
    tqsym, targs, taux, trep = r20["tq"]
    assert sorted(targs) == sorted(jargs) and sorted(taux) == sorted(jaux)
    for k in jargs:
        want = np.asarray(jargs[k])
        got = np.asarray(targs[k])
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert trep == jrep
    assert len(trep["sites"]) == N_SITES and trep["skipped"] == {}
    assert trep["calibration"]["fingerprint"] == r20["jcal"].fingerprint()
    # the same graph, node for node, attributes included
    assert json.loads(tqsym.tojson())["nodes"] == \
        json.loads(jqsym.tojson())["nodes"]
    wb = trep["weight_bytes"]
    assert wb["int8"] <= 0.3 * wb["f32"]


# ------------------------------------------------------ the int8 forward
def _jax_forward(qsym, qargs, qaux, x, tier):
    with jconfig.override(kernel_tier=tier):
        f = jeval(qsym)
        vals = {k: jnp.asarray(v) for k, v in qargs.items()}
        vals["data"] = jnp.asarray(x)
        vals["softmax_label"] = jnp.zeros((x.shape[0],), jnp.float32)
        outs, _ = jax.jit(lambda v, a: f(v, a, jax.random.PRNGKey(0),
                                         False))(
            vals, {k: jnp.asarray(v) for k, v in qaux.items()})
    return np.asarray(outs[0])


@pytest.mark.parametrize("tier", ["off", "auto"])
def test_resnet20_int8_forward_matches_jax(r20, tier):
    x = np.random.RandomState(7).randn(2, 3, SIDE, SIDE).astype(np.float32)
    jtier.reset_stats()
    want = _jax_forward(*r20["jq"][:3], x, tier)
    if tier == "auto":
        assert jtier.stats()["dispatch"] == {"int8_dequant": N_SITES}
    with mt.config.override(kernel_tier=tier):
        model = mt.serving.CompiledModel.load(r20["int8"], device="cpu")
    ttier.reset_stats()
    before = tdq.launches
    got = model.predict(data=x)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    st = ttier.stats()
    assert st["fallback"] == {}
    assert st["dispatch"] == ({"int8_dequant": N_SITES} if tier == "auto"
                              else {})
    assert tdq.launches == before


def test_quantized_sites_multiply_in_int8_only(r20):
    """The port's stand-in for the JAX package's MXL509 lint: in the
    int8 forward every quantized site's product is one ``aten._int_mm``
    on int8 operands, and no float convolution or matmul runs."""
    model = mt.serving.CompiledModel.load(r20["int8"], device="cpu")
    x = torch.from_numpy(np.random.RandomState(8).randn(
        2, 3, SIDE, SIDE).astype(np.float32))
    with _OpLog() as log:
        model.run(x)
    names = [o[0] for o in log.ops]
    mms = [o for o in log.ops if o[0] == "_int_mm"]
    assert len(mms) == N_SITES
    assert all(o[1] == [torch.int8, torch.int8] for o in mms)
    _assert_card_operands(log)
    float_products = {"convolution", "_convolution", "conv2d", "mm",
                      "addmm", "bmm", "matmul", "linear", "baddbmm",
                      "cudnn_convolution", "mkldnn_convolution"}
    assert not float_products & set(names), float_products & set(names)


# ------------------------------------------------- the format-4 artifact
def test_format4_artifact_round_trips_bitwise(r20):
    meta = r20["qmeta"]
    assert meta["format_version"] == 4
    assert meta["quant"] == r20["tq"][3]
    assert meta["kernel_tier"] == {"tier": "auto",
                                   "kernels": {"int8_dequant": N_SITES}}
    m1 = mt.serving.load_artifact(r20["int8"], device="cpu")
    m2 = mt.serving.CompiledModel.load(r20["int8"], device="cpu")
    assert isinstance(m1, mt.serving.CompiledModel)
    assert m1.quantized and m2.quantized
    assert not mt.serving.CompiledModel.load(r20["f32"],
                                             device="cpu").quantized
    targs = r20["tq"][1]
    for k, v in targs.items():
        np.testing.assert_array_equal(m1._args[k].numpy(), np.asarray(v))
        assert m1._args[k].dtype == torch.from_numpy(np.asarray(v)).dtype
    x = np.random.RandomState(9).randn(2, 3, SIDE, SIDE).astype(np.float32)
    a, b = m1.predict(data=x)[0], m2.predict(data=x)[0]
    assert torch.equal(a, b) and torch.equal(a, m1.predict(data=x)[0])
    # the whole pipeline in one call: the same graph and weights
    path = str(r20["dir"] / "again.int8.mxtorch")
    again = mt.quant.export_quantized(
        r20["tsym"], r20["args"], r20["aux"], _calib_batches(),
        {"data": (None, 3, SIDE, SIDE)}, path, device="cpu")
    assert again["format_version"] == 4
    assert again["quant"]["sites"] == meta["quant"]["sites"]
    for k in ("conv0_weight_q", "fc1_weight_q"):
        m3 = mt.serving.CompiledModel.load(path, device="cpu")
        np.testing.assert_array_equal(m3._args[k].numpy(),
                                      np.asarray(targs[k]))


def test_params_from_reference_carries_int8_weights(r20):
    qsym, qargs, qaux, _ = r20["jq"]
    tqsym = r20["tq"][0]
    args, aux = mt.serving.params_from_reference(
        qargs, qaux, tqsym, "cpu", data_shapes={"data": (None, 3, SIDE,
                                                         SIDE)})
    assert args["conv0_weight_q"].dtype == torch.int8
    np.testing.assert_array_equal(args["conv0_weight_q"].numpy(),
                                  np.asarray(qargs["conv0_weight_q"]))
    assert args["fc1_oscale"].dtype == torch.float32


def test_export_compiled_refuses_a_non_predict_version(r20, tmp_path):
    with pytest.raises(mt.MXNetError, match="predict artifacts"):
        mt.serving.export_compiled(
            r20["tsym"], r20["args"], r20["aux"],
            {"data": (None, 3, SIDE, SIDE)}, str(tmp_path / "x.mxtorch"),
            device="cpu", format_version=3)


# ---------------------------------------------------- Server(quantized=)
def _xs():
    rng = np.random.RandomState(42)
    return [rng.randn(b, 3, SIDE, SIDE).astype(np.float32)
            for b in (1, 2, 1)]


def test_server_routes_f32_and_int8_in_one_window(r20):
    srv = Server(r20["f32"], quantized=r20["int8"], buckets=(2, 4),
                 device="cpu", auto_start=False, batch_timeout_ms=0)
    f32 = mt.serving.CompiledModel.load(r20["f32"], device="cpu")
    i8 = mt.serving.CompiledModel.load(r20["int8"], device="cpu")
    xs = _xs()
    tdq.reset_launches()
    reqs = [srv.submit(data=xs[0], timeout_ms=0),
            srv.submit(data=xs[1], dtype="int8", timeout_ms=0),
            srv.submit(data=xs[2], dtype="f32", timeout_ms=0)]
    assert [r.dtype for r in reqs] == ["f32", "int8", "f32"]
    assert srv.run_once(block=False) == 3
    for r, x, m in zip(reqs, xs, (f32, i8, f32)):
        np.testing.assert_allclose(r.result(1)[0], m.predict(data=x)[0]
                                   .numpy(), rtol=1e-5, atol=1e-6)
    # one device batch per dtype group: f32 (1 + 1 rows) and int8 (2)
    assert [r.bucket for r in reqs] == [2, 2, 2]
    late = srv.submit(data=xs[0], dtype="int8", timeout_ms=0)
    assert srv.run_once(block=False) == 1
    np.testing.assert_allclose(late.result(1)[0], i8.predict(data=xs[0])[0]
                               .numpy(), rtol=1e-5, atol=1e-6)
    snap = srv.metrics()
    assert set(snap["buckets_by_dtype"]) == {"f32", "int8"}
    assert snap["buckets_by_dtype"]["int8"]["2"]["batches"] == 2
    eng = snap["engines"]
    assert eng["dtypes"] == ["f32", "int8"]
    assert set(eng["engines"]) == {"2", "int8:2"}
    assert eng["engines"]["int8:2"]["dtype"] == "int8"
    assert tdq.launches == 0          # CPU tensors: the plain version
    with pytest.raises(mt.MXNetError, match="no 'bf16' engines"):
        srv.submit(data=xs[0], dtype="bf16")
    srv.close()


def test_server_refuses_a_mismatched_or_unquantized_twin(r20, tmp_path):
    other = str(tmp_path / "r20_side16.int8.mxtorch")
    mt.serving.export_compiled(
        r20["tq"][0], r20["tq"][1], r20["tq"][2], {"data": (None, 3, 16, 16)},
        other, device="cpu", format_version=4)
    with pytest.raises(mt.MXNetError, match="does not match the primary"):
        Server(r20["f32"], quantized=other, buckets=(2,), device="cpu",
               auto_start=False)
    with pytest.raises(mt.MXNetError, match="not format_version 4"):
        Server(r20["f32"], quantized=r20["f32"], buckets=(2,), device="cpu",
               auto_start=False)
    srv = Server(r20["f32"], buckets=(2,), device="cpu", auto_start=False)
    with pytest.raises(mt.MXNetError, match="no 'int8' engines"):
        srv.submit(data=_xs()[0], dtype="int8")
    srv.close()


def test_a_format4_artifact_serves_alone_as_int8(r20):
    srv = Server(r20["int8"], buckets=(1, 2), device="cpu",
                 batch_timeout_ms=0)
    try:
        out = srv.predict(data=_xs()[1], timeout_ms=600000)[0]
        snap = srv.metrics()
    finally:
        srv.close()
    assert out.shape == (2, 10)
    np.testing.assert_allclose(out.sum(axis=1), 1.0, rtol=1e-5)
    assert snap["engines"]["dtypes"] == ["int8"]
    assert set(snap["buckets_by_dtype"]) == {"int8"}


def test_int8_entry_points_default_to_cuda0(r20, tmp_path):
    """Calibration and export run on cuda:0 unless the CPU is asked for;
    without a card they raise instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    tsym, args, aux = r20["tsym"], r20["args"], r20["aux"]
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.quant.calibrate(tsym, args, aux, _calib_batches())
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.quant.export_quantized(tsym, args, aux, _calib_batches(),
                                  {"data": (None, 3, SIDE, SIDE)},
                                  str(tmp_path / "x.mxtorch"))
    with mt.cpu():
        c = mt.quant.calibrate(tsym, args, aux, _calib_batches(n=1))
    assert len(c.sites) == N_SITES
