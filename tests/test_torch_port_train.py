"""Port parity for the symbolic training path: the ops the GPT graph
needs, SoftmaxOutput's gradient, the executor's fusion, the optimizers,
the iterator and metrics, and ``Module.fit`` on a small GPT.

Every case feeds the same numpy inputs to the JAX package (on the CPU,
its Pallas kernels in interpret mode) and to the port (CPU tensors, the
kernels' plain versions). Tolerances: f32 atol/rtol 1e-5 for forwards
and gradients (the same math summed in another order); where a number
is stated otherwise, the reason is beside it.

The slice as a whole: the GPT of ``examples/train_transformer_lm.py`` at
vocab 96, dim 128, 4 heads, 2 layers, T 32, batch 2, built by one helper
(``mxnet_tpu_torch.models.gpt_lm``) from each package's ``sym``
namespace, trained 3 steps by each package's ``Module.fit`` from the
JAX package's initial parameters (carried over by
``serving.params_from_reference``), for Adam and SGD with momentum, at
kernel tier auto and off, fused (``kvstore="tpu_sync"``) and eager.
After every step the outputs and every parameter agree within 1e-5,
and for Adam each step's gradients, computed by both packages'
executors at their own current parameters, agree within 1e-4 of each
tensor's largest magnitude. At its first step Adam moves an element by
about ``lr * g / (|g| + epsilon / sqrt(1 - beta2))``, so at the default
epsilon (1e-8) an element whose gradient is float noise moves by up to
``lr`` in a direction the noise picks, and two correct runs drift apart
by up to ``2 * lr`` per step. Here the key bias of each qkv projection
has an exactly zero gradient that comes out as noise of about 1e-7. The
test therefore runs Adam at epsilon 1e-4: such an element then moves by
at most ``1e-3 * 1e-7 / 3.2e-3``, about 3e-8 a step, far inside the 1e-5
the parameters are held to.
"""
import inspect
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import config as jconfig
from mxnet_tpu.kernels import tier as jtier
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.kernels import mlp as tmlp
from mxnet_tpu_torch.kernels import tier as ttier
from mxnet_tpu_torch.ops import registry as treg

V, C, H, L, T, B = 96, 128, 4, 2, 32, 2


def _f32(x):
    """A host copy: on the CPU a JAX buffer may share memory with numpy,
    and the fused step donates (and overwrites) its parameters."""
    if hasattr(x, "asnumpy"):
        x = x.asnumpy()
    return np.array(jnp.asarray(x, jnp.float32), copy=True)


def _t(x):
    """A host copy (the port updates its tensors in place)."""
    return x.detach().float().cpu().numpy().copy()


# --------------------------------------------------------------------- ops
@pytest.mark.parametrize("case", [
    ("Reshape", (2, 3, 4, 5), {"shape": (0, 0, -3)}),
    ("Reshape", (2, 3, 20), {"shape": (0, 0, -4, 4, 5)}),
    ("Reshape", (2, 3, 20), {"shape": (0, -1)}),
    ("Reshape", (2, 3, 4, 5), {"shape": (-2,)}),
    ("Reshape", (2, 3, 4, 5), {"shape": (6, -1), "reverse": True}),
    ("transpose", (2, 3, 4), {"axes": (2, 0, 1)}),
    ("transpose", (2, 3, 4), {}),
    ("expand_dims", (3, 4), {"axis": 0}),
    ("squeeze", (1, 3, 1, 4), {"axis": 2}),
    ("squeeze", (1, 3, 1, 4), {}),
    ("slice_axis", (4, 5, 6), {"axis": 1, "begin": 1, "end": 4}),
    ("slice_axis", (4, 5, 6), {"axis": -1, "begin": 2, "end": None}),
    ("split", (2, 6, 4), {"num_outputs": 3, "axis": 1}),
    ("SliceChannel", (2, 6, 4), {"num_outputs": 2, "axis": 1,
                                 "squeeze_axis": False}),
    ("split", (2, 3, 4), {"num_outputs": 3, "axis": 1,
                          "squeeze_axis": True}),
    ("softmax", (3, 7), {"axis": -1}),
    ("softmax", (3, 7), {"axis": 0, "temperature": 2.0}),
    ("LeakyReLU", (3, 7), {"act_type": "gelu"}),
    ("LeakyReLU", (3, 7), {"act_type": "leaky", "slope": 0.1}),
    ("_mul_scalar", (3, 7), {"scalar": 0.3}),
    ("_plus_scalar", (3, 7), {"scalar": -1.5}),
])
def test_unary_ops_match_the_jax_package(case):
    name, shape, params = case
    x = np.random.RandomState(len(shape)).randn(*shape).astype(np.float32)
    jout = jreg.get(name).fn(jnp.asarray(x), **params)
    tout = treg.get(name).fn(torch.from_numpy(x), **params)
    jout = jout if isinstance(jout, tuple) else (jout,)
    tout = tout if isinstance(tout, tuple) else (tout,)
    assert len(jout) == len(tout)
    for j, t in zip(jout, tout):
        assert tuple(t.shape) == tuple(j.shape)
        np.testing.assert_allclose(_t(t), _f32(j), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["broadcast_mul", "elemwise_mul",
                                  "elemwise_add", "batch_dot"])
def test_binary_ops_match_the_jax_package(name):
    rng = np.random.RandomState(2)
    if name == "batch_dot":
        a, b = rng.randn(3, 4, 5), rng.randn(3, 5, 6)
    else:
        a, b = rng.randn(3, 4, 5), np.abs(rng.randn(1, 4, 5)) + 0.5
    a, b = a.astype(np.float32), b.astype(np.float32)
    want = _f32(jreg.get(name).fn(jnp.asarray(a), jnp.asarray(b)))
    got = _t(treg.get(name).fn(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if name == "batch_dot":
        want = _f32(jreg.get(name).fn(jnp.asarray(a), jnp.asarray(a),
                                      transpose_b=True))
        got = _t(treg.get(name).fn(torch.from_numpy(a), torch.from_numpy(a),
                                   transpose_b=True))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("axis", [-1, 1])
def test_layer_norm_matches_the_jax_package(axis):
    rng = np.random.RandomState(4)
    x = (rng.randn(2, 5, 16) * 3 + 1).astype(np.float32)
    n = x.shape[axis]
    g = rng.rand(n).astype(np.float32) + 0.5
    b = rng.randn(n).astype(np.float32)
    want = _f32(jreg.get("LayerNorm").fn(*map(jnp.asarray, (x, g, b)),
                                         axis=axis))
    got = _t(treg.get("LayerNorm").fn(*map(torch.from_numpy, (x, g, b)),
                                      axis=axis))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tier_val", ["off", "auto"])
def test_embedding_clips_like_the_jax_package(tier_val):
    rng = np.random.RandomState(5)
    w = rng.randn(30, 128).astype(np.float32)
    ids = rng.randint(-5, 40, (3, 7)).astype(np.float32)
    with jconfig.override(kernel_tier=tier_val):
        want = _f32(jreg.get("Embedding").fn(
            jnp.asarray(ids), jnp.asarray(w), input_dim=30, output_dim=128))
    with mt.config.override(kernel_tier=tier_val):
        ttier.reset_stats()
        got = _t(treg.get("Embedding").fn(
            torch.from_numpy(ids), torch.from_numpy(w), input_dim=30,
            output_dim=128))
        st = ttier.stats()
    np.testing.assert_array_equal(got, want)
    assert st["dispatch"] == ({"take_rows": 1} if tier_val == "auto"
                              else {})


def test_registry_meta_matches_jax():
    for name in ("Reshape", "transpose", "expand_dims", "squeeze",
                 "slice_axis", "split", "batch_dot", "broadcast_mul",
                 "_mul_scalar", "LayerNorm", "LeakyReLU", "softmax",
                 "Embedding", "_contrib_FlashAttention",
                 "_contrib_FusedScaleBiasGeLU"):
        j, t = jreg.get(name), treg.get(name)
        assert t.param_names == j.param_names, name
        assert t.input_names == j.input_names, name
        # LeakyReLU's JAX hook shapes prelu's gamma, not ported
        if name != "LeakyReLU":
            assert (t.shape_hook is None) == (j.shape_hook is None), name
    p = {"num_outputs": 3}
    assert treg.get("split").resolve_num_outputs(p) == \
        jreg.get("split").resolve_num_outputs(p) == 3


# ------------------------------------------------------- SoftmaxOutput grad
@pytest.mark.parametrize("case", [
    {}, {"normalization": "batch"}, {"normalization": "valid"},
    {"use_ignore": True, "ignore_label": 2.0},
    {"use_ignore": True, "normalization": "valid"},
    {"use_ignore": True, "normalization": "batch", "grad_scale": 0.5},
    {"smooth_alpha": 0.1},
    {"multi_output": True},
    {"multi_output": True, "use_ignore": True, "normalization": "valid"},
])
def test_softmax_output_grad_matches_and_ignores_the_head_grad(case):
    """softmax - onehot times the scale; the head gradient (random here,
    not ones) is ignored by both packages; -1 labels (the default
    ignore label) have an all-zero one-hot row."""
    rng = np.random.RandomState(6)
    if case.get("multi_output"):
        x = rng.randn(3, 5, 4).astype(np.float32)
        lab = rng.randint(-1, 5, (3, 4)).astype(np.float32)
    else:
        x = rng.randn(4, 3, 6).astype(np.float32)
        lab = rng.randint(-1, 6, (4, 3)).astype(np.float32)
    head = rng.randn(*x.shape).astype(np.float32)
    jfn = jreg.get("SoftmaxOutput").fn
    jout, vjp = jax.vjp(lambda d: jfn(d, jnp.asarray(lab), **case),
                        jnp.asarray(x))
    (jgrad,) = vjp(jnp.asarray(head))
    tx = torch.from_numpy(x).requires_grad_(True)
    tout = treg.get("SoftmaxOutput").fn(tx, torch.from_numpy(lab), **case)
    tout.backward(torch.from_numpy(head))
    np.testing.assert_allclose(_t(tout), _f32(jout), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), _f32(jgrad), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------------ graph fusion
def _small_net(sym):
    x = sym.Variable("data")
    c = sym.Convolution(x, kernel=(3, 3), num_filter=8, pad=(1, 1),
                        name="c")
    bn = sym.BatchNorm(c, name="bn", fix_gamma=False)
    res = sym.Activation(bn + c, act_type="relu")
    fc = sym.FullyConnected(res, num_hidden=16, name="fc")
    fc2 = sym.FullyConnected(sym.LeakyReLU(fc, act_type="gelu"),
                             num_hidden=8, name="fc2")
    return sym.Activation(fc2, act_type="relu")


def _small_values():
    rng = np.random.RandomState(7)
    args = {"data": rng.randn(2, 4, 8, 8),
            "c_weight": rng.randn(8, 4, 3, 3) * 0.1, "c_bias": np.zeros(8),
            "bn_gamma": rng.rand(8) + 0.5, "bn_beta": rng.randn(8),
            "fc_weight": rng.randn(16, 512) * 0.05,
            "fc_bias": rng.randn(16), "fc2_weight": rng.randn(8, 16) * 0.2,
            "fc2_bias": rng.randn(8)}
    aux = {"bn_moving_mean": np.zeros(8), "bn_moving_var": np.ones(8)}
    cast = lambda d: {k: v.astype(np.float32) for k, v in d.items()}  # noqa
    return cast(args), cast(aux)


def _run_port_small(tier_val):
    args, aux = _small_values()
    with mt.config.override(kernel_tier=tier_val):
        ttier.reset_stats()
        ex = _small_net(mt.sym).bind(
            mt.cpu(), {k: torch.from_numpy(v) for k, v in args.items()},
            args_grad={k: torch.zeros(v.shape) for k, v in args.items()},
            aux_states={k: torch.from_numpy(v) for k, v in aux.items()})
        out = ex.forward(is_train=True)[0]
        ex.backward(torch.ones(out.shape))
        st = ttier.stats()
    return ([_t(out)] + [_t(g) for g in ex.grad_arrays]
            + [_t(a) for a in ex.aux_arrays]), st


def test_graph_fusion_executor_parity():
    """Outputs, gradients and moving statistics at tier auto equal tier
    off and the JAX package's executor; BatchNorm -> +residual -> relu
    runs ``bn_act`` and FC -> gelu and FC -> relu run ``scale_bias_act``,
    their backwards the recomputed references, with no fallback."""
    off, _ = _run_port_small("off")
    auto, st = _run_port_small("auto")
    assert st["dispatch"] == {"bn_act": 1, "scale_bias_act": 2}, st
    assert not st["fallback"], st
    for a, b in zip(off, auto):
        assert float(np.max(np.abs(a - b))) < 2e-5
    args, aux = _small_values()
    ex = _small_net(mx.sym).bind(
        mx.cpu(), {k: mx.nd.array(v) for k, v in args.items()},
        args_grad={k: mx.nd.zeros(v.shape) for k, v in args.items()},
        aux_states={k: mx.nd.array(v) for k, v in aux.items()})
    out = ex.forward(is_train=True)[0]
    ex.backward(mx.nd.ones(out.shape))
    want = ([_f32(out)] + [_f32(g) for g in ex.grad_arrays]
            + [_f32(a) for a in ex.aux_arrays])
    for a, b in zip(auto, want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=2e-5)


def test_graph_fusion_forward_only_dispatches_bn_act():
    args, aux = _small_values()
    with mt.config.override(kernel_tier="auto"):
        ttier.reset_stats()
        ex = _small_net(mt.sym).bind(
            mt.cpu(), {k: torch.from_numpy(v) for k, v in args.items()},
            aux_states={k: torch.from_numpy(v) for k, v in aux.items()})
        ex.forward(is_train=False)
        st = ttier.stats()
    assert st["dispatch"] == {"bn_act": 1, "scale_bias_act": 2}
    assert not st["fallback"]


def _naive_attn(sym, d, scale=None):
    q, k, v = sym.Variable("q"), sym.Variable("k"), sym.Variable("v")
    s = sym.batch_dot(q, k, transpose_b=True) \
        * (1.0 / math.sqrt(d) if scale is None else scale)
    return sym.batch_dot(sym.softmax(s, axis=-1), v)


@pytest.mark.parametrize("scale", [None, 0.5])
def test_graph_fuse_naive_attention_parity_and_dispatch(scale):
    """The naive attention spelling fuses to ``flash_attn`` at tier auto
    (non-causal) when the scale is 1/sqrt(d) and falls back, with the
    JAX package's reason, when it is not; outputs and gradients equal
    tier off and the JAX package's."""
    b, t, d = 4, 32, 8
    rng = np.random.RandomState(11)
    vals = {n: rng.randn(b, t, d).astype(np.float32) for n in "qkv"}

    def port(tier_val):
        with mt.config.override(kernel_tier=tier_val):
            ttier.reset_stats()
            ex = _naive_attn(mt.sym, d, scale).bind(
                mt.cpu(), {n: torch.from_numpy(a) for n, a in vals.items()},
                args_grad={n: torch.zeros(b, t, d) for n in vals})
            out = ex.forward(is_train=True)[0]
            ex.backward()
            return [_t(out)] + [_t(g) for g in ex.grad_arrays], \
                ttier.stats()

    off, _ = port("off")
    auto, st = port("auto")
    with jconfig.override(kernel_tier="auto"):
        jtier.reset_stats()
        ex = _naive_attn(mx.sym, d, scale).bind(
            mx.cpu(), {n: mx.nd.array(a) for n, a in vals.items()},
            args_grad={n: mx.nd.zeros((b, t, d)) for n in vals})
        out = ex.forward(is_train=True)[0]
        ex.backward(mx.nd.ones(out.shape))
        want = [_f32(out)] + [_f32(g) for g in ex.grad_arrays]
        jst = jtier.stats()
    for a, o, w in zip(auto, off, want):
        assert float(np.max(np.abs(a - o))) < 2e-5
        np.testing.assert_allclose(a, w, rtol=1e-5, atol=2e-5)
    if scale is None:
        assert st["dispatch"] == {"flash_attn": 1} and not st["fallback"]
    else:
        assert st["dispatch"] == {}
        assert list(st["fallback"]) == list(jst["fallback"])
        assert "1/sqrt(d)" in next(iter(st["fallback"]))


# ------------------------------------------------------- optimizers, data
def test_wd_mult_and_rescale_rules_match_the_jax_package():
    net = mt.models.gpt_lm(V, C, H, 1, T)
    names = [n for n in net.list_arguments()
             if n not in ("data", "softmax_label")]
    idx2name = dict(enumerate(names))
    jo = mx.optimizer.create("adam", param_idx2name=idx2name, wd=0.01)
    to = mt.optimizer.create("adam", param_idx2name=idx2name, wd=0.01)
    assert {n: to._get_wd(i) for i, n in idx2name.items()} == \
        {n: jo._get_wd(i) for i, n in idx2name.items()}
    assert to._get_wd(names.index("pos_weight")) == 0.01
    assert to._get_wd(names.index("blk0_ln1_gamma")) == 0.01
    assert to._get_wd(names.index("blk0_ln1_beta")) == 0.0
    assert to._get_wd(names.index("head_bias")) == 0.0
    mod = mt.mod.Module(net, context=mt.cpu())
    mod.bind([("data", (B, T))], [("softmax_label", (B, T))])
    mod.init_params(mt.init.Xavier())
    mod.init_optimizer(kvstore="tpu_sync", optimizer="sgd")
    assert mod._optimizer.rescale_grad == 1.0 / B
    assert mod._fused is not None
    # dist_sync in one process updates on the kvstore (no fused step),
    # with or without MXNET_DDP (a world of one has nothing to reduce)
    mod.init_optimizer(kvstore="dist_sync", force_init=True)
    assert mod._update_on_kvstore and mod._fused is None
    import os
    from unittest import mock
    with mock.patch.dict(os.environ, {"MXNET_NUM_WORKERS": "2"}), \
            mt.config.override(ddp=True):
        mod.init_optimizer(kvstore="dist_sync", force_init=True)
        assert mod._update_on_kvstore and not mod._ddp
        assert mod.ddp_stats() is None


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("clip", [None, 0.05])
def test_eager_optimizer_updates_match_the_jax_package(opt, clip):
    """Three eager updates of one weight (rescale, clip, wd, momentum or
    Adam's bias-corrected lr) through each package's Updater."""
    rng = np.random.RandomState(9)
    w0 = rng.randn(5, 6).astype(np.float32)
    grads = [rng.randn(5, 6).astype(np.float32) for _ in range(3)]
    kw = dict(learning_rate=0.1, wd=0.01, rescale_grad=0.5,
              clip_gradient=clip, param_idx2name={0: "fc_weight"})
    if opt == "sgd":
        kw["momentum"] = 0.9
    ju = mx.optimizer.get_updater(mx.optimizer.create(opt, **kw))
    tu = mt.optimizer.get_updater(mt.optimizer.create(opt, **kw))
    jw, tw = mx.nd.array(w0), torch.from_numpy(w0.copy())
    for g in grads:
        ju(0, mx.nd.array(g), jw)
        tu(0, torch.from_numpy(g), tw)
        np.testing.assert_allclose(tw.numpy(), _f32(jw), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("handle", ["pad", "discard"])
def test_ndarray_iter_matches_the_jax_package(handle):
    x = np.arange(7 * 3, dtype=np.float32).reshape(7, 3)
    y = np.arange(7, dtype=np.float32)
    ji = mx.io.NDArrayIter(x, y, batch_size=3, last_batch_handle=handle)
    ti = mt.io.NDArrayIter(x, y, batch_size=3, last_batch_handle=handle)
    assert [tuple(d) for d in ti.provide_data] == \
        [tuple(d) for d in ji.provide_data]
    jb, tb = list(ji), list(ti)
    assert len(jb) == len(tb) == (3 if handle == "pad" else 2)
    for a, b in zip(jb, tb):
        assert a.pad == b.pad
        np.testing.assert_array_equal(b.data[0].numpy(), _f32(a.data[0]))
        np.testing.assert_array_equal(b.label[0].numpy(), _f32(a.label[0]))


@pytest.mark.parametrize("name", ["acc", "ce", "perplexity"])
def test_metrics_match_the_jax_package(name):
    rng = np.random.RandomState(10)
    logits = rng.randn(12, 5).astype(np.float32)
    pred = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    label = rng.randint(0, 5, 12).astype(np.float32)
    jm, tm = mx.metric.create(name), mt.metric.create(name)
    jm.update([mx.nd.array(label)], [mx.nd.array(pred)])
    tm.update([torch.from_numpy(label)], [torch.from_numpy(pred)])
    assert tm.get()[0] == jm.get()[0]
    np.testing.assert_allclose(tm.get()[1], jm.get()[1], rtol=1e-6)


def test_initializer_name_rules_and_seed():
    a, b = torch.empty(64, 32), torch.empty(64, 32)
    mt.init.Xavier(seed=3)("fc_weight", a)
    mt.init.Xavier(seed=3)("fc_weight", b)
    assert torch.equal(a, b)
    bound = math.sqrt(3.0 / ((64 + 32) / 2.0))
    assert float(a.abs().max()) <= bound and float(a.std()) > bound / 3
    z, o = torch.full((4,), 7.0), torch.full((4,), 7.0)
    mt.init.Xavier()("ln_beta", z)
    mt.init.Xavier()("ln_gamma", o)
    assert (z == 0).all() and (o == 1).all()
    with pytest.raises(ValueError, match="Unknown initialization"):
        mt.init.Uniform()("mystery", torch.empty(3))


# ------------------------------------------------------------ the slice
def _gpt(sym):
    return mt.models.gpt_lm(V, C, H, L, T, sym=sym)


def _batches():
    rng = np.random.RandomState(0)
    xs, ys = zip(*[mt.models.make_copy_batch(rng, B, T, V, 5)
                   for _ in range(3)])
    return np.concatenate(xs), np.concatenate(ys)


_INIT = {}


def _jax_init_params():
    """The JAX package's Xavier draw (numpy seed 0), once per process."""
    if not _INIT:
        mod = mx.mod.Module(_gpt(mx.sym), context=mx.cpu())
        mod.bind([("data", (B, T))], [("softmax_label", (B, T))])
        np.random.seed(0)
        mod.init_params(mx.initializer.Xavier())
        args, _ = mod.get_params()
        _INIT.update({k: _f32(v) for k, v in args.items()})
    return {k: v.copy() for k, v in _INIT.items()}


OPT = {"adam": {"learning_rate": 1e-3, "wd": 0.01, "epsilon": 1e-4},
       "sgd": {"learning_rate": 0.05, "momentum": 0.9, "wd": 0.01}}


def _train_jax(opt, tier_val, kvstore):
    X, Y = _batches()
    seen = []
    with jconfig.override(kernel_tier=tier_val):
        mod = mx.mod.Module(_gpt(mx.sym), context=mx.cpu())

        def record(_p):
            args, _ = mod.get_params()
            seen.append((_f32(mod.get_outputs()[0]),
                         {k: _f32(v) for k, v in args.items()}))
        mod.fit(mx.io.NDArrayIter(X, Y, batch_size=B), num_epoch=1,
                kvstore=kvstore, optimizer=opt, optimizer_params=OPT[opt],
                arg_params={k: mx.nd.array(v)
                            for k, v in _jax_init_params().items()},
                eval_metric=None, batch_end_callback=record)
    return seen


_JAX_RUNS = {}


def _jax_run(opt, tier_val, kvstore):
    """``_train_jax``, once per (optimizer, tier, kvstore) in this module:
    the cases that differ only on the port's side share it."""
    key = (opt, tier_val, kvstore)
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = _train_jax(*key)
    return _JAX_RUNS[key]


def _train_port(opt, tier_val, kvstore, loop=False):
    X, Y = _batches()
    net = _gpt(mt.sym)
    args, aux = mt.serving.params_from_reference(
        _jax_init_params(), {}, net, "cpu", data_shapes={"data": (B, T)})
    seen = []
    with mt.config.override(kernel_tier=tier_val):
        ttier.reset_stats()
        mod = mt.mod.Module(net, context=mt.cpu())

        def record(_p=None):
            a, _ = mod.get_params()
            seen.append((_t(mod.get_outputs()[0]),
                         {k: _t(v) for k, v in a.items()}))
        it = mt.io.NDArrayIter(X, Y, batch_size=B)
        if loop:
            # the public per-batch pair on the fused path
            mod.bind(it.provide_data, it.provide_label)
            mod.init_params(arg_params=args)
            mod.init_optimizer(kvstore=kvstore, optimizer=opt,
                               optimizer_params=OPT[opt])
            for batch in it:
                mod.forward_backward(batch)
                mod.update()
                record()
        else:
            mod.fit(it, num_epoch=1, kvstore=kvstore, optimizer=opt,
                    optimizer_params=OPT[opt], arg_params=args,
                    eval_metric=None, batch_end_callback=record)
        st = ttier.stats()
    return seen, st, mod


_JAX_EXECUTORS = {}


def _grads_at(params_seq, tier_val):
    """Each step's gradients, by each package's executor, at that
    package's parameters before the step. The JAX executor is bound once
    per tier in this module (every call overwrites its parameters and
    data)."""
    X, Y = _batches()
    out = []
    if tier_val not in _JAX_EXECUTORS:
        with jconfig.override(kernel_tier=tier_val):
            _JAX_EXECUTORS[tier_val] = _gpt(mx.sym).simple_bind(
                mx.cpu(), data=(B, T), softmax_label=(B, T))
    jex = _JAX_EXECUTORS[tier_val]
    with mt.config.override(kernel_tier=tier_val):
        tex = _gpt(mt.sym).simple_bind(mt.cpu(), data=(B, T),
                                       softmax_label=(B, T))
    for step, (jp, tp) in enumerate(params_seq):
        feed = dict(data=X[step * B:(step + 1) * B],
                    softmax_label=Y[step * B:(step + 1) * B])
        jex.copy_params_from({k: mx.nd.array(v) for k, v in jp.items()})
        jex.forward(is_train=True, **{k: mx.nd.array(v)
                                      for k, v in feed.items()})
        jex.backward()
        tex.copy_params_from(tp)
        tex.forward(is_train=True, **feed)
        tex.backward()
        out.append(({k: _f32(g) for k, g in jex.grad_dict.items()},
                    {k: _t(g) for k, g in tex.grad_dict.items()}))
    return out


CONFIGS = [("adam", "auto", "tpu_sync", False),
           ("adam", "off", "tpu_sync", False),
           ("sgd", "auto", "tpu_sync", False),
           ("sgd", "off", "tpu_sync", False),
           ("adam", "auto", "local", False),
           ("sgd", "off", "local", False),
           ("sgd", "auto", "tpu_sync", True)]


@pytest.mark.parametrize("cfg", CONFIGS,
                         ids=["-".join(map(str, c)) for c in CONFIGS])
def test_module_fit_matches_the_jax_package_step_by_step(cfg):
    opt, tier_val, kvstore, loop = cfg
    want = _jax_run(opt, tier_val, kvstore)
    got, st, mod = _train_port(opt, tier_val, kvstore, loop=loop)
    assert (mod._fused is not None) == (kvstore == "tpu_sync")
    if tier_val == "auto":
        assert st["dispatch"] == {"take_rows": 3, "flash_attn": 3 * L,
                                  "scale_bias_act": 3 * L}, st
    else:
        assert st["dispatch"] == {}
    assert not st["fallback"]
    assert tmlp.launches == 0
    assert len(got) == len(want) == 3
    for (go, gp), (wo, wp) in zip(got, want):
        np.testing.assert_allclose(go, wo, rtol=1e-4, atol=1e-5)
        assert sorted(gp) == sorted(wp)
        for k in wp:
            np.testing.assert_allclose(gp[k], wp[k], rtol=0, atol=1e-5,
                                       err_msg=k)
    if opt == "adam":
        seq = [(_jax_init_params(), _jax_init_params())] + \
            [(w[1], g[1]) for w, g in zip(want[:-1], got[:-1])]
        for jg, tg in _grads_at(seq, tier_val):
            for k in jg:
                scale = float(np.abs(jg[k]).max())
                np.testing.assert_allclose(tg[k], jg[k], rtol=0,
                                           atol=1e-4 * scale + 1e-7,
                                           err_msg=k)


def test_fit_lowers_the_loss_on_a_repeated_batch():
    """Six Adam steps on one batch: the loss (cross-entropy of the
    outputs at the labels) falls, at both tiers, with equal losses."""
    X, Y = _batches()
    X, Y = np.tile(X[:B], (6, 1)), np.tile(Y[:B], (6, 1))
    args, _ = mt.serving.params_from_reference(
        _jax_init_params(), {}, _gpt(mt.sym), "cpu",
        data_shapes={"data": (B, T)})
    losses = {}
    for tier_val in ("auto", "off"):
        with mt.config.override(kernel_tier=tier_val):
            mod = mt.mod.Module(_gpt(mt.sym), context=mt.cpu())
            ce = []

            def record(p):
                ce.append(p.eval_metric.get()[1])
                p.eval_metric.reset()
            mod.fit(mt.io.NDArrayIter(X, Y, batch_size=B), num_epoch=1,
                    kvstore="tpu_sync", optimizer="adam",
                    optimizer_params=OPT["adam"], arg_params=args,
                    eval_metric=mt.metric.Perplexity(),
                    batch_end_callback=record)
        losses[tier_val] = np.log(ce)
    assert np.isfinite(losses["auto"]).all()
    assert losses["auto"][-1] < losses["auto"][0]
    np.testing.assert_allclose(losses["auto"], losses["off"], rtol=1e-5)


def test_fit_takes_the_jax_packages_keywords():
    want = inspect.signature(mx.mod.BaseModule.fit).parameters
    assert list(inspect.signature(mt.mod.BaseModule.fit).parameters) == \
        list(want)


@pytest.mark.parametrize("env,value", [
    ("MXNET_CHECKPOINT_DIR", "ckpt"), ("MXNET_RESUME_DIR", "ckpt")])
def test_fit_refuses_settings_it_does_not_obey(env, value, monkeypatch,
                                              tmp_path):
    """fit obeys the checkpoint settings as the JAX package's does (a
    snapshot a step in the directory; under MXNET_RESUME_DIR a run over
    an empty directory starts from scratch), and MXNET_FAULT_INJECT: a
    ``raise`` at step 1 fires after exactly one step, its snapshot
    committed (the launcher's kill and restart:
    test_torch_port_dist.py)."""
    monkeypatch.setenv(env, str(tmp_path / value))
    X, Y = _batches()
    mod = mt.mod.Module(_gpt(mt.sym), context=mt.cpu())
    mod.fit(mt.io.NDArrayIter(X, Y, batch_size=B), num_epoch=1,
            eval_metric=None)
    steps = mt.checkpoint.CheckpointManager(tmp_path / value).steps()
    assert steps[0] == len(X) // B and len(steps) >= 2
    monkeypatch.setenv("MXNET_FAULT_INJECT", "raise@step=1")
    monkeypatch.setenv("MXNET_CHECKPOINT_DIR", str(tmp_path / "fault"))
    monkeypatch.delenv("MXNET_RESUME_DIR", raising=False)
    mt.parallel.faultinject.reset()
    mod = mt.mod.Module(_gpt(mt.sym), context=mt.cpu())
    try:
        with pytest.raises(mt.parallel.faultinject.InjectedFault):
            mod.fit(mt.io.NDArrayIter(X, Y, batch_size=B), num_epoch=1,
                    eval_metric=None)
    finally:
        mt.parallel.faultinject.reset()
    # the step-1 snapshot was saved on the background thread
    import threading
    for t in threading.enumerate():
        if t.name == "mxnet-ckpt-save":
            t.join()
    assert mt.checkpoint.CheckpointManager(
        tmp_path / "fault", async_save=False).steps() == [1]


def test_fit_refuses_grouped_dispatch():
    """fit refuses grouped dispatch only where the JAX package's does
    (K < 1, or with sparse_row_id_fn), before binding anything; else
    ``steps_per_dispatch=4`` trains one window of four SGD steps and
    matches the JAX package's grouped fit at this file's per-step fit
    tolerances (outputs rtol 1e-4, atol 1e-5; parameters atol 1e-5)."""
    X, Y = _batches()
    X, Y = np.concatenate([X, X[:B]]), np.concatenate([Y, Y[:B]])
    for kw in (dict(steps_per_dispatch=0),
               dict(steps_per_dispatch=4, sparse_row_id_fn=lambda b: {})):
        mod = mt.mod.Module(_gpt(mt.sym), context=mt.cpu())
        with pytest.raises(ValueError, match="steps_per_dispatch"):
            mod.fit(mt.io.NDArrayIter(X, Y, batch_size=B), num_epoch=1,
                    **kw)
        assert not mod.binded
    jmod = mx.mod.Module(_gpt(mx.sym), context=mx.cpu())
    jmod.fit(mx.io.NDArrayIter(X, Y, batch_size=B), num_epoch=1,
             kvstore="tpu_sync", optimizer="sgd", optimizer_params=OPT["sgd"],
             arg_params={k: mx.nd.array(v)
                         for k, v in _jax_init_params().items()},
             eval_metric=None, steps_per_dispatch=4)
    args, _ = mt.serving.params_from_reference(
        _jax_init_params(), {}, _gpt(mt.sym), "cpu",
        data_shapes={"data": (B, T)})
    mod = mt.mod.Module(_gpt(mt.sym), context=mt.cpu())
    mod.fit(mt.io.NDArrayIter(X, Y, batch_size=B), num_epoch=1,
            kvstore="tpu_sync", optimizer="sgd", optimizer_params=OPT["sgd"],
            arg_params=args, eval_metric=None, steps_per_dispatch=4)
    assert mod._optimizer.num_update == 4
    np.testing.assert_allclose(_t(mod.get_outputs()[0]),
                               _f32(jmod.get_outputs()[0]),
                               rtol=1e-4, atol=1e-5)
    want = jmod.get_params()[0]
    got = mod.get_params()[0]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(_t(got[k]), _f32(want[k]), rtol=0,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("value,mp,want", [
    ("bfloat16", False, "bfloat16"), ("fp16", False, "float16"),
    ("float32", True, None), ("off", True, None), ("auto", True, "bfloat16"),
    ("auto", False, None)])
def test_fit_obeys_the_compute_dtype_policy(value, mp, want, monkeypatch):
    """``MXNET_COMPUTE_DTYPE`` as the JAX package's Module reads it: bf16
    or f16 compute over f32 masters when asked for, multi_precision's
    bf16 by default, and float32/off vetoing it. One fused SGD step of
    the small GPT; the step's outputs take the compute dtype, the
    weights stay f32 and move, and the JAX Module picks the same dtype.
    A vetoed step equals the f32 step."""
    monkeypatch.setenv("MXNET_COMPUTE_DTYPE", value)
    opt = dict(OPT["sgd"], multi_precision=mp)
    X, Y = _batches()
    X, Y = X[:B], Y[:B]
    args0 = _jax_init_params()

    def step(net_mod):
        net_mod.fit(mt.io.NDArrayIter(X, Y, batch_size=B), num_epoch=1,
                    kvstore="tpu_sync", optimizer="sgd",
                    optimizer_params=opt, arg_params=args, eval_metric=None)
        return net_mod
    args, _ = mt.serving.params_from_reference(
        args0, {}, _gpt(mt.sym), "cpu", data_shapes={"data": (B, T)})
    flags, jflags = mt.config.flags, jconfig.flags
    monkeypatch.setitem(flags._values, "compute_dtype",
                        flags._resolve("compute_dtype"))
    monkeypatch.setitem(jflags._values, "compute_dtype",
                        jflags._resolve("compute_dtype"))
    mod = step(mt.mod.Module(_gpt(mt.sym), context=mt.cpu()))
    cdt = mod._fused.compute_dtype
    assert cdt == (None if want is None else getattr(torch, want))
    assert mod.get_outputs()[0].dtype == (cdt or torch.float32)
    got = {k: _t(v) for k, v in mod.get_params()[0].items()}
    assert all(v.dtype == torch.float32
               for v in mod.get_params()[0].values())
    assert all(np.isfinite(v).all() for v in got.values())
    assert any(not np.array_equal(got[k], args0[k]) for k in got)
    jmod = mx.mod.Module(_gpt(mx.sym), context=mx.cpu())
    jmod.bind([("data", (B, T))], [("softmax_label", (B, T))])
    jmod.init_params(arg_params={k: mx.nd.array(v)
                                 for k, v in args0.items()})
    jmod.init_optimizer(kvstore="tpu_sync", optimizer="sgd",
                        optimizer_params=opt)
    jcdt = jmod._fused._compute_dtype
    assert (None if jcdt is None else jnp.dtype(jcdt).name) == want
    if want is None:
        monkeypatch.setitem(flags._values, "compute_dtype", "float32")
        ref = step(mt.mod.Module(_gpt(mt.sym), context=mt.cpu()))
        for k, v in ref.get_params()[0].items():
            np.testing.assert_array_equal(got[k], _t(v), err_msg=k)


@pytest.mark.parametrize("fused", [False, True])
def test_a_training_step_leaves_no_reference_cycle(fused):
    """The graph walk's closures referred to each other, so every
    activation of a step stayed alive until the garbage collector ran
    (on the card: tens of GB at ResNet-50's batch 128). A step through
    the executor, and through the bf16 fused step, now leaves nothing
    for the collector."""
    import gc
    sym = mt.models.resnet(num_layers=20, num_classes=10,
                           image_shape=(3, 8, 8))
    X = np.random.RandomState(0).randn(2, 3, 8, 8).astype(np.float32)
    Y = np.zeros(2, np.float32)
    mod = mt.mod.Module(sym, context=mt.cpu())
    mod.bind([("data", X.shape)], [("softmax_label", Y.shape)])
    mod.init_params(mt.init.Xavier(seed=0))
    mod.init_optimizer(kvstore="tpu_sync" if fused else "local",
                       optimizer="sgd",
                       optimizer_params={"learning_rate": 0.01,
                                         "multi_precision": True})
    batch = mt.io.DataBatch([torch.from_numpy(X)], [torch.from_numpy(Y)])
    mod.forward_backward(batch)
    mod.update()
    gc.collect()
    gc.disable()
    try:
        mod.forward_backward(batch)
        mod.update()
        mod.forward(batch, is_train=False)
        found = gc.collect()
    finally:
        gc.enable()
    assert (mod._fused is not None) == fused
    assert found == 0


def test_fit_refuses_sparse_row_id_fn():
    X, Y = _batches()
    mod = mt.mod.Module(_gpt(mt.sym), context=mt.cpu())
    with pytest.raises(mt.base.MXNetError, match="sparse_row_id_fn"):
        mod.fit(mt.io.NDArrayIter(X, Y, batch_size=B), num_epoch=1,
                sparse_row_id_fn=lambda batch: {})


@pytest.mark.parametrize("value,want", [
    ("auto", None), ("bf16", "bfloat16"), ("half", "float16"),
    ("float32", None), ("off", None)])
def test_compute_dtype_policy_matches_the_jax_package(value, want):
    with mt.config.override(compute_dtype=value), \
            jconfig.override(compute_dtype=value):
        assert mt.config.compute_dtype() == want
        jwant = jconfig.compute_dtype()
        assert (None if jwant is None else jnp.dtype(jwant).name) == want
    with mt.config.override(compute_dtype="int8"):
        with pytest.raises(ValueError, match="not understood"):
            mt.config.compute_dtype()
