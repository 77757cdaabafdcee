"""Port parity for ResNet training through ``Module.fit``: bf16 compute
over f32 master weights (SGD with ``multi_precision``), the JAX
BatchNorm's low-precision vjp, ``bn_act`` (B1) in training mode, the
learning-rate schedulers, the multi-precision updates and the shuffled
``NDArrayIter``.

Every case feeds the same numpy inputs to the JAX package (on the CPU,
its Pallas kernels in interpret mode) and to the port (CPU tensors, the
kernels' plain versions).

The slice as a whole: CIFAR ResNet-20 (3x32x32, 10 classes), one Symbol
JSON for both packages, batch 2, trained 3 steps by each package's
``Module.fit`` over a shuffled ``NDArrayIter`` (one numpy seed before
each iterator), from weights the JAX package draws once with bench.py's
``Xavier(factor_type="in", magnitude=2)``. BatchNorm's beta is then
drawn uniform(-0.1, 0.1), as ``tests/test_module_fused.py`` draws every
argument for the JAX package's own bf16 bound: at Xavier's beta of 0 a
beta's value after a step is its update alone (see the update check
below). SGD with momentum 0.9 at lr 0.01 and wd 1e-4: at lr 0.05 the
second step of this batch-2 model lands where the gradients move by
0.5 % for a 1e-7 change of the weights (measured with the JAX package
alone, one f32 rounding of a step), so two correct f32 runs part by
1e-3 within 3 steps; at lr 0.01 they stay within 1e-7.

- f32 (fused at tier auto, and eager at tier off with a
  ``MultiFactorScheduler``): outputs, parameters and moving statistics
  within atol 1e-5 after every step, and each step's gradients by both
  packages' executors at the JAX package's weights within 1e-4 of each
  tensor's largest magnitude.
- bf16 (``multi_precision``, fused, tier auto and off): outputs,
  parameters and moving statistics within a relative L2 error of 0.05
  per tensor after every step (the JAX package's own bf16-vs-f32
  bound), masters and moving statistics f32. An update itself is
  rounding noise in bf16 here: most of it cancels in the sums of bf16
  cotangents, so one bf16 rounding moves it by 20-60 % in either
  package. So per step the median over tensors of the updates' relative
  L2 error, port against the JAX package, must not exceed the JAX
  package's own bf16-against-f32 median.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
import mxnet_tpu.models  # noqa: F401  (not imported by the package)
from mxnet_tpu import config as jconfig
from mxnet_tpu import lr_scheduler as jls
from mxnet_tpu.kernels import bn_act as jbn
from mxnet_tpu.ops import nn as jnn

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.kernels import bn_act as tbn
from mxnet_tpu_torch.kernels import tier as ttier
from mxnet_tpu_torch.ops import nn as tnn

SIDE, B, STEPS = 32, 2, 3
SGD = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}


def _f32(x):
    """A host copy: on the CPU a JAX buffer may share memory with numpy,
    and the fused step donates (and overwrites) its parameters."""
    if hasattr(x, "asnumpy"):
        x = x.asnumpy()
    return np.array(jnp.asarray(x, jnp.float32), copy=True)


def _t(x):
    """A host copy (the port updates its tensors in place)."""
    return x.detach().float().cpu().numpy().copy()


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ------------------------------------------------------------ the slice
_CACHE = {}


def _net():
    """One CIFAR ResNet-20 graph: the JAX package's symbol and the
    port's load of its JSON."""
    if "sym" not in _CACHE:
        jsym = mx.models.resnet_symbol(num_classes=10, num_layers=20,
                                       image_shape="3,%d,%d" % (SIDE, SIDE))
        _CACHE["sym"] = (jsym, mt.symbol.load_json(jsym.tojson()))
    return _CACHE["sym"]


def _init():
    """The JAX package's Xavier draw (numpy seed 0) and BatchNorm betas
    from uniform(-0.1, 0.1), once per process."""
    if "init" not in _CACHE:
        jsym, _ = _net()
        mod = mx.mod.Module(jsym, context=mx.cpu())
        mod.bind([("data", (B, 3, SIDE, SIDE))], [("softmax_label", (B,))])
        np.random.seed(0)
        mod.init_params(mx.initializer.Xavier(factor_type="in",
                                              magnitude=2.0))
        args, aux = mod.get_params()
        args = {k: _f32(v) for k, v in args.items()}
        rng = np.random.RandomState(3)
        for k in sorted(args):
            if k.endswith("_beta"):
                args[k] = rng.uniform(-0.1, 0.1, args[k].shape) \
                    .astype(np.float32)
        _CACHE["init"] = (args, {k: _f32(v) for k, v in aux.items()})
    args, aux = _CACHE["init"]
    return ({k: v.copy() for k, v in args.items()},
            {k: v.copy() for k, v in aux.items()})


def _data():
    rng = np.random.RandomState(1)
    X = rng.randn(B * STEPS, 3, SIDE, SIDE).astype(np.float32)
    Y = rng.randint(0, 10, (B * STEPS,)).astype(np.float32)
    return X, Y


def _opt_params(mp, sched, lr_scheduler):
    p = dict(SGD)
    if mp:
        p["multi_precision"] = True
    if sched:
        p["lr_scheduler"] = lr_scheduler.MultiFactorScheduler(
            step=[1, 2], factor=0.5)
    return p


def _fit_jax(mp, tier_val, kvstore, sched):
    jsym, _ = _net()
    args, aux = _init()
    X, Y = _data()
    seen = []
    with jconfig.override(kernel_tier=tier_val):
        mod = mx.mod.Module(jsym, context=mx.cpu())

        def record(_p):
            a, x = mod.get_params()
            seen.append((_f32(mod.get_outputs()[0]),
                         {k: _f32(v) for k, v in a.items()},
                         {k: _f32(v) for k, v in x.items()}))
        np.random.seed(5)
        it = mx.io.NDArrayIter(X, Y, batch_size=B, shuffle=True)
        mod.fit(it, num_epoch=1, kvstore=kvstore, optimizer="sgd",
                optimizer_params=_opt_params(mp, sched, jls),
                arg_params={k: mx.nd.array(v) for k, v in args.items()},
                aux_params={k: mx.nd.array(v) for k, v in aux.items()},
                eval_metric=None, batch_end_callback=record)
    return seen


def _fit_port(mp, tier_val, kvstore, sched):
    _, tsym = _net()
    a0, x0 = _init()
    args, aux = mt.serving.params_from_reference(
        a0, x0, tsym, "cpu", data_shapes={"data": (B, 3, SIDE, SIDE)})
    X, Y = _data()
    seen, dtypes = [], set()
    with mt.config.override(kernel_tier=tier_val):
        ttier.reset_stats()
        mod = mt.mod.Module(tsym, context=mt.cpu())

        def record(_p):
            a, x = mod.get_params()
            dtypes.update(v.dtype for v in list(a.values())
                          + list(x.values()))
            seen.append((_t(mod.get_outputs()[0]),
                         {k: _t(v) for k, v in a.items()},
                         {k: _t(v) for k, v in x.items()}))
        np.random.seed(5)
        it = mt.io.NDArrayIter(X, Y, batch_size=B, shuffle=True)
        mod.fit(it, num_epoch=1, kvstore=kvstore, optimizer="sgd",
                optimizer_params=_opt_params(mp, sched, mt.lr_scheduler),
                arg_params=args, aux_params=aux, eval_metric=None,
                batch_end_callback=record)
        stats = ttier.stats()
    return seen, stats, mod, dtypes


def _jax_run(cfg):
    if cfg not in _CACHE:
        _CACHE[cfg] = _fit_jax(*cfg)
    return _CACHE[cfg]


FIT_CONFIGS = [(True, "auto", "tpu_sync", False),
               (True, "off", "tpu_sync", False),
               (False, "auto", "tpu_sync", False),
               (False, "off", "local", True)]
F32_AUTO = (False, "auto", "tpu_sync", False)


def _fused_sites():
    _, tsym = _net()
    with mt.config.override(kernel_tier="auto"):
        census = mt.serving._kernel_census(tsym)
    return census["bn_act"] + census["bn_act_res"]


def _grads_at(params, step, tier_val):
    """Step ``step``'s gradients by each package's executor at
    ``params`` (the JAX run's weights before that step), f32."""
    jsym, tsym = _net()
    _, aux = _init()
    X, Y = _data()
    np.random.seed(5)
    idx = np.arange(B * STEPS)
    np.random.shuffle(idx)
    sel = idx[step * B:(step + 1) * B]
    with jconfig.override(kernel_tier=tier_val):
        jex = jsym.simple_bind(mx.cpu(), data=(B, 3, SIDE, SIDE),
                               softmax_label=(B,))
    jex.copy_params_from({k: mx.nd.array(v) for k, v in params.items()},
                         {k: mx.nd.array(v) for k, v in aux.items()})
    jex.forward(is_train=True, data=mx.nd.array(X[sel]),
                softmax_label=mx.nd.array(Y[sel]))
    jex.backward()
    with mt.config.override(kernel_tier=tier_val):
        tex = tsym.simple_bind(mt.cpu(), data=(B, 3, SIDE, SIDE),
                               softmax_label=(B,))
    tex.copy_params_from(params, aux)
    tex.forward(is_train=True, data=X[sel], softmax_label=Y[sel])
    tex.backward()
    return ({k: _f32(g) for k, g in jex.grad_dict.items() if k in params},
            {k: _t(g) for k, g in tex.grad_dict.items() if k in params})


@pytest.mark.parametrize("cfg", FIT_CONFIGS, ids=[
    "-".join(["bf16" if c[0] else "f32", c[1], c[2]]
             + (["multifactor"] if c[3] else [])) for c in FIT_CONFIGS])
def test_resnet_fit_matches_the_jax_package_step_by_step(cfg):
    mp, tier_val, kvstore, sched = cfg
    want = _jax_run(cfg)
    got, stats, mod, dtypes = _fit_port(*cfg)
    # the path: fused at tpu_sync (bf16 under multi_precision), B1 at
    # every fused site at auto, never at off, no fallback
    assert (mod._fused is not None) == (kvstore == "tpu_sync")
    if mod._fused is not None:
        assert mod._fused.compute_dtype == (torch.bfloat16 if mp else None)
    want_dispatch = ({"bn_act": STEPS * _fused_sites()}
                     if tier_val == "auto" else {})
    assert stats["dispatch"] == want_dispatch, stats
    assert not stats["fallback"]
    assert tbn.launches == 0
    assert dtypes == {torch.float32}          # masters and aux stay f32
    assert mod.get_outputs()[0].dtype == (torch.bfloat16 if mp
                                          else torch.float32)
    assert len(got) == len(want) == STEPS
    a0, x0 = _init()
    for step, ((go, gp, ga), (wo, wp, wa)) in enumerate(zip(got, want)):
        assert sorted(gp) == sorted(wp) and sorted(ga) == sorted(wa)
        assert all(np.isfinite(v).all() for v in gp.values())
        if not mp:
            np.testing.assert_allclose(go, wo, rtol=1e-4, atol=1e-5)
            for k in wp:
                np.testing.assert_allclose(gp[k], wp[k], rtol=0, atol=1e-5,
                                           err_msg=k)
            for k in wa:
                np.testing.assert_allclose(ga[k], wa[k], rtol=0, atol=1e-5,
                                           err_msg=k)
            continue
        assert _rel(go, wo) <= 0.05, (step, _rel(go, wo))
        for d_got, d_want in ((gp, wp), (ga, wa)):
            for k in d_want:
                assert _rel(d_got[k], d_want[k]) <= 0.05, \
                    (step, k, _rel(d_got[k], d_want[k]))
        # the updates: port vs JAX within the JAX package's own bf16 noise
        ref32 = _jax_run(F32_AUTO)[step][1]
        port_err = np.median([_rel(gp[k] - a0[k], wp[k] - a0[k])
                              for k in wp])
        own_err = np.median([_rel(wp[k] - a0[k], ref32[k] - a0[k])
                             for k in wp])
        assert port_err <= own_err, (step, port_err, own_err)
    if not mp:
        # each step's gradients by both executors at the JAX weights
        seq = [_init()[0]] + [w[1] for w in want[:-1]]
        for step, params in enumerate(seq):
            jg, tg = _grads_at(params, step, tier_val)
            for k in jg:
                scale = float(np.abs(jg[k]).max())
                np.testing.assert_allclose(tg[k], jg[k], rtol=0,
                                           atol=1e-4 * scale + 1e-7,
                                           err_msg=k)


# --------------------------------------------- the low-precision BatchNorm
_LOWP = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
         "float16": (jnp.float16, torch.float16)}


def _bn_case(seed=0, shape=(8, 16, 6, 7)):
    rng = np.random.RandomState(seed)
    C = shape[1]
    return dict(x=(rng.randn(*shape) * 2 + 0.5).astype(np.float32),
                gamma=(rng.rand(C) + 0.5).astype(np.float32),
                beta=rng.randn(C).astype(np.float32),
                mm=(0.3 * rng.randn(C)).astype(np.float32),
                mv=(rng.rand(C) + 0.5).astype(np.float32),
                t=rng.randn(*shape).astype(np.float32))


@pytest.mark.parametrize("fix_gamma", [False, True])
@pytest.mark.parametrize("dt", ["bfloat16", "float16"])
def test_low_precision_batch_norm_matches_the_jax_vjp(dt, fix_gamma):
    """Training BatchNorm on bf16/f16 data against ``jax.grad`` through
    the JAX op's custom vjp, for the loss sum((out - t)^2): the forward
    and its statistics, and dx, dgamma and dbeta within a relative L2
    error of 1e-5 (autograd of the forward was 5.9e-3, 1.7e-3 and 1.6e-3
    off for bf16). Under fix_gamma, gamma's gradient is zeros."""
    d = _bn_case()
    jdt, tdt = _LOWP[dt]
    kw = dict(eps=2e-5, momentum=0.9, fix_gamma=fix_gamma, _training=True)

    def jloss(x, g, b):
        out = jnn.batch_norm(x, g, b, jnp.asarray(d["mm"]),
                             jnp.asarray(d["mv"]), **kw)
        return jnp.sum((out[0].astype(jnp.float32) - d["t"]) ** 2), out
    (_, jout), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(d["x"], jdt), jnp.asarray(d["gamma"]),
        jnp.asarray(d["beta"]))
    x = torch.from_numpy(d["x"]).to(tdt).requires_grad_(True)
    g = torch.from_numpy(d["gamma"]).requires_grad_(True)
    b = torch.from_numpy(d["beta"]).requires_grad_(True)
    tout = tnn.batch_norm(x, g, b, torch.from_numpy(d["mm"]),
                          torch.from_numpy(d["mv"]), **kw)
    ((tout[0].float() - torch.from_numpy(d["t"])) ** 2).sum().backward()
    assert tout[0].dtype == tdt
    assert all(o.dtype == torch.float32 for o in tout[1:])
    np.testing.assert_array_equal(_t(tout[0]), _f32(jout[0]))
    for o, j in zip(tout[1:], jout[1:]):
        np.testing.assert_allclose(_t(o), _f32(j), rtol=1e-5, atol=1e-6)
    for name, t, j in (("dx", x, jgrads[0]), ("dgamma", g, jgrads[1]),
                       ("dbeta", b, jgrads[2])):
        got, w = _t(t.grad), _f32(j)
        if name == "dgamma" and fix_gamma:
            np.testing.assert_array_equal(got, np.zeros_like(got))
            np.testing.assert_array_equal(w, np.zeros_like(w))
            continue
        assert _rel(got, w) <= 1e-5, (name, _rel(got, w))


@pytest.mark.parametrize("residual", [False, True])
def test_bn_act_bf16_training_gradients_match_jax(residual):
    """B1 in training mode on bf16 data, against ``jax.grad`` through the
    JAX package's ``fused_bn_act`` (its Pallas epilogue in interpret
    mode): the output and the gradients of data, gamma, beta and the
    residual within a relative L2 error of 1e-5 (the same f32 sums in
    another order), for a random head gradient."""
    d = _bn_case(seed=4, shape=(2, 16, 7, 7))
    r = np.random.RandomState(6).randn(*d["x"].shape).astype(np.float32)
    kw = dict(eps=2e-5, momentum=0.9, fix_gamma=False, act="relu",
              training=True)
    names = ["x", "gamma", "beta"] + (["r"] if residual else [])
    vals = dict(d, r=r)

    def jfn(*v):
        a = dict(zip(names, v))
        out = jbn.fused_bn_act(a["x"], a["gamma"], a["beta"],
                               jnp.asarray(d["mm"]), jnp.asarray(d["mv"]),
                               a.get("r"), **kw)
        return jnp.sum(out[0].astype(jnp.float32) * d["t"]), out
    jin = [jnp.asarray(vals[n], jnp.bfloat16 if n in ("x", "r")
                       else jnp.float32) for n in names]
    with jconfig.override(kernel_tier="auto"):
        (_, jout), jgrads = jax.value_and_grad(
            jfn, argnums=tuple(range(len(names))), has_aux=True)(*jin)
    tin = [torch.from_numpy(vals[n]).to(torch.bfloat16 if n in ("x", "r")
                                        else torch.float32)
           .requires_grad_(True) for n in names]
    a = dict(zip(names, tin))
    tout = tbn.fused_bn_act(a["x"], a["gamma"], a["beta"],
                            torch.from_numpy(d["mm"]),
                            torch.from_numpy(d["mv"]), a.get("r"), **kw)
    (tout[0].float() * torch.from_numpy(d["t"])).sum().backward()
    for o, j in zip(tout, jout):
        assert _rel(_t(o), _f32(j)) <= 1e-5
    for n, t, j in zip(names, tin, jgrads):
        assert _rel(_t(t.grad), _f32(j)) <= 1e-5, (n, _rel(_t(t.grad),
                                                           _f32(j)))


# ------------------------------------------------------------ schedulers
_SCHEDULERS = [
    ("FactorScheduler", dict(step=3, factor=0.5, stop_factor_lr=1e-3)),
    ("FactorScheduler", dict(step=4, factor=0.7, warmup_steps=5,
                             warmup_begin_lr=0.001)),
    ("MultiFactorScheduler", dict(step=[2, 5, 9], factor=0.1)),
    ("MultiFactorScheduler", dict(step=[6, 10], factor=0.5, warmup_steps=4,
                                  warmup_begin_lr=0.01,
                                  warmup_mode="constant")),
    ("PolyScheduler", dict(max_update=12, pwr=2, final_lr=1e-4)),
    ("PolyScheduler", dict(max_update=15, warmup_steps=3)),
    ("CosineScheduler", dict(max_update=12, final_lr=1e-3)),
    ("CosineScheduler", dict(max_update=14, warmup_steps=4,
                             warmup_begin_lr=0.02)),
]


@pytest.mark.parametrize("name,kw", _SCHEDULERS)
def test_lr_schedulers_match_the_jax_package(name, kw):
    """The learning rate over num_update 0..19, read in order as an
    optimizer reads it (the schedulers keep state), warmups included;
    then through each package's optimizer, which sets base_lr."""
    js = getattr(jls, name)(base_lr=0.1, **kw)
    ts = getattr(mt.lr_scheduler, name)(base_lr=0.1, **kw)
    assert [ts(n) for n in range(20)] == [js(n) for n in range(20)]
    jo = mx.optimizer.create("sgd", learning_rate=0.3,
                             lr_scheduler=getattr(jls, name)(**kw))
    to = mt.optimizer.create("sgd", learning_rate=0.3,
                             lr_scheduler=getattr(mt.lr_scheduler,
                                                  name)(**kw))
    assert [to._get_lr(0, num_update=n) for n in range(20)] == \
        [jo._get_lr(0, num_update=n) for n in range(20)]


# ------------------------------------------------- multi-precision updates
@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("dt", ["bfloat16", "float16"])
def test_update_multi_precision_matches_the_jax_package(dt, momentum):
    """Three Updater steps on a low-precision weight under
    multi_precision: the f32 master, the momentum and the rounded weight
    equal the JAX package's (the same f32 arithmetic, rounded once)."""
    jdt, tdt = _LOWP[dt]
    rng = np.random.RandomState(11)
    w0 = rng.randn(6, 5).astype(np.float32)
    grads = [rng.randn(6, 5).astype(np.float32) for _ in range(3)]
    kw = dict(learning_rate=0.1, momentum=momentum, wd=0.01,
              rescale_grad=0.5, clip_gradient=0.8, multi_precision=True,
              param_idx2name={0: "fc_weight"})
    jo, to = mx.optimizer.create("sgd", **kw), mt.optimizer.create("sgd",
                                                                   **kw)
    ju, tu = mx.optimizer.get_updater(jo), mt.optimizer.get_updater(to)
    jw = mx.nd.array(w0, dtype=jdt)
    tw = torch.from_numpy(w0).to(tdt)
    for g in grads:
        ju(0, mx.nd.array(g, dtype=jdt), jw)
        tu(0, torch.from_numpy(g).to(tdt), tw)
        assert tw.dtype == tdt and jw.dtype == jdt
        np.testing.assert_array_equal(_t(tw), _f32(jw))
        jinner, jw32 = ju.states[0]
        tinner, tw32 = tu.states[0]
        assert tw32.dtype == torch.float32
        np.testing.assert_allclose(_t(tw32), _f32(jw32), rtol=0, atol=1e-7)
        if momentum:
            np.testing.assert_allclose(_t(tinner), _f32(jinner), rtol=0,
                                       atol=1e-7)
        else:
            assert tinner is None and jinner is None
    # f32 weights: the flag changes nothing
    w32 = torch.from_numpy(w0.copy())
    mt.optimizer.get_updater(mt.optimizer.create("sgd", **kw))(
        0, torch.from_numpy(grads[0]), w32)
    ref = torch.from_numpy(w0.copy())
    kw32 = dict(kw, multi_precision=False)
    mt.optimizer.get_updater(mt.optimizer.create("sgd", **kw32))(
        0, torch.from_numpy(grads[0]), ref)
    assert torch.equal(w32, ref)


# --------------------------------------------------------- the iterator
@pytest.mark.parametrize("handle", ["pad", "discard"])
def test_shuffled_ndarray_iter_matches_the_jax_package(handle):
    """Under one numpy seed both iterators give the same batches, labels
    and pads over two epochs (a reset between them reshuffles)."""
    rng = np.random.RandomState(2)
    X = rng.randn(11, 3).astype(np.float32)
    Y = np.arange(11).astype(np.float32)
    seen = {}
    for name, io in (("jax", mx.io), ("port", mt.io)):
        np.random.seed(7)
        it = io.NDArrayIter(X, Y, batch_size=4, shuffle=True,
                            last_batch_handle=handle)
        out = []
        for _epoch in range(2):
            for b in it:
                out.append((np.asarray(_f32(b.data[0]) if name == "jax"
                                       else _t(b.data[0])),
                            np.asarray(_f32(b.label[0]) if name == "jax"
                                       else _t(b.label[0])), b.pad))
            it.reset()
        seen[name] = out
    assert len(seen["port"]) == len(seen["jax"]) == 2 * (
        3 if handle == "pad" else 2)
    for (pd, pl, pp), (jd, jl, jp) in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(pd, jd)
        np.testing.assert_array_equal(pl, jl)
        assert pp == jp
    firsts = [seen["port"][0][1], seen["port"][len(seen["port"]) // 2][1]]
    assert not np.array_equal(firsts[0], firsts[1])   # reshuffled
