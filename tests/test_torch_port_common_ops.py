"""Port parity: the common ops (elementwise, reductions, indexing,
ordering, creation, the legacy names and the random-surface aliases)
against the JAX package's.

Every name these files register is one case: the same numpy inputs go
through the registered function of ``mxnet_tpu`` and of
``mxnet_tpu_torch`` (same keyword parameters), in f32 and, where the op
takes one, int32. Tolerances:

* bitwise (values and dtype) for data movement, indexing, ordering,
  rounding, sign, logical, comparison and integer ops, and for
  arithmetic whose every output is one IEEE operation;
* ``rtol 1e-6, atol 1e-7`` for the f32 transcendental ops (each side
  calls its own libm-style kernel: a few ulp apart);
* ``rtol 1e-5`` for ``erfinv``, ``gamma`` and ``gammaln``;
* ``rtol 1e-6, atol 1e-6`` for f32 sums over many terms (``cumsum``,
  ``nansum``, ``nanprod``, ``square_sum``: XLA and torch add in another
  order) and for the points of ``_linspace`` and the histogram edges
  (XLA folds ``jnp.linspace``'s constants in another order; the counts
  stay bitwise);
* the random ops after the same seed: bitwise for uniform draws,
  integer draws and permutations, ``rtol 1e-6`` for normal and
  exponential draws (``random.py``'s note on ``erf_inv`` and ``log1p``).

Then the edge cases the two libraries disagree on, the gradients against
``jax.grad``, and the registry gap left after this slice.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import mxnet_tpu as mx
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import registry as treg

BITWISE = "bitwise"
TRANS = dict(rtol=1e-6, atol=1e-7)
SPECIAL = dict(rtol=1e-5, atol=1e-7)
SUMS = dict(rtol=1e-6, atol=1e-6)


def _rng(seed=0):
    return np.random.RandomState(seed)


def _x(shape=(3, 4), lo=-2.0, hi=2.0, seed=0):
    return _rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _ints(shape=(3, 4), lo=-9, hi=10, seed=0):
    return _rng(seed).randint(lo, hi, shape).astype(np.int32)


def _as(a, dtype):
    return a.astype(dtype) if dtype != "int32" or a.dtype.kind != "f" \
        else np.round(a * 3).astype(np.int32)


def _run(name, arrays, params):
    """(JAX outputs, port outputs) as numpy lists."""
    jout = jreg.get(name).fn(*[jnp.asarray(a) for a in arrays], **params)
    tout = treg.get(name).fn(*[torch.from_numpy(np.array(a))
                               for a in arrays], **params)
    jout = jout if isinstance(jout, tuple) else (jout,)
    tout = tout if isinstance(tout, tuple) else (tout,)
    assert len(jout) == len(tout), name
    return ([np.asarray(o) for o in jout],
            [o.detach().numpy() for o in tout])


def _check(name, arrays, params, tol, edges=BITWISE):
    """Outputs compared at ``tol``; a histogram's edges (its second
    output) at ``edges``."""
    jout, tout = _run(name, arrays, params)
    for k, (w, g) in enumerate(zip(jout, tout)):
        if "histogram" in name and k == 1:
            tol = edges
        assert g.shape == w.shape, (name, g.shape, w.shape)
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        if tol == BITWISE:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, err_msg=name, **tol)


# -------------------------------------------------------------- the cases
# name -> (inputs(dtype) -> list of arrays, params, tolerance, dtypes)
F = ("float32",)
FI = ("float32", "int32")


def _u(lo=-2.0, hi=2.0):
    return lambda dt: [_as(_x(lo=lo, hi=hi), dt)]


def _b(lo=-2.0, hi=2.0, shape2=(3, 4), nonzero=False):
    def make(dt):
        a, b = _x(lo=lo, hi=hi), _x(shape2, lo=lo, hi=hi, seed=1)
        if dt == "int32":
            a, b = _ints(), _ints(shape2, seed=1)
        if nonzero:
            b = np.where(b == 0, 3, b).astype(b.dtype)
        return [a, b]
    return make


UNARY_BITWISE = {"sign": FI, "rint": FI, "ceil": FI, "floor": FI,
                 "trunc": FI, "fix": FI, "round": FI, "logical_not": FI,
                 "degrees": FI, "radians": FI, "reciprocal": FI,
                 "softsign": F}
UNARY_TRANS = {"rsqrt": (0.1, 4.0), "cbrt": (-8.0, 8.0),
               "rcbrt": (0.1, 8.0), "log10": (0.1, 9.0),
               "log2": (0.1, 9.0), "log1p": (-0.9, 4.0),
               "expm1": (-2.0, 2.0), "sin": (-3.0, 3.0),
               "cos": (-3.0, 3.0), "tan": (-1.2, 1.2),
               "arcsin": (-0.99, 0.99), "arccos": (-0.99, 0.99),
               "arctan": (-4.0, 4.0), "sinh": (-3.0, 3.0),
               "cosh": (-3.0, 3.0), "arcsinh": (-4.0, 4.0),
               "arccosh": (1.01, 5.0), "arctanh": (-0.99, 0.99),
               "erf": (-2.0, 2.0)}
UNARY_SPECIAL = {"erfinv": (-0.99, 0.99), "gamma": (0.1, 5.0),
                 "gammaln": (0.1, 9.0)}

CASES = {}
for _n, _dts in UNARY_BITWISE.items():
    CASES[_n] = (_u(-3.0, 3.0), {}, BITWISE, _dts)
for _n, (_lo, _hi) in UNARY_TRANS.items():
    CASES[_n] = (_u(_lo, _hi), {}, TRANS, F)
for _n, (_lo, _hi) in UNARY_SPECIAL.items():
    CASES[_n] = (_u(_lo, _hi), {}, SPECIAL, F)

for _fam in ("mod", "hypot", "logical_and", "logical_or", "logical_xor"):
    _tol = TRANS if _fam == "hypot" else BITWISE
    _dts = F if _fam == "hypot" else FI
    for _pre in ("broadcast_", "elemwise_", "_"):
        _shape2 = (1, 4) if _pre == "broadcast_" else (3, 4)
        CASES[_pre + _fam] = (_b(shape2=_shape2, nonzero=_fam == "mod"),
                              {}, _tol, _dts)

for _n in ("_mod_scalar", "_rmod_scalar", "_maximum_scalar",
           "_minimum_scalar"):
    CASES[_n] = (lambda dt: [_as(_x(), dt) if dt == "float32"
                             else np.where(_ints() == 0, 5, _ints())
                             .astype(np.int32)],
                 {"scalar": -1.5}, BITWISE, FI)
for _n in ("_logical_and_scalar", "_logical_or_scalar",
           "_logical_xor_scalar"):
    CASES[_n] = (_u(), {"scalar": 1.0}, BITWISE, FI)
CASES["_hypot_scalar"] = (_u(), {"scalar": 1.5}, TRANS, F)
CASES["add_n"] = (lambda dt: [_as(_x(seed=i), dt) for i in range(4)], {},
                  BITWISE, FI)

# legacy capitalised names: the case of the op each aliases
_LEGACY = {
    "_Div": "broadcast_div", "_Equal": "broadcast_equal",
    "_Greater": "broadcast_greater",
    "_Greater_Equal": "broadcast_greater_equal",
    "_Lesser": "broadcast_lesser", "_Lesser_Equal": "broadcast_lesser_equal",
    "_Maximum": "broadcast_maximum", "_Minimum": "broadcast_minimum",
    "_Minus": "broadcast_sub", "_Mul": "broadcast_mul",
    "_Not_Equal": "broadcast_not_equal", "_Plus": "broadcast_add",
    "_Power": "broadcast_power", "_grad_add": "broadcast_add",
    "_Hypot": "_hypot", "_Mod": "_mod", "_Logical_And": "_logical_and",
    "_Logical_Or": "_logical_or", "_Logical_Xor": "_logical_xor",
    "ElementWiseSum": "add_n", "reverse": "flip",
    "broadcast_axes": "broadcast_axis",
    "_crop_assign": "_slice_assign",
    "_crop_assign_scalar": "_slice_assign_scalar",
    "_contrib_group_adagrad_update": "group_adagrad_update",
    "_zeros_without_dtype": "_zeros",
}
for _n, _scalar_of in {
        "_DivScalar": "_div_scalar", "_EqualScalar": "_equal_scalar",
        "_GreaterEqualScalar": "_greater_equal_scalar",
        "_GreaterScalar": "_greater_scalar",
        "_LesserEqualScalar": "_lesser_equal_scalar",
        "_LesserScalar": "_lesser_scalar",
        "_MaximumScalar": "_maximum_scalar",
        "_MinimumScalar": "_minimum_scalar",
        "_MinusScalar": "_minus_scalar", "_ModScalar": "_mod_scalar",
        "_MulScalar": "_mul_scalar", "_NotEqualScalar": "_not_equal_scalar",
        "_PlusScalar": "_plus_scalar", "_PowerScalar": "_power_scalar",
        "_RDivScalar": "_rdiv_scalar", "_RMinusScalar": "_rminus_scalar",
        "_RModScalar": "_rmod_scalar",
        "_RPowerScalar": "_rpower_scalar"}.items():
    _LEGACY[_n] = _scalar_of
for _n in ("_div_scalar", "_equal_scalar", "_greater_equal_scalar",
           "_greater_scalar", "_lesser_equal_scalar", "_lesser_scalar",
           "_minus_scalar", "_mul_scalar", "_not_equal_scalar",
           "_plus_scalar", "_rdiv_scalar", "_rminus_scalar"):
    CASES[_n] = (_u(0.5, 3.0), {"scalar": 1.5}, BITWISE, FI)
CASES["_power_scalar"] = (_u(0.5, 3.0), {"scalar": 1.5}, TRANS, F)
CASES["_rpower_scalar"] = (_u(-2.0, 2.0), {"scalar": 1.5}, TRANS, F)
for _n in ("broadcast_div", "broadcast_equal", "broadcast_greater",
           "broadcast_greater_equal", "broadcast_lesser",
           "broadcast_lesser_equal", "broadcast_maximum",
           "broadcast_minimum", "broadcast_sub", "broadcast_mul",
           "broadcast_not_equal", "broadcast_add"):
    CASES[_n] = (_b(shape2=(1, 4), nonzero=True), {}, BITWISE,
                 F if _n == "broadcast_div" else FI)
CASES["broadcast_power"] = (_b(0.5, 2.0, shape2=(1, 4)), {}, TRANS, F)

# reductions
for _n in ("argmax", "argmin"):
    CASES[_n] = (_u(), {"axis": 1, "keepdims": True}, BITWISE, FI)
CASES["argmax_channel"] = (_u(), {}, BITWISE, FI)
CASES["broadcast_axis"] = (lambda dt: [_as(_x((3, 1, 2)), dt)],
                           {"axis": 1, "size": 4}, BITWISE, FI)
CASES["cumsum"] = (_u(), {"axis": 1}, SUMS, FI)
CASES["nansum"] = (lambda dt: [np.where(_x() > 1.0, np.nan, _x())
                               .astype(np.float32)],
                   {"axis": 0}, SUMS, F)
CASES["nanprod"] = (lambda dt: [np.where(_x() > 1.0, np.nan, _x())
                                .astype(np.float32)],
                    {"axis": (0, 1), "keepdims": True}, SUMS, F)
CASES["square_sum"] = (_u(), {"axis": 1, "keepdims": True}, SUMS, F)
CASES["_square_sum"] = (_u(), {"axis": 0}, SUMS, F)

# indexing, ordering, movement
_ND = lambda dt: [_as(_x((4, 5, 3)), dt)]   # noqa: E731
CASES["slice"] = (_ND, {"begin": (1, None, 0), "end": (3, None, 3),
                        "step": (1, -2, 2)}, BITWISE, FI)
CASES["slice_like"] = (lambda dt: [_as(_x((4, 5)), dt), _x((2, 3))],
                       {"axes": (0, 1)}, BITWISE, FI)
CASES["tile"] = (_u(), {"reps": (2, 1, 3)}, BITWISE, FI)
CASES["repeat"] = (_u(), {"repeats": 2, "axis": 1}, BITWISE, FI)
CASES["flip"] = (_ND, {"axis": (0, 2)}, BITWISE, FI)
CASES["take"] = (lambda dt: [_as(_x((5, 3)), dt),
                             np.array([[0, 4], [-1, 7]], np.float32)],
                 {"axis": 0}, BITWISE, FI)
CASES["batch_take"] = (lambda dt: [_as(_x((3, 4)), dt),
                                   np.array([0, 3, 1], np.int32)],
                       {}, BITWISE, FI)
CASES["gather_nd"] = (lambda dt: [_as(_x((4, 5)), dt),
                                  np.array([[0, 3, -1], [1, 9, 2]],
                                           np.int32)], {}, BITWISE, FI)
CASES["scatter_nd"] = (lambda dt: [_as(_x((3,)), dt),
                                   np.array([[0, 3, 1], [1, 0, 2]],
                                            np.int32)],
                       {"shape": (4, 3)}, BITWISE, FI)
CASES["one_hot"] = (lambda dt: [np.array([0, 2, -1, 5], np.int32)
                                .astype(dt)],
                    {"depth": 4, "on_value": 2.5, "off_value": -1.0},
                    BITWISE, FI)
CASES["sort"] = (lambda dt: [_as(np.round(_x((3, 6)) * 2), dt)],
                 {"axis": 1, "is_ascend": False}, BITWISE, FI)
CASES["argsort"] = (lambda dt: [_as(np.round(_x((3, 6)) * 2), dt)],
                    {"axis": -1, "is_ascend": False}, BITWISE, FI)
CASES["topk"] = (lambda dt: [_as(np.round(_x((3, 6)) * 2), dt)],
                 {"axis": 1, "k": 3, "ret_typ": "both"}, BITWISE, FI)
CASES["depth_to_space"] = (lambda dt: [_as(_x((2, 16, 3, 2)), dt)],
                           {"block_size": 2}, BITWISE, FI)
CASES["space_to_depth"] = (lambda dt: [_as(_x((2, 4, 6, 4)), dt)],
                           {"block_size": 2}, BITWISE, FI)
CASES["diag"] = (_u(), {"k": 1}, BITWISE, FI)
CASES["shape_array"] = (_ND, {}, BITWISE, FI)
CASES["size_array"] = (_ND, {}, BITWISE, FI)
CASES["khatri_rao"] = (lambda dt: [_as(_x((2, 3)), dt),
                                   _as(_x((4, 3), seed=1), dt)],
                       {}, BITWISE, FI)
CASES["boolean_mask_dense"] = (lambda dt: [_as(_x((4, 3)), dt),
                                           np.array([1, 0, 1, 1],
                                                    np.float32)],
                               {}, BITWISE, FI)
CASES["histogram"] = (_u(), {"bin_cnt": 5}, "edges", F)
CASES["_histogram"] = (_u(), {"bin_cnt": 4, "range": (-1.0, 1.5)},
                       "edges", F)
CASES["ravel_multi_index"] = (lambda dt: [np.array([[1, 0, 2], [3, 1, 0]])
                                          .astype(dt)],
                              {"shape": (3, 4)}, BITWISE, FI)
CASES["unravel_index"] = (lambda dt: [np.array([0, 5, 11, 7]).astype(dt)],
                          {"shape": (3, 4)}, BITWISE, FI)
CASES["_ravel_multi_index"] = (lambda dt: [np.array([[1, -1, 5],
                                                     [3, 1, 9]])
                                           .astype(dt)],
                               {"shape": (3, 4)}, BITWISE, FI)
CASES["_unravel_index"] = (lambda dt: [np.array([0, 5, 11, -1, -30, 40])
                                       .astype(dt)],
                           {"shape": (3, 4)}, BITWISE, FI)
CASES["_slice_assign"] = (lambda dt: [_as(_x((4, 5)), dt),
                                      _as(_x((2, 2), seed=1), dt)],
                          {"begin": (1, 4), "end": (3, 0),
                           "step": (1, -2)}, BITWISE, FI)
CASES["_slice_assign_scalar"] = (lambda dt: [_as(_x((4, 5)), dt)],
                                 {"scalar": 2.0, "begin": (0, 1),
                                  "end": (4, 5), "step": (2, 1)},
                                 BITWISE, FI)
CASES["_sparse_retain"] = (lambda dt: [_as(_x((5, 2)), dt),
                                       np.array([0, 3, -1], np.int32)],
                           {}, BITWISE, FI)
CASES["_scatter_set_nd"] = (lambda dt: [_as(_x((4, 3)), dt),
                                        _as(_x((2,), seed=1), dt),
                                        np.array([[0, 2], [1, 0]],
                                                 np.int32)],
                            {}, BITWISE, FI)
CASES["_scatter_plus_scalar"] = (_u(), {"scalar": 1.5}, BITWISE, F)
CASES["_scatter_minus_scalar"] = (_u(), {"scalar": 1.5}, BITWISE, F)
CASES["_scatter_elemwise_div"] = (_b(nonzero=True), {}, BITWISE, F)
CASES["_identity_with_attr_like_rhs"] = (_b(), {}, BITWISE, FI)
CASES["cast_storage"] = (_u(), {"stype": "row_sparse"}, BITWISE, F)
CASES["hard_sigmoid"] = (_u(-4.0, 4.0), {}, BITWISE, F)

# creation
CASES["_eye"] = (lambda dt: [], {"N": 4, "M": 5, "k": -1, "dtype": "int32"},
                 BITWISE, F)
CASES["_linspace"] = (lambda dt: [], {"start": 0.3, "stop": 7.1,
                                      "num": 13}, SUMS, F)
CASES["_zeros"] = (lambda dt: [], {"shape": (2, 3)}, BITWISE, F)

# update ops: weight, grad, states
_OPT = {
    "sgd_update": (0, {"lr": 0.1, "wd": 0.01}),
    "sgd_mom_update": (1, {"lr": 0.1, "momentum": 0.9, "wd": 0.01}),
    "nag_mom_update": (1, {"lr": 0.1, "momentum": 0.9, "wd": 0.01}),
    "adam_update": (2, {"lr": 0.01, "wd": 0.01}),
    "rmsprop_update": (1, {"lr": 0.01, "clip_weights": 0.5}),
    "rmspropalex_update": (3, {"lr": 0.01}),
    "ftrl_update": (2, {"lr": 0.1, "wd": 0.01}),
    "signsgd_update": (0, {"lr": 0.1, "wd": 0.01}),
    "signum_update": (1, {"lr": 0.1, "momentum": 0.9, "wd_lh": 0.01}),
    "adagrad_update": (1, {"lr": 0.1, "wd": 0.01}),
    "_sparse_adagrad_update": (1, {"lr": 0.1, "wd": 0.01}),
    "adadelta_update": (2, {"wd": 0.01}),
    "ftml_update": (3, {"lr": 0.01, "t": 2, "wd": 0.01}),
    "group_adagrad_update": (1, {"lr": 0.1}),
}


def _opt_inputs(name):
    n_states, params = _OPT[name]

    def make(dt):
        w, g = _x((4, 3)), _x((4, 3), seed=1)
        states = [np.abs(_x((4, 3), seed=2 + i)) for i in range(n_states)]
        if name == "group_adagrad_update":
            states = [np.abs(_x((4, 1), seed=2))]
        if name == "rmspropalex_update":
            states[1] = states[1] * 0.1   # n > g^2 keeps the root real
        return [w, g] + states
    return make, dict(params, rescale_grad=0.5, clip_gradient=0.6)


for _n in _OPT:
    _make, _params = _opt_inputs(_n)
    if _n == "ftml_update":
        _params["clip_grad"] = _params.pop("clip_gradient")
    CASES[_n] = (_make, _params, TRANS, F)


def _mp_inputs(n_mom):
    def make(dt):
        w32 = _x((4, 3))
        mom = [_x((4, 3), seed=2)] if n_mom else []
        return [w32.astype(np.float16), _x((4, 3), seed=1)
                .astype(np.float16)] + mom + [w32]
    return make


CASES["mp_sgd_update"] = (_mp_inputs(0), {"lr": 0.1, "wd": 0.01},
                          TRANS, F)
CASES["mp_sgd_mom_update"] = (_mp_inputs(1), {"lr": 0.1, "momentum": 0.9,
                                              "wd": 0.01}, TRANS, F)

# random-surface aliases: drawn after the same seed
RANDOM = {
    "uniform": ({"low": -1.0, "high": 2.0, "shape": (3, 4)}, BITWISE),
    "random_uniform": ({"shape": (5,)}, BITWISE),
    "normal": ({"loc": 1.0, "scale": 2.0, "shape": (3, 4)}, TRANS),
    "random_normal": ({"shape": (6,)}, TRANS),
    "random_exponential": ({"lam": 2.0, "shape": (3, 4)}, TRANS),
    "random_randint": ({"low": -3, "high": 9, "shape": (3, 4)}, BITWISE),
}
RAISING = ("random_gamma", "random_poisson", "random_negative_binomial",
           "random_generalized_negative_binomial")


def _case(name):
    return CASES[_LEGACY.get(name, name)]


# the cases of names an earlier slice registered, there as the targets
# of legacy names
EARLIER = {"_zeros", "broadcast_power", "_power_scalar", "_rpower_scalar"} \
    | {n for n in CASES if n.startswith("broadcast_")
       and n[len("broadcast_"):] in (
           "add", "sub", "mul", "div", "maximum", "minimum", "equal",
           "not_equal", "greater", "greater_equal", "lesser",
           "lesser_equal")} \
    | {"_%s_scalar" % n for n in (
        "plus", "minus", "rminus", "mul", "div", "rdiv", "equal",
        "not_equal", "greater", "greater_equal", "lesser",
        "lesser_equal")}
# every name this slice registers
SLICE_NAMES = sorted(
    (set(CASES) - EARLIER) | set(_LEGACY) | set(RANDOM) | set(RAISING)
    | {"sample_multinomial", "shuffle", "_sample_unique_zipfian"})
PARAMS = [(n, dt) for n in sorted(set(SLICE_NAMES) | EARLIER)
          if n not in RANDOM and n not in RAISING
          and n not in ("sample_multinomial", "shuffle",
                        "_sample_unique_zipfian")
          for dt in _case(n)[3]]


@pytest.mark.parametrize("name,dtype", PARAMS,
                         ids=["%s-%s" % p for p in PARAMS])
def test_forward_matches_the_jax_op(name, dtype):
    make, params, tol, _ = _case(name)
    if tol == "edges":
        _check(name, make(dtype), params, BITWISE, edges=SUMS)
    else:
        _check(name, make(dtype), params, tol)


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_alias_draws_match(name):
    params, tol = RANDOM[name]
    mx.random.seed(11)
    mt.random.seed(11)
    _check(name, [], params, tol)


@pytest.mark.parametrize("name", ["sample_multinomial", "shuffle"])
def test_random_alias_ops_with_inputs_match(name):
    p = _rng(3).dirichlet(np.ones(5), 4).astype(np.float32)
    mx.random.seed(5)
    mt.random.seed(5)
    if name == "shuffle":
        _check(name, [_x((6, 2))], {}, BITWISE)
    else:
        _check(name, [p], {"shape": (3,), "get_prob": False}, BITWISE)


@pytest.mark.parametrize("name", RAISING)
def test_gamma_family_aliases_raise_with_their_ops(name):
    with pytest.raises(mt.MXNetError, match="A3b.1b"):
        treg.get(name).fn(shape=(2,))


def test_sample_unique_zipfian_matches():
    mx.random.seed(7)
    mt.random.seed(7)
    _check("_sample_unique_zipfian", [], {"range_max": 50,
                                          "shape": (3, 20)}, BITWISE)


# C15: at these ranges torch.exp, one ulp off XLA's exp on ~10 % of its
# inputs, moved a few draws of the op at each of these shapes and seeds
# (5000: 1554, 600 and 122 ids at seeds 0-2; 50000: 1 at seed 1;
# 1000000: 7-8 at each seed)
ZIPF_WIDE = [(5000, (64, 2048)), (50000, (64, 256)), (1000000, (16, 512))]


@pytest.mark.parametrize("range_max,shape", ZIPF_WIDE,
                         ids=[str(r) for r, _ in ZIPF_WIDE])
def test_sample_unique_zipfian_matches_at_wide_ranges(range_max, shape):
    for seed in (0, 1, 2):
        mx.random.seed(seed)
        mt.random.seed(seed)
        _check("_sample_unique_zipfian", [], {"range_max": range_max,
                                              "shape": shape}, BITWISE)


@pytest.mark.parametrize("range_max", [r for r, _ in ZIPF_WIDE])
def test_exp_f32_is_xlas_exp_on_every_zipfian_input(range_max):
    """``random.exp_f32`` against ``jnp.exp`` on every input the op can
    give it: ``u * log(range_max)`` for each of the 2^23 uniform
    floats."""
    u = ((np.arange(2 ** 23, dtype=np.uint32) | np.uint32(0x3F800000))
         .view(np.float32) - np.float32(1.0))
    lr = np.float32(jnp.log(float(range_max)))
    want = np.asarray(jax.jit(lambda x: jnp.exp(x * lr))(u))
    got = mt.random.exp_f32(torch.from_numpy(u) * torch.log(
        torch.tensor(float(range_max)))).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_sample_unique_zipfian_runs_on_the_context_it_is_given():
    """Like its siblings the op takes ``ctx``: the default context is the
    card (it raises on a host without one), and ``cpu()`` draws the
    registry op's values."""
    if torch.cuda.is_available():
        out = mt.nd._sample_unique_zipfian(range_max=50, shape=(3, 20))
        assert out[0]._data.device.type == "cuda"
    else:
        with pytest.raises(mt.MXNetError, match="no CUDA device"):
            mt.nd._sample_unique_zipfian(range_max=50, shape=(3, 20))
    mt.random.seed(7)
    got = mt.nd._sample_unique_zipfian(range_max=50, shape=(3, 20),
                                       ctx=mt.cpu())
    mt.random.seed(7)
    want = treg.get("_sample_unique_zipfian").fn(range_max=50,
                                                 shape=(3, 20))
    for g, w in zip(got, want):
        assert g.context == mt.cpu()
        assert torch.equal(g._data, w)


def test_histogram_reads_back_only_without_a_range():
    """Only a histogram whose range comes from the data's min and max
    reads back, so only that one keeps a fused step off the CUDA
    graph."""
    assert treg.get("histogram").reads_back({})
    assert not treg.get("histogram").reads_back({"range": (-2.0, 2.0)})
    assert not treg.get("_histogram").reads_back({"range": (-2.0, 2.0)})
    assert treg.get("_sample_unique_zipfian").reads_back({})


def test_every_slice_name_is_registered_and_covered():
    assert len(SLICE_NAMES) == 178
    assert set(SLICE_NAMES) <= set(treg.list_ops())


# ------------------------------------------------------------ edge cases
@pytest.mark.parametrize("c_per_block", [1, 4])
def test_depth_to_space_is_dcr_not_pixel_shuffle(c_per_block):
    x = _x((2, 4 * c_per_block, 3, 5))
    _check("depth_to_space", [x], {"block_size": 2}, BITWISE)
    y = _x((2, c_per_block, 6, 4), seed=2)
    _check("space_to_depth", [y], {"block_size": 2}, BITWISE)
    port = treg.get("depth_to_space").fn(torch.from_numpy(x), block_size=2)
    shuffled = torch.nn.functional.pixel_shuffle(torch.from_numpy(x), 2)
    assert torch.equal(port, shuffled) == (c_per_block == 1)


@pytest.mark.parametrize("is_ascend", [True, False])
def test_ties_keep_the_lower_index_first(is_ascend):
    x = np.array([[2., 1., 2., 1., 3., 2., 3.],
                  [0., 0., 0., 0., 0., 0., 0.]], np.float32)
    for ret in ("indices", "value", "mask"):
        _check("topk", [x], {"k": 4, "ret_typ": ret,
                             "is_ascend": is_ascend}, BITWISE)
    _check("argsort", [x], {"is_ascend": is_ascend}, BITWISE)
    _check("sort", [x], {"is_ascend": is_ascend}, BITWISE)
    got = treg.get("topk").fn(torch.from_numpy(x), k=3, ret_typ="indices",
                              is_ascend=is_ascend)
    assert got[1].tolist() == [0.0, 1.0, 2.0]


def test_nan_sorts_as_the_largest():
    x = np.array([[1.0, np.nan, 3.0, 3.0, -1.0]], np.float32)
    for op, p in (("topk", {"k": 5, "ret_typ": "both"}), ("sort", {}),
                  ("argsort", {"is_ascend": False}), ("argmax", {"axis": 1}),
                  ("argmin", {"axis": 1})):
        _check(op, [x], p, BITWISE)


@pytest.mark.parametrize("mode", ["clip", "wrap", "raise"])
def test_take_out_of_range_indices(mode):
    x = _x((5, 3))
    idx = np.array([-7, -1, 0, 4, 5, 12], np.float32)
    _check("take", [x, idx], {"axis": 0, "mode": mode}, BITWISE)
    _check("take", [x, idx], {"axis": 1, "mode": mode}, BITWISE)


def test_one_hot_and_gather_nd_out_of_range():
    _check("one_hot", [np.array([-3, -1, 0, 3, 4, 9], np.float32)],
           {"depth": 4}, BITWISE)
    idx = np.array([[-9, -5, -1, 0, 3, 4, 20], [0, 1, -2, 6, 2, -9, 1]],
                   np.int32)
    _check("gather_nd", [_x((4, 3)), idx], {}, BITWISE)
    _check("batch_take", [_x((3, 4)), np.array([-1, 4, -6], np.int32)], {},
           BITWISE)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_mod_takes_the_divisors_sign(dtype):
    a = np.array([5, -5, 5, -5, 6, -6, 0], dtype)
    b = np.array([3, 3, -3, -3, 3, -3, -3], dtype)
    _check("broadcast_mod", [a, b], {}, BITWISE)
    got = treg.get("broadcast_mod").fn(torch.from_numpy(a),
                                       torch.from_numpy(b))
    assert got.tolist()[:4] == [2, 1, -1, -2]
    for s in (-3.0, 3.0):
        _check("_mod_scalar", [a], {"scalar": s}, BITWISE)
        _check("_rmod_scalar", [np.where(a == 0, 7, a).astype(dtype)],
               {"scalar": s}, BITWISE)


def test_round_is_half_to_even_r10():
    """ROADMAP §C R10: ``round`` is ``jnp.round`` (half to even), not
    upstream's half away from zero."""
    x = np.array([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 0.49999997], np.float32)
    _check("round", [x], {}, BITWISE)
    _check("rint", [x], {}, BITWISE)
    got = treg.get("round").fn(torch.from_numpy(x)).tolist()
    assert got == [0.0, -0.0, 2.0, -2.0, 2.0, -2.0, 0.0]


def test_gamma_drops_the_sign_r11():
    """ROADMAP §C R11: ``gamma`` is ``exp(gammaln(x))``, positive where
    Γ is negative (-0.5: Γ = -2 sqrt(pi))."""
    x = np.array([-0.5, -1.5, 0.5, 3.0], np.float32)
    _check("gamma", [x], {}, SPECIAL)
    got = treg.get("gamma").fn(torch.from_numpy(x))
    np.testing.assert_allclose(got[0].item(), 2 * np.sqrt(np.pi), rtol=1e-6)


def test_sign_keeps_nan_and_negative_zero():
    x = np.array([np.nan, -0.0, 0.0, -3.0, 2.0], np.float32)
    _check("sign", [x], {}, BITWISE)
    assert np.signbit(treg.get("sign").fn(torch.from_numpy(x))[1].item())


def test_scalar_ops_keep_an_integer_tensor_integer():
    """An integer tensor's scalar op rounds the scalar to the tensor's
    dtype and stays integer, as the JAX op (the port returned f32)."""
    x = _ints()
    for op in ("_plus_scalar", "_minus_scalar", "_mul_scalar",
               "_rminus_scalar", "_maximum_scalar", "_minimum_scalar"):
        _check(op, [x], {"scalar": 2.7}, BITWISE)


def test_histogram_closes_the_last_bin_and_reads_its_range():
    x = np.array([0.0, 1.0, 2.0, 3.0, 3.0, 9.0, -1.0], np.float32)
    _check("histogram", [x], {"bin_cnt": 3, "range": (0.0, 3.0)}, BITWISE,
           edges=SUMS)
    _check("histogram", [x], {"bin_cnt": 4}, BITWISE, edges=SUMS)
    _check("histogram", [np.full((3,), 2.0, np.float32)], {"bin_cnt": 2},
           BITWISE, edges=SUMS)
    _check("_histogram", [x, np.array([0.0, 0.5, 3.0], np.float32)], {},
           BITWISE)


def test_slice_steps_and_assign():
    x = _x((6, 5, 4))
    for begin, end, step in (((None, None), (None, None), (-1, -2)),
                             ((5, 1), (0, None), (-2, 1)),
                             ((1, 0, 3), (5, 5, 0), (2, 2, -1)),
                             ((0,), (0,), None)):
        _check("slice", [x], {"begin": begin, "end": end, "step": step},
               BITWISE)
    _check("_slice_assign", [x, _x((3, 5, 4), seed=1)],
           {"begin": (5,), "end": (None,), "step": (-2,)}, BITWISE)


# -------------------------------------------------------------- gradients
GRAD_UNARY = sorted(n for n in list(UNARY_TRANS) + list(UNARY_SPECIAL)
                    + ["softsign", "degrees", "radians", "reciprocal"]
                    if n != "erfinv")
GRAD_CASES = [(n, {}) for n in GRAD_UNARY] + [
    ("take", {"axis": 0}), ("slice", {"begin": (1, None),
                                      "end": (4, None), "step": (2, -1)}),
    ("tile", {"reps": (2, 2)}), ("repeat", {"repeats": 3, "axis": 0}),
    ("flip", {"axis": 1}), ("cumsum", {"axis": 0}),
    ("gather_nd", {}), ("depth_to_space", {"block_size": 2}),
    ("add_n", {}), ("erfinv", {})]


@pytest.mark.parametrize("name,params", GRAD_CASES,
                         ids=[c[0] for c in GRAD_CASES])
def test_gradient_matches_jax_grad(name, params):
    if name in UNARY_TRANS or name in UNARY_SPECIAL:
        lo, hi = {**UNARY_TRANS, **UNARY_SPECIAL}[name]
        x = _x((3, 4), lo, hi)
    elif name == "depth_to_space":
        x = _x((2, 8, 3, 2))
    else:
        x = _x((5, 3), 0.5, 2.0)
    extra = []
    if name == "take":
        extra = [np.array([0, 4, 4, 1, -2], np.float32)]
    elif name == "gather_nd":
        extra = [np.array([[0, 4, 4], [1, 2, 1]], np.int32)]
    elif name == "add_n":
        extra = [_x((5, 3), seed=1), _x((5, 3), seed=2)]
    jf = jreg.get(name).fn
    w = np.asarray(jax.grad(lambda a: jnp.sum(
        jf(a, *[jnp.asarray(e) for e in extra], **params)))(jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_(True)
    treg.get(name).fn(t, *[torch.from_numpy(e) for e in extra],
                      **params).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), w, rtol=1e-5, atol=1e-6,
                               err_msg=name)


# ----------------------------------------------------- the remaining gap
GAP = {
    # ops/contrib_ops.py
    "BilinearSampler", "GridGenerator", "SVMOutput", "SpatialTransformer",
    "_contrib_boolean_mask", "_contrib_box_non_maximum_suppression",
    "_contrib_count_sketch", "_contrib_fft", "_contrib_getnnz",
    "_contrib_ifft", "_contrib_index_copy",
    # ops/vision_ops.py
    "Correlation", "Crop", "MultiProposal", "SyncBatchNorm",
    "_contrib_Correlation", "_contrib_DeformableConvolution",
    "_contrib_DeformablePSROIPooling", "_contrib_MultiProposal",
    "_contrib_PSROIPooling", "_contrib_SyncBatchNorm",
    "_contrib_div_sqrt_dim", "_contrib_quadratic", "crop",
    # ops/quantization.py
    "_contrib_dequantize", "_contrib_quantize", "_contrib_quantize_v2",
    "_contrib_quantized_concat", "_contrib_quantized_conv",
    "_contrib_quantized_flatten", "_contrib_quantized_fully_connected",
    "_contrib_quantized_pooling", "_contrib_requantize", "dequantize",
    "quantize",
    # ops/linalg.py
    "_linalg_extractdiag", "_linalg_gelqf", "_linalg_gemm", "_linalg_gemm2",
    "_linalg_makediag", "_linalg_potrf", "_linalg_potri",
    "_linalg_sumlogdiag", "_linalg_syevd", "_linalg_syrk", "_linalg_trmm",
    "_linalg_trsm", "linalg_extractdiag", "linalg_gelqf", "linalg_gemm",
    "linalg_gemm2", "linalg_makediag", "linalg_potrf", "linalg_potri",
    "linalg_sumlogdiag", "linalg_syevd", "linalg_syrk", "linalg_trmm",
    "linalg_trsm",
}


def test_registry_gap_is_the_roadmaps():
    """The JAX names the port still lacks: exactly the 59 that
    ROADMAP.md queues under A3b.7 and A9."""
    assert len(GAP) == 59
    assert set(jreg.list_ops()) - set(treg.list_ops()) == GAP
    assert not set(treg.list_ops()) - set(jreg.list_ops())
