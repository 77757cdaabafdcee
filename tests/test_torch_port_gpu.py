"""Port tests that need the card: each CUDA kernel (``bn_act``,
``take_rows``, ``flash_attn``, ``flash_attn_paged``, ``scale_bias_act``,
``flash_fwd``, ``int8_dequant``) against its plain torch version, forward
and (for the training kernels and ``bn_act``) backward, the wrappers'
checks and launch counts, B1's op surface ``_contrib_FusedBNAct`` (one
launch a call, against the CPU), the random key chain's draws against
the CPU's, the card's ``torch._int_mm`` against the
CPU's, and small models (a ResNet-20 predictor in f32 and int8, a GPT
decoder in generate mode and its speculative step, a 2-layer GPT and a
ResNet-20 in f32 and bf16 trained by ``Module.fit``, the example's GPT
trained through Gluon, a recommend batch through the cache-backed
engine, a fused gluon.rnn layer with dropout, Inception-v3 at 139 x 139
with its 94 B1 launches, the LRN op) on the card against the CPU, B1 at
Inception-v3's odd and small site shapes and on each of its index paths
(rows odd, aligned and shorter than a vector, one channel, x and r at
storage offsets, NaN and infinities, a CUDA graph's replay, more than
2^31 elements), and B2's launches under gluon.rnn's word language model.

Every test takes the ``cuda`` fixture, which skips when
``torch.cuda.is_available()`` is false. On a machine with a card (which
may have no jax, so the suite's conftest cannot load there):

    python -m pytest tests/test_torch_port_gpu.py -q --noconftest

Tolerances: f32 atol/rtol 1e-5 (nvcc may contract x*sc + sh into one
FMA where torch rounds twice); bf16 within one bf16 ulp of the plain
result (both round one f32 value once) plus that 1e-5, which is what
remains of the FMA difference where a sum cancels near zero. The
attention kernels sum in another order than torch (and contract FMAs):
f32 within atol 2e-5, rtol 1e-4; bf16 within one bf16 ulp plus 1e-3.
``take_rows`` moves bytes and must match bitwise. On the planted
non-finite cases of ``tests/paged_nonfinite.py``, ``flash_attn_paged``'s
NaN and inf masks must equal the plain version's exactly (and the plain
version's the contract's), the finite values within the attention
tolerance. ``int8_dequant``
within one f32 ulp of the larger of |acc * sc| and |y| (the kernel's FMA
and the plain version's f64 sum both round once), with at least 99 % of
the outputs bitwise equal; int32 accumulators bitwise.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.kernels import _build
from mxnet_tpu_torch.kernels import attention as tattn
from mxnet_tpu_torch.kernels import bn_act as tbn
from mxnet_tpu_torch.kernels import int8_dequant as tdq
from mxnet_tpu_torch.kernels import mlp as tmlp
from mxnet_tpu_torch.kernels import take as ttake
from mxnet_tpu_torch.ops import pallas_flash as tpf
from mxnet_tpu_torch.ops import quant_serve as tqs
from mxnet_tpu_torch.parallel import blockwise_attention
from mxnet_tpu_torch.serve import decode_model as tdm

from paged_nonfinite import CASES, plant

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _case(shape, dtype, residual, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    C = shape[1]
    x = torch.randn(shape, generator=g).to(device, dtype)
    r = torch.randn(shape, generator=g).to(device, dtype) if residual \
        else None
    sc = (torch.rand(C, generator=g) * 2 - 0.5).to(device)
    sh = torch.randn(C, generator=g).to(device)
    return x, sc, sh, r


def _assert_kernel_matches_plain(y, ref):
    if y.dtype == torch.float32:
        torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-5)
    else:
        # one bf16 ulp (2^-7 of the larger magnitude) plus the f32
        # allowance, which dominates where a sum cancels near zero
        diff = (y.float() - ref.float()).abs()
        ulp = torch.maximum(y.float().abs(), ref.float().abs()) * 2 ** -7
        assert bool((diff <= ulp + 1e-5).all()), float(diff.max())


@pytest.mark.parametrize("shape", [(2, 16, 7, 7), (3, 5, 4, 6),
                                   (1, 64, 112, 112), (32, 2048, 7, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("act", ["relu", "identity"])
def test_kernel_matches_plain(cuda, shape, dtype, residual, act):
    x, sc, sh, r = _case(shape, dtype, residual, cuda)
    before = dict(tbn.launches_by_kernel)
    y = tbn._launch(x, sc, sh, r, act, tbn.DEFAULT_CONFIG)
    torch.cuda.synchronize()
    form = "bn_act_res" if residual else "bn_act"
    assert tbn.launches_by_kernel[form] == before[form] + 1
    _assert_kernel_matches_plain(y, tbn._plain_epilogue(x, sc, sh, r, act))


def test_small_grids_cover_every_element(cuda):
    x, sc, sh, r = _case((2, 3, 50, 51), torch.float32, True, cuda, seed=1)
    y = tbn._launch(x, sc, sh, r, "relu", {"threads": 64, "max_blocks": 3})
    torch.cuda.synchronize()
    _assert_kernel_matches_plain(y, tbn._plain_epilogue(x, sc, sh, r,
                                                        "relu"))


# B1's index paths (csrc/bn_act.cu, 16-byte vectors over the flat tensor):
# rows of odd length, rows a multiple of a vector, rows shorter than a
# vector, one channel, element counts no multiple of 8; chip_smoke.py's
# phase 3 runs the same cases
_B1_EDGE_SHAPES = [(2, 3, 147, 147), (3, 5, 17, 17), (4, 6, 7, 7),
                   (2, 5, 8, 8), (2, 3, 56, 56), (3, 7, 1, 1), (2, 5, 2, 3),
                   (3, 1, 9, 11), (2, 1, 8, 8)]


def _launch_once(x, sc, sh, r, act):
    before = tbn.launches
    y = tbn._launch(x, sc, sh, r, act, tbn.DEFAULT_CONFIG)
    torch.cuda.synchronize()
    assert tbn.launches == before + 1
    return y


@pytest.mark.parametrize("shape", _B1_EDGE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
def test_bn_act_index_paths_match_plain(cuda, shape, dtype, residual):
    x, sc, sh, r = _case(shape, dtype, residual, cuda, seed=sum(shape))
    for act in ("relu", "identity"):
        _assert_kernel_matches_plain(_launch_once(x, sc, sh, r, act),
                                     tbn._plain_epilogue(x, sc, sh, r, act))


def _at_offset(t, off):
    """A contiguous copy of ``t`` starting ``off`` elements into its
    storage."""
    buf = torch.empty(off + t.numel(), dtype=t.dtype, device=t.device)
    view = buf[off:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("offsets", [(1, 1), (3, 3), (1, 3), (0, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
def test_bn_act_at_storage_offsets_matches_plain(cuda, offsets, dtype,
                                                 residual):
    """x and r as views whose 16-byte alignment differs from y's: the
    same kernel's element-wise path."""
    for shape in ((3, 5, 17, 17), (2, 3, 56, 56)):
        x, sc, sh, r = _case(shape, dtype, residual, cuda, seed=5)
        xo = _at_offset(x, offsets[0])
        ro = None if r is None else _at_offset(r, offsets[1])
        assert xo.is_contiguous() and xo.storage_offset() == offsets[0]
        _assert_kernel_matches_plain(_launch_once(xo, sc, sh, ro, "relu"),
                                     tbn._plain_epilogue(x, sc, sh, r,
                                                         "relu"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
def test_bn_act_passes_nan_inf_and_negative_zero_as_plain(cuda, dtype,
                                                         residual):
    """NaN stays NaN through the ReLU (``v < 0 ? 0 : v``), infinities
    follow the arithmetic, -0.0 is an ordinary zero: the kernel's NaN and
    infinities are the plain version's, and the rest within tolerance."""
    for shape in ((3, 5, 17, 17), (2, 5, 8, 8)):
        x, sc, sh, r = _case(shape, dtype, residual, cuda, seed=11)
        hw, n = shape[2] * shape[3], x.numel()
        flat = x.view(-1)
        vals = (float("nan"), float("inf"), float("-inf"), -0.0)
        for k, i in enumerate((0, 1, hw - 1, hw, n // 2, n - 2, n - 1)):
            flat[i] = vals[k % len(vals)]
        for act in ("relu", "identity"):
            y = _launch_once(x, sc, sh, r, act)
            ref = tbn._plain_epilogue(x, sc, sh, r, act)
            nan, inf = torch.isnan(ref), torch.isinf(ref)
            assert nan.any() and inf.any()
            assert torch.equal(torch.isnan(y), nan)
            assert torch.equal(torch.isinf(y), inf)
            assert torch.equal(y[inf], ref[inf])
            fin = torch.isfinite(ref)
            _assert_kernel_matches_plain(torch.where(fin, y, 0),
                                         torch.where(fin, ref, 0))


def test_bn_act_replays_bitwise_in_a_cuda_graph(cuda):
    x, sc, sh, r = _case((8, 64, 35, 35), torch.bfloat16, True, cuda, seed=9)

    def launch():
        return tbn._launch(x, sc, sh, r, "relu", tbn.DEFAULT_CONFIG)
    eager = launch()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = tbn.launches
    with torch.cuda.graph(graph):
        y = launch()
    assert tbn.launches == before + 1
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, eager)
    x.copy_(x.flip(0))                # the graph reads x by its address
    eager = launch()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, eager)


def test_bn_act_past_2_31_elements(cuda):
    """2.17e9 bf16 elements (H*W odd): the 64-bit index path, held
    against the plain version one (n, c) row at a time."""
    N, C, H, W = 2, 3, 19001, 19001
    x = torch.empty((N, C, H, W), dtype=torch.bfloat16, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    for n in range(N):
        x[n].normal_(generator=g)
    assert x.numel() > 2 ** 31
    _x, sc, sh, _r = _case((1, C, 1, 1), torch.bfloat16, False, cuda)
    y = _launch_once(x, sc, sh, None, "relu")
    for n in range(N):
        for c in range(C):
            ref = tbn._plain_epilogue(x[n:n + 1, c:c + 1], sc[c:c + 1],
                                      sh[c:c + 1], None, "relu")
            _assert_kernel_matches_plain(y[n:n + 1, c:c + 1], ref)
    del x, y


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, sc, sh, r = _case((2, 4, 3, 3), torch.float32, True, cuda)
    for bad in (x.transpose(2, 3), x.half()):
        with pytest.raises(mt.MXNetError):
            tbn._launch(bad, sc, sh, None, "relu", tbn.DEFAULT_CONFIG)
    with pytest.raises(mt.MXNetError, match="residual"):
        tbn._launch(x, sc, sh, r.bfloat16(), "relu", tbn.DEFAULT_CONFIG)
    with pytest.raises(mt.MXNetError, match="sc must be"):
        tbn._launch(x, sc.cpu(), sh, None, "relu", tbn.DEFAULT_CONFIG)


def test_build_is_reused(cuda):
    first = _build.build(["bn_act"])
    assert _build.build(["bn_act"]) == first
    assert "bn_act" in _build.sources()


def test_resnet20_on_the_card_matches_the_cpu(cuda, tmp_path):
    sym = mt.models.resnet(num_layers=20, num_classes=10,
                           image_shape=(3, 32, 32))
    shapes, _, aux_shapes = sym.infer_shape(data=(2, 3, 32, 32))
    rng = np.random.RandomState(0)
    args = {n: rng.uniform(-0.5, 0.5, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}
    aux = {n: (rng.rand(*s) + 0.5).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    path = str(tmp_path / "r20.mxtorch")
    mt.serving.export_compiled(sym, args, aux, {"data": (None, 3, 32, 32)},
                               path)
    x = rng.randn(3, 3, 32, 32).astype(np.float32)
    before = tbn.launches
    srv = mt.serve.Server(path, buckets=(1, 4), batch_timeout_ms=0)
    try:
        got = srv.predict(data=x, timeout_ms=60000)[0]
    finally:
        srv.close()
    # one warmup and one request at bucket 4, 19 fused sites each
    assert tbn.launches - before == 2 * 19
    want = mt.serving.CompiledModel.load(path, device="cpu").predict(
        data=x)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ take_rows
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim", [768, 33, 8])
def test_take_rows_is_bitwise_the_clipped_gather(cuda, dtype, dim):
    g = torch.Generator().manual_seed(dim)
    table = torch.randn(300, dim, generator=g).to(cuda, dtype)
    ids = torch.randint(-50, 350, (4, 70), generator=g,
                        dtype=torch.int32).to(cuda)
    before = ttake.launches
    got = ttake.take_rows(table, ids)
    torch.cuda.synchronize()
    assert ttake.launches == before + 1
    want = ttake._plain_take(table, ids)
    assert got.shape == (4, 70, dim)
    assert torch.equal(got, want)


def test_take_rows_refuses_what_the_kernel_does_not_take(cuda):
    table = torch.randn(10, 8, device=cuda)
    with pytest.raises(mt.MXNetError, match="ids must be"):
        ttake._launch(table, torch.zeros(3, dtype=torch.int64,
                                         device=cuda), ttake.DEFAULT_CONFIG)
    with pytest.raises(mt.MXNetError, match="contiguous"):
        ttake._launch(table.t(), torch.zeros(3, dtype=torch.int32,
                                             device=cuda),
                      ttake.DEFAULT_CONFIG)


# ------------------------------------------------------------ attention
def _assert_attn_close(got, want):
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-5)
    else:
        diff = (got.float() - want.float()).abs()
        ulp = torch.maximum(got.float().abs(), want.float().abs()) * 2 ** -7
        assert bool((diff <= ulp + 1e-3).all()), float(diff.max())


# the tile takes 128 q rows a CTA (64 over head dim 64) and 64 kv rows a
# step: several q tiles, a last one whose second warpgroup has no row
@pytest.mark.parametrize("shape", [(2, 3, 128, 64), (1, 2, 100, 64),
                                   (2, 2, 37, 8), (1, 1, 70, 128),
                                   (1, 2, 300, 32), (1, 2, 200, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attn_matches_plain(cuda, shape, dtype):
    g = torch.Generator().manual_seed(shape[2])
    q, k, v = (torch.randn(shape, generator=g).to(cuda, dtype)
               for _ in range(3))
    before = tattn.launches_by_kernel["flash_attn"]
    got = tattn.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert tattn.launches_by_kernel["flash_attn"] == before + 1
    _assert_attn_close(got, tattn._plain_flash(q, k, v, True))
    _assert_attn_close(got, tattn.reference_attention(q, k, v, True))


def test_flash_attn_non_causal_cross_length(cuda):
    g = torch.Generator().manual_seed(5)
    q = torch.randn(2, 2, 30, 16, generator=g).to(cuda)
    k = torch.randn(2, 2, 90, 16, generator=g).to(cuda)
    v = torch.randn(2, 2, 90, 16, generator=g).to(cuda)
    got = tattn.flash_attention(q, k, v, causal=False)
    _assert_attn_close(got, tattn.reference_attention(q, k, v, False))


def _paged_case(S, W, heads, dh, page, mp, positions, dtype, device,
                seed=0):
    rng = np.random.RandomState(seed)
    C = heads * dh
    num_pages = S * mp + 1
    rows = num_pages * page
    kp = torch.from_numpy(rng.randn(rows, C).astype(np.float32))
    vp = torch.from_numpy(rng.randn(rows, C).astype(np.float32))
    perm = rng.permutation(np.arange(1, num_pages))[:S * mp]
    bt = torch.from_numpy(perm.reshape(S, mp).astype(np.int32))
    q = torch.from_numpy(rng.randn(S, W, C).astype(np.float32))
    pos = torch.tensor(positions, dtype=torch.int32)
    return (q.to(device, dtype), kp.to(device, dtype), vp.to(device, dtype),
            bt.to(device), pos.to(device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,W,heads,dh,page,mp,positions", [
    (16, 1, 12, 64, 16, 64, [0, 1, 15, 16, 17, 31, 32, 100, 255, 256, 511,
                             600, 777, 1000, 1022, 1023]),
    (1, 128, 12, 64, 16, 64, [0]),
    (1, 128, 12, 64, 16, 64, [256]),
    (3, 5, 4, 8, 8, 4, [0, 7, 26]),
    (2, 3, 2, 100, 4, 5, [3, 17]),
    # the speculative verifier's window at GPT-2 small (k = 4)
    (16, 5, 12, 64, 16, 64, [0, 1, 15, 16, 17, 31, 32, 100, 255, 256, 511,
                             600, 777, 1000, 1015, 1019]),
])
def test_flash_attn_paged_matches_plain(cuda, dtype, S, W, heads, dh, page,
                                        mp, positions):
    q, kp, vp, bt, pos = _paged_case(S, W, heads, dh, page, mp, positions,
                                     dtype, cuda)
    before = tattn.launches_by_kernel["flash_attn_paged"]
    got = tattn.paged_attention(q, kp, vp, bt, pos, heads=heads,
                                page_size=page)
    torch.cuda.synchronize()
    assert tattn.launches_by_kernel["flash_attn_paged"] == before + 1
    _assert_attn_close(got, tattn._plain_paged(q, kp, vp, bt, pos, heads,
                                               page))


def _assert_same_nonfinite(got, want):
    """NaN, +inf and -inf masks equal exactly; finite entries within the
    attention tolerance."""
    for test in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(test(got), test(want)), test.__name__
    fin = torch.isfinite(want)
    _assert_attn_close(got[fin], want[fin])


# the generate path's decode step and a prompt chunk whose last row's page
# has a masked tail, and a small W = 3 block
PLANT_GEOMS = {
    "decode": (16, 1, 12, 64, 16, 64, [0, 1, 15, 16, 17, 31, 32, 100, 255,
                                       256, 511, 600, 777, 1000, 1022,
                                       1023]),
    "chunk": (1, 128, 12, 64, 16, 64, [250]),
    "w3": (2, 3, 2, 8, 8, 4, [4, 17]),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", sorted(PLANT_GEOMS))
@pytest.mark.parametrize("case", CASES)
def test_flash_attn_paged_keeps_the_nonfinite_contract(cuda, dtype, geom,
                                                       case):
    S, W, heads, dh, page, mp, positions = PLANT_GEOMS[geom]
    q, kp, vp, bt, pos = _paged_case(S, W, heads, dh, page, mp, positions,
                                     torch.float32, "cpu")
    kp, vp, bt, nan, inf = plant(case, kp.numpy(), vp.numpy(), bt.numpy(),
                                 pos.numpy(), W, page)
    q, kp, vp = (torch.as_tensor(a).to(cuda, dtype) for a in (q, kp, vp))
    bt, pos = torch.from_numpy(bt).to(cuda), pos.to(cuda)
    want = tattn._plain_paged(q, kp, vp, bt, pos, heads, page)
    assert torch.equal(torch.isnan(want).cpu(), torch.from_numpy(nan))
    assert torch.equal(torch.isinf(want).cpu(), torch.from_numpy(inf))
    got = tattn.paged_attention(q, kp, vp, bt, pos, heads=heads,
                                page_size=page)
    torch.cuda.synchronize()
    _assert_same_nonfinite(got, want)


def test_generate_on_the_card_matches_the_cpu(cuda, tmp_path):
    spec = tdm.DecoderSpec(vocab=61, dim=64, num_heads=4, num_layers=2,
                           max_prompt_len=16, page_size=8,
                           max_pages_per_slot=8, max_slots=4, num_pages=33)
    params = tdm.init_params(spec, seed=0)
    path = str(tmp_path / "lm.mxtorch")
    mt.serving.export_generate(params, spec, path, chunked=True)
    work = [([5, 9, 13], 12, 0.0, 0), (list(range(1, 40)), 6, 0.0, 0),
            ([4, 4, 6], 8, 0.9, 11), ([7], 20, 0.0, 0)]
    outs = {}
    for dev in ("cpu", cuda):
        srv = mt.serve.Server(path, config=mt.serve.GenerateConfig(
            timeout_ms=0), device=dev)
        try:
            reqs = [srv.submit_generate(p, max_new_tokens=n, temperature=t,
                                        seed=s) for p, n, t, s in work]
            outs[str(dev)] = [r.result(timeout=120)["tokens"]
                              for r in reqs]
        finally:
            srv.close()
    assert outs["cpu"] == outs[str(cuda)]


def test_draft_verify_on_the_card_matches_the_cpu(cuda):
    """One speculative step (k = 3) from caches prefilled on the CPU: on
    the card (B4 at W = 1 and W = 4, the int8 products through
    ``_int_mm``) against the CPU's plain run."""
    spec = tdm.DecoderSpec(vocab=61, dim=64, num_heads=4, num_layers=2,
                           max_prompt_len=8, page_size=4,
                           max_pages_per_slot=8, max_slots=4, num_pages=33)
    k = 3
    params = tdm.init_params(spec, seed=0)
    draft = tdm.quantize_decoder_params(params)
    weights = {}
    for dev in ("cpu", cuda):
        weights[str(dev)] = (tdm.params_from_reference(params, spec, dev),
                             tdm.params_from_reference(draft, spec, dev))
    p, dp = weights["cpu"]
    shape = (spec.num_layers, spec.cache_rows, spec.dim)
    caches = [torch.zeros(shape) for _ in range(4)]
    bt = (np.arange(32, dtype=np.int32) + 1).reshape(4, 8)
    prompts = [[5, 9, 13], list(range(1, 20)), [4, 4, 6, 7], [60] * 27]
    tokens = np.zeros((4, 1), np.int32)
    for s, prompt in enumerate(prompts):
        for start in range(0, len(prompt), 8):
            toks = np.zeros(8, np.int32)
            part = prompt[start:start + 8]
            toks[:len(part)] = part
            nxt, _k, _v = tdm.make_chunk_prefill(p, spec)(
                toks, start, len(part), bt[s], 0.0, 0, caches[0], caches[1])
            tdm.make_chunk_prefill(dp, spec)(
                toks, start, len(part), bt[s], 0.0, 0, caches[2], caches[3])
        tokens[s, 0] = int(nxt)
    args = (tokens, np.array([len(q) for q in prompts], np.int32), bt,
            np.array([0.0, 0.8, 0.0, 0.0], np.float32),
            np.array([0, 3, 0, 0], np.int32))
    host = [c.clone() for c in caches]
    want = tdm.make_draft_verify(p, dp, spec, k)(*args, *host)[0]
    card = [c.to(cuda) for c in caches]
    before = tattn.launches_by_kernel["flash_attn_paged"]
    got = tdm.make_draft_verify(*weights[str(cuda)], spec, k)(*args, *card)[0]
    torch.cuda.synchronize()
    assert tattn.launches_by_kernel["flash_attn_paged"] == \
        before + spec.num_layers * (k + 1)
    assert torch.equal(got.cpu(), want)
    for c, h in zip(card[:2], host[:2]):
        np.testing.assert_allclose(c.cpu().numpy(), h.numpy(), rtol=1e-4,
                                   atol=1e-4)


# ------------------------------------------------- training kernels (B5, B7)
def _grads(fn, *inputs, seed=0):
    """(out, grads) of sum(fn(*inputs) * cot) for the float inputs."""
    leaves = [None if t is None else t.detach().clone().requires_grad_(
        t.is_floating_point()) for t in inputs]
    out = fn(*leaves)
    g = torch.Generator().manual_seed(seed)
    cot = torch.randn(out.shape, generator=g).to(out.device)
    (out.float() * cot).sum().backward()
    return out, [None if t is None else t.grad for t in leaves]


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("training", [False, True])
def test_bn_act_backward_on_the_card(cuda, residual, training):
    """The fused BatchNorm epilogue under autograd launches its kernel
    once; the gradients of data, gamma, beta and the residual equal
    autograd through the unfused reference on the card."""
    x, _sc, _sh, r = _case((4, 16, 7, 7), torch.float32, residual, cuda)
    g = torch.Generator().manual_seed(3)
    gamma, beta = (torch.rand(16, generator=g) + 0.5).to(cuda), \
        torch.randn(16, generator=g).to(cuda)
    mm, mv = torch.zeros(16, device=cuda), torch.ones(16, device=cuda)
    kw = dict(eps=2e-5, momentum=0.9, fix_gamma=False,
              use_global_stats=False, training=training)
    before = tbn.launches
    out, got = _grads(lambda a, b, c, d: tbn.fused_bn_act(
        a, b, c, mm, mv, d, act="relu", **kw)[0], x, gamma, beta, r)
    torch.cuda.synchronize()
    assert tbn.launches == before + 1
    ref, want = _grads(lambda a, b, c, d: tbn._reference(
        a, b, c, mm, mv, d, "relu", **kw), x, gamma, beta, r)
    _assert_kernel_matches_plain(out.detach(), ref.detach())
    for a, b in zip(got, want):
        if b is not None:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("residual", [False, True])
def test_bn_act_matches_plain_at_a_training_shape(cuda, residual):
    """B1 at the largest site of the bf16 ResNet-50 training forward
    (batch 128, 256 x 56 x 56): kernel against plain, one launch."""
    x, sc, sh, r = _case((128, 256, 56, 56), torch.bfloat16, residual, cuda)
    before = tbn.launches
    y = tbn._launch(x, sc, sh, r, "relu", tbn.DEFAULT_CONFIG)
    torch.cuda.synchronize()
    assert tbn.launches == before + 1
    _assert_kernel_matches_plain(y, tbn._plain_epilogue(x, sc, sh, r,
                                                        "relu"))


@pytest.mark.parametrize("residual", [False, True])
def test_bn_act_bf16_training_on_the_card_matches_the_cpu(cuda, residual):
    """B1 in training mode on bf16 data, forward (batch statistics
    through the widened f32 sums) and the recomputed low-precision
    backward, on the card against the CPU: outputs and gradients within
    a relative L2 error of 2^-8 (f32 sums in another order can move a
    bf16 rounding), statistics within 1e-5."""
    x, _sc, _sh, r = _case((8, 64, 14, 14), torch.bfloat16, residual, "cpu")
    g = torch.Generator().manual_seed(4)
    gamma, beta = torch.rand(64, generator=g) + 0.5, torch.randn(64,
                                                                generator=g)
    mm, mv = torch.zeros(64), torch.ones(64)
    kw = dict(eps=2e-5, momentum=0.9, fix_gamma=False, act="relu",
              training=True)
    res = {}
    for dev in ("cpu", cuda):
        mv_, mm_ = mv.to(dev), mm.to(dev)
        outs = {}

        def fn(a, b, c, d):
            o = tbn.fused_bn_act(a, b, c, mm_, mv_, d, **kw)
            outs["stats"] = o[1:]
            return o[0]
        before = tbn.launches
        out, grads = _grads(fn, *[None if t is None else t.to(dev)
                                  for t in (x, gamma, beta, r)])
        if dev != "cpu":
            torch.cuda.synchronize()
            assert tbn.launches == before + 1
        res[str(dev)] = (out.detach().float().cpu(),
                         [None if t is None else t.float().cpu()
                          for t in grads],
                         [t.cpu() for t in outs["stats"]])
    (o1, g1, s1), (o2, g2, s2) = res[str(cuda)], res["cpu"]
    assert float((o1 - o2).norm() / o2.norm()) <= 2 ** -8
    for a, b in zip(g1, g2):
        if b is not None:
            assert float((a - b).norm() / b.norm()) <= 2 ** -8
    for a, b in zip(s1, s2):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mp", [False, True], ids=["f32", "bf16"])
def test_resnet20_fit_on_the_card_matches_the_cpu(cuda, mp):
    """CIFAR ResNet-20, batch 4, three SGD steps (lr 0.01, momentum 0.9,
    ``multi_precision`` for bf16) by ``Module.fit`` at tier auto, from
    one Xavier(in, 2) draw with BatchNorm betas uniform(-0.1, 0.1): 19
    B1 launches a step on the card, masters f32; parameters and moving
    statistics within 1e-4 (f32) or a relative L2 error of 0.05 per
    tensor (bf16, the bound the CPU parity test holds against the JAX
    package)."""
    sym = mt.models.resnet(num_layers=20, num_classes=10,
                           image_shape=(3, 32, 32))
    init = mt.mod.Module(sym, context="cpu")
    init.bind([("data", (4, 3, 32, 32))], [("softmax_label", (4,))])
    init.init_params(mt.init.Xavier(factor_type="in", magnitude=2.0,
                                    seed=0))
    args, aux = init.get_params()
    g = torch.Generator().manual_seed(3)
    for k in sorted(args):
        if k.endswith("_beta"):
            args[k] = torch.rand(args[k].shape, generator=g) * 0.2 - 0.1
    rng = np.random.RandomState(1)
    X = rng.randn(12, 3, 32, 32).astype(np.float32)
    Y = rng.randint(0, 10, (12,)).astype(np.float32)
    got = {}
    for dev in ("cpu", cuda):
        mod = mt.mod.Module(sym, context=dev)
        before = dict(tbn.launches_by_kernel)
        mod.fit(mt.io.NDArrayIter(X, Y, batch_size=4), num_epoch=1,
                kvstore="tpu_sync", optimizer="sgd",
                optimizer_params={"learning_rate": 0.01, "momentum": 0.9,
                                  "multi_precision": mp},
                arg_params=args, aux_params=aux, eval_metric=None)
        if dev != "cpu":
            torch.cuda.synchronize()
            n = sum(tbn.launches_by_kernel[k] - before[k] for k in before)
            assert n == 3 * 19
        a, x = mod.get_params()
        assert all(v.dtype == torch.float32 for v in list(a.values())
                   + list(x.values()))
        got[str(dev)] = {k: v.cpu() for k, v in {**a, **x}.items()}
    for k, v in got["cpu"].items():
        w = got[str(cuda)][k]
        if mp:
            assert float((w - v).norm() / v.norm()) <= 0.05, k
        else:
            torch.testing.assert_close(w, v, rtol=0, atol=1e-4)


@pytest.mark.parametrize("shape", [(8192, 3072), (1000, 3000), (3, 5, 7),
                                   (2, 9)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["relu", "gelu", "identity"])
@pytest.mark.parametrize("with_scale", [False, True])
def test_scale_bias_act_matches_plain(cuda, shape, dtype, act, with_scale):
    g = torch.Generator().manual_seed(shape[-1])
    F = shape[-1]
    x = torch.randn(shape, generator=g).to(cuda, dtype)
    sc = (torch.rand(F, generator=g) * 2 - 0.5).to(cuda) if with_scale \
        else None
    b = torch.randn(F, generator=g).to(cuda)
    before = tmlp.launches
    got = tmlp.fused_scale_bias_act(x, sc, b, act=act)
    torch.cuda.synchronize()
    assert tmlp.launches == before + 1
    _assert_kernel_matches_plain(got, tmlp._plain_scale_bias_act(
        x, sc, b, act))
    # the backward is the reference's vjp on either device
    out, grads = _grads(lambda a, s, c: tmlp.fused_scale_bias_act(
        a, s, c, act=act), x, sc, b)
    _out, want = _grads(lambda a, s, c: tmlp._reference(a, s, c, act),
                        x, sc, b)
    for got_g, want_g in zip(grads, want):
        if want_g is not None:
            torch.testing.assert_close(got_g, want_g, rtol=1e-6, atol=1e-6)


def test_scale_bias_act_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.randn(4, 8, device=cuda)
    b = torch.randn(8, device=cuda)
    for bad in (x.t(), x.half()):
        with pytest.raises(mt.MXNetError):
            tmlp._launch(bad, None, b[:bad.shape[-1]], "relu",
                         tmlp.DEFAULT_CONFIG)
    with pytest.raises(mt.MXNetError, match="bias must be"):
        tmlp._launch(x, None, b.cpu(), "relu", tmlp.DEFAULT_CONFIG)
    with pytest.raises(mt.MXNetError, match="unsupported activation"):
        tmlp._launch(x, None, b, "swish", tmlp.DEFAULT_CONFIG)


@pytest.mark.parametrize("case", [
    ((2, 3, 128, 64), (2, 3, 128, 64), True),
    ((2, 3, 128, 64), (2, 3, 128, 64), False),
    ((1, 2, 100, 64), (1, 2, 100, 64), True),
    ((1, 2, 100, 64), (1, 2, 60, 64), True),
    ((1, 2, 60, 32), (1, 2, 100, 32), True),
    ((2, 2, 37, 8), (2, 2, 90, 8), False),
    ((1, 2, 300, 64), (1, 2, 300, 64), True),
    ((1, 2, 200, 64), (1, 2, 72, 64), True),
    ((1, 2, 130, 128), (1, 2, 130, 128), True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_matches_plain(cuda, case, dtype):
    qs, ks, causal = case
    g = torch.Generator().manual_seed(qs[2] + ks[2])
    q = torch.randn(qs, generator=g).to(cuda, dtype)
    k, v = (torch.randn(ks, generator=g).to(cuda, dtype) for _ in range(2))
    before = tpf.launches
    got = tpf.flash_attention(q, k, v, 128, 128, causal)
    torch.cuda.synchronize()
    assert tpf.launches == before + 1
    _assert_attn_close(got, blockwise_attention(q, k, v, tpf.KV_TILE,
                                                causal))
    if causal and qs[2] > ks[2]:
        assert bool((got[:, :, :qs[2] - ks[2]] == 0).all())
    if dtype == torch.float32:
        _out, grads = _grads(lambda a, b, c: tpf.flash_attention(
            a, b, c, 128, 128, causal), q, k, v)
        _out, want = _grads(lambda a, b, c: blockwise_attention(
            a, b, c, 128, causal), q, k, v)
        for got_g, want_g in zip(grads, want):
            torch.testing.assert_close(got_g, want_g, rtol=1e-4, atol=2e-5)


def test_flash_fwd_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.randn(1, 2, 8, 16, device=cuda)
    with pytest.raises(mt.MXNetError):
        tpf._launch(q.half(), q.half(), q.half(), True)
    with pytest.raises(mt.MXNetError):
        tpf._launch(q.transpose(2, 3), q, q, True)
    big = torch.randn(1, 1, 8, 192, device=cuda)
    with pytest.raises(mt.MXNetError, match="head_dim"):
        tpf._launch(big, big, big, False)


def test_flash_attn_and_take_rows_backwards_on_the_card(cuda):
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 3, 128, 64, generator=g).to(cuda)
               for _ in range(3))
    _o, grads = _grads(lambda a, b, c: tattn.flash_attention(
        a, b, c, causal=True), q, k, v)
    _o, want = _grads(lambda a, b, c: tattn.reference_attention(
        a, b, c, True), q, k, v)
    for got_g, want_g in zip(grads, want):
        torch.testing.assert_close(got_g, want_g, rtol=1e-4, atol=2e-5)
    table = torch.randn(500, 768, generator=g).to(cuda)
    ids = torch.randint(-20, 520, (8, 64), generator=g).to(cuda)
    _o, (dw, _) = _grads(lambda w, i: ttake.take_rows(w, i), table, ids)
    _o, (want_dw, _) = _grads(lambda w, i: ttake._plain_take(w, i), table,
                              ids)
    torch.testing.assert_close(dw, want_dw, rtol=1e-5, atol=1e-5)


def test_gpt_fit_on_the_card_matches_the_cpu(cuda):
    """Two layers of the GPT at T 128, batch 2, two Adam steps at tier
    auto: the card (kernels) and the CPU (plain versions) end within
    1e-4 of each other, and every step launched each kernel."""
    vocab, dim, heads, layers, T, B = 512, 256, 4, 2, 128, 2
    net = mt.models.gpt_lm(vocab, dim, heads, layers, T)
    rng = np.random.RandomState(0)
    xs, ys = zip(*[mt.models.make_copy_batch(rng, B, T, vocab, 17)
                   for _ in range(2)])
    X, Y = np.concatenate(xs), np.concatenate(ys)
    params = {}
    for dev in ("cpu", cuda):
        mod = mt.mod.Module(net, context=dev)
        before = (tmlp.launches, tattn.launches_by_kernel["flash_attn"],
                  ttake.launches)
        mod.fit(mt.io.NDArrayIter(X, Y, batch_size=B), num_epoch=1,
                kvstore="tpu_sync", optimizer="adam",
                optimizer_params={"learning_rate": 3e-4, "wd": 0.01,
                                  "epsilon": 1e-4},
                initializer=mt.init.Xavier(seed=0), eval_metric=None)
        after = (tmlp.launches, tattn.launches_by_kernel["flash_attn"],
                 ttake.launches)
        if dev != "cpu":
            assert [a - b for a, b in zip(after, before)] == \
                [2 * layers, 2 * layers, 2]
        params[str(dev)] = {k: v.cpu() for k, v in mod.get_params()[0]
                            .items()}
    for k, v in params["cpu"].items():
        torch.testing.assert_close(params[str(cuda)][k], v, rtol=0,
                                   atol=1e-4)


def _gluon_step_grads(net, ctx, xb, yb, lag, masks=None):
    """One forward and backward of the Gluon GPT on (xb, yb): the loss,
    every gradient and each block's ReLU input, on the CPU. ``masks``
    (one per block) replace each MLP's ReLU by ``x * mask``: the same
    forward up to the sign decisions, with the decisions given."""
    acts = [blk.mlp1.act for blk in net.blocks]
    seen = []
    for act, m in zip(acts, masks or [None] * len(acts)):
        act.register_forward_pre_hook(
            lambda _b, args: seen.append(args[0].detach().cpu()))
        if m is not None:
            act.hybrid_forward = (lambda F, x, _m=m: x * _m.to(x.device))
    try:
        x, y = mt.nd.array(xb, ctx=ctx), mt.nd.array(yb, ctx=ctx)
        with mt.autograd.record():
            loss = mt.gluon.loss.SoftmaxCrossEntropyLoss()(
                net(x)[:, lag:, :], y[:, lag:]).mean()
        loss.backward()
    finally:
        for act in acts:
            act._forward_pre_hooks.clear()
            act.__dict__.pop("hybrid_forward", None)
    grads = {n[len(net.prefix):]: p.grad()._data.detach().cpu().clone()
             for n, p in net.collect_params().items()}
    return float(loss.asnumpy()), grads, seen


def test_gluon_gpt_hybridized_on_the_card_matches_the_cpu(cuda):
    """The example's GPT through Gluon (``tests/gluon_gpt.py``),
    hybridized, at dim 128, 4 heads, 2 layers, T 128, batch 2, two Adam
    steps at tier auto from the same weights: every step on the card
    launches ``flash_attn`` once a layer and ``take_rows`` once, and
    never ``scale_bias_act`` (Gluon does not fuse bias and ReLU) or
    ``flash_fwd``. Step 1's gradients on the card are within 1e-3 of
    each tensor's largest magnitude of the CPU's taking the card's ReLU
    decisions (a ReLU input within f32 noise of 0 may open on one side
    only: at most 4 such flips, each within 1e-4 of its tensor's
    largest magnitude from 0); the losses end within 1e-4 relative and
    the parameters within 1e-4 of the CPU's (plain versions)."""
    from gluon_gpt import gpt_classes, make_copy_batch
    _a, _b, GPT = gpt_classes(mt, mt.gluon, mt.gluon.nn)
    vocab, dim, heads, layers, T, B, lag = 512, 128, 4, 2, 128, 2, 17
    rng = np.random.RandomState(0)
    batches = [make_copy_batch(rng, B, T, vocab, lag) for _ in range(2)]
    runs, nets, p0 = {}, {}, None
    for ctx in (mt.cpu(), mt.gpu(0)):
        net = nets[ctx.device_type] = GPT(vocab, dim, heads, layers, T)
        net.initialize(mt.init.Xavier(seed=0), ctx=ctx)
        net.hybridize()
        with mt.autograd.predict_mode():
            net(mt.nd.array(batches[0][0], ctx=ctx))
        rel = {n[len(net.prefix):]: p
               for n, p in net.collect_params().items()}
        if p0 is None:
            p0 = {k: p.data().asnumpy() for k, p in rel.items()}
        mt.gluon.utils.params_from_reference(net, p0)
        trainer = mt.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": 3e-4, "wd": 0.01,
                                    "epsilon": 1e-4})
        losses, grads1, pre1 = [], None, None
        for step, (xb, yb) in enumerate(batches):
            before = (tmlp.launches, tattn.launches_by_kernel["flash_attn"],
                      ttake.launches, tpf.launches)
            loss, grads, pre = _gluon_step_grads(net, ctx, xb, yb, lag)
            trainer.step(1)
            losses.append(loss)
            if step == 0:
                grads1, pre1 = grads, pre
            after = (tmlp.launches, tattn.launches_by_kernel["flash_attn"],
                     ttake.launches, tpf.launches)
            if ctx.device_type == "gpu":
                assert [a - b for a, b in zip(after, before)] == \
                    [0, layers, 1, 0]
        runs[ctx.device_type] = (losses, {k: p.data()._data.cpu().clone()
                                          for k, p in rel.items()},
                                 grads1, pre1)
    (lc, pc, _gc, prc), (lg, pg, gg, prg) = runs["cpu"], runs["gpu"]
    assert len(prc) == len(prg) == layers
    flips = [(a > 0) != (b > 0) for a, b in zip(prc, prg)]
    assert sum(int(f.sum()) for f in flips) <= 4
    for a, b, f in zip(prc, prg, flips):
        if f.any():
            far = torch.maximum(a.abs(), b.abs())[f].max()
            assert float(far / a.abs().max().clamp_min(1e-30)) <= 1e-4
    cpu = nets["cpu"]
    mt.gluon.utils.params_from_reference(cpu, p0)
    _l, want, _p = _gluon_step_grads(cpu, mt.cpu(), *batches[0], lag,
                                      masks=[(b > 0).float() for b in prg])
    for k, v in want.items():
        err = float((gg[k] - v).abs().max()
                    / v.abs().max().clamp_min(1e-30))
        assert err <= 1e-3, (k, err)
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    for k, v in pc.items():
        torch.testing.assert_close(pg[k], v, rtol=0, atol=1e-4)


# ---------------------------------------------------------- int8_dequant
def _dequant_case(R, S, per_row, device, seed=0, n_coef=None):
    g = torch.Generator().manual_seed(seed)
    acc = torch.randint(-2 ** 22, 2 ** 22, (R, S), generator=g,
                        dtype=torch.int32)
    n = n_coef or (R if per_row else S)
    sc = torch.rand(n, generator=g) * 2e-3 - 5e-4
    sh = torch.randn(n, generator=g)
    return acc.to(device), sc.to(device), sh.to(device)


def _assert_dequant_close(y, ref, acc, sc, per_row):
    C = sc.numel()
    coef = (sc.reshape(1, C, 1).expand(acc.shape[0] // C, C, 1)
            .reshape(-1, 1) if per_row else sc.reshape(1, -1))
    prod = (acc.float() * coef).abs()
    big = torch.maximum(prod, ref.abs())
    tol = torch.nextafter(big, torch.full_like(big, float("inf"))) - big
    diff = (y.double() - ref.double()).abs()
    assert bool((diff <= tol.double()).all()), float((diff / tol).max())
    assert float((y == ref).float().mean()) >= 0.99


@pytest.mark.parametrize("R,S", [(32 * 2048, 49), (32 * 49, 2048),
                                 (1, 1000), (37, 29), (3, 1)])
@pytest.mark.parametrize("per_row", [True, False])
@pytest.mark.parametrize("act", ["relu", "identity"])
def test_int8_dequant_matches_plain(cuda, R, S, per_row, act):
    acc, sc, sh = _dequant_case(R, S, per_row, cuda, seed=R + S)
    before = tdq.launches_by_kernel["%s/%s" % ("row" if per_row
                                               else "column", act)]
    y = tdq._launch(acc, sc, sh, per_row, act, tdq.DEFAULT_CONFIG)
    torch.cuda.synchronize()
    assert tdq.launches_by_kernel["%s/%s" % ("row" if per_row
                                             else "column", act)] \
        == before + 1
    _assert_dequant_close(y, tdq._plain_dequant(acc, sc, sh, per_row, act),
                          acc, sc, per_row)


def test_int8_dequant_untiled_rows_misaligned_and_small_grids(cuda):
    acc, sc, sh = _dequant_case(6 * 64, 49, True, cuda, seed=1, n_coef=64)
    y = tdq._launch(acc, sc, sh, True, "relu", tdq.DEFAULT_CONFIG)
    _assert_dequant_close(y, tdq._plain_dequant(acc, sc, sh, True, "relu"),
                          acc, sc, True)
    # an accumulator 4 bytes past an aligned address takes the scalar loop
    base, sc, sh = _dequant_case(1, 1 + 50 * 64, False, cuda, seed=2)
    acc = base[0, 1:].view(50, 64)
    sc, sh = sc[:64].contiguous(), sh[:64].contiguous()
    y = tdq._launch(acc, sc, sh, False, "identity", tdq.DEFAULT_CONFIG)
    _assert_dequant_close(y, tdq._plain_dequant(acc, sc, sh, False,
                                                "identity"), acc, sc, False)
    acc, sc, sh = _dequant_case(50, 51, False, cuda, seed=3)
    y = tdq._launch(acc, sc, sh, False, "relu",
                    {"threads": 64, "max_blocks": 3})
    torch.cuda.synchronize()
    _assert_dequant_close(y, tdq._plain_dequant(acc, sc, sh, False, "relu"),
                          acc, sc, False)


def test_int8_dequant_refuses_what_the_kernel_does_not_take(cuda):
    acc, sc, sh = _dequant_case(8, 8, False, cuda)
    for bad in (acc.t(), acc.long()):
        with pytest.raises(mt.MXNetError):
            tdq._launch(bad, sc, sh, False, "relu", tdq.DEFAULT_CONFIG)
    with pytest.raises(mt.MXNetError, match="sc must be"):
        tdq._launch(acc, sc.cpu(), sh, False, "relu", tdq.DEFAULT_CONFIG)
    with pytest.raises(mt.MXNetError, match="must divide"):
        tdq._launch(acc, sc[:3], sh[:3], True, "relu", tdq.DEFAULT_CONFIG)


@pytest.mark.parametrize("case", [((1, 3, 224, 224), 64, (7, 7), (2, 2),
                                   (3, 3)),
                                  ((2, 64, 56, 56), 64, (3, 3), (1, 1),
                                   (1, 1)),
                                  ((2, 256, 56, 56), 512, (1, 1), (2, 2),
                                   (0, 0)),
                                  ((1, 512, 7, 7), 2048, (1, 1), (1, 1),
                                   (0, 0)),
                                  ((3, 2048), 1000, None, None, None)])
def test_int_mm_on_the_card_is_the_cpus(cuda, case):
    """The int32 accumulators of the int8 product, through the same
    padding helper, on the card and on the CPU: bitwise."""
    shape, O, kernel, stride, pad = case
    g = torch.Generator().manual_seed(len(shape) + O)
    xq = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
    K = shape[1] * (kernel[0] * kernel[1] if kernel else 1)
    w = torch.randint(-127, 128, (O, K), generator=g, dtype=torch.int8)
    accs = []
    for dev in ("cpu", cuda):
        x = xq.to(dev)
        p = (tqs._patches(x, kernel, stride, pad, (1, 1)) if kernel
             else x)
        accs.append(tqs._int8_matmul(p, w.to(dev)).cpu())
    assert torch.equal(accs[0], accs[1])


def test_resnet20_int8_on_the_card_matches_the_cpu(cuda, tmp_path):
    sym = mt.models.resnet(num_layers=20, num_classes=10,
                           image_shape=(3, 32, 32))
    shapes, _, aux_shapes = sym.infer_shape(data=(2, 3, 32, 32))
    rng = np.random.RandomState(0)
    args = {n: rng.uniform(-0.5, 0.5, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}
    aux = {n: (rng.rand(*s) + 0.5).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    calib = [rng.randn(4, 3, 32, 32).astype(np.float32) for _ in range(2)]
    path = str(tmp_path / "r20.int8.mxtorch")
    meta = mt.quant.export_quantized(sym, args, aux, calib,
                                     {"data": (None, 3, 32, 32)}, path)
    assert meta["kernel_tier"]["kernels"] == {"int8_dequant": 23}
    x = rng.randn(3, 3, 32, 32).astype(np.float32)
    before = tdq.launches
    srv = mt.serve.Server(path, buckets=(1, 4), batch_timeout_ms=0)
    try:
        got = srv.predict(data=x, timeout_ms=60000)[0]
    finally:
        srv.close()
    # one warmup and one request at bucket 4, 23 sites each
    assert tdq.launches - before == 2 * 23
    want = mt.serving.CompiledModel.load(path, device="cpu").predict(
        data=x)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# ------------------------------------------- B1's op surface, the key chain
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("training", [True, False])
def test_fused_bn_act_op_launches_b1_once_on_the_card(cuda, dtype, residual,
                                                       training):
    """``nd.contrib.FusedBNAct`` on CUDA tensors: one B1 launch a call,
    the output against the op's plain version on the CPU (the kernel's
    tolerance), the moving statistics written back in training only."""
    g = torch.Generator(device="cpu").manual_seed(7)
    shape = (4, 8, 6, 5)
    host = [torch.randn(shape, generator=g).to(dtype)] \
        + [torch.rand(8, generator=g) + 0.5 for _ in range(2)] \
        + [0.3 * torch.randn(8, generator=g), torch.rand(8, generator=g)
           + 0.5] + ([torch.randn(shape, generator=g).to(dtype)]
                     if residual else [])
    outs = {}
    for where in ("cuda", "cpu"):
        ins = [mt.nd.NDArray(t.to(where).clone()) for t in host]
        ins[0].attach_grad()
        before = tbn.launches
        with mt.autograd.record(train_mode=training):
            y = mt.nd.contrib.FusedBNAct(*ins, act="relu", fix_gamma=False)
        y.backward()
        torch.cuda.synchronize()
        assert tbn.launches - before == (1 if where == "cuda" else 0)
        outs[where] = [y.data.detach().cpu(), ins[3].data.cpu(),
                       ins[4].data.cpu(), ins[0].grad.data.cpu()]
    _assert_kernel_matches_plain(outs["cuda"][0], outs["cpu"][0])
    for a, b in zip(outs["cuda"][1:3], outs["cpu"][1:3]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert torch.equal(outs["cuda"][1], host[3]) != training
    tol = 1e-5 if dtype == torch.float32 else 2 ** -6
    torch.testing.assert_close(outs["cuda"][3].float(),
                               outs["cpu"][3].float(), rtol=tol, atol=tol)


def test_key_chain_draws_on_the_card_equal_the_cpus(cuda):
    """After ``random.seed(0)``: uniform, randint, Dropout masks and
    shuffles bitwise; normal draws within 4 f32 ulp."""
    def draws(ctx):
        mt.random.seed(0)
        x = mt.nd.array(np.linspace(1, 2, 300).reshape(20, 15), ctx=ctx)
        return [mt.nd.random.uniform(shape=(5000,), ctx=ctx).asnumpy(),
                mt.nd.random.randint(-3, 70, shape=(5000,), ctx=ctx)
                .asnumpy(),
                mt.nd.Dropout(x, p=0.3, mode="always").asnumpy(),
                mt.nd.random.shuffle(x).asnumpy(),
                mt.nd.random.normal(shape=(5000,), ctx=ctx).asnumpy()]
    card, host = draws(mt.gpu(0)), draws(mt.cpu())
    for a, b in zip(card[:4], host[:4]):
        np.testing.assert_array_equal(a, b)
    ia = card[4].view(np.int32).astype(np.int64)
    ib = host[4].view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    assert np.abs(ia - ib).max() <= 4


# --------------------------------------------------- grouped dispatch (A1b)
def _grouped_mlp():
    data = mt.sym.Variable("data")
    net = mt.sym.FullyConnected(data, num_hidden=64, name="fc1")
    net = mt.sym.BatchNorm(net, name="bn1")
    net = mt.sym.Activation(net, act_type="relu")
    net = mt.sym.Dropout(net, p=0.5)
    net = mt.sym.FullyConnected(net, num_hidden=10, name="fc2")
    return mt.sym.SoftmaxOutput(net, name="softmax")


def _grouped_fit(k, ctx, n=12, metric=None):
    rng = np.random.RandomState(0)
    X = rng.randn(n * 32, 16).astype(np.float32)
    Y = rng.randint(0, 10, (n * 32,)).astype(np.float32)
    mod = mt.mod.Module(_grouped_mlp(), context=ctx)
    mt.random.seed(3)
    mod.fit(mt.io.NDArrayIter(X, Y, batch_size=32), num_epoch=2,
            kvstore="tpu_sync", optimizer="adam",
            optimizer_params={"learning_rate": 0.01},
            initializer=mt.init.Xavier(seed=0), eval_metric=metric,
            steps_per_dispatch=k)
    args, aux = mod.get_params()
    state = {k_: v.cpu() for k_, v in {**args, **aux}.items()}
    return mod, state, mt.random.get_state()[0].copy()


def test_grouped_graph_replay_matches_the_eager_steps(cuda):
    """K = 4 over 12 batches, 2 epochs, on the card: one graph captured
    after 2 warm-up steps and replayed 46 times; weights, moving
    statistics, outputs, the device metric and the key chain bitwise
    those of the eager per-step run on the card (Dropout's masks drawn
    from staged keys inside the graph)."""
    runs = {}
    for k in (1, 4):
        m = mt.metric.create(["acc", "ce"])
        mod, state, chain = _grouped_fit(k, cuda, metric=m)
        runs[k] = (state, chain, m.get_name_value(),
                   mod.get_outputs()[0].cpu(), mod._fused)
    (s1, c1, m1, o1, f1), (s4, c4, m4, o4, f4) = runs[1], runs[4]
    assert (f4.captures, f4.eager_steps, f4.replays) == (1, 2, 22)
    assert f1.captures == 0 and f1.eager_steps == 24
    for k in s1:
        assert torch.equal(s4[k], s1[k]), k
    assert torch.equal(o4, o1)
    np.testing.assert_array_equal(c4, c1)
    assert m4 == m1


def test_grouped_capture_failure_raises(cuda, monkeypatch):
    """A step that reads the card from the host cannot be captured:
    run_k raises MXNetError naming the capture, and runs no eager step
    in the graph's place."""
    mod = mt.mod.Module(_grouped_mlp(), context=cuda)
    mod.bind([("data", (32, 16))], [("softmax_label", (32,))])
    mod.init_params(mt.init.Xavier(seed=0))
    mod.init_optimizer(kvstore="tpu_sync", optimizer="sgd")
    ex = mod._exec
    real = ex._run

    def reads_back(*a, **kw):
        outs, auxu = real(*a, **kw)
        float(outs[0].sum())
        return outs, auxu
    monkeypatch.setattr(ex, "_run", reads_back)
    X = np.zeros((4 * 32, 16), np.float32)
    Y = np.zeros(4 * 32, np.float32)
    with pytest.raises(mt.base.MXNetError, match="capturing the fused step"):
        mod.fit(mt.io.NDArrayIter(X, Y, batch_size=32), num_epoch=1,
                eval_metric=None, steps_per_dispatch=4)
    assert mod._fused.eager_steps == 2 and mod._fused.replays == 0


# ------------------------------------------------- recommend (B2 on embed)
@pytest.mark.parametrize("rows,n_ids", [(1024, 1024), (8192, 512)])
def test_take_rows_at_the_recommend_shapes(cuda, rows, n_ids):
    """B2 at 256-byte rows: the served lookup's (1024, 64) cache by a
    (16 x 64) slot matrix, and the training cache's (8192, 64) by 512
    ids; out-of-range ids included. Bitwise the plain gather."""
    g = torch.Generator().manual_seed(rows)
    table = torch.randn(rows, 64, generator=g).to(cuda)
    ids = torch.randint(-40, rows + 40, (n_ids,), generator=g,
                        dtype=torch.int32).to(cuda)
    before = ttake.launches
    got = ttake.take_rows(table, ids)
    torch.cuda.synchronize()
    assert ttake.launches == before + 1
    assert torch.equal(got, ttake._plain_take(table, ids))


def test_recommend_batch_on_the_card_matches_the_cpu(cuda, tmp_path):
    """One recommend batch through the engine on the card and on the
    CPU: the same items, scores within rtol 1e-5, one B2 launch, one
    recorded d2h, the buffer in place and the discipline clean."""
    from mxnet_tpu_torch import embed, profiler
    from mxnet_tpu_torch.embed import serve as eserve
    path = str(tmp_path / "reco.mxtorch")
    eserve.export_recommend(embed.row_init(1, np.arange(4096), 64),
                            embed.row_init(2, np.arange(512), 64), path,
                            max_ids=64, k=10)
    rng = np.random.RandomState(0)
    lists = [((rng.zipf(1.3, size=n) - 1) % 4096).tolist()
             for n in (1, 5, 64, 70, 8, 3)]
    cpu = mt.serving.load_artifact(path, device="cpu").engine()
    card = mt.serving.load_artifact(path, device=cuda).engine()
    ptr = card.cache.buf.data_ptr()
    want_s, want_i = cpu.recommend_batch(lists)
    profiler.reset_sync_counters()
    before = ttake.launches
    got_s, got_i = card.recommend_batch(lists)
    assert ttake.launches == before + 1
    assert profiler.sync_counters()["d2h"] == 1
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5)
    assert card.cache.buf.data_ptr() == ptr
    assert card.stats() == cpu.stats()
    assert card.check_discipline() == []


@pytest.mark.parametrize("mode,bi", [("lstm", False), ("lstm", True),
                                     ("gru", True)])
def test_fused_rnn_layer_on_the_card_matches_the_cpu(cuda, mode, bi):
    """A gluon.rnn layer (2 layers, NTC, dropout 0.3 between them) on the
    card against the CPU from the same weights and the same key chain:
    outputs, states and every gradient within 1e-5 of each tensor's
    largest magnitude (the dropout masks drawn on either device are the
    same bits)."""
    make = {"lstm": mt.gluon.rnn.LSTM, "gru": mt.gluon.rnn.GRU}[mode]
    rng = np.random.RandomState(0)
    x = rng.randn(3, 7, 5).astype("f4")
    res, w = {}, None
    for ctx in (mt.cpu(), mt.gpu(0)):
        layer = make(16, num_layers=2, layout="NTC", dropout=0.3,
                     bidirectional=bi, input_size=5)
        layer.initialize(mt.init.Xavier(seed=0), ctx=ctx)
        rel = {n[len(layer.prefix):]: p
               for n, p in layer.collect_params().items()}
        if w is None:
            w = {k: p.data()._data.detach().cpu() for k, p in rel.items()}
        for k, p in rel.items():
            p.set_data(mt.nd.NDArray(w[k].to(p.data()._data.device)))
        states = layer.begin_state(3, ctx=ctx)
        xs = mt.nd.array(x, ctx=ctx)
        xs.attach_grad()
        mt.random.seed(11)
        with mt.autograd.record():
            out, new = layer(xs, states)
            loss = (out * out).sum() + sum(s.sum() for s in new)
        loss.backward()
        res[ctx.device_type] = [t.detach().cpu() for t in
                                [out._data] + [s._data for s in new]
                                + [xs.grad._data]
                                + [p.grad()._data for p in rel.values()]]
    for a, b in zip(res["gpu"], res["cpu"]):
        scale = b.abs().max().clamp_min(1e-30)
        assert float((a - b).abs().max() / scale) < 1e-5


def test_word_language_model_launches_b2_once_a_step_on_the_card(cuda):
    """examples/word_language_model.py's model (tests/gluon_lstm_lm.py),
    tied, dropout 0.5, at vocab 1000, emsize = nhid = 64: every training
    step launches B2 once (the encoder; the tied decoder's product reads
    the same weight), with no kernel-tier fallback, and the losses stay
    finite."""
    from gluon_lstm_lm import lm_step, rnn_model_class
    from mxnet_tpu_torch.kernels import tier
    ctx = mt.gpu(0)
    model = rnn_model_class(mt.gluon)(1000, 64, 64, 2, 0.5, True)
    model.initialize(mt.init.Xavier(seed=0), ctx=ctx)
    trainer = mt.gluon.Trainer(model.collect_params(), "sgd",
                               {"learning_rate": 2.0})
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    toks = np.random.RandomState(0).randint(0, 1000, (8, 4 * 20 + 1))
    hidden = model.begin_state(8, ctx)
    tier.reset_stats()
    for b in range(4):
        before = ttake.launches
        X = mt.nd.array(toks[:, b * 20:(b + 1) * 20], ctx=ctx)
        Y = mt.nd.array(toks[:, b * 20 + 1:(b + 1) * 20 + 1], ctx=ctx)
        loss, hidden = lm_step(mt.gluon, mt.autograd, model, trainer,
                               loss_fn, X, Y, hidden, 0.25, 8)
        assert np.isfinite(loss.asnumpy()).all()
        assert ttake.launches == before + 1
    st = tier.stats()
    assert st["fallback"] == {}
    assert st["dispatch"]["take_rows"] == 4


# ------------------------------------------------ the record pipeline (A5)
def _fixture():
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "data", "jpeg_fixture"))
    try:
        import fixture
    finally:
        sys.path.pop(0)
    return fixture.load(), fixture.load_blocks()


def _decode(jpegs, dev):
    """``BatchDecoder.decode`` of ``jpegs`` on the card -> (h, w, 3)
    uint8 tensors of their pixels."""
    from mxnet_tpu_torch.kernels import nvjpeg
    infos = [nvjpeg.image_info(j, record=i) for i, j in enumerate(jpegs)]
    dec = nvjpeg.BatchDecoder()
    try:
        buf, boff = dec.decode(jpegs, infos, dev,
                               records=list(range(len(jpegs))))
        outs = [buf[o:o + 3 * h * w].view(h, w, 3).clone()
                for o, (_ss, h, w) in zip(boff.tolist(), infos)]
    finally:
        torch.cuda.synchronize()
        dec.close()
    return outs


def test_nvjpeg_decodes_the_fixture_within_the_bound_of_cv2s_pixels(cuda):
    """Over the 16 fixture JPEGs (4:2:0 and 4:4:4, qualities 75-95) the
    card's decode (nvJPEG's planes, then jpeg_color) is within a mean of
    1.0 and a 99.9th percentile of 8 levels of cv2's pixels in every
    channel; the block JPEGs, which decode exactly, are bitwise cv2's."""
    from mxnet_tpu_torch.kernels import nvjpeg
    fx, blocks = _fixture()
    before = nvjpeg.decodes
    outs = _decode([j for j, _, _ in fx], cuda)
    assert nvjpeg.decodes == before + len(fx)
    d = np.concatenate([np.abs(o.cpu().numpy().astype(np.int16)
                               - px.astype(np.int16)).reshape(-1, 3)
                        for o, (_j, px, _e) in zip(outs, fx)])
    assert d.mean(0).max() <= 1.0
    assert np.percentile(d, 99.9, axis=0).max() <= 8
    for o, (_j, px, _e) in zip(_decode([j for j, _, _ in blocks], cuda),
                               blocks):
        assert torch.equal(o.cpu(), torch.from_numpy(px))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_image_aug_kernel_is_bitwise_its_plain_version(cuda, dtype):
    """The ImageNet recipe (224 crops, mirrors) and the CIFAR recipe (pad
    4, fill 255, mean/std, 32 crops) on the decoded fixture; one launch
    a call."""
    from mxnet_tpu_torch.kernels import image_aug
    imgs = _decode([j for j, _, _ in _fixture()[0]], cuda)
    rng = np.random.RandomState(0)
    for shape, kw in (((3, 224, 224), {}),
                      ((3, 32, 32), dict(pad=4, fill=255,
                                         mean=(125.3, 123.0, 113.9),
                                         std=(63.0, 62.1, 66.7)))):
        pad = kw.get("pad", 0)
        crops = [(rng.randint(0, im.shape[0] + 2 * pad - shape[1] + 1),
                  rng.randint(0, im.shape[1] + 2 * pad - shape[2] + 1),
                  rng.rand() < 0.5) for im in imgs]
        out = torch.empty((len(imgs),) + shape, dtype=dtype, device=cuda)
        before = image_aug.launches
        image_aug.augment(imgs, crops, out, **kw)
        assert image_aug.launches == before + 1
        want = torch.empty((len(imgs),) + shape, dtype=dtype)
        image_aug.augment([im.cpu() for im in imgs], crops, want, **kw)
        iv = torch.int32 if dtype == torch.float32 else torch.int16
        assert torch.equal(out.cpu().view(iv), want.view(iv))
    with pytest.raises(mt.MXNetError, match="does not fit"):
        image_aug.augment(imgs[:1], [(999, 0, False)],
                          torch.empty((1, 3, 8, 8), device=cuda))


def test_jpeg_color_kernel_is_bitwise_its_plain_version(cuda):
    from mxnet_tpu_torch.kernels import jpeg_color
    rng = np.random.RandomState(1)
    items = []
    for (h, w), mode in (((41, 57), 3), ((41, 57), 2), ((9, 3), 3),
                         ((30, 31), 1), ((17, 16), 2)):
        ch, cw = jpeg_color.chroma_shape(h, w, mode)
        planes = [torch.from_numpy(rng.randint(0, 256, s).astype(np.uint8))
                  for s in ((h, w), (ch, cw), (ch, cw))]
        items.append((planes, mode))
    outs = [torch.empty(p[0].shape + (3,), dtype=torch.uint8, device=cuda)
            for p, _m in items]
    before = jpeg_color.launches
    jpeg_color.ycc_to_bgr([(p[0].to(cuda), p[1].to(cuda), p[2].to(cuda),
                            o, m) for (p, m), o in zip(items, outs)])
    assert jpeg_color.launches == before + 1
    for (p, m), o in zip(items, outs):
        want = torch.empty_like(o, device="cpu")
        jpeg_color.ycc_to_bgr([(p[0], p[1], p[2], want, m)])
        assert torch.equal(o.cpu(), want)


def _records(tmp_path, fx, n):
    path = str(tmp_path / "r.rec")
    w = mt.recordio.MXIndexedRecordIO(str(tmp_path / "r.idx"), path, "w")
    for i in range(n):
        w.write_idx(i, mt.recordio.pack(
            mt.recordio.IRHeader(0, float(i % 10), i, 0), fx[i % len(fx)][0]))
    w.close()
    return path


def _draws(order, sizes, B, P, seed, epoch, shape, pad=0):
    crops = []
    for b in range(len(order) // B):
        idxs = order[b * B:(b + 1) * B]
        for p in range(P):
            rng = np.random.RandomState(seed + epoch * 1000003 + b * 1009 + p)
            for i in idxs[p * B // P:(p + 1) * B // P]:
                h, w = sizes[i]
                h, w = h + 2 * pad, w + 2 * pad
                crops.append((rng.randint(0, h - shape[1] + 1),
                              rng.randint(0, w - shape[2] + 1),
                              rng.rand() < 0.5))
    return crops


def test_card_record_iter_matches_the_plain_augment_of_cv2s_pixels(
        cuda, tmp_path):
    """Two epochs of the card iterator (shuffled, 3 threads, random crops
    and mirrors, mean/std) against the plain augment of the fixture's cv2
    pixels under the JAX package's order and draws: labels equal, every
    image within the decode bound (a wrong draw is far outside it)."""
    from mxnet_tpu_torch.kernels import image_aug
    fx, _ = _fixture()
    n, B, P, seed = 40, 8, 3, 2
    path = _records(tmp_path, fx, n)
    kw = dict(mean_r=120.0, mean_g=110.0, mean_b=100.0, std_r=50.0,
              std_g=55.0, std_b=60.0)
    it = mt.io.ImageRecordIter(path, (3, 200, 200), B, shuffle=True,
                               rand_crop=True, rand_mirror=True,
                               preprocess_threads=P, seed=seed,
                               ctx=mt.gpu(0), **kw)
    sizes = [fx[i % len(fx)][1].shape[:2] for i in range(n)]
    for epoch in range(2):
        got = [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in it]
        order = np.arange(n)
        np.random.RandomState(seed + epoch).shuffle(order)
        crops = _draws(order, sizes, B, P, seed, epoch, (3, 200, 200))
        want = torch.empty((n, 3, 200, 200))
        image_aug.augment([torch.from_numpy(fx[i % len(fx)][1])
                           for i in order], crops, want,
                          mean=(120.0, 110.0, 100.0), std=(50.0, 55.0, 60.0))
        data = np.concatenate([g[0] for g in got])
        np.testing.assert_array_equal(np.concatenate([g[1] for g in got]),
                                      (order % 10).astype(np.float32))
        d = np.abs(data - want.numpy()) * np.array([50.0, 55.0, 60.0]
                                                   ).reshape(1, 3, 1, 1)
        assert d.mean(axis=(1, 2, 3)).max() <= 1.0
        it.reset()
    it.close()


def test_card_record_iter_matches_the_cpu_iterator(cuda, tmp_path):
    """Where cv2 is installed: the card iterator against the CPU
    iterator (cv2's decode and the JAX package's augmenter) on the same
    records, draws and order, within the decode bound; the CIFAR
    recipe."""
    pytest.importorskip("cv2")
    fx, _ = _fixture()
    path = _records(tmp_path, fx, 24)
    kw = dict(shuffle=True, rand_crop=True, rand_mirror=True, pad=4,
              fill_value=255, preprocess_threads=2, seed=3)
    out = {}
    for ctx in (mt.gpu(0), mt.cpu()):
        it = mt.io.ImageRecordIter(path, (3, 32, 32), 6, ctx=ctx, **kw)
        out[ctx.device_type] = [(b.data[0].asnumpy(), b.label[0].asnumpy())
                                for b in it]
        it.close()
    for (gd, gl), (cd, cl) in zip(out["gpu"], out["cpu"]):
        np.testing.assert_array_equal(gl, cl)
        assert np.abs(gd - cd).mean(axis=(1, 2, 3)).max() <= 1.0


def test_a_png_record_raises_on_the_card_and_cv2_is_not_tried(
        cuda, tmp_path, monkeypatch):
    import struct
    import sys
    import zlib

    def chunk(kind, data):
        body = kind + data
        return struct.pack(">I", len(data)) + body + struct.pack(
            ">I", zlib.crc32(body) & 0xffffffff)
    rows = b"".join(b"\x00" + bytes(range(30)) * 3 for _ in range(40))
    png = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", 30, 40, 8, 2, 0, 0, 0)) + chunk(
        b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b"")
    fx, _ = _fixture()
    path = str(tmp_path / "p.rec")
    w = mt.recordio.MXIndexedRecordIO(str(tmp_path / "p.idx"), path, "w")
    for i, payload in enumerate([fx[0][0], png]):
        w.write_idx(i, mt.recordio.pack(mt.recordio.IRHeader(0, 1.0, i, 0),
                                        payload))
    w.close()
    monkeypatch.setitem(sys.modules, "cv2", None)   # import cv2 fails
    it = mt.io.ImageRecordIter(path, (3, 16, 16), 2, ctx=mt.gpu(0))
    with pytest.raises(mt.MXNetError, match=r"record 1.*A5b"):
        next(it)
    it.close()
    with pytest.raises(mt.MXNetError, match="A5b"):
        mt.io.ImageRecordIter(path, (3, 16, 16), 2, ctx=mt.gpu(0), resize=20)


def test_staged_fit_is_bitwise_the_unstaged_fit_on_the_card(cuda, tmp_path):
    """A two-convolution BatchNorm net fed by the card iterator (the
    CIFAR recipe, batch 8), K = 2 for 3 windows, cuDNN deterministic:
    staged and unstaged fits end with every tensor bitwise equal, and
    the staged one ran through the staged feed."""
    fx, _ = _fixture()
    path = _records(tmp_path, fx, 48)
    sym = mt.sym
    net = sym.Variable("data")
    for i in (1, 2):
        net = sym.Activation(sym.BatchNorm(sym.Convolution(
            net, num_filter=8, kernel=(3, 3), pad=(1, 1), stride=(2, 2),
            name="conv%d" % i), fix_gamma=False, name="bn%d" % i),
            act_type="relu")
    net = sym.FullyConnected(sym.Flatten(sym.Pooling(
        net, global_pool=True, pool_type="avg", kernel=(1, 1))),
        num_hidden=10, name="fc")
    net = sym.SoftmaxOutput(net, name="softmax")
    rng = np.random.RandomState(0)
    shapes, _, _ = net.infer_shape(data=(8, 3, 32, 32))
    p0 = {n: rng.uniform(-0.3, 0.3, s).astype(np.float32)
          for n, s in zip(net.list_arguments(), shapes)
          if n not in ("data", "softmax_label")}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    states = []
    try:
        for staged in (True, False):
            it = mt.io.ImageRecordIter(
                path, (3, 32, 32), 8, shuffle=True, rand_crop=True,
                rand_mirror=True, pad=4, fill_value=255,
                mean_r=125.3, mean_g=123.0, mean_b=113.9, std_r=63.0,
                std_g=62.1, std_b=66.7, preprocess_threads=3, seed=4,
                ctx=mt.gpu(0))
            mod = mt.mod.Module(net, context=mt.gpu(0))
            with mt.config.override(data_staged_feed=staged):
                mod.fit(it, num_epoch=1, kvstore="tpu_sync",
                        optimizer="sgd",
                        optimizer_params={"learning_rate": 0.1,
                                          "momentum": 0.9,
                                          "multi_precision": True},
                        arg_params=p0, eval_metric=None,
                        steps_per_dispatch=2)
            it.close()
            assert mod.data_stats["staged"] == staged
            assert mod._fused.captures == 1
            args, aux = mod.get_params()
            states.append({k: v.cpu() for k, v in {**args, **aux}.items()})
    finally:
        torch.backends.cudnn.deterministic = det
    for k in states[0]:
        assert torch.equal(states[0][k], states[1][k]), k
    assert not np.array_equal(states[0]["fc_weight"].numpy(), p0["fc_weight"])


# ------------------------------------- kvstore, checkpoints, the loop
@pytest.mark.parametrize("compress", [False, True])
def test_kvstore_on_the_card_is_bitwise_and_stays_there(cuda, compress):
    """Two card values pushed as a list, pulled into a card tensor in
    place: bitwise their sum (with 2-bit, numpy's quantize with the
    residual carried over 3 pushes), the store on the card."""
    from mxnet_tpu_torch import kvstore as tkv
    rng = np.random.RandomState(0)
    a, b, w = (rng.randn(1000).astype(np.float32) for _ in range(3))
    kv = mt.kv.create("device")
    if compress:
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kv.init(0, torch.from_numpy(w).to(cuda))
    out = torch.zeros(1000, device=cuda)
    ptr, res = out.data_ptr(), np.zeros(1000, np.float32)
    for _ in range(3 if compress else 1):
        kv.push(0, [torch.from_numpy(a).to(cuda),
                    torch.from_numpy(b).to(cuda)])
        kv.pull(0, out=out)
        want = a + b
        if compress:
            acc = want + res
            want = np.where(acc >= 0.5, np.float32(0.5), np.where(
                acc <= -0.5, np.float32(-0.5), np.float32(0)))
            res = acc - want
        np.testing.assert_array_equal(out.cpu().numpy(), want)
    assert out.data_ptr() == ptr and kv._store[0].device.type == "cuda"
    packed, _ = tkv._pack_2bit(torch.from_numpy(a).to(cuda),
                               torch.zeros(1000, device=cuda), 0.5)
    np.testing.assert_array_equal(
        tkv._dequantize_2bit(packed, (1000,), 0.5).cpu().numpy(),
        tkv._dequantize_2bit(packed.cpu().numpy(), (1000,), 0.5))


@pytest.mark.parametrize("kvstore", ["local", "dist_sync"])
def test_module_kvstores_on_the_card(cuda, kvstore):
    """On the card ``local`` takes the fused step (as the JAX package's
    on an accelerator) and a ``dist_sync`` store in one process updates on
    push; both train a small MLP as the CPU does within 1e-5."""
    def run(ctx):
        data = mt.sym.Variable("data")
        net = mt.sym.FullyConnected(data, num_hidden=16, name="fc1")
        net = mt.sym.Activation(net, act_type="relu")
        net = mt.sym.FullyConnected(net, num_hidden=4, name="fc2")
        net = mt.sym.SoftmaxOutput(net, name="softmax")
        rng = np.random.RandomState(0)
        X = rng.randn(32, 8).astype(np.float32)
        Y = rng.randint(0, 4, 32).astype(np.float32)
        mod = mt.mod.Module(net, context=ctx)
        mod.fit(mt.io.NDArrayIter(X, Y, batch_size=8), num_epoch=1,
                kvstore=mt.kv.create(kvstore), optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                initializer=mt.init.Xavier(seed=0), eval_metric=None)
        return mod, {k: v.cpu() for k, v in mod.get_params()[0].items()}
    mod, got = run(mt.gpu(0))
    assert (mod._fused is not None) == (kvstore == "local")
    assert mod._update_on_kvstore == (kvstore == "dist_sync")
    _, want = run(mt.cpu())
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [1, 2])
def test_resumed_fit_on_the_card_is_bitwise(cuda, tmp_path, monkeypatch, k):
    """A small MLP with BatchNorm: 4 steps snapshotted every 2, resumed
    under MXNET_RESUME_DIR to 8, bitwise the uninterrupted 8 on the card
    (per step and as captured K = 2 windows)."""
    def fit(n, ckpt=None):
        mt.random.seed(0)
        data = mt.sym.Variable("data")
        net = mt.sym.FullyConnected(data, num_hidden=16, name="fc1")
        net = mt.sym.BatchNorm(net, name="bn1")
        net = mt.sym.Activation(net, act_type="relu")
        net = mt.sym.FullyConnected(net, num_hidden=4, name="fc2")
        net = mt.sym.SoftmaxOutput(net, name="softmax")
        rng = np.random.RandomState(0)
        X = rng.randn(32, 8).astype(np.float32)
        Y = rng.randint(0, 4, 32).astype(np.float32)
        mod = mt.mod.Module(net, context=mt.gpu(0))
        mod.fit(mt.io.NDArrayIter(X[:n * 4], Y[:n * 4], batch_size=4),
                num_epoch=1, kvstore="tpu_sync", optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                initializer=mt.init.Xavier(seed=0), eval_metric=None,
                checkpoint=ckpt, steps_per_dispatch=k)
        args, aux = mod.get_params()
        out = {n_: v.cpu() for n_, v in {**args, **aux}.items()}
        out.update({"mom:" + n_: s[0].cpu()
                    for n_, s in mod._fused_opt_state.items()})
        return out
    full = fit(8)
    fit(4, mt.checkpoint.CheckpointManager(tmp_path, save_every=2,
                                           async_save=False))
    monkeypatch.setenv("MXNET_RESUME_DIR", str(tmp_path))
    resumed = fit(8)
    for name in full:
        assert torch.equal(resumed[name], full[name]), name


@pytest.mark.parametrize("chw", [(32, 147, 147), (64, 35, 35),
                                 (192, 17, 17), (448, 8, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_at_inception_v3_shapes(cuda, chw, dtype):
    # odd rows (147 x 147) and the small 8 x 8 grids of Inception-v3
    x, sc, sh, _r = _case((4,) + chw, dtype, False, cuda, seed=7)
    y = tbn._launch(x, sc, sh, None, "relu", tbn.DEFAULT_CONFIG)
    torch.cuda.synchronize()
    _assert_kernel_matches_plain(y, tbn._plain_epilogue(x, sc, sh, None,
                                                        "relu"))


def test_inception_v3_forward_on_the_card_launches_94_and_matches_cpu(cuda):
    """Inception-v3 at its smallest input (2 x 3 x 139 x 139), inference at
    tier auto: 94 B1 launches, the softmax within 1e-5 of the CPU's."""
    sym = mt.models.inception_v3_symbol(num_classes=10)
    shapes, _, aux_shapes = sym.infer_shape(data=(2, 3, 139, 139))
    rng = np.random.RandomState(0)
    args = {n: rng.uniform(-0.05, 0.05, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}
    aux = {n: (np.ones(s) if n.endswith("var") else np.zeros(s))
           .astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    x = rng.rand(2, 3, 139, 139).astype(np.float32)
    outs = {}
    for dev in (cuda, "cpu"):
        ex = sym.simple_bind(dev, grad_req="null", data=x.shape)
        ex.copy_params_from(args, aux)
        tbn.reset_launches()
        outs[str(dev)] = ex.forward(data=x)[0].cpu().numpy()
        launches = dict(tbn.launches_by_kernel)
        assert launches == ({"bn_act": 94, "bn_act_res": 0}
                            if dev is cuda else
                            {"bn_act": 0, "bn_act_res": 0})
    np.testing.assert_allclose(outs[str(cuda)], outs["cpu"], rtol=0,
                               atol=1e-5)


def test_lrn_on_the_card_matches_the_cpu(cuda):
    from mxnet_tpu_torch.ops import nn as tnn
    rng = np.random.RandomState(1)
    x = np.maximum(rng.randn(2, 96, 27, 27) * 20, 0).astype(np.float32)
    cot = rng.randn(*x.shape).astype(np.float32)
    res = []
    for dev in (cuda, "cpu"):
        xt = torch.from_numpy(x).to(dev).requires_grad_(True)
        y = tnn.lrn(xt, nsize=5, alpha=1e-4, beta=0.75, knorm=2)
        (y * torch.from_numpy(cot).to(dev)).sum().backward()
        res.append((y.detach().cpu(), xt.grad.cpu()))
    for a, b in zip(*res):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Object detection (BASELINE config 4): the detection ops, the Custom op
# and mt.image on the card, against the port on the CPU. Selections
# bitwise, values f32 atol/rtol 1e-5 (other summation orders).
# ---------------------------------------------------------------------------

def _det_case(seed=0):
    rng = np.random.RandomState(seed)
    n = 300
    data = np.zeros((2, n, 6), np.float32)
    data[..., 0] = rng.randint(0, 3, (2, n))
    data[..., 1] = np.round(rng.uniform(0, 1, (2, n)), 2)    # ties
    lo = rng.uniform(0, 0.7, (2, n, 2))
    data[..., 2:4] = lo
    data[..., 4:] = lo + rng.uniform(0.05, 0.3, (2, n, 2))
    return data


def _both(name, ins, cuda, **kw):
    from mxnet_tpu_torch.ops import registry as treg
    fn = treg.get(name).fn
    cpu = fn(*[torch.from_numpy(x) for x in ins], **kw)
    card = fn(*[torch.from_numpy(x).to(cuda) for x in ins], **kw)
    torch.cuda.synchronize()
    cpu = cpu if isinstance(cpu, tuple) else (cpu,)
    card = card if isinstance(card, tuple) else (card,)
    return [c.cpu().numpy() for c in card], [c.numpy() for c in cpu]


@pytest.mark.parametrize("kw", [dict(), dict(id_index=0, topk=40),
                                dict(force_suppress=True, id_index=0)])
def test_box_nms_on_the_card_is_bitwise_the_cpu(cuda, kw):
    from mxnet_tpu_torch.ops import contrib_ops
    before = contrib_ops.nms_passes
    (got,), (want,) = _both("_contrib_box_nms", [_det_case()], cuda, **kw)
    np.testing.assert_array_equal(got, want)
    assert contrib_ops.nms_passes == before + 4


def test_multibox_ops_on_the_card_match_the_cpu(cuda):
    rng = np.random.RandomState(1)
    anchors = mt.ops.registry.get("_contrib_MultiBoxPrior").fn(
        torch.zeros(1, 1, 16, 16), sizes=(0.3, 0.39),
        ratios=(1.0, 2.0, 0.5)).numpy()
    a = anchors.shape[1]
    label = np.full((4, 2, 5), -1.0, np.float32)
    label[:, 0] = [[0, 0.1, 0.1, 0.5, 0.6], [1, 0.3, 0.2, 0.7, 0.9],
                   [2, 0.05, 0.5, 0.4, 0.95], [0, 0.5, 0.5, 0.6, 0.6]]
    label[:2, 1] = [[1, 0.6, 0.1, 0.9, 0.4], [0, 0.1, 0.1, 0.3, 0.3]]
    conf = rng.randn(4, 4, a).astype(np.float32)
    conf[:, :, :100] = conf[:, :, :1]                 # tied backgrounds
    got, want = _both("_contrib_MultiBoxTarget", [anchors, label, conf],
                      cuda, negative_mining_ratio=3)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    e = np.exp(conf - conf.max(1, keepdims=True))
    prob = (e / e.sum(1, keepdims=True)).astype(np.float32)
    loc = (rng.randn(4, a * 4) * 0.3).astype(np.float32)
    (got,), (want,) = _both("_contrib_MultiBoxDetection",
                            [prob, loc, anchors], cuda)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_array_equal(got[..., 1] >= 0, want[..., 1] >= 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_proposal_and_bipartite_matching_on_the_card(cuda):
    rng = np.random.RandomState(2)
    logits = rng.randn(2, 2, 3, 8, 8).astype(np.float32)
    logits[:, :, :, :3] = logits[:, :, :, :1]
    e = np.exp(logits - logits.max(1, keepdims=True))
    prob = (e / e.sum(1, keepdims=True)).reshape(2, 6, 8, 8)
    deltas = (rng.randn(2, 12, 8, 8) * 0.2).astype(np.float32)
    info = np.array([[128, 128, 1], [128, 128, 1]], np.float32)
    got, want = _both("_contrib_Proposal", [prob.astype(np.float32), deltas,
                                            info], cuda,
                      scales=(2, 4, 6), ratios=(1.0,), feature_stride=16,
                      rpn_pre_nms_top_n=64, rpn_post_nms_top_n=16,
                      threshold=0.7, rpn_min_size=8, output_score=True)
    np.testing.assert_array_equal(got[0][:, 0], want[0][:, 0])
    np.testing.assert_array_equal(got[0][:, 1] == -1, want[0][:, 1] == -1)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-4)
    x = np.round(rng.uniform(0, 1, (3, 7, 5)), 1).astype(np.float32)
    got, want = _both("_contrib_bipartite_matching", [x], cuda,
                      threshold=0.2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("op", ["ROIPooling", "_contrib_ROIAlign"])
def test_roi_ops_and_gradients_on_the_card_match_the_cpu(cuda, op):
    from mxnet_tpu_torch.ops import registry as treg
    rng = np.random.RandomState(3)
    data = np.maximum(rng.randn(2, 64, 8, 8), 0).astype(np.float32)
    rois = np.concatenate([rng.randint(0, 2, (32, 1)),
                           rng.uniform(0, 60, (32, 2)),
                           rng.uniform(60, 127, (32, 2))], 1) \
        .astype(np.float32)
    cot = rng.randn(32, 64, 4, 4).astype(np.float32)
    res = []
    for dev in ("cpu", cuda):
        d = torch.from_numpy(data).to(dev).requires_grad_(True)
        out = treg.get(op).fn(d, torch.from_numpy(rois).to(dev),
                              pooled_size=(4, 4), spatial_scale=1.0 / 16)
        (g,) = torch.autograd.grad((out * torch.from_numpy(cot).to(dev))
                                   .sum(), [d])
        res.append((out.detach().cpu().numpy(), g.cpu().numpy()))
    for a, b in zip(res[1], res[0]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_a_custom_op_in_a_k3_fit_on_the_card_runs_uncaptured(cuda):
    """A graph with a Custom node: its K = 3 window runs eagerly on the
    card (decided from the graph), two host round trips a step counted,
    the parameters against the same fit on the CPU."""
    from mxnet_tpu_torch.ops import custom_op

    @mt.operator.register("gpu_t_sqr")
    class SqrProp(mt.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Sqr()

    class Sqr(mt.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * in_data[0])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], 2 * in_data[0] * out_grad[0])

    rng = np.random.RandomState(4)
    X = rng.randn(12, 5).astype(np.float32)
    Y = rng.randint(0, 3, 12).astype(np.float32)
    p0 = {"fc1_weight": rng.randn(6, 5) * 0.3, "fc1_bias": np.zeros(6),
          "fc2_weight": rng.randn(3, 6) * 0.3, "fc2_bias": np.zeros(3)}
    out = {}
    for ctx in (mt.cpu(), mt.gpu(0)):
        h = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=6,
                                  name="fc1")
        h = mt.sym.Custom(h, op_type="gpu_t_sqr")
        net = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(
            h, num_hidden=3, name="fc2"), name="softmax")
        with ctx:
            mod = mt.mod.Module(net, context=ctx)
            it = mt.io.NDArrayIter(X, Y, batch_size=4)
            mod.bind(data_shapes=it.provide_data,
                     label_shapes=it.provide_label)
            mod.init_params(arg_params={
                n: mt.nd.array(v.astype(np.float32))
                for n, v in p0.items()}, aux_params={})
            custom_op.reset_counts()
            mod.fit(it, num_epoch=1, kvstore="tpu_sync", eval_metric=None,
                    optimizer_params={"learning_rate": 0.1},
                    steps_per_dispatch=3)
        assert mod._fused.dispatch == "eager"
        assert mod._fused.captures == 0 and custom_op.round_trips == 6
        out[ctx.device_type] = {n: v.detach().cpu().numpy() for n, v in
                                mod.get_params()[0].items()}
    for n in out["cpu"]:
        np.testing.assert_allclose(out["gpu"][n], out["cpu"][n], rtol=1e-5,
                                   atol=1e-5)


def test_image_det_iter_on_the_card(cuda, tmp_path):
    """The SSD example's iterator on the card (nvJPEG, no cv2): labels
    bitwise the CPU iterator's (same draws), pixels within the decode
    bound; a resize to another size raises, to the same size is the
    identity."""
    import random
    import detection_graphs
    rec = detection_graphs.det_fixture().write_records(str(tmp_path / "d"),
                                                       mt.recordio)
    out = {}
    for ctx in (mt.gpu(0), mt.cpu()):
        if ctx.device_type == "cpu":
            pytest.importorskip("cv2")
        random.seed(3)
        it = mt.image.ImageDetIter(batch_size=8, data_shape=(3, 64, 64),
                                   path_imgrec=rec, shuffle=True,
                                   rand_mirror=True, mean=True, std=True,
                                   ctx=ctx)
        out[ctx.device_type] = [(b.data[0].asnumpy(), b.label[0].asnumpy(),
                                 b.data[0].context) for b in it]
        it.close()
    for (gd, gl, gc), (cd, cl, _) in zip(out["gpu"], out["cpu"]):
        assert gc == mt.gpu(0)
        np.testing.assert_array_equal(gl, cl)
        d = np.abs(gd - cd)
        assert d.mean() <= 1.0 and np.percentile(d, 99.9) <= 8
    img = mt.nd.array(np.zeros((5, 7, 3), np.uint8), ctx=mt.gpu(0),
                      dtype="uint8")
    assert mt.image.imresize(img, 7, 5) is img
    with pytest.raises(mt.MXNetError, match="A5b"):
        mt.image.imresize(img, 8, 5)
