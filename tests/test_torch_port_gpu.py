"""Port tests that need the card: each CUDA kernel (``bn_act``,
``take_rows``, ``flash_attn``, ``flash_attn_paged``) against its plain
torch version, the wrappers' checks and launch counts, and small models
(a ResNet-20 predictor, a GPT decoder in generate mode) served on the
card against the same artifact on the CPU.

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
``take_rows`` moves bytes and must match bitwise.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.kernels import _build
from mxnet_tpu_torch.kernels import attention as tattn
from mxnet_tpu_torch.kernels import bn_act as tbn
from mxnet_tpu_torch.kernels import take as ttake
from mxnet_tpu_torch.serve import decode_model as tdm

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


@pytest.mark.parametrize("shape", [(2, 3, 128, 64), (1, 2, 100, 64),
                                   (2, 2, 37, 8), (1, 1, 70, 128)])
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


def test_flash_attn_paged_never_reads_past_the_last_visible_row(cuda):
    # a non-finite value in a row nobody may see must not leak into the
    # result (0 * inf is NaN): the kernel walks visible positions only
    q, kp, vp, bt, pos = _paged_case(2, 1, 2, 16, 4, 4, [5, 9],
                                     torch.float32, cuda)
    for s, p in enumerate((5, 9)):
        row = int(bt[s, (p + 1) // 4]) * 4 + (p + 1) % 4
        vp[row] = float("inf")
    got = tattn.paged_attention(q, kp, vp, bt, pos, heads=2, page_size=4)
    assert bool(torch.isfinite(got).all())


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
