"""Port parity for GPT decode serving: the sampler, the decoder's
programs and the generate path as a whole.

The same numpy parameters and inputs go through the JAX package (tier
auto, its Pallas kernels in interpret mode, as
``tests/test_attention_kernel.py`` runs them) and through the port on
the CPU (the kernels' plain versions). Tokens must be equal; K/V rows
agree within atol/rtol 1e-5 on the rows a consumer reads (the same f32
math summed in another order). The sampler's keys, random bits and
uniforms are bitwise jax's; its Gumbel noise agrees to the last place
of a float32 (torch's and XLA's ``log`` round differently now and then)
and the drawn tokens are equal.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import config as jconfig
from mxnet_tpu import serving as jserving
from mxnet_tpu.serve import GenerateSession as JSession
from mxnet_tpu.serve import decode_model as jdm
from mxnet_tpu.serve.metrics import DecodeMetrics as JDecodeMetrics

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.kernels import tier as ttier
from mxnet_tpu_torch.serve import _threefry
from mxnet_tpu_torch.serve import decode_model as tdm
from mxnet_tpu_torch.serve.metrics import DecodeMetrics

SPEC = dict(vocab=61, dim=32, num_heads=4, num_layers=2, max_prompt_len=8,
            page_size=8, max_pages_per_slot=6, max_slots=4, num_pages=25)
JSPEC = jdm.DecoderSpec(**SPEC)
TSPEC = tdm.DecoderSpec(**SPEC)

WORK = [  # (prompt, max_new, temperature, seed): greedy AND sampled
    ([5, 9, 13], 12, 0.0, 0),
    ([2, 3], 3, 0.0, 0),
    ([4, 4, 4, 4, 6, 7], 8, 0.9, 11),
    ([7], 2, 0.0, 0),
    ([11, 60, 1, 2, 3], 16, 0.7, 5),
    ([8, 8, 9], 5, 0.0, 0),
    (list(range(1, 20)), 10, 0.0, 0),           # chunked: 19 > P = 8
    (list(range(30, 50)), 6, 0.8, 3),           # chunked and sampled
]


@pytest.fixture(scope="module")
def params():
    return jdm.init_params(JSPEC, seed=0)


@pytest.fixture(scope="module")
def tparams(params):
    return tdm.params_from_reference(params, TSPEC, "cpu")


def _jit(make, *args):
    """A JAX decoder program traced at tier auto (its kernels in
    interpret mode); call it inside the same override."""
    return jax.jit(make(*args))


def _tokens(x):
    return np.asarray(x).astype(np.int64).tolist()


# ------------------------------------------------------------- sampler
def test_sampler_is_jax_bit_for_bit():
    rng = np.random.RandomState(0)
    n, V = 240, 61
    seeds = rng.randint(0, 2 ** 31 - 1, n).astype(np.int32)
    seeds[:3] = [0, 1, 2 ** 31 - 1]
    pos = rng.randint(0, 4096, n).astype(np.int32)
    logits = (rng.randn(n, V) * 2).astype(np.float32)
    temps = rng.choice([0.3, 0.8, 1.0, 1.7], n).astype(np.float32)

    def jkey(s, c):
        return jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0),
                                                     s), c)
    jk = jax.vmap(jkey)(jnp.asarray(seeds), jnp.asarray(pos))
    key = _threefry.fold_in(_threefry.fold_in(_threefry.prng_key(0),
                                              torch.from_numpy(seeds)),
                            torch.from_numpy(pos))
    got_key = np.stack([key[0].numpy(), key[1].numpy()], 1)
    np.testing.assert_array_equal(got_key.astype(np.uint32), np.asarray(jk))
    bits = jax.vmap(lambda k: jax.random.bits(k, (V,), jnp.uint32))(jk)
    np.testing.assert_array_equal(
        _threefry.random_bits(key, V).numpy().astype(np.uint32),
        np.asarray(bits))
    tiny = np.finfo(np.float32).tiny
    u = jax.vmap(lambda k: jax.random.uniform(k, (V,), minval=tiny,
                                              maxval=1.0))(jk)
    np.testing.assert_array_equal(_threefry.uniform(key, V).numpy(),
                                  np.asarray(u))
    g = jax.vmap(lambda k: jax.random.gumbel(k, (V,)))(jk)
    np.testing.assert_allclose(_threefry.gumbel(key, V).numpy(),
                               np.asarray(g), rtol=3e-7, atol=2.5e-7)
    # the decoder's _sample: greedy rows, sampled rows, temperature scale
    temps[::5] = 0.0
    want = np.asarray(jdm._sample(jnp.asarray(logits), jnp.asarray(temps),
                                  jnp.asarray(seeds), jnp.asarray(pos)))
    for host in (temps, None):
        got = tdm._sample(torch.from_numpy(logits), torch.from_numpy(temps),
                          torch.from_numpy(seeds).long(),
                          torch.from_numpy(pos).long(), host)
        np.testing.assert_array_equal(got.numpy(), want)


# -------------------------------------------------------------- programs
def test_init_params_match_and_are_checked(params, tparams):
    ours = tdm.init_params(TSPEC, seed=0)
    assert sorted(ours) == sorted(params)
    for k in params:
        np.testing.assert_array_equal(ours[k], params[k])
        np.testing.assert_array_equal(tparams[k].numpy(), params[k])
    bad = dict(params)
    bad["l0_qkv_w"] = bad["l0_qkv_w"][:, :5]
    with pytest.raises(mt.MXNetError, match="l0_qkv_w"):
        tdm.params_from_reference(bad, TSPEC, "cpu")
    with pytest.raises(mt.MXNetError, match="missing"):
        tdm.params_from_reference({"tok_w": params["tok_w"]}, TSPEC, "cpu")


def test_prefill_matches_jax(params, tparams):
    P, S = SPEC["max_prompt_len"], SPEC["max_slots"]
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, 61, (S, P)).astype(np.int32)
    lengths = np.array([3, 8, 1, 5], np.int32)
    temps = np.array([0.0, 0.9, 0.0, 0.7], np.float32)
    seeds = np.array([0, 11, 0, 5], np.int32)
    with jconfig.override(kernel_tier="auto"):
        jfirst, jk, jv = _jit(jdm.make_prefill, params, JSPEC)(
            tokens, lengths, temps, seeds)
    first, k, v = tdm.make_prefill(tparams, TSPEC)(tokens, lengths, temps,
                                                   seeds)
    assert _tokens(first) == _tokens(jfirst)
    assert k.shape == (S, SPEC["num_layers"], P, SPEC["dim"])
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(k[b, :, :n].numpy(),
                                   np.asarray(jk)[b, :, :n],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(v[b, :, :n].numpy(),
                                   np.asarray(jv)[b, :, :n],
                                   rtol=1e-5, atol=1e-5)


def _cache(seed=2):
    rng = np.random.RandomState(seed)
    shape = (SPEC["num_layers"], TSPEC.cache_rows, SPEC["dim"])
    return (rng.randn(*shape).astype(np.float32) * 0.5,
            rng.randn(*shape).astype(np.float32) * 0.5)


def test_commit_matches_jax():
    k0, v0 = _cache()
    rng = np.random.RandomState(3)
    L, P, C = SPEC["num_layers"], SPEC["max_prompt_len"], SPEC["dim"]
    k_new = rng.randn(L, P, C).astype(np.float32)
    v_new = rng.randn(L, P, C).astype(np.float32)
    page_ids = np.array([3], np.int32)
    jk, jv = jax.jit(jdm.make_commit(JSPEC))(
        jnp.asarray(k0), jnp.asarray(v0), k_new, v_new, page_ids,
        np.int32(5))
    tk, tv = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    out = tdm.make_commit(TSPEC)(tk, tv, torch.from_numpy(k_new),
                                 torch.from_numpy(v_new), page_ids, 5)
    assert out[0] is tk and out[1] is tv          # updated in place
    page = SPEC["page_size"]
    # page 0 is the scratch page padding rows race for: compare the rest
    np.testing.assert_array_equal(tk.numpy()[:, page:],
                                  np.asarray(jk)[:, page:])
    np.testing.assert_array_equal(tv.numpy()[:, page:],
                                  np.asarray(jv)[:, page:])
    np.testing.assert_array_equal(tk.numpy()[:, 3 * page:3 * page + 5],
                                  k_new[:, :5])


def test_decode_step_matches_jax(params, tparams):
    k0, v0 = _cache()
    S, MP, page = SPEC["max_slots"], SPEC["max_pages_per_slot"], 8
    bt = np.zeros((S, MP), np.int32)
    bt[0, :3] = [1, 2, 3]
    bt[2, :1] = [4]
    bt[3, :6] = [5, 6, 7, 8, 9, 10]
    positions = np.array([17, 0, 0, 47], np.int32)   # slot 1 inactive
    tokens = np.array([[5], [0], [9], [60]], np.int32)
    temps = np.array([0.0, 0.0, 0.8, 0.0], np.float32)
    seeds = np.array([0, 0, 7, 0], np.int32)
    with jconfig.override(kernel_tier="auto"):
        jnxt, jk, jv = _jit(jdm.make_decode, params, JSPEC)(
            tokens, positions, bt, temps, seeds, k0, v0)
    tk, tv = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    nxt, k, v = tdm.make_decode(tparams, TSPEC)(tokens, positions, bt, temps,
                                                seeds, tk, tv)
    assert k is tk and v is tv                    # updated in place
    live = [0, 2, 3]
    assert _tokens(nxt)[:1] + _tokens(nxt)[2:] == \
        [_tokens(jnxt)[i] for i in live]
    for s in live:
        row = bt[s, positions[s] // page] * page + positions[s] % page
        np.testing.assert_allclose(tk.numpy()[:, row], np.asarray(jk)[:, row],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tv.numpy()[:, row], np.asarray(jv)[:, row],
                                   rtol=1e-5, atol=1e-5)
    # nothing outside the written rows moved
    written = {int(bt[s, positions[s] // page] * page + positions[s] % page)
               for s in range(S)}
    keep = np.array([r not in written for r in range(TSPEC.cache_rows)])
    np.testing.assert_array_equal(tk.numpy()[:, keep], k0[:, keep])


def test_chunk_prefill_matches_jax(params, tparams):
    k0, v0 = _cache(seed=4)
    MP, P = SPEC["max_pages_per_slot"], SPEC["max_prompt_len"]
    bt = np.array([3, 1, 4, 0, 0, 0], np.int32)
    rng = np.random.RandomState(5)
    tokens = rng.randint(0, 61, P).astype(np.int32)
    for start, n, temp, seed in ((0, 8, 0.0, 0), (8, 8, 0.7, 3),
                                 (16, 5, 0.0, 0)):
        with jconfig.override(kernel_tier="auto"):
            jnxt, jk, jv = _jit(jdm.make_chunk_prefill, params, JSPEC)(
                tokens, np.int32(start), np.int32(n), bt, np.float32(temp),
                np.int32(seed), k0, v0)
        tk, tv = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
        nxt, _k, _v = tdm.make_chunk_prefill(tparams, TSPEC)(
            tokens, start, n, bt, temp, seed, tk, tv)
        assert int(nxt) == int(jnxt)
        rows = [int(bt[(start + i) // 8]) * 8 + (start + i) % 8
                for i in range(n)]
        np.testing.assert_allclose(tk.numpy()[:, rows],
                                   np.asarray(jk)[:, rows],
                                   rtol=1e-5, atol=1e-5)
    # logits=True: every chunk row's logits, the last one the sampled row
    lg, _k, _v = tdm.make_chunk_prefill(tparams, TSPEC, logits=True)(
        tokens, 16, 5, bt, 0.0, 0, torch.from_numpy(k0.copy()),
        torch.from_numpy(v0.copy()))
    assert lg.shape == (P, SPEC["vocab"])
    assert int(lg[4].argmax()) == int(nxt)


# --------------------------------------------------- the slice as a whole
def _drive(run_round, reqs, cap=400):
    for _ in range(cap):
        if all(r.done() for r in reqs):
            break
        run_round()
    assert all(r.done() for r in reqs), "scheduler stalled"
    return [r.result(timeout=1.0) for r in reqs]


@pytest.fixture(scope="module")
def served(params, tmp_path_factory):
    """WORK through the JAX package's GenerateSession and through the
    port's Server, each over its own format_version 5 artifact."""
    d = tmp_path_factory.mktemp("port_decode")
    jpath, tpath = str(d / "lm.mxtpu"), str(d / "lm.mxtorch")
    with jconfig.override(kernel_tier="auto"):
        jserving.export_generate(params, JSPEC, jpath, chunked=True)
        sess = JSession(jpath, auto_start=False, timeout_ms=0)
        reqs = [sess.submit(p, max_new_tokens=n, temperature=t, seed=s)
                for p, n, t, s in WORK]
        jout = _drive(sess.run_round, reqs)
        sess.close(drain=True)
        jmetrics = sess.metrics()
    meta = mt.serving.export_generate(params, TSPEC, tpath, chunked=True)
    ttier.reset_stats()
    srv = mt.serve.Server(tpath, config=mt.serve.GenerateConfig(
        timeout_ms=0), device="cpu", auto_start=False)
    reqs = [srv.submit_generate(p, max_new_tokens=n, temperature=t, seed=s)
            for p, n, t, s in WORK]
    tout = _drive(srv.session.run_round, reqs)
    stats = ttier.stats()
    srv.close(drain=True)
    return {"jax": jout, "port": tout, "meta": meta, "stats": stats,
            "jmetrics": jmetrics, "metrics": srv.metrics(), "path": tpath}


def test_served_tokens_equal_the_jax_session(served):
    assert [o["tokens"] for o in served["port"]] == \
        [o["tokens"] for o in served["jax"]]
    assert [o["finish_reason"] for o in served["port"]] == \
        ["length"] * len(WORK)
    # every attention site went through the tier's kernels (their plain
    # versions on the CPU), prefill's included: no fallback
    assert set(served["stats"]["dispatch"]) == {"flash_attn",
                                                "flash_attn_paged"}
    assert not served["stats"]["fallback"]
    assert served["meta"]["format_version"] == 5
    assert served["meta"]["kernel_tier"]["kernels"]["decode"] == {
        "flash_attn_paged": SPEC["num_layers"]}


def test_greedy_tokens_equal_reference_generate(served, params, tparams):
    for (p, n, t, _s), o in zip(WORK, served["port"]):
        if t > 0:
            continue
        want = jdm.reference_generate(params, JSPEC, p, n)
        assert tdm.reference_generate(tparams, TSPEC, p, n) == want
        assert o["tokens"] == want


def test_tier_off_serves_the_same_tokens(served):
    with mt.config.override(kernel_tier="off"):
        ttier.reset_stats()
        srv = mt.serve.Server(served["path"], config=mt.serve.GenerateConfig(
            timeout_ms=0), device="cpu", auto_start=False)
        reqs = [srv.submit_generate(p, max_new_tokens=n, temperature=t,
                                    seed=s) for p, n, t, s in WORK]
        out = _drive(srv.session.run_round, reqs)
        srv.close(drain=True)
        assert ttier.stats()["dispatch"] == {}
    assert [o["tokens"] for o in out] == \
        [o["tokens"] for o in served["port"]]


def test_metrics_keys_match_the_jax_package(served):
    assert set(DecodeMetrics().snapshot()) == set(JDecodeMetrics().snapshot())
    got, want = served["metrics"], served["jmetrics"]
    assert set(got) - {"mode"} == set(want)
    for key in ("requests", "prefill", "ttft_ms", "tpot_ms", "kv_pages",
                "slots", "speculative"):
        assert set(got[key]) == set(want[key]), key
    assert got["requests"] == want["requests"]
    assert got["prefill"] == want["prefill"]
    assert got["decode_steps"] == want["decode_steps"]
    assert got["tokens"] == want["tokens"]
    assert got["mode"] == "generate" and got["status"] == "closed"


def test_server_refuses_what_is_not_ported(served):
    # the artifact bundles no draft: speculation cannot be asked for
    with pytest.raises(mt.MXNetError, match="bundles no draft"):
        mt.serve.Server(served["path"], device="cpu", draft="on")
    srv = mt.serve.Server(served["path"], config=mt.serve.GenerateConfig(
        timeout_ms=0, warmup=False), device="cpu", auto_start=False)
    try:
        with pytest.raises(mt.MXNetError, match="submit_generate"):
            srv.submit(np.zeros((1, 8), np.int32))
        with pytest.raises(mt.MXNetError, match="max_context"):
            srv.submit_generate(list(range(40)), max_new_tokens=20)
    finally:
        srv.close(drain=False)


def test_generate_entry_points_default_to_cuda0(served):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.serving.GenerateModel.load(served["path"])
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.serve.Server(served["path"])
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        tdm.params_from_reference(tdm.init_params(TSPEC), TSPEC)


def test_session_evicts_on_drain_with_a_resumable_cursor(served):
    sess = mt.serve.GenerateSession(served["path"], device="cpu",
                                    auto_start=False, timeout_ms=0,
                                    drain_tokens=2)
    req = sess.submit([5, 9, 13], max_new_tokens=12)
    queued = [sess.submit([1, 2], max_new_tokens=3) for _ in range(4)]
    sess.run_round()
    sess.close(drain=True)
    with pytest.raises(mt.serve.Evicted) as ei:
        req.result(timeout=1)
    first = served["port"][0]["tokens"]
    assert ei.value.tokens == first[:len(ei.value.tokens)]
    assert ei.value.cursor["resume_prompt"] == [5, 9, 13] + ei.value.tokens
    assert all(r.done() for r in queued)
    bt, params = mt.serving.load_bundled_params(served["path"])
    assert params is None and sorted(bt) == sorted(tdm._param_names(TSPEC))
