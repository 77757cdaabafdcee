"""Port parity for speculative GPT decode serving: the int8 draft (its
quantized weights and dense), the speculative step and the speculative
session as a whole, at the JAX package's own test size
(``tests/test_serve_decode.py``: vocab 61, dim 32, 4 heads, 2 layers,
k = 3; vocab 61 also pads the head's product to 64 columns).

The same numpy parameters and inputs go through the JAX package and the
port on the CPU (the kernels' plain versions). The quantized weights,
the int8 activations and the int32 accumulators are bitwise the JAX
package's; f32 results agree within atol/rtol 1e-5 (the same f32 math
summed in another order). Tokens are equal: the JAX session's, and
``reference_generate``'s, greedy and sampled.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import config as jconfig
from mxnet_tpu import perfmodel as jperfmodel
from mxnet_tpu import serving as jserving
from mxnet_tpu.serve import GenerateSession as JSession
from mxnet_tpu.serve import decode_model as jdm

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import perfmodel as tperfmodel
from mxnet_tpu_torch.serve import decode_model as tdm

SPEC = dict(vocab=61, dim=32, num_heads=4, num_layers=2, max_prompt_len=8,
            page_size=4, max_pages_per_slot=8, max_slots=4, num_pages=33)
JSPEC = jdm.DecoderSpec(**SPEC)
TSPEC = tdm.DecoderSpec(**SPEC)
K = 3

WORK = [  # (prompt, max_new, temperature, seed): ragged, greedy and sampled
    ([5, 9, 13], 12, 0.0, 0),
    ([2, 3], 3, 0.0, 0),
    ([4, 4, 4, 4, 6, 7], 8, 0.8, 11),
    ([7], 2, 0.0, 0),
    ([11, 60, 1, 2, 3], 16, 0.8, 5),
    (list(range(1, 20)), 10, 0.0, 0),            # chunked: 19 > P = 8
    (list(range(30, 44)), 6, 0.8, 3),            # chunked and sampled
]


@pytest.fixture(scope="module")
def params():
    return jdm.init_params(JSPEC, seed=0)


@pytest.fixture(scope="module")
def qparams(params):
    return jdm.quantize_decoder_params(params)


@pytest.fixture(scope="module")
def tparams(params):
    return tdm.params_from_reference(params, TSPEC, "cpu")


@pytest.fixture(scope="module")
def arts(params, qparams, tmp_path_factory):
    """The port's artifacts: format 5 with the draft, format 5 without,
    format 3."""
    d = tmp_path_factory.mktemp("port_spec")
    paths = {n: str(d / ("%s.mxtorch" % n)) for n in ("spec", "v5", "v3")}
    meta = mt.serving.export_generate(params, TSPEC, paths["spec"],
                                      draft_params=qparams, speculate_k=K)
    mt.serving.export_generate(params, TSPEC, paths["v5"], chunked=True)
    mt.serving.export_generate(params, TSPEC, paths["v3"])
    return dict(paths, meta=meta)


def _drive(sess, reqs, cap=400):
    for _ in range(cap):
        if all(r.done() for r in reqs):
            break
        sess.run_round()
    assert all(r.done() for r in reqs), "scheduler stalled"
    return [r.result(timeout=1.0) for r in reqs]


def _session(path, **kw):
    kw.setdefault("auto_start", False)
    kw.setdefault("timeout_ms", 0)
    return mt.serve.GenerateSession(path, device="cpu", **kw)


# ------------------------------------------------------------ the draft
def test_quantize_decoder_params_is_bitwise_the_jax_packages(params,
                                                             qparams):
    ours = tdm.quantize_decoder_params(params)
    assert list(ours) == list(qparams)
    for name, want in qparams.items():
        assert ours[name].dtype == want.dtype, name
        np.testing.assert_array_equal(ours[name], want, err_msg=name)
    # the quantized dict crosses with its names, shapes and int8 checked
    got = tdm.params_from_reference(qparams, TSPEC, "cpu")
    assert got["head_w_q"].dtype == torch.int8
    assert got["head_w_deq"].shape == (SPEC["vocab"],)
    bad = dict(qparams, l0_qkv_w_q=qparams["l0_qkv_w_q"].astype(np.float32))
    with pytest.raises(mt.MXNetError, match="not int8"):
        tdm.params_from_reference(bad, TSPEC, "cpu")
    bad = dict(qparams, l1_proj_w_deq=qparams["l1_proj_w_deq"][:5])
    with pytest.raises(mt.MXNetError, match="l1_proj_w_deq"):
        tdm.params_from_reference(bad, TSPEC, "cpu")
    bad = dict(qparams)
    bad.pop("l0_mlp1_w_deq")
    with pytest.raises(mt.MXNetError, match="missing"):
        tdm.params_from_reference(bad, TSPEC, "cpu")


@pytest.mark.parametrize("rows,name", [(5, "l0_qkv_w"), (20, "l1_mlp2_w"),
                                       (4, "head_w")])
def test_dense_int8_matches_jax(qparams, rows, name):
    """Per-row activation quantization and the int32 product bitwise,
    the f32 epilogue within 1e-5; 5 and 4 rows pad the product's M to
    17, the head's 61 columns pad its N to 64 (once, at alignment)."""
    C_in = qparams[name + "_q"].shape[1]
    x = (np.random.RandomState(rows).randn(rows, C_in) * 0.7).astype(
        np.float32)
    x[0] = 0.0                                    # an all-zero row
    bname = name[:-1] + "b"
    wq, deq = qparams[name + "_q"], qparams[name + "_deq"]
    b = np.random.RandomState(1).randn(wq.shape[0]).astype(np.float32)
    # the JAX package's quantize and product, as its _dense_int8 runs them
    jx = jnp.asarray(x)
    amax = jnp.max(jnp.abs(jx), axis=-1, keepdims=True)
    ascale = 127.0 / jnp.maximum(amax, 1e-8)
    jxq = jnp.clip(jnp.round(jx * ascale), -127, 127).astype(jnp.int8)
    jacc = jax.lax.dot_general(jxq, jnp.asarray(wq), (((1,), (1,)), ((), ())),
                               preferred_element_type=jnp.int32)
    want = jdm._dense_int8(jx, jnp.asarray(wq), jnp.asarray(deq),
                           jnp.asarray(b))
    tx = torch.from_numpy(x)
    tascale = 127.0 / tx.abs().amax(-1, keepdim=True).clamp_min(1e-8)
    txq = torch.round(tx * tascale).clamp_(-127, 127).to(torch.int8)
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    p = tdm._int8_aligned({bname: torch.from_numpy(b),
                           name + "_q": torch.from_numpy(wq),
                           name + "_deq": torch.from_numpy(deq)})
    assert p[name + "_q"].shape[0] % 8 == 0
    acc = tdm._int8_matmul(txq, p[name + "_q"])[:, :wq.shape[0]]
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    got = tdm._dense_p(p, tx, name, bname)
    assert got.shape == (rows, wq.shape[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------- the speculative step
def _slot_state(tparams, qparams):
    """Caches filled by the port's chunk prefills (verifier f32, draft
    int8) for three live slots, one inactive; slot 3 sits near
    max_context so its window's last rows go to scratch."""
    L, R, C = SPEC["num_layers"], TSPEC.cache_rows, SPEC["dim"]
    S, MP = SPEC["max_slots"], SPEC["max_pages_per_slot"]
    caches = [torch.zeros(L, R, C) for _ in range(4)]
    tq = tdm.params_from_reference(qparams, TSPEC, "cpu")
    chunk = tdm.make_chunk_prefill(tparams, TSPEC)
    dchunk = tdm.make_chunk_prefill(tq, TSPEC)
    bt = np.zeros((S, MP), np.int32)
    bt[0, :3] = [1, 2, 3]
    bt[2, :2] = [4, 5]
    bt[3, :] = np.arange(6, 14)
    prompts = {0: [5, 9, 13, 2, 8, 1, 7, 3, 4, 4], 2: [11, 60, 1], 3:
               list(np.random.RandomState(9).randint(0, 61, 30))}
    positions = np.zeros(S, np.int32)
    tokens = np.zeros((S, 1), np.int32)
    for s, prompt in prompts.items():
        for start in range(0, len(prompt), 8):
            part = prompt[start:start + 8]
            toks = np.zeros(8, np.int32)
            toks[:len(part)] = part
            nxt, _k, _v = chunk(toks, start, len(part), bt[s], 0.0, 0,
                                caches[0], caches[1])
            dchunk(toks, start, len(part), bt[s], 0.0, 0, caches[2],
                   caches[3])
        positions[s], tokens[s, 0] = len(prompt), int(nxt)
    temps = np.array([0.0, 0.0, 0.8, 0.0], np.float32)
    seeds = np.array([0, 0, 7, 0], np.int32)
    return (tokens, positions, bt, temps, seeds), [c.numpy() for c in caches]


def test_draft_verify_matches_jax(params, qparams, tparams):
    args, caches = _slot_state(tparams, qparams)
    with jconfig.override(kernel_tier="auto"):
        jout = jax.jit(jdm.make_draft_verify(params, qparams, JSPEC, K))(
            *args, *caches)
    tc = [torch.from_numpy(c.copy()) for c in caches]
    tq = tdm.params_from_reference(qparams, TSPEC, "cpu")
    out = tdm.make_draft_verify(tparams, tq, TSPEC, K)(*args, *tc)
    assert all(o is t for o, t in zip(out[1:], tc))   # updated in place
    packed = out[0].numpy()
    assert packed.shape == (SPEC["max_slots"], K + 2)
    live = [0, 2, 3]
    np.testing.assert_array_equal(packed[live], np.asarray(jout[0])[live])
    assert packed[live, 0].max() >= 1       # the draft is accepted at all
    # every page store, scratch page 0 aside (inactive and past-the-end
    # rows race for it)
    page = SPEC["page_size"]
    for got, want in zip(tc, jout[1:]):
        np.testing.assert_allclose(got.numpy()[:, page:],
                                   np.asarray(want)[:, page:],
                                   rtol=1e-5, atol=1e-5)
    # at tier off (the gather and masked softmax) the same tokens
    with mt.config.override(kernel_tier="off"):
        off = tdm.make_draft_verify(tparams, tq, TSPEC, K)
    tc = [torch.from_numpy(c.copy()) for c in caches]
    np.testing.assert_array_equal(off(*args, *tc)[0].numpy()[live],
                                  packed[live])
    # the logits form: the same samples, and the logits behind them
    tc = [torch.from_numpy(c.copy()) for c in caches]
    packed2, props, dlg, vlg = tdm.make_draft_verify(
        tparams, tq, TSPEC, K, logits=True)(*args, *tc)
    np.testing.assert_array_equal(packed2.numpy(), packed)
    assert props.shape == (4, K) and dlg.shape == (4, K, SPEC["vocab"])
    assert vlg.shape == (4, K + 1, SPEC["vocab"])
    assert torch.equal(vlg[0].argmax(-1).to(torch.int32), packed2[0, 1:])
    with pytest.raises(mt.MXNetError, match="speculation depth"):
        tdm.make_draft_verify(tparams, tq, TSPEC, SPEC["max_prompt_len"] + 1)


def test_speculation_depth_stays_in_its_window():
    for kw in (dict(), dict(max_prompt_len=2, max_pages_per_slot=8),
               dict(vocab=50257, dim=768, num_heads=12, num_layers=12,
                    max_prompt_len=128, page_size=16,
                    max_pages_per_slot=64, max_slots=16, num_pages=1025)):
        spec = TSPEC._replace(**kw)
        for max_k in (1, 4, 8, 16):
            for a in (0.1, 0.8, 0.99):
                k = tdm.suggest_speculation_depth(spec, max_k=max_k,
                                                  acceptance=a)
                assert 1 <= k <= min(max_k, spec.max_prompt_len)
    # the policy is the JAX package's pure math
    rng = np.random.RandomState(0)
    for _ in range(50):
        td, tv = rng.uniform(1e-5, 1e-3, 2)
        a, max_k = rng.uniform(0.05, 0.99), rng.randint(1, 12)
        assert tperfmodel.speculation_depth(td, tv, max_k, a) == \
            jperfmodel.speculation_depth(td, tv, max_k, a)
        assert tperfmodel.speculation_depth(
            td, lambda w: tv * (1 + 0.1 * w), max_k, a) == \
            jperfmodel.speculation_depth(td, lambda w: tv * (1 + 0.1 * w),
                                         max_k, a)


# ---------------------------------------------------------- the session
@pytest.fixture(scope="module")
def served(params, qparams, arts, tmp_path_factory):
    """WORK through the JAX package's speculative session and through
    the port's, each over its own speculative artifact."""
    jpath = str(tmp_path_factory.mktemp("jax_spec") / "m.mxtpu")
    jserving.export_generate(params, JSPEC, jpath, draft_params=qparams,
                             speculate_k=K)
    jsess = JSession(jpath, auto_start=False, timeout_ms=0)
    assert jsess.speculative
    jreqs = [jsess.submit(p, max_new_tokens=n, temperature=t, seed=s)
             for p, n, t, s in WORK]
    jout = _drive(jsess, jreqs)
    jsess.close(drain=True)
    sess = _session(arts["spec"])
    assert sess.speculative and sess.speculate_k == K
    reqs = [sess.submit(p, max_new_tokens=n, temperature=t, seed=s)
            for p, n, t, s in WORK]
    out = _drive(sess, reqs)
    sess.close(drain=True)
    return {"jax": jout, "port": out, "metrics": sess.metrics(),
            "jmetrics": jsess.metrics()}


def test_speculative_tokens_equal_jax_and_the_reference(served, tparams):
    assert [o["tokens"] for o in served["port"]] == \
        [o["tokens"] for o in served["jax"]]
    for (p, n, t, s), o in zip(WORK, served["port"]):
        assert o["tokens"] == tdm.reference_generate(
            tparams, TSPEC, p, n, temperature=t, seed=s)
        assert o["finish_reason"] == "length"
        assert o["accepted_tokens_per_step"] >= 1.0
        assert 0.0 <= o["draft_acceptance_rate"] <= 1.0
    assert max(o["accepted_tokens_per_step"] for o in served["port"]) > 1.0
    # a wrong draft cache changes no token, only acceptance: hold it
    for o, jo in zip(served["port"], served["jax"]):
        assert o["accepted_tokens_per_step"] == jo["accepted_tokens_per_step"]
        assert o["draft_acceptance_rate"] == jo["draft_acceptance_rate"]
    got, want = served["metrics"], served["jmetrics"]
    assert got["speculative"] == want["speculative"]
    assert got["speculative"]["k"] == K and got["speculative"]["steps"] > 0
    assert got["tokens"] == want["tokens"]
    assert got["decode_steps"] == want["decode_steps"]


def test_speculative_false_on_a_draft_artifact_serves_plainly(arts,
                                                              tparams):
    sess = _session(arts["spec"], speculative=False)
    assert not sess.speculative and sess.chunked and sess.speculate_k == 0
    p, n = list(range(1, 20)), 8
    out = _drive(sess, [sess.submit(p, max_new_tokens=n)])[0]
    sess.close(drain=True)
    assert out["tokens"] == tdm.reference_generate(tparams, TSPEC, p, n)
    assert "accepted_tokens_per_step" not in out
    assert sess.metrics()["speculative"]["steps"] == 0


def test_speculative_true_needs_a_draft(arts):
    for path in (arts["v3"], arts["v5"]):
        with pytest.raises(mt.MXNetError, match="draft"):
            _session(path, speculative=True, warmup=False)


def test_eviction_mid_speculation_resumes_to_the_same_tokens(arts,
                                                             tparams):
    """An eviction lands between speculative steps: the tokens it
    carries are committed verifier tokens, and the cursor resumes to the
    uninterrupted stream on a speculative session and on a plain one."""
    prompt = [5, 9, 13]
    full = tdm.reference_generate(tparams, TSPEC, prompt, 24)
    sess = _session(arts["spec"], drain_tokens=2)
    req = sess.submit(prompt, max_new_tokens=24)
    sess.run_round()
    sess.run_round()
    sess.close(drain=True)
    with pytest.raises(mt.serve.Evicted) as ei:
        req.result(timeout=0.1)
    exc = ei.value
    assert 0 < len(exc.tokens) < 24 and exc.tokens == full[:len(exc.tokens)]
    remaining = exc.cursor["remaining_tokens"]
    assert remaining == 24 - len(exc.tokens)
    for path in (arts["spec"], arts["v5"]):
        s2 = _session(path)
        out = _drive(s2, [s2.submit(exc.cursor["resume_prompt"],
                                    max_new_tokens=remaining)])[0]
        s2.close(drain=True)
        assert exc.tokens + out["tokens"] == full


def test_one_device_to_host_copy_per_speculative_step(arts, monkeypatch):
    sess = _session(arts["spec"])
    copies = []
    real_cpu = torch.Tensor.cpu

    def counting_cpu(self, *a, **kw):
        copies.append(tuple(self.shape))
        return real_cpu(self, *a, **kw)
    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    reqs = [sess.submit(p, max_new_tokens=n) for p, n, _t, _s in WORK[:3]]
    reqs.append(sess.submit(list(range(2, 15)), max_new_tokens=9))
    _drive(sess, reqs)
    monkeypatch.undo()
    sess._publish_window(force=True)
    snap = sess.metrics_.snapshot()
    steps, prefills = snap["decode_steps"], snap["prefill"]["batches"]
    assert prefills >= 2 and steps >= 1   # a batched group and a long one
    assert sess.d2h_copies == len(copies) == steps + prefills
    assert copies.count((SPEC["max_slots"], K + 2)) == steps
    sp = snap["speculative"]
    assert sp["steps"] >= steps and sp["accepted_tokens_per_step"] >= 1.0
    sess.close(drain=True)


def test_eos_stops_inside_a_window(params, qparams, tparams, tmp_path):
    """A stop token accepted in the middle of a speculative window ends
    the request there, as plain decode would."""
    base = tdm.reference_generate(tparams, TSPEC, [5, 9, 13], 12)
    spec = TSPEC._replace(eos_id=int(base[5]))
    want = tdm.reference_generate(tparams, spec, [5, 9, 13], 12)
    assert want[-1] == spec.eos_id and len(want) < 12
    path = str(tmp_path / "eos.mxtorch")
    mt.serving.export_generate(params, spec, path, draft_params=qparams,
                               speculate_k=K)
    for speculative in (True, False):
        sess = _session(path, speculative=speculative)
        out = _drive(sess, [sess.submit([5, 9, 13], max_new_tokens=12)])[0]
        sess.close(drain=True)
        assert out["tokens"] == want and out["finish_reason"] == "stop"


def test_a_full_cache_keeps_every_slots_tokens(arts, tparams):
    """Four requests that each reserve 8 pages (3 + 25 tokens + k = 31
    rows; 28 rows, 7 pages, without the window) hold all 32 pages: every
    speculative window writes into its own pages up to the last one, the
    fifth request waits, and every token is the reference's."""
    work = [([3 + i, 9, 13], 25, 0.0, 0) for i in range(4)]
    work.append(([7, 7], 4, 0.8, 2))
    sess = _session(arts["spec"])
    reqs = [sess.submit(p, max_new_tokens=n, temperature=t, seed=s)
            for p, n, t, s in work]
    sess.run_round()
    assert sess.cache.free_pages == 0
    assert [len(s.pages) for s in sess._slots] == [8] * 4
    assert sess.metrics()["queue"]["depth"] == 1
    outs = _drive(sess, reqs)
    sess.close(drain=True)
    for (p, n, t, s), o in zip(work, outs):
        assert o["tokens"] == tdm.reference_generate(
            tparams, TSPEC, p, n, temperature=t, seed=s)


# ------------------------------------------------------- the artifact
def test_format5_round_trip_with_a_draft(arts, params, qparams, tmp_path):
    meta = arts["meta"]
    assert meta["format_version"] == 5
    assert meta["generate"]["speculate_k"] == K
    assert meta["kernel_tier"]["kernels"]["draft_verify"] == {
        "flash_attn_paged": SPEC["num_layers"] * (K + 1)}
    got, draft = mt.serving.load_bundled_params(arts["spec"])
    for name, want in params.items():
        np.testing.assert_array_equal(got[name], want)
    assert sorted(draft) == sorted(qparams)
    for name, want in qparams.items():
        assert draft[name].dtype == want.dtype
        np.testing.assert_array_equal(draft[name], want)
    assert mt.serving.load_bundled_params(arts["v5"])[1] is None
    m = mt.serving.load_artifact(arts["spec"], device="cpu")
    assert m.speculative and m.speculate_k == K and m.has_chunk_prefill
    assert callable(m.draft_verify) and callable(m.draft_chunk_prefill)
    plain = mt.serving.load_artifact(arts["v5"], device="cpu")
    assert not plain.speculative and plain.speculate_k == 0
    assert plain.draft_verify is None and plain.has_chunk_prefill
    # the default depth is the roofline pick; a draft needs chunking
    path = str(tmp_path / "auto_k.mxtorch")
    meta = mt.serving.export_generate(params, TSPEC, path,
                                      draft_params=qparams)
    assert meta["generate"]["speculate_k"] == \
        tdm.suggest_speculation_depth(TSPEC)
    with pytest.raises(mt.MXNetError, match="chunked prefill"):
        mt.serving.export_generate(params, TSPEC, path, chunked=False,
                                   draft_params=qparams)


def test_server_draft_modes(arts, tmp_path):
    cfg = dict(timeout_ms=0, warmup=False)
    cases = [(arts["spec"], "auto", True), (arts["spec"], "on", True),
             (arts["spec"], "off", False), (arts["spec"], None, True),
             (arts["v5"], "auto", False), (arts["v3"], "off", False)]
    for path, draft, spec in cases:
        srv = mt.serve.Server(path, config=mt.serve.GenerateConfig(**cfg),
                              device="cpu", auto_start=False, draft=draft)
        assert srv.session.speculative is spec, (path, draft)
        srv.close(drain=False)
    srv = mt.serve.Server(arts["spec"], config=mt.serve.GenerateConfig(
        **cfg), device="cpu", auto_start=False, draft="on")
    req = srv.submit_generate([5, 9, 13], max_new_tokens=6)
    for _ in range(20):
        if req.done():
            break
        srv.session.run_round()
    assert req.result(timeout=1)["accepted_tokens_per_step"] >= 1.0
    srv.close()
    with pytest.raises(mt.MXNetError, match="draft"):
        mt.serve.Server(arts["v5"], config=mt.serve.GenerateConfig(**cfg),
                        device="cpu", draft="on")
    with pytest.raises(mt.MXNetError, match="'auto', 'on' or 'off'"):
        mt.serve.Server(arts["spec"], device="cpu", draft="sometimes")
    data = mt.sym.Variable("data")
    net = mt.sym.FullyConnected(data, num_hidden=3, name="fc")
    ppath = str(tmp_path / "fc.mxtorch")
    mt.serving.export_compiled(net, {
        "fc_weight": np.ones((3, 4), np.float32),
        "fc_bias": np.zeros(3, np.float32)}, {}, {"data": (None, 4)}, ppath,
        device="cpu")
    with pytest.raises(mt.MXNetError, match="generate-mode"):
        mt.serve.Server(ppath, device="cpu", draft="off")
