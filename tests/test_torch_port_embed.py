"""Port parity for the embeddings and the recommend serving path.

The same numpy inputs go through the JAX package's ``embed`` (on the
CPU, tier off: its gathers are ``jnp.take``) and the port's (CPU
tensors: ``take_rows``'s plain version). Tolerances:

* ``row_init``, the cache's slot plans, buffers and ``stats()`` and the
  spill store's contents are exact;
* two-tower training through the cache is bitwise across capacities
  (and equal to the dense table) within the port, and within 1e-6
  (absolute, on rows of scale 0.01) of the JAX package's final tables;
* served items equal the JAX engine's and the float64 oracle's; scores
  within rtol 1e-6, as the JAX package's own test holds them.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import config as jconfig
from mxnet_tpu import embed as jembed
from mxnet_tpu.embed import serve as jserve
from mxnet_tpu.serving import load_artifact as jload_artifact

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import embed as tembed
from mxnet_tpu_torch import perfmodel, profiler
from mxnet_tpu_torch.embed import serve as tserve
from mxnet_tpu_torch.kernels import tier as ttier
from mxnet_tpu_torch.serve import Server, ServerBusy

U, I, D = 64, 24, 8
MAX_IDS, K = 8, 5


def _tables():
    return (tembed.row_init(1, np.arange(U), D),
            tembed.row_init(2, np.arange(I), D))


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The same two tables exported by both packages."""
    d = tmp_path_factory.mktemp("reco")
    user, item = _tables()
    jpath, tpath = str(d / "twotower.mxtpu"), str(d / "twotower.mxtorch")
    jserve.export_recommend(user, item, jpath, max_ids=MAX_IDS, k=K)
    tserve.export_recommend(user, item, tpath, max_ids=MAX_IDS, k=K)
    return jpath, tpath


def _id_stream(seed, n, per, rows):
    rng = np.random.RandomState(seed)
    return [((rng.zipf(1.3, size=per) - 1) % rows).astype(np.int64)
            for _ in range(n)]


# ------------------------------------------------------------- row_init
@pytest.mark.parametrize("seed,dim", [(0, 8), (1, 64), (7, 3)])
def test_row_init_is_bitwise_the_jax_packages(seed, dim):
    ids = np.array([0, 5, 3, 4095, 65535, 5])
    got = tembed.row_init(seed, ids, dim)
    np.testing.assert_array_equal(got, jembed.row_init(seed, ids, dim))
    # per row and order-independent
    np.testing.assert_array_equal(got[1], tembed.row_init(seed, [5], dim)[0])


# ------------------------------------------------------- cache and spill
def test_spill_store_budget_gate():
    store = tembed.SpillStore(64, 8, seed=0, budget_bytes=10 * 8 * 4)
    assert store.logical_bytes > store.budget_bytes
    store.put(np.arange(10), np.zeros((10, 8), np.float32))
    with pytest.raises(mt.MXNetError, match="host spill store exceeded"):
        store.put(np.arange(10, 14), np.zeros((4, 8), np.float32))


@pytest.mark.parametrize("capacity", [16, 48])
def test_cache_plans_buffers_and_stats_equal_the_jax_caches(capacity):
    """One Zipf id stream through both caches: the same slots, buffer
    rows and counters after every step, with rows rewritten and marked
    dirty each step so that evictions spill; then the same flushed
    store."""
    jstore = jembed.SpillStore(U, D, seed=1)
    tstore = tembed.SpillStore(U, D, seed=1)
    jc = jembed.HotRowCache(jstore, capacity)
    tc = tembed.HotRowCache(tstore, capacity, device="cpu")
    for step, ids in enumerate(_id_stream(4, 12, 10, U)):
        js, ts = jc.ensure(ids), tc.ensure(ids)
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tc.buf.numpy(), np.asarray(jc.buf))
        assert tc.stats() == jc.stats()
        # a "training step": each touched row moves once, by the same
        bump = np.float32(step + 1) * np.float32(1e-3)
        touched = np.unique(js)
        jc.buf = jc.buf.at[touched].add(bump)
        tc.buf[torch.from_numpy(touched).long()] += bump
        jc.note_updated(ids)
        tc.note_updated(ids)
    if capacity == 16:
        assert tc.stats()["spill_bytes"] > 0
    assert jc.flush() == tc.flush()
    assert tc.stats() == jc.stats()
    np.testing.assert_array_equal(tstore.peek(np.arange(U)),
                                  jstore.peek(np.arange(U)))


def test_cache_refuses_a_working_set_above_capacity():
    c = tembed.HotRowCache(tembed.SpillStore(U, D), 4, device="cpu")
    with pytest.raises(mt.MXNetError, match="touches 5 distinct rows but "
                       "the cache holds 4"):
        c.ensure([1, 2, 3, 4, 5])


def test_spill_and_flush_record_one_d2h_each():
    c = tembed.HotRowCache(tembed.SpillStore(U, D), 4, device="cpu")
    c.ensure([0, 1, 2, 3])
    c.note_updated([0, 1, 2, 3])
    profiler.reset_sync_counters()
    c.ensure([10, 11])                      # evicts 0 and 1, both dirty
    assert profiler.sync_counters()["d2h"] == 1
    assert c.flush() == 2                   # 2 and 3
    st = profiler.sync_counters()
    assert st["d2h"] == 2 and st["d2h_bytes"] == 4 * D * 4
    assert c.stats()["spill_bytes"] == 4 * D * 4


# ---------------------------------------------------- two-tower training
B, STEPS, LR = 8, 6, 0.5


def _stream():
    rng = np.random.RandomState(3)
    return (rng.randint(0, U, size=(STEPS, B)).astype(np.int64),
            rng.randint(0, I, size=(STEPS, B)).astype(np.int64),
            rng.randn(STEPS, B).astype(np.float32))


def _torch_step(u_buf, i_buf, us, isl, r):
    """bench.py's two-tower step in torch: each row's contributions
    summed in batch order (index_put_ accumulate), then one update."""
    us, isl = torch.as_tensor(us).long(), torch.as_tensor(isl).long()
    uv, iv = u_buf[us], i_buf[isl]
    err = (uv * iv).sum(-1) - torch.as_tensor(r)
    d = (2.0 / B) * err
    gu = torch.zeros_like(u_buf).index_put_((us,), d[:, None] * iv,
                                            accumulate=True)
    gi = torch.zeros_like(i_buf).index_put_((isl,), d[:, None] * uv,
                                            accumulate=True)
    u_buf.sub_(LR * gu)
    i_buf.sub_(LR * gi)


def _port_cached(cap):
    u_ids, i_ids, ratings = _stream()
    budget = (U - 8) * D * 4
    store_u = tembed.SpillStore(U, D, seed=1, budget_bytes=budget)
    store_i = tembed.SpillStore(I, D, seed=2)
    cu = tembed.HotRowCache(store_u, cap, device="cpu")
    ci = tembed.HotRowCache(store_i, I, device="cpu")
    for s in range(STEPS):
        us, isl = cu.ensure(u_ids[s]), ci.ensure(i_ids[s])
        _torch_step(cu.buf, ci.buf, us, isl, ratings[s])
        cu.note_updated(u_ids[s])
        ci.note_updated(i_ids[s])
    cu.flush(), ci.flush()
    return (store_u.peek(np.arange(U)), store_i.peek(np.arange(I)),
            cu.stats())


def test_two_tower_training_is_bitwise_across_capacities():
    u_ids, i_ids, ratings = _stream()
    u_ref = torch.from_numpy(tembed.row_init(1, np.arange(U), D))
    i_ref = torch.from_numpy(tembed.row_init(2, np.arange(I), D))
    for s in range(STEPS):
        _torch_step(u_ref, i_ref, u_ids[s], i_ids[s], ratings[s])
    for cap in (16, 24, 48):
        u_c, i_c, st = _port_cached(cap)
        np.testing.assert_array_equal(u_c, u_ref.numpy())
        np.testing.assert_array_equal(i_c, i_ref.numpy())
        if cap < 48:
            assert st["spill_bytes"] > 0     # the cache really spilled


def test_two_tower_training_matches_the_jax_package():
    u_ids, i_ids, ratings = _stream()
    lr = np.float32(LR)
    store_u = jembed.SpillStore(U, D, seed=1)
    store_i = jembed.SpillStore(I, D, seed=2)
    cu, ci = jembed.HotRowCache(store_u, 24), jembed.HotRowCache(store_i, I)

    @jax.jit
    def step(u_buf, i_buf, us, isl, r):
        uv, iv = u_buf[us], i_buf[isl]
        err = (uv * iv).sum(-1) - r
        d = (2.0 / B) * err
        gu = jnp.zeros_like(u_buf).at[us].add(d[:, None] * iv)
        gi = jnp.zeros_like(i_buf).at[isl].add(d[:, None] * uv)
        return u_buf - lr * gu, i_buf - lr * gi

    for s in range(STEPS):
        us, isl = cu.ensure(u_ids[s]), ci.ensure(i_ids[s])
        cu.buf, ci.buf = step(cu.buf, ci.buf, us, isl, ratings[s])
        cu.note_updated(u_ids[s])
        ci.note_updated(i_ids[s])
    cu.flush(), ci.flush()
    u_c, i_c, st = _port_cached(24)
    np.testing.assert_allclose(u_c, store_u.peek(np.arange(U)), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(i_c, store_i.peek(np.arange(I)), rtol=0,
                               atol=1e-6)
    assert st == cu.stats()


# ----------------------------------------------------- recommend serving
ID_LISTS = [[3, 9, 9, 60], [0], [5, 1, 2], list(range(12))]


def _oracle(user, corpus, ids):
    vec = user[np.asarray(ids[:MAX_IDS])].astype(np.float64).mean(0)
    scores = corpus.astype(np.float64) @ vec
    top = np.argsort(-scores, kind="stable")[:K]
    return top, scores[top]


def test_recommend_batch_equals_the_jax_engine_and_the_oracle(artifacts):
    jpath, tpath = artifacts
    jeng = jload_artifact(jpath).engine(capacity=16, buckets=(4,))
    model = mt.serving.load_artifact(tpath, device="cpu")
    assert model.meta["format_version"] == 6
    teng = model.engine(capacity=16, buckets=(4,))
    with jconfig.override(kernel_tier="off"):
        js, ji = jeng.recommend_batch(ID_LISTS)
    profiler.reset_sync_counters()
    ts, ti = teng.recommend_batch(ID_LISTS)
    st = profiler.sync_counters()
    assert st["d2h"] == 1 and st["d2h_bytes"] == 4 * 2 * K * 4
    assert ts.dtype == np.float32 and ti.dtype == np.int32
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=1e-6)
    user, corpus = model.user_table, model.item_table
    for j, ids in enumerate(ID_LISTS):
        top, scores = _oracle(user, corpus, ids)
        np.testing.assert_array_equal(ti[j], top)
        np.testing.assert_allclose(ts[j], scores, rtol=1e-6)
    assert teng.stats() == jeng.stats()
    assert teng.stats()["gathers"] == sum(min(len(x), MAX_IDS)
                                          for x in ID_LISTS)
    assert teng.check_discipline() == []


def test_warm_touches_no_counter(artifacts):
    eng = mt.serving.load_artifact(artifacts[1], device="cpu").engine()
    before = eng.stats()
    eng.warm()
    assert eng.stats() == before and eng.requests == 0


def test_served_lookup_dispatches_the_gather_once_a_batch(artifacts):
    eng = mt.serving.load_artifact(artifacts[1], device="cpu").engine(
        capacity=32, buckets=(1, 4))
    with mt.config.override(kernel_tier="auto"):
        ttier.reset_stats()
        eng.recommend_batch(ID_LISTS[:3])
        eng.recommend_batch(ID_LISTS[3:])
        st = ttier.stats()
    assert st["dispatch"] == {"take_rows": 2} and not st["fallback"]


def test_a_jax_artifact_crosses_and_serves_the_same(artifacts, tmp_path):
    jpath, _ = artifacts
    user, item = tserve.tables_from_reference(jpath)
    ref_user, ref_item = _tables()
    np.testing.assert_array_equal(user, ref_user)
    np.testing.assert_array_equal(item, ref_item)
    path = str(tmp_path / "crossed.mxtorch")
    tserve.export_recommend(user, item, path, max_ids=MAX_IDS, k=K)
    with jconfig.override(kernel_tier="off"):
        js, ji = jload_artifact(jpath).engine().recommend_batch(ID_LISTS)
    srv = Server(path, device="cpu")
    try:
        for j, ids in enumerate(ID_LISTS):
            scores, items = srv.recommend(ids)
            np.testing.assert_array_equal(items, ji[j])
            np.testing.assert_allclose(scores, js[j], rtol=1e-6)
        m = srv.metrics()
        assert m["mode"] == "recommend" and m["embed"]["requests"] == 4
    finally:
        srv.close(drain=True)
    with pytest.raises(mt.MXNetError, match="not an mxnet_tpu artifact"):
        tserve.tables_from_reference(path)


def test_admission_bills_gather_units_and_caps_them(artifacts):
    """The JAX package's test: a 3-gather request is billed 3 units; a
    second one past MXNET_SERVE_MAX_GATHERS=4 is rejected with "cost
    cap"; the queued one still completes. A request is billed up to
    max_ids gathers, at least one."""
    with mt.config.override(serve_max_gathers=4):
        srv = Server(artifacts[1], auto_start=False, device="cpu")
    try:
        req = srv.submit_recommend([1, 2, 3])
        assert req.units == 3
        with pytest.raises(ServerBusy, match="cost cap"):
            srv.submit_recommend([4, 5, 6])
        srv.start()
        scores, items = req.result(timeout=30)
        assert len(items) == K and len(scores) == K
    finally:
        srv.close(drain=False)
    assert srv.engine.gather_unit_s() == max(
        perfmodel.recommend_request_seconds(1, D, I), 1e-9)
    srv = Server(artifacts[1], auto_start=False, device="cpu")
    try:
        assert srv.submit_recommend(list(range(40))).units == MAX_IDS
        assert srv.submit_recommend([]).units == 1
    finally:
        srv.close(drain=False)


def test_recommend_server_refusals(artifacts):
    with pytest.raises(mt.MXNetError, match="quantized=/draft= do not "
                       "apply to recommend artifacts"):
        Server(artifacts[1], device="cpu", draft="on")
    srv = Server(artifacts[1], auto_start=False, device="cpu")
    try:
        with pytest.raises(mt.MXNetError, match="submit_recommend"):
            srv.submit(np.zeros((1, 3), np.float32))
    finally:
        srv.close(drain=False)


def test_recommend_cost_model():
    got = perfmodel.recommend_request_seconds(64, 64, 4096)
    assert got == max(2.0 * 4096 * 64 / perfmodel.H100_F32_FLOPS_PER_S,
                      64 * 64 * 4 / perfmodel.H100_HBM_BYTES_PER_S)


def test_sharded_lookup_is_not_ported():
    with pytest.raises(mt.MXNetError, match="ROADMAP A6"):
        tembed.ShardedEmbedding(10, 4)
    with pytest.raises(mt.MXNetError, match="ROADMAP A6"):
        tembed.sharded_lookup(None, None)


def test_entry_points_default_to_the_card(artifacts):
    """The cache, the loaded model and the server run on cuda:0 unless
    the CPU is asked for; without a card they raise."""
    store = tembed.SpillStore(U, D)
    if torch.cuda.is_available():
        assert tembed.HotRowCache(store, 4).buf.device == torch.device(
            "cuda", 0)
        return
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        tembed.HotRowCache(store, 4)
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.serving.load_artifact(artifacts[1])
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        Server(artifacts[1])
