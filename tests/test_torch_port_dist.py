"""The port's multi-process training (``mxnet_tpu_torch/parallel/dist.py``,
``ddp.py``, ``async_server.py``, ``kvstore.py``'s ``dist_*``, the
launcher) against the JAX package, on the CPU over gloo.

In one process, on the same numpy inputs: the DDP bucket plans and
``GradReducer.stats`` at explicit byte bounds, the 2-bit pack and
dequantize (bitwise), the async server's weights after the same pushes
(each package's own server and client), and its refusals (a forged
frame, a replayed frame, a public bind without a secret). Across
processes, each launch through ``python -m mxnet_tpu_torch.tools.launch``
(run here as its file) with ``tests/torch_dist_worker.py``: the
reference nightly test's invariants at 2 and 3 ranks with dead-node
detection; ``Module.fit(kvstore="dist_sync")`` on 2 ranks against the
JAX package's one-process full-batch fit (rtol 2e-5, atol 2e-6, as
``tests/test_dist_kvstore.py``), DDP bitwise across bucket sizes and
bitwise the kvstore path, the Gluon Trainer at ``dist_sync`` and
``dist_async``; the failing rank's exit code; an injected kill of rank 0
resumed bitwise the uninterrupted run; the multi-host dry run."""
import hashlib
import hmac
import json
import os
import pickle
import socket
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import config as jconfig
from mxnet_tpu import kvstore as jkv
from mxnet_tpu.parallel import async_server as jas
from mxnet_tpu.parallel import ddp as jddp
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch import kvstore as tkv
from mxnet_tpu_torch.parallel import async_server as tas
from mxnet_tpu_torch.parallel import ddp as tddp
from mxnet_tpu_torch.parallel import dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
from torch_dist_common import (EPOCHS, PER_WORKER_BATCH, SGD,  # noqa: E402
                               fixed_params, full_data, interleaved,
                               make_net)

# the launcher is stdlib only: run as a file it skips the package's
# import (``python -m mxnet_tpu_torch.tools.launch`` is the same program)
LAUNCH = [sys.executable,
          os.path.join(ROOT, "mxnet_tpu_torch", "tools", "launch.py")]
WORKER = os.path.join(ROOT, "tests", "torch_dist_worker.py")


def _env(**extra):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("MXNET_FAULT_INJECT", None)
    env.update(extra)
    return env


def _launch(args, timeout=300, **env):
    return subprocess.run(LAUNCH + args, capture_output=True, text=True,
                          timeout=timeout, env=_env(**env), cwd=ROOT)


# ------------------------------------------------------- in one process
ENTRIES = [("fc1_weight", (16, 8), np.float32), ("fc1_bias", (16,),
           np.float32), ("emb", (300, 64), np.float32),
           ("h", (7,), np.float16), ("h2", (9, 3), np.float16),
           ("fc2_weight", (4, 16), np.float32), ("fc2_bias", (4,),
           np.float32)]


@pytest.mark.parametrize("bucket_bytes", [64, 300, 4096, 1 << 20])
@pytest.mark.parametrize("reverse", [True, False])
def test_partition_buckets_equal_jax(bucket_bytes, reverse):
    t = tddp.partition_buckets(ENTRIES, bucket_bytes, reverse=reverse)
    j = jddp.partition_buckets(ENTRIES, bucket_bytes, reverse=reverse)
    assert [(b.keys, b.shapes, b.sizes, str(b.dtype), b.nbytes)
            for b in t] == [(b.keys, b.shapes, b.sizes, str(b.dtype),
                             b.nbytes) for b in j]
    # torch dtypes plan as their numpy twins
    tt = tddp.partition_buckets(
        [(k, s, getattr(torch, np.dtype(d).name)) for k, s, d in ENTRIES],
        bucket_bytes, reverse=reverse)
    assert [(b.keys, b.nbytes) for b in tt] == \
        [(b.keys, b.nbytes) for b in t]


@pytest.mark.parametrize("bucket_bytes", [256, 4 << 20])
def test_grad_reducer_stats_equal_jax(bucket_bytes):
    t = tddp.GradReducer(ENTRIES, bucket_bytes=bucket_bytes,
                         axis_size=2).stats()
    j = jddp.GradReducer(ENTRIES, axis_name="dp",
                         bucket_bytes=bucket_bytes, axis_size=2).stats()
    for k in ("buckets", "bucket_bytes", "bucket_bytes_plan",
              "comm_bytes"):
        assert t[k] == j[k], k
    # the model side reads the port's link (the host link, not a TPU's)
    with tconfig.override(ddp_bucket_mb=0.0):
        assert tddp.choose_bucket_bytes() == int(min(max(
            mt.perfmodel.group_link_bytes_per_s() * 20e-6 / 0.05, 1 << 20),
            64 << 20))
    with tconfig.override(ddp_bucket_mb=2.0), \
            jconfig.override(ddp_bucket_mb=2.0):
        assert tddp.choose_bucket_bytes() == jddp.choose_bucket_bytes() \
            == 2 << 20


def test_single_process_collectives_and_store():
    assert not dist.initialized() and dist.num_workers() == 1
    x = torch.arange(4.0)
    assert dist.allreduce_sum(x) is x
    assert dist.allgather(x).shape == (1, 4)
    kv = mt.kv.create("dist_sync")
    assert kv.num_workers == 1 and kv.rank == 0
    kv.init("a", mt.nd.ones((2, 2), ctx=mt.cpu()))
    kv.push("a", mt.nd.ones((2, 2), ctx=mt.cpu()) * 3)
    out = mt.nd.zeros((2, 2), ctx=mt.cpu())
    kv.pull("a", out=out)
    assert (out.asnumpy() == 3).all()
    with pytest.raises(mt.MXNetError, match="no parameter server"):
        kv._send_command_to_servers(0, "x")


@pytest.mark.parametrize("shape", [(13, 7), (4,), (3, 5, 2)])
def test_pack_2bit_bitwise_jax(shape):
    import jax.numpy as jnp
    rng = np.random.RandomState(len(shape))
    g = rng.randn(*shape).astype("f4")
    res = (rng.randn(*shape) * 0.3).astype("f4")
    for thr in (0.5, 1.25):
        tp, tr = tkv._pack_2bit(torch.from_numpy(g), torch.from_numpy(res),
                                thr)
        jp, jr = jkv._pack_2bit(jnp.asarray(g), jnp.asarray(res), thr)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        want = jkv._dequantize_2bit(np.asarray(jp), shape, thr)
        np.testing.assert_array_equal(
            tkv._dequantize_2bit(tp.numpy(), shape, thr), want)
        np.testing.assert_array_equal(
            tkv._dequantize_2bit(tp, shape, thr).numpy(), want)


def _server_run(mod, server, opt):
    cli = mod.Client("127.0.0.1", server.port)
    try:
        rng = np.random.RandomState(0)
        w0 = rng.randn(5, 3).astype("f4")
        cli.call("init", "w", w0)
        cli.call("init", "w", w0 * 0)            # the first writer wins
        cli.call("set_optimizer", pickle.dumps(opt))
        for i in range(4):
            cli.call("push", "w", rng.randn(5, 3).astype("f4"))
        packed = np.asarray(jkv._pack_2bit(
            np.full((5, 3), 0.7, "f4"), np.zeros((5, 3), "f4"), 0.5)[0])
        cli.call("pushq", "w", packed, (5, 3), 0.5)
        out = cli.call("pull", "w")
        stats = cli.call("stats")
        with pytest.raises(Exception, match="not initialized"):
            cli.call("push", "nope", np.zeros((1,), "f4"))
        return out, len(stats["pushes"])
    finally:
        cli.call("shutdown")
        cli.close()


@pytest.mark.parametrize("name,kw", [
    ("sgd", {"learning_rate": 0.5, "momentum": 0.9, "wd": 1e-3}),
    ("adagrad", {"learning_rate": 0.1})])
def test_async_server_apply_on_push_equals_jax(name, kw):
    t_out, t_n = _server_run(tas, tas.Server(device="cpu"),
                             mt.optimizer.create(name, **kw))
    j_out, j_n = _server_run(jas, jas.Server(), mx.optimizer.create(name,
                                                                   **kw))
    assert t_n == j_n == 5
    np.testing.assert_allclose(t_out, j_out, rtol=1e-6, atol=1e-7)


def test_async_server_refuses_forged_and_replayed_frames(monkeypatch):
    srv = tas.Server(device="cpu")
    try:
        # a well-formed frame with a wrong tag: dropped unparsed
        sock = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
        hello, _ = tas._recv_frame(sock)
        assert hello["op"] == "hello"
        payload = struct.pack("<I", 15) + b'{"op": "stats"}'
        sock.sendall(struct.pack("<Q", 32 + len(payload)) + b"\x00" * 32
                     + payload)
        sock.settimeout(5)
        assert sock.recv(1) == b""
        sock.close()
        # a valid frame sent twice: the replay lands on a stale counter
        sock = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
        hello, _ = tas._recv_frame(sock)
        chan = tas._Channel(bytes.fromhex(hello["challenge"]))
        hdr = json.dumps({"op": "stats"}).encode()
        payload = struct.pack("<I", len(hdr)) + hdr
        tag = hmac.new(tas._secret(), chan._mac_prefix() + payload,
                       hashlib.sha256).digest()
        frame = struct.pack("<Q", 32 + len(payload)) + tag + payload
        sock.sendall(frame)
        assert tas._recv_frame(sock, chan=chan)[0]["status"] == "ok"
        sock.sendall(frame)
        sock.settimeout(5)
        assert sock.recv(1) == b""
        sock.close()
        # an authenticated client still works
        cli = tas.Client("127.0.0.1", srv.port)
        cli.call("init", "k", np.ones((2,), "f4"))
        np.testing.assert_array_equal(cli.call("pull", "k"), [1, 1])
        cli.close()
    finally:
        tas.Client("127.0.0.1", srv.port).call("shutdown")
    monkeypatch.delenv("MXNET_KVSTORE_SECRET", raising=False)
    with pytest.raises(RuntimeError, match="MXNET_KVSTORE_SECRET"):
        tas.Server(bind="0.0.0.0")


# ------------------------------------------------------ across processes
@pytest.mark.parametrize("n", [2, 3])
def test_dist_sync_invariants(n, request):
    """At 2 ranks the training launch runs them first (one launch fewer);
    at 3 a launch of their own, with dead-node detection."""
    if n == 2:
        out = request.getfixturevalue("trained")[1]
    else:
        r = _launch(["-n", str(n), "--max-restarts", "0", "--env",
                     "MXNET_HEARTBEAT_INTERVAL=0.2", sys.executable, WORKER,
                     "invariants"])
        assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-2000:]
        out = r.stdout
    for rank in range(n):
        assert "rank %d/%d: all dist_sync invariants OK" % (rank, n) \
            in out, out[-4000:]
        if n >= 3:
            assert "rank %d/%d: fault detection OK" % (rank, n) in out


def test_launcher_propagates_failure():
    r = _launch(["-n", "2", "--max-restarts", "0", sys.executable, "-c",
                 "import sys, os; sys.exit(3 if os.environ["
                 "'MXNET_WORKER_RANK'] == '1' else 0)"], timeout=120)
    assert r.returncode == 3


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One 2-rank launch of the worker's ``train`` mode (the invariants,
    Module.fit on the kvstore path and under DDP, the Gluon Trainer) ->
    the kvstore run's weights (rank 0's dump) and the launch's stdout."""
    dump = str(tmp_path_factory.mktemp("dist") / "dist_params.npz")
    r = _launch(["-n", "2", "--max-restarts", "0", sys.executable, WORKER,
                 "train"], DIST_TRAIN_DUMP=dump)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-2000:]
    with np.load(dump) as z:
        return {k: z[k] for k in z.files}, r.stdout


def test_dist_fit_matches_jax_full_batch(trained):
    """2-process ``Module.fit(dist_sync)`` of the port equals the JAX
    package's one-process full-batch fit (no BN: the same math)."""
    dist_params, out = trained
    for rank in range(2):
        assert "rank %d/2: dist training converged identically" % rank \
            in out, out[-3000:]
    n = 2
    X, Y = full_data(n)
    order = interleaved(X, n)
    sym = make_net(mx.sym)
    mod = mx.mod.Module(sym)
    mod.fit(mx.io.NDArrayIter(X[order], Y[order],
                              batch_size=PER_WORKER_BATCH * n,
                              label_name="softmax_label"),
            num_epoch=EPOCHS, kvstore="local", optimizer="sgd",
            optimizer_params=dict(SGD, rescale_grad=1.0 / (
                PER_WORKER_BATCH * n)),
            arg_params={k: mx.nd.array(v) for k, v in
                        fixed_params(sym).items()}, initializer=None)
    args, _ = mod.get_params()
    assert sorted(args) == sorted(dist_params)
    for name, v in dist_params.items():
        np.testing.assert_allclose(args[name].asnumpy(), v, rtol=2e-5,
                                   atol=2e-6, err_msg=name)


def test_gluon_trainer_dist_sync_ddp_and_async(trained):
    out = trained[1]
    for rank in range(2):
        assert "rank %d/2: gluon dist_sync, ddp and dist_async OK" % rank \
            in out, out[-3000:]


def test_kill_resume_bitwise_matches_uninterrupted(trained, tmp_path):
    """An injected kill of rank 0 in 2-process dist_sync training is
    survived by the supervised restart, which resumes from the newest
    step both ranks saved; the final weights are the uninterrupted
    run's, bitwise."""
    killed = str(tmp_path / "killed.npz")
    r = _launch(["-n", "2", "--restart-backoff", "0.2", "--max-restarts",
                 "1", "--checkpoint-dir", str(tmp_path / "ckpt"), "--env",
                 "MXNET_FAULT_INJECT=kill@step=3:rank=0", sys.executable,
                 WORKER, "resume"], FAULT_TRAIN_DUMP=killed)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-2000:]
    assert "launch: restarting the group" in r.stderr, r.stderr[-3000:]
    assert "resumed from checkpoint step" in r.stdout, r.stdout[-3000:]
    base = trained[0]
    with np.load(killed) as z:
        assert sorted(z.files) == sorted(base)
        for k in z.files:
            np.testing.assert_array_equal(z[k], base[k], err_msg=k)


def test_multihost_and_singlehost_dry_runs():
    r = _launch(["-H", "me@hostA,hostB", "--heartbeat-dir", "/shared/hb",
                 "--ddp", "--dry-run", "python", "train.py"], timeout=60,
                MXNET_KVSTORE_SECRET="")
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 2
    for rank, line in enumerate(lines):
        assert line.startswith("[rank %d @ %s] printf" % (
            rank, ("me@hostA", "hostB")[rank]))
        assert "MXNET_COORDINATOR_ADDRESS=hostA:9091" in line
        assert "MXNET_WORKER_RANK=%d" % rank in line
        assert "MXNET_DDP=1" in line and "DMLC_ROLE=worker" in line
        assert "IFS= read -r MXNET_KVSTORE_SECRET" in line
    r = _launch(["-n", "2", "--dry-run", "python", "train.py"], timeout=60)
    lines = r.stdout.strip().splitlines()
    assert r.returncode == 0 and len(lines) == 2
    assert all("MXNET_NUM_WORKERS=2" in ln for ln in lines)
