"""Multi-process worker for the port's distributed tests, on the CPU
over gloo. Run through the port's launcher, one mode a launch::

    python -m mxnet_tpu_torch.tools.launch -n 3 \\
        python tests/torch_dist_worker.py invariants

Modes:

* ``invariants [device]``: the reference nightly ``dist_sync_kvstore.py``'s
  invariants (init as a broadcast, the ``test`` optimizer's
  ``w = (n+1)*n*rate/2*(i+1) + 1``, aggregate-replace, row_sparse keys,
  2-bit compression across the wire, rank/num_workers/barrier), then
  ``dist_async`` through rank 0's server (every push applied once, a
  server command) and ``allreduce_tree``/``allgather``/``broadcast``;
  at 3 ranks also ``get_num_dead_node`` while the last rank stops
  beating. Every value on ``device`` (the CPU by default; ``cuda:0``
  on the card, all ranks sharing it).
* ``train``: the invariants above, then ``Module.fit(kvstore=
  "dist_sync")`` of the little net on each rank's shard; then the same under ``MXNET_DDP`` at two bucket
  sizes. Every rank's weights equal rank 0's; the two DDP runs are
  bitwise each other and the kvstore path's. Rank 0 writes the kvstore
  run's weights to ``$DIST_TRAIN_DUMP``. Then a Gluon ``Trainer`` at
  ``dist_sync`` (and under ``MXNET_DDP``, bitwise it) and at
  ``dist_async``.
* ``resume``: ``fit`` at ``dist_sync`` as ``train`` runs it, under the
  launcher's checkpoint directory; rank 0 writes the final weights to
  ``$FAULT_TRAIN_DUMP``.
* ``collectives <device>``: ``allreduce_sum``, ``broadcast``,
  ``allgather`` and a ``GradReducer``'s buckets on ``<device>`` tensors
  (``cuda:0`` on the card) bitwise the same calls on the CPU's.

Imports ``mxnet_tpu_torch`` and numpy only.
"""
import logging
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import numpy as np  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch import config  # noqa: E402
from mxnet_tpu_torch.parallel import dist, fault  # noqa: E402
from torch_dist_common import (EPOCHS, PER_WORKER_BATCH, SGD,  # noqa: E402
                               fixed_params, full_data, make_net, shard)

SHAPE = (2, 3)
BIG_SHAPE = (120, 120)
RATE = 2


def host(v):
    return v.asnumpy() if hasattr(v, "asnumpy") else v.detach().numpy()


def same_everywhere(arr, what):
    """``arr`` bitwise rank 0's."""
    theirs = dist.broadcast(arr, root=0)
    np.testing.assert_array_equal(arr, theirs, err_msg="rank %d diverged "
                                  "from rank 0 on %s" % (dist.rank(), what))


def invariants():
    kv = mt.kv.create("dist_sync")
    rank, n = kv.rank, kv.num_workers
    assert n == int(os.environ["MXNET_NUM_WORKERS"]), n
    assert rank == int(os.environ["MXNET_WORKER_RANK"]), rank

    # init is a broadcast: rank 0's random value everywhere
    rng = np.random.RandomState(100 + rank)
    kv.init("b0", mt.nd.array(rng.randn(*SHAPE).astype(np.float32)))
    want = np.random.RandomState(100).randn(*SHAPE).astype(np.float32)
    got = mt.nd.zeros(SHAPE)
    kv.pull("b0", out=got)
    np.testing.assert_array_equal(host(got), want)
    # the store keeps the value where it came from
    assert kv._store["b0"].device == got._data.device, kv._store["b0"]

    # the 'test' optimizer in the store: w += rate * sum of the pushes
    for keys, shape in ((["3", "5", "7"], SHAPE), (["99"], BIG_SHAPE)):
        kv2 = mt.kv.create("dist_sync")
        kv2.set_optimizer(mt.optimizer.create("test", rescale_grad=RATE))
        for k in keys:
            kv2.init(k, mt.nd.ones(shape))
        for i in range(3):
            for k in keys:
                kv2.push(k, mt.nd.ones(shape) * (rank + 1))
                expected = (n + 1) * n * RATE / 2 * (i + 1) + 1
                val = mt.nd.zeros(shape)
                kv2.pull(k, out=val)
                assert (host(val) == expected).all(), (rank, k, i)

    # no updater: the reduced push replaces the stored value
    kv.init("r0", mt.nd.zeros(SHAPE))
    kv.push("r0", mt.nd.ones(SHAPE) * (rank + 1))
    val = mt.nd.zeros(SHAPE)
    kv.pull("r0", out=val)
    assert (host(val) == n * (n + 1) / 2).all(), host(val)

    # row_sparse keys
    kv.init("rsp", mt.nd.zeros(SHAPE).tostype("row_sparse"))
    v = np.zeros(SHAPE, np.float32)
    v[rank % SHAPE[0]] = rank + 1
    kv.push("rsp", mt.nd.array(v).tostype("row_sparse"))
    out = mt.nd.zeros(SHAPE)
    kv.pull("rsp", out=out, ignore_sparse=False)
    expected = np.zeros(SHAPE, np.float32)
    for r in range(n):
        expected[r % SHAPE[0]] += r + 1
    np.testing.assert_array_equal(host(out), expected)

    # 2-bit compression: the packed codes cross the group
    kvc = mt.kv.create("dist_sync")
    kvc.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kvc.init("c0", mt.nd.zeros(SHAPE))
    kvc.push("c0", mt.nd.ones(SHAPE))        # 1.0 >= 0.5 -> +0.5
    kvc.pull("c0", out=out)
    assert (host(out) == 0.5 * n).all(), host(out)
    kvc.push("c0", mt.nd.zeros(SHAPE))       # the residual 0.5 -> +0.5
    kvc.pull("c0", out=out)
    assert (host(out) == 0.5 * n).all(), host(out)
    assert kvc._last_wire_bytes == (int(np.prod(SHAPE)) + 3) // 4

    # the collectives themselves
    tree = dist.allreduce_tree({"a": np.full((3,), rank + 1, np.float32),
                                "b": np.full((2, 2), 1.0, np.float32)},
                               bucket_bytes=16)
    assert (tree["a"] == n * (n + 1) / 2).all() and (tree["b"] == n).all()
    g = dist.allgather(np.array([rank], np.int64))
    assert g.tolist() == [[r] for r in range(n)], g
    assert dist.broadcast(np.array([rank + 7]), root=n - 1)[0] == n + 6

    # dist_async: every push goes to rank 0's server and is applied once
    kva = mt.kv.create("dist_async")
    kva.init("w", mt.nd.zeros(SHAPE))
    kva.set_optimizer(mt.optimizer.create("sgd", learning_rate=1.0))
    assert kva._updater is None, "an async worker updates nothing itself"
    kva._barrier()
    for _ in range(rank + 1):
        kva.push("w", mt.nd.ones(SHAPE))
    kva._barrier()
    kva.pull("w", out=out)
    total = n * (n + 1) // 2
    assert (host(out) == -total).all(), host(out)
    if rank == 0:
        stats = kva._async_client.call("stats")
        assert len(stats["pushes"]) == total, stats
        kva._send_command_to_servers(0, "profile_on")
        assert kva._async_client.call("stats")["commands"] == \
            [(0, "profile_on")]
    kva._barrier()

    kv._barrier()
    assert kv.get_num_dead_node(timeout=30) == 0
    if n >= 3:
        dead_node(kv, rank, n)
    print("rank %d/%d: all dist_sync invariants OK" % (rank, n))


def dead_node(kv, rank, n):
    """The last rank stops beating; the others see one dead node."""
    hb = os.environ["MXNET_HEARTBEAT_DIR"]
    assert fault.active(), "dist.init should have started the heartbeat"
    dist.barrier("fault_start")
    if rank == n - 1:
        fault.stop()
        os.remove(os.path.join(hb, "hb_%d" % rank))
        deadline = time.time() + 60
        while time.time() < deadline and not all(
                os.path.exists(os.path.join(hb, "done_%d" % r))
                for r in range(n - 1)):
            time.sleep(0.1)
    else:
        deadline = time.time() + 60
        while kv.get_num_dead_node(timeout=1.0) < 1:
            assert time.time() < deadline, "get_num_dead_node stayed 0"
            time.sleep(0.1)
        with open(os.path.join(hb, "done_%d" % rank), "w") as f:
            f.write("1")
    dist.barrier("fault_end")
    print("rank %d/%d: fault detection OK" % (rank, n))


def fit_once(kv, ddp=False, bucket_mb=0.0):
    mt.random.seed(7)
    rank, n = dist.rank(), dist.num_workers()
    X, Y = shard(*full_data(n), rank)
    it = mt.io.NDArrayIter(X, Y, batch_size=PER_WORKER_BATCH,
                           label_name="softmax_label")
    sym = make_net(mt.sym)
    mod = mt.mod.Module(sym, context=mt.cpu())
    with config.override(ddp=ddp, ddp_bucket_mb=bucket_mb):
        mod.fit(it, num_epoch=EPOCHS, kvstore=kv, optimizer="sgd",
                optimizer_params=dict(
                    SGD, rescale_grad=1.0 / (PER_WORKER_BATCH * n)),
                arg_params=fixed_params(sym), initializer=None)
    args, _ = mod.get_params()
    return {k: host(v) for k, v in args.items()}, mod


def fit():
    rank, n = dist.rank(), dist.num_workers()
    ref, mod = fit_once(mt.kv.create("dist_sync"))
    assert mod._update_on_kvstore and not mod._ddp
    for k in sorted(ref):
        same_everywhere(ref[k], k)
    if rank == 0 and os.environ.get("DIST_TRAIN_DUMP"):
        np.savez(os.environ["DIST_TRAIN_DUMP"], **ref)
    # ~300-byte buckets split the net over several all-reduces
    tiny, tmod = fit_once(mt.kv.create("dist_sync"), True, 0.0003)
    huge, hmod = fit_once(mt.kv.create("dist_sync"), True, 64.0)
    ts, hs = tmod.ddp_stats(), hmod.ddp_stats()
    assert tmod._ddp and hmod._ddp
    assert ts["buckets"] >= 2 and hs["buckets"] == 1, (ts, hs)
    assert ts["collectives"] == ts["buckets"] * len(ts["reduce_ms"])
    for k in sorted(ref):
        np.testing.assert_array_equal(tiny[k], huge[k], err_msg=k)
        # two ranks: one order of sum, so DDP is the kvstore path bitwise
        np.testing.assert_array_equal(tiny[k], ref[k], err_msg=k)
    print("rank %d/%d: dist training converged identically (buckets %d "
          "vs %d)" % (rank, n, ts["buckets"], hs["buckets"]))


def gluon_run(kvstore, steps=8, ddp=False):
    rank = dist.rank()
    rng = np.random.RandomState(100 + rank)
    net = mt.gluon.nn.Dense(1, in_units=1)
    net.initialize(mt.init.Constant(0.0), ctx=mt.cpu())
    with config.override(ddp=ddp):
        trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.05},
                                   kvstore=kvstore)
        losses = []
        for _ in range(steps):
            x = mt.nd.array(rng.randn(16, 1).astype("f4"))
            y = x * 2.0 + 1.0
            with mt.autograd.record():
                loss = ((net(x) - y) ** 2).mean()
            loss.backward()
            trainer.step(1)
            losses.append(float(host(loss)))
    params = {k: host(p.data()).copy()
              for k, p in net.collect_params().items()}
    return params, losses, trainer


def gluon():
    rank, n = dist.rank(), dist.num_workers()
    sync, losses, tr = gluon_run("dist_sync")
    assert tr._update_on_kvstore and losses[-1] < losses[0], losses
    ddp, _, tr = gluon_run("dist_sync", ddp=True)
    assert tr._ddp and not tr._update_on_kvstore
    for (k, a), b in zip(sorted(sync.items()), [v for _, v in
                                               sorted(ddp.items())]):
        same_everywhere(a, k)
        np.testing.assert_array_equal(a, b, err_msg=k)
    params, losses, tr = gluon_run("dist_async", steps=30)
    assert losses[-1] < losses[0] * 0.5, losses
    dist.barrier("async_done")
    if rank == 0:
        pushes = tr._kvstore._async_client.call("stats")["pushes"]
        assert len(pushes) == 30 * n * 2, len(pushes)
    print("rank %d/%d: gluon dist_sync, ddp and dist_async OK" % (rank, n))


def resume():
    logging.basicConfig(level=logging.INFO)
    rank, n = dist.rank(), dist.num_workers()
    params, _ = fit_once(mt.kv.create("dist_sync"))
    if rank == 0 and os.environ.get("FAULT_TRAIN_DUMP"):
        np.savez(os.environ["FAULT_TRAIN_DUMP"], **params)
    print("rank %d/%d: elastic training run complete" % (rank, n))


def collectives(device):
    import torch
    dev = torch.device(device)
    rank, n = dist.rank(), dist.num_workers()
    g = torch.Generator().manual_seed(rank)
    for dtype in (torch.float32, torch.bfloat16, torch.int64):
        x = (torch.randn(1000, generator=g) * 100).to(dtype)
        for fn in (dist.allreduce_sum, lambda t: dist.broadcast(t, root=1),
                   dist.allgather):
            want, got = fn(x), fn(x.to(dev))
            assert got.device == dev and got.dtype == want.dtype
            assert torch.equal(got.cpu(), want), (fn, dtype)
    entries = [("w%d" % i, (37 * (i + 1), 5), torch.float32)
               for i in range(6)]
    grads = {k: torch.randn(s, generator=g) for k, s, _ in entries}
    red = mt.parallel.ddp.GradReducer(entries, bucket_bytes=2048,
                                      axis_size=n)
    assert red.stats()["buckets"] > 1
    want = red.reduce(grads)
    got = red.reduce({k: v.to(dev) for k, v in grads.items()})
    for k in grads:
        assert got[k].device == dev and torch.equal(got[k].cpu(), want[k])
    print("rank %d/%d: collectives on %s bitwise the CPU's" % (rank, n,
                                                               device))


def main():
    mode = sys.argv[1]
    if mode == "collectives":
        collectives(sys.argv[2])
        dist.shutdown()
        return 0
    dev = sys.argv[2] if len(sys.argv) > 2 else "cpu"
    with (mt.cpu() if dev == "cpu" else mt.gpu(0)):
        if mode == "train":
            invariants()
            fit()
            gluon()
        elif mode == "invariants":
            invariants()
        else:
            resume()
    dist.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
