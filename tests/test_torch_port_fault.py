"""The port's heartbeats and fault injection
(``mxnet_tpu_torch/parallel/fault.py``, ``faultinject.py``), the
launcher's supervision (``python -m mxnet_tpu_torch.tools.launch``) and
``fit`` under ``MXNET_FAULT_INJECT``: the grammar and its matching
against the JAX package's over a list of specs, the fired actions, the
heartbeat unit behaviour, and the launcher's restart summary. The
killed-and-resumed 2-process run is in ``test_torch_port_dist.py``,
beside the uninterrupted run it is held against."""
import json
import os
import subprocess
import sys
import time

import pytest

import mxnet_tpu_torch as mt
from mxnet_tpu.parallel import faultinject as jfi
from mxnet_tpu_torch.parallel import fault
from mxnet_tpu_torch.parallel import faultinject as tfi

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the launcher is stdlib only: run as a file it skips the package's
# import (``python -m mxnet_tpu_torch.tools.launch`` is the same program)
LAUNCH = [sys.executable,
          os.path.join(ROOT, "mxnet_tpu_torch", "tools", "launch.py")]

SPECS = ("kill@step=7:rank=0,delay@step=3:secs=0.5,"
         "conn_drop@call=push:count=2,conn_drop@serve=pull,"
         "kill@ckpt=4,truncate@ckpt=5:bytes=10,enospc@journal=append,"
         "torn_write@journal=append:bytes=3,slow_fsync@journal=fsync,"
         "raise@step=9:skip=2,bogus@step=1,kill@step=2:norank,"
         "kill@serve=decode_step:skip=6")
CTXS = [("step", {"step": 7}), ("step", {"step": 3}), ("step", {"step": 9}),
        ("call", {"op": "push"}), ("call", {"op": "pull"}),
        ("serve", {"op": "pull"}), ("ckpt", {"step": 4}),
        ("ckpt", {"step": 5, "path": "x"}), ("journal", {"op": "append"}),
        ("journal", {"op": "fsync"}), ("serve", {"op": "decode_step"})]


def _env():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("MXNET_FAULT_INJECT", None)
    return env


def _parsed(mod):
    return [(s.action, s.point, s.match, dict(s.kwargs), s.budget, s.skip,
             s.raw) for s in mod.specs()]


@pytest.mark.parametrize("rank", ["0", "1"])
def test_grammar_and_matching_equal_jax(monkeypatch, rank):
    monkeypatch.setenv("MXNET_FAULT_INJECT", SPECS)
    monkeypatch.setenv("MXNET_WORKER_RANK", rank)
    tfi.reset()
    jfi.reset()
    try:
        assert _parsed(tfi) == _parsed(jfi)
        assert len(_parsed(tfi)) == 11   # two malformed specs dropped
        for point, ctx in CTXS:
            for st, sj in zip(tfi.specs(), jfi.specs()):
                assert (st.point == point and st.matches(ctx)) == \
                    (sj.point == point and sj.matches(ctx)), (st.raw, ctx)
        # the firing budgets and skips advance alike
        for _ in range(4):
            got = [tfi._consume(s) for s in tfi.specs()]
            assert got == [jfi._consume(s) for s in jfi.specs()]
    finally:
        tfi.reset()
        jfi.reset()


def test_fired_actions(monkeypatch, tmp_path):
    p = tmp_path / "data.npz"
    p.write_bytes(b"x" * 100)
    monkeypatch.setenv("MXNET_FAULT_INJECT",
                       "truncate@ckpt=5:bytes=10,conn_drop@call=pull,"
                       "raise@step=2")
    tfi.reset()
    try:
        tfi.fire("ckpt", step=5, path=str(p))
        assert p.stat().st_size == 90
        with pytest.raises(tfi.InjectedConnDrop):
            tfi.fire("call", op="pull")
        tfi.fire("call", op="pull")          # a budget of one
        with pytest.raises(tfi.InjectedFault):
            tfi.fire("step", step=2)
        tfi.fire("step", step=3)
    finally:
        tfi.reset()


def test_heartbeat_tracker_unit(tmp_path, monkeypatch):
    d = str(tmp_path)
    monkeypatch.setenv("MXNET_HEARTBEAT_DIR", d)
    assert fault.start(0, interval=0.05)
    try:
        time.sleep(0.2)
        # rank 1 stale, rank 2 never wrote one (still in its grace)
        p1 = os.path.join(d, "hb_1")
        with open(p1, "w") as f:
            f.write("0 0")
        os.utime(p1, (time.time() - 100, time.time() - 100))
        assert fault.dead_nodes(3, timeout=5.0) == [1]
        assert 0 not in fault.dead_nodes(3, timeout=1.0)
    finally:
        fault.stop()


def test_heartbeat_no_dir_is_noop(monkeypatch):
    monkeypatch.delenv("MXNET_HEARTBEAT_DIR", raising=False)
    assert not fault.start(0)
    assert fault.dead_nodes(4, timeout=1.0) == []
    assert mt.kv.create("dist_sync").get_num_dead_node() == 0


def test_fit_under_fault_inject_trains(monkeypatch):
    """A spec that matches no step leaves fit to train; one that matches
    fires at that step (a raise here, a kill under the launcher)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_dist_common import fixed_params, full_data, make_net
    X, Y = full_data(1)
    sym = make_net(mt.sym)

    def fit():
        mod = mt.mod.Module(sym, context=mt.cpu())
        mod.fit(mt.io.NDArrayIter(X, Y, batch_size=16,
                                  label_name="softmax_label"),
                num_epoch=1, kvstore="local", optimizer="sgd",
                arg_params=fixed_params(sym), initializer=None,
                eval_metric=None)
    tfi.reset()
    try:
        monkeypatch.setenv("MXNET_FAULT_INJECT", "kill@step=999")
        fit()
        monkeypatch.setenv("MXNET_FAULT_INJECT", "raise@step=1")
        with pytest.raises(tfi.InjectedFault):
            fit()
    finally:
        tfi.reset()


def test_launcher_reports_dead_workers_and_restarts(tmp_path):
    r = subprocess.run(
        LAUNCH + ["-n", "2", "--max-restarts", "0", sys.executable, "-c",
                  "import sys, os; sys.exit(5 if os.environ["
                  "'MXNET_WORKER_RANK'] == '0' else 0)"],
        capture_output=True, text=True, timeout=120, cwd=ROOT, env=_env())
    assert r.returncode == 5
    assert "worker(s) [0] died" in r.stderr, r.stderr[-1000:]
    marker = tmp_path / "first_attempt_done"
    prog = ("import os, sys\n"
            "m = %r\n"
            "if os.environ['MXNET_WORKER_RANK'] == '0' and "
            "not os.path.exists(m):\n"
            "    open(m, 'w').close()\n"
            "    sys.exit(7)\n"
            "assert os.environ.get('MXNET_RESUME_DIR') or "
            "os.environ['MXNET_WORKER_RANK'] != '0'\n"
            "assert os.environ['GLOO_SOCKET_IFNAME'] == 'lo'\n" % str(marker))
    r = subprocess.run(
        LAUNCH + ["-n", "2", "--max-restarts", "2", "--restart-backoff",
                  "0.1", sys.executable, "-c", prog],
        capture_output=True, text=True, timeout=120, cwd=ROOT, env=_env())
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-2000:]
    summary = json.loads([ln for ln in r.stderr.splitlines()
                          if ln.startswith("launch: summary ")][-1]
                         .split("summary ", 1)[1])
    assert summary["restarts"] == 1
    assert summary["attempts"][0]["rc"] == 7
    assert summary["attempts"][0]["dead_ranks"] == [0]
    assert summary["attempts"][1]["resumed"] is True
