"""Heartbeat-based failure detection (counterpart of
``mxnet_tpu/parallel/fault.py``; the reference surfaces ps-lite
scheduler heartbeats through ``KVStore::num_dead_node``).

Every worker touches a per-rank heartbeat file under a shared directory
on a background thread; ``dead_nodes`` reports the ranks whose heartbeat
went stale. The launcher (``python -m mxnet_tpu_torch.tools.launch``)
provisions the directory (``MXNET_HEARTBEAT_DIR``) and
``parallel.dist.init`` starts the beat when the group is joined. A peer
that dies inside a collective also fails that collective: the group has
a finite timeout (``parallel.dist``), and gloo reports a closed
connection at once. Standard library only.
"""
from __future__ import annotations

import os
import threading
import time

__all__ = ["start", "stop", "dead_nodes", "heartbeat_dir", "active"]

_DEFAULT_INTERVAL = 1.0

_lock = threading.Lock()
_thread = None
_stop_evt = None
_started_at = None          # monotonic; see dead_nodes
# Liveness bookkeeping for dead_nodes: (dir, rank) -> [stat signature,
# monotonic stamp of the last observed change]. Staleness is judged on
# the MONOTONIC clock from the moment *this* process last saw the file
# change — a wall-clock step (NTP slew, manual date set) between polls
# can no longer mass-kill a healthy fleet. The wall/mtime delta is
# trusted exactly once, at first sight of a file, so a tracker that
# starts late still detects an already-stale heartbeat immediately.
_obs = {}


def heartbeat_dir():
    return os.environ.get("MXNET_HEARTBEAT_DIR") or None


def _hb_path(dir_, rank):
    return os.path.join(dir_, "hb_%d" % rank)


def _interval():
    try:
        return float(os.environ.get("MXNET_HEARTBEAT_INTERVAL",
                                    _DEFAULT_INTERVAL))
    except ValueError:
        return _DEFAULT_INTERVAL


def active():
    return _thread is not None and _thread.is_alive()


def start(rank, dir_=None, interval=None):
    """Begin heartbeating as ``rank`` (idempotent). No-op without a
    heartbeat directory."""
    global _thread, _stop_evt, _started_at
    dir_ = dir_ or heartbeat_dir()
    if dir_ is None:
        return False
    with _lock:
        if active():
            return True
        os.makedirs(dir_, exist_ok=True)
        interval = interval or _interval()
        _stop_evt = threading.Event()
        _started_at = time.monotonic()
        path = _hb_path(dir_, rank)

        def beat(evt=_stop_evt):
            # atomic write (temp + rename): dead_nodes readers and crash
            # forensics must never observe a partial "pid time" record
            tmp = path + ".tmp.%d" % os.getpid()
            while not evt.is_set():
                try:
                    with open(tmp, "w") as f:
                        f.write("%d %f" % (os.getpid(), time.time()))
                    os.replace(tmp, path)
                except OSError:
                    pass  # a vanished dir must not kill the worker
                evt.wait(interval)

        _thread = threading.Thread(target=beat, daemon=True,
                                   name="mxnet-heartbeat")
        _thread.start()
    return True


def stop():
    """Stop heartbeating and JOIN the beat thread, so a test reusing the
    tmpdir can't race a straggler writing one last heartbeat."""
    global _thread, _stop_evt
    with _lock:
        t, _thread = _thread, None
        if _stop_evt is not None:
            _stop_evt.set()
        _stop_evt = None
        _obs.clear()
    if t is not None and t.is_alive():
        t.join(timeout=10.0)


def dead_nodes(num_workers, timeout=60.0, dir_=None):
    """Ranks considered dead: heartbeat file unchanged for > ``timeout``
    seconds of MONOTONIC time since this process last saw it change, or
    never written although the group has been up longer than ``timeout``
    (startup grace period).  Wall-clock enters the verdict only at first
    sight of a file (how stale was it when we arrived?); after that a
    rank stays alive iff its heartbeat keeps changing, so an NTP step or
    operator ``date`` call between polls cannot mass-kill the fleet."""
    dir_ = dir_ or heartbeat_dir()
    if dir_ is None or not os.path.isdir(dir_):
        return []
    mono_now = time.monotonic()
    up_since = _started_at if _started_at is not None else mono_now
    dead = []
    for r in range(num_workers):
        path = _hb_path(dir_, r)
        try:
            st = os.stat(path)
        except OSError:
            _obs.pop((dir_, r), None)   # reappearance = fresh sighting
            if mono_now - up_since > timeout:
                dead.append(r)
            continue
        sig = (st.st_mtime_ns, st.st_size)
        rec = _obs.get((dir_, r))
        if rec is None:
            # first sighting: trust the wall/mtime delta once, so an
            # already-stale file is dead immediately (a future mtime —
            # writer clock ahead of ours — clamps to "fresh")
            age = max(0.0, time.time() - st.st_mtime)
            rec = _obs[(dir_, r)] = [sig, mono_now - age]
        elif rec[0] != sig:
            rec[0] = sig
            rec[1] = mono_now
        if mono_now - rec[1] > timeout:
            dead.append(r)
    return dead
