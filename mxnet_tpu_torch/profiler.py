"""Host-sync counters (the ``record_host_sync`` / ``sync_counters``
part of ``mxnet_tpu/profiler.py``; its tracing is not ported).

Every device-to-host copy a serving or training path makes on purpose
is recorded here, so tests can assert the discipline "one d2h a batch"
without a device: ``d2h`` counts copies and ``d2h_bytes`` their bytes.
"""
from __future__ import annotations

import threading

__all__ = ["record_host_sync", "sync_counters", "reset_sync_counters"]

_lock = threading.Lock()
_sync_counts = {"d2h": 0, "d2h_bytes": 0}


def record_host_sync(kind, nbytes=0):
    """Count one host sync of ``kind``; a ``d2h`` adds its bytes."""
    with _lock:
        _sync_counts[kind] = _sync_counts.get(kind, 0) + 1
        if kind == "d2h" and nbytes:
            _sync_counts["d2h_bytes"] += int(nbytes)


def sync_counters():
    """Snapshot: {d2h, d2h_bytes, total}, and a count for any other kind
    recorded (total is d2h plus waits)."""
    with _lock:
        out = dict(_sync_counts)
    out["total"] = out["d2h"] + out.get("wait", 0)
    return out


def reset_sync_counters():
    with _lock:
        for k in list(_sync_counts):
            _sync_counts[k] = 0
