"""Serving observability (counterpart of ``ServeMetrics`` and
``DecodeMetrics`` in ``mxnet_tpu/serve/metrics.py``, without the
telemetry registry and profiler hooks, which come in a later slice).

Predict: per-bucket latency percentiles, queue depth, batch occupancy,
padding waste and rejection counts. Decode: request counters, prefill
batches, decode steps, tokens, TTFT and TPOT percentiles. Each
``snapshot()`` has the JAX package's keys.
"""
from __future__ import annotations

import threading
import time
from collections import deque

__all__ = ["ServeMetrics", "DecodeMetrics", "percentile"]

_SAMPLE_CAP = 8192   # bounded reservoir per series (latest wins)


def percentile(samples, p):
    """Linear-interpolated percentile of an unsorted sample list."""
    if not samples:
        return None
    s = sorted(samples)
    if len(s) == 1:
        return s[0]
    rank = (p / 100.0) * (len(s) - 1)
    lo = int(rank)
    frac = rank - lo
    if lo + 1 >= len(s):
        return s[-1]
    return s[lo] * (1.0 - frac) + s[lo + 1] * frac


class _BucketStats:
    __slots__ = ("batches", "rows", "padded_rows", "latency_ms", "exec_ms")

    def __init__(self):
        self.batches = 0
        self.rows = 0
        self.padded_rows = 0
        self.latency_ms = deque(maxlen=_SAMPLE_CAP)
        self.exec_ms = deque(maxlen=_SAMPLE_CAP)


class ServeMetrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._buckets = {}           # (dtype, bucket) -> _BucketStats
        self.submitted = 0
        self.completed = 0
        self.rejected = 0
        self.expired = 0
        self.dropped = 0             # failed by a non-drain shutdown
        self.errors = 0              # batch execution failures
        self.queue_depth = 0
        self.queue_peak = 0
        self._exec_s_total = 0.0
        self._rows_total = 0
        self._t_start = time.monotonic()

    def _bucket(self, key):
        st = self._buckets.get(key)
        if st is None:
            st = self._buckets[key] = _BucketStats()
        return st

    # -- event hooks --------------------------------------------------------
    def note_submit(self, rows=1):
        with self._lock:
            self.submitted += 1

    def note_reject(self):
        with self._lock:
            self.rejected += 1

    def note_expire(self, n=1):
        with self._lock:
            self.expired += n

    def note_drop(self, n=1):
        with self._lock:
            self.dropped += n

    def note_error(self, n=1):
        with self._lock:
            self.errors += n

    def note_batch(self, bucket, rows, padded, exec_ms, dtype="f32"):
        with self._lock:
            st = self._bucket((dtype, bucket))
            st.batches += 1
            st.rows += rows
            st.padded_rows += padded
            st.exec_ms.append(exec_ms)
            self._exec_s_total += exec_ms / 1e3
            self._rows_total += rows

    def note_request_done(self, bucket, latency_ms, dtype="f32"):
        with self._lock:
            self.completed += 1
            self._bucket((dtype, bucket)).latency_ms.append(latency_ms)

    def set_queue_depth(self, depth):
        with self._lock:
            self.queue_depth = depth
            self.queue_peak = max(self.queue_peak, depth)

    # -- derived ------------------------------------------------------------
    def throughput_rows_per_s(self):
        """Device throughput so far; used for retry-after estimates."""
        with self._lock:
            if self._exec_s_total <= 0:
                return 0.0
            return self._rows_total / self._exec_s_total

    def estimate_drain_s(self, pending_rows):
        rate = self.throughput_rows_per_s()
        if rate <= 0:
            return 0.05
        return max(0.005, pending_rows / rate)

    @staticmethod
    def _render(batches, rows, padded, lat, ex):
        total = rows + padded
        return {
            "batches": batches,
            "rows": rows,
            "padded_rows": padded,
            "occupancy": round(rows / total, 4) if total else None,
            "padding_waste": (round(padded / total, 4)
                              if total else None),
            "latency_ms": {
                "count": len(lat),
                "p50": percentile(lat, 50),
                "p95": percentile(lat, 95),
                "p99": percentile(lat, 99),
                "mean": (sum(lat) / len(lat)) if lat else None,
            },
            "exec_ms": {
                "count": len(ex),
                "p50": percentile(ex, 50),
                "p99": percentile(ex, 99),
            },
        }

    def snapshot(self, engine_stats=None):
        with self._lock:
            merged = {}   # bucket -> [batches, rows, padded, lat, ex]
            by_dtype = {}
            for (dt, b), st in sorted(self._buckets.items(),
                                      key=lambda kv: (kv[0][1], kv[0][0])):
                m = merged.setdefault(b, [0, 0, 0, [], []])
                m[0] += st.batches
                m[1] += st.rows
                m[2] += st.padded_rows
                m[3].extend(st.latency_ms)
                m[4].extend(st.exec_ms)
                by_dtype.setdefault(dt, {})[str(b)] = self._render(
                    st.batches, st.rows, st.padded_rows,
                    list(st.latency_ms), list(st.exec_ms))
            out = {
                "uptime_s": round(time.monotonic() - self._t_start, 3),
                "requests": {
                    "submitted": self.submitted,
                    "completed": self.completed,
                    "rejected": self.rejected,
                    "expired": self.expired,
                    "dropped": self.dropped,
                    "errors": self.errors,
                },
                "queue": {"depth": self.queue_depth,
                          "peak": self.queue_peak},
                "throughput_rows_per_s": round(
                    self._rows_total / self._exec_s_total, 2)
                    if self._exec_s_total > 0 else None,
                "buckets": {str(b): self._render(*m)
                            for b, m in sorted(merged.items())},
                "buckets_by_dtype": by_dtype,
            }
        if engine_stats is not None:
            out["engines"] = engine_stats
        return out


class DecodeMetrics:
    """Continuous-batching decode observability.

    Every number here is HOST state the scheduler already holds (step
    counts, wall clock, completion timestamps), so recording costs no
    device-to-host copy. ``publish_window`` folds a window of decode
    steps in every MXNET_SERVE_DECODE_WINDOW steps. The speculative
    counters are per slot: a speculative step with n live slots adds n
    steps, n * k drafted tokens and the draft tokens the verifier
    accepted among them.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.submitted = 0
        self.completed = 0
        self.evicted = 0
        self.expired = 0
        self.rejected = 0
        self.prefill_batches = 0
        self.prefill_rows = 0
        self.decode_steps = 0
        self.tokens = 0
        self.spec_steps = 0
        self.drafted = 0
        self.accepted = 0
        self.ttft_ms = deque(maxlen=_SAMPLE_CAP)
        self.tpot_ms = deque(maxlen=_SAMPLE_CAP)
        self._t_start = time.monotonic()

    # -- host-side event hooks (no device tensors anywhere below) ----------
    def note_submit(self, n=1):
        with self._lock:
            self.submitted += n

    def note_reject(self, n=1):
        with self._lock:
            self.rejected += n

    def note_prefill(self, rows):
        with self._lock:
            self.prefill_batches += 1
            self.prefill_rows += rows

    def note_ttft(self, ms):
        with self._lock:
            self.ttft_ms.append(ms)

    def note_complete(self, tpot_ms=None):
        with self._lock:
            self.completed += 1
            if tpot_ms is not None:
                self.tpot_ms.append(tpot_ms)

    def note_evict(self, expired=False):
        with self._lock:
            self.evicted += 1
            if expired:
                self.expired += 1

    def publish_window(self, *, steps, tokens, spec_steps=0, drafted=0,
                       accepted=0):
        """Fold one decode window in, from host-held values (the JAX
        package also sets its telemetry gauges here; those are not
        ported yet). ``spec_steps``/``drafted``/``accepted`` are 0 on a
        session that does not speculate."""
        with self._lock:
            self.decode_steps += steps
            self.tokens += tokens
            self.spec_steps += spec_steps
            self.drafted += drafted
            self.accepted += accepted

    def snapshot(self):
        with self._lock:
            ttft = list(self.ttft_ms)
            tpot = list(self.tpot_ms)
            up = time.monotonic() - self._t_start
            return {
                "uptime_s": round(up, 3),
                "requests": {
                    "submitted": self.submitted,
                    "completed": self.completed,
                    "evicted": self.evicted,
                    "expired": self.expired,
                    "rejected": self.rejected,
                },
                "prefill": {"batches": self.prefill_batches,
                            "rows": self.prefill_rows},
                "decode_steps": self.decode_steps,
                "tokens": self.tokens,
                "tokens_per_s": round(self.tokens / up, 2) if up > 0
                else None,
                "ttft_ms": {
                    "count": len(ttft),
                    "p50": percentile(ttft, 50),
                    "p95": percentile(ttft, 95),
                    "p99": percentile(ttft, 99),
                },
                "tpot_ms": {
                    "count": len(tpot),
                    "p50": percentile(tpot, 50),
                    "p95": percentile(tpot, 95),
                    "p99": percentile(tpot, 99),
                },
                "speculative": {
                    "steps": self.spec_steps,
                    "drafted": self.drafted,
                    "accepted": self.accepted,
                    # each step emits its accepted prefix and the
                    # verifier's correction or bonus token
                    "accepted_tokens_per_step": round(
                        (self.accepted + self.spec_steps)
                        / float(self.spec_steps), 4)
                    if self.spec_steps else None,
                    "draft_acceptance_rate": round(
                        self.accepted / float(self.drafted), 4)
                    if self.drafted else None,
                },
            }
