"""Shape-bucketed engine cache over one artifact.

Counterpart of ``mxnet_tpu/serve/engine_cache.py``. There an engine is
an XLA executable compiled for one batch size; here it is the artifact's
eval function bound to one bucket shape, built lazily, held in an LRU
and warmed with one zero batch, so the first real request at a bucket
pays no first-call costs (cuDNN plans, the kernel build). An int8
variant of the same model (a format_version 4 artifact) can be attached
beside the primary with :meth:`BucketedEngineCache.add_model`; engines
are then keyed by (dtype, bucket) and callers route with ``dtype=``.
Padding, execution and the slice back to the real rows stay on the
device; the caller does its one device-to-host copy per response batch.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict

import torch

from ..base import MXNetError, normalize_dtype
from ..config import flags

__all__ = ["BucketedEngineCache", "check_buckets", "pick_bucket",
           "parse_buckets", "model_dtype_label"]


def model_dtype_label(model):
    """Serving dtype label for a loaded artifact: "int8" for
    format_version-4 quantized artifacts, "f32" otherwise."""
    return "int8" if getattr(model, "quantized", False) else "f32"


def parse_buckets(spec):
    """'1,8,32' -> sorted unique positive ints."""
    if isinstance(spec, str):
        spec = [s for s in spec.replace(";", ",").split(",") if s.strip()]
    out = sorted({int(b) for b in spec})
    if not out or out[0] < 1:
        raise MXNetError("serve: buckets must be positive ints, got %r"
                         % (spec,))
    return tuple(out)


def check_buckets(buckets, model):
    """Validate a bucket set against an artifact; None -> the default set
    (MXNET_SERVE_BUCKETS for dynamic artifacts, the frozen batch for
    fixed ones)."""
    frozen = None
    shape = model.meta["inputs"][0]["shape"]
    if not model.dynamic_batch and shape:
        frozen = shape[0]
    if buckets is None:
        if frozen is not None:
            return (int(frozen),)
        return parse_buckets(flags.serve_buckets)
    buckets = parse_buckets(buckets)
    if frozen is not None and tuple(buckets) != (int(frozen),):
        raise MXNetError(
            "serve: artifact has a FIXED batch size %d (exported without "
            "dynamic_batch=True); the only legal bucket set is (%d,), got "
            "%s. Re-export with dynamic_batch=True for multi-bucket "
            "serving." % (frozen, frozen, list(buckets)))
    return buckets


def pick_bucket(buckets, rows):
    """Smallest bucket >= rows, or None when rows exceeds every bucket."""
    for b in buckets:
        if rows <= b:
            return b
    return None


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Engine:
    __slots__ = ("bucket", "dtype", "compile_ms", "warmup_ms", "calls",
                 "rows", "padded_rows")

    def __init__(self, bucket, dtype, compile_ms, warmup_ms):
        self.bucket = bucket
        self.dtype = dtype
        self.compile_ms = compile_ms
        self.warmup_ms = warmup_ms
        self.calls = 0
        self.rows = 0
        self.padded_rows = 0


class BucketedEngineCache:
    """LRU of per-bucket engines, possibly over several precision
    variants of one model.

    The primary artifact (usually f32) defines the input signature; an
    int8 format-version-4 artifact of the same model can be attached
    with :meth:`add_model`, after which every bucket can hold one engine
    per dtype, ``(dtype, bucket)`` being the cache key, and callers
    route per request with ``dtype=``. Omitting ``dtype`` everywhere
    keeps the single-model behaviour (stats keys included).
    """

    def __init__(self, model, capacity=None, warmup=None):
        self._model = model
        self._specs = model.meta["inputs"]
        self.primary_dtype = model_dtype_label(model)
        self._models = {self.primary_dtype: model}
        self.capacity = (flags.serve_cache_engines if capacity is None
                         else int(capacity))
        self.warmup = flags.serve_warmup if warmup is None else bool(warmup)
        self._engines = OrderedDict()   # (dtype, bucket) -> _Engine, LRU
        self._lock = threading.Lock()
        self.builds = 0
        self.evictions = 0

    @property
    def dtypes(self):
        """Serving dtypes available for routing, primary first."""
        rest = sorted(d for d in self._models if d != self.primary_dtype)
        return (self.primary_dtype,) + tuple(rest)

    def add_model(self, model):
        """Attach a precision variant (the int8 quantized artifact) of the
        SAME model: identical input names, per-row shapes, input dtypes
        and batch mode. Its engines build lazily per bucket, as the
        primary's do. -> its dtype label."""
        dtype = model_dtype_label(model)

        def sig(specs, dyn):
            return (tuple((s["name"], tuple(s["shape"][1:]), s["dtype"])
                          for s in specs), bool(dyn))
        have = sig(self._specs, self._model.dynamic_batch)
        got = sig(model.meta["inputs"], model.dynamic_batch)
        if have != got:
            raise MXNetError(
                "serve: %r variant's input signature %r does not match "
                "the primary artifact's %r; quantize the SAME model "
                "with the same export shapes" % (dtype, got, have))
        with self._lock:
            if dtype in self._models:
                raise MXNetError(
                    "serve: a %r model is already attached" % dtype)
            self._models[dtype] = model
        return dtype

    def _resolve(self, dtype):
        d = self.primary_dtype if dtype is None else str(dtype)
        model = self._models.get(d)
        if model is None:
            raise MXNetError(
                "serve: no %r engines; attached dtypes are %s"
                % (d, list(self.dtypes)))
        return d, model

    def _build(self, bucket, dtype, model):
        frozen = (None if model.dynamic_batch
                  else self._specs[0]["shape"][0])
        if frozen is not None and bucket != frozen:
            raise MXNetError("serve: bucket %d on a fixed-batch-%d artifact"
                             % (bucket, frozen))
        # nothing to compile: eager engines are built by their first run
        compile_ms = 0.0
        warmup_ms = 0.0
        if self.warmup:
            dev = model.device
            t1 = time.perf_counter()
            model.run(*[torch.zeros(
                (bucket,) + tuple(s["shape"][1:]),
                dtype=normalize_dtype(s["dtype"]), device=dev)
                for s in self._specs])
            _sync(dev)
            warmup_ms = (time.perf_counter() - t1) * 1e3
        with self._lock:
            self.builds += 1
        return _Engine(bucket, dtype, compile_ms, warmup_ms)

    def engine(self, bucket, dtype=None):
        """Fetch (building lazily) the engine for one bucket of one
        attached dtype (default: the primary artifact's)."""
        dtype, model = self._resolve(dtype)
        key = (dtype, bucket)
        with self._lock:
            eng = self._engines.get(key)
            if eng is not None:
                self._engines.move_to_end(key)
                return eng
        # build outside the lock: a warmup can take seconds and other
        # buckets' traffic must not stall behind it
        eng = self._build(bucket, dtype, model)
        with self._lock:
            cur = self._engines.get(key)
            if cur is not None:          # lost a build race: keep the first
                self._engines.move_to_end(key)
                return cur
            self._engines[key] = eng
            while self.capacity > 0 and len(self._engines) > self.capacity:
                self._engines.popitem(last=False)
                self.evictions += 1
            return eng

    def run(self, bucket, arrs, rows, dtype=None):
        """Pad ``arrs`` (one per input, ``rows`` real rows each) to
        ``bucket``, execute on the ``dtype`` variant (default the
        primary), slice back to the real rows. Everything stays on the
        device; no host sync."""
        eng = self.engine(bucket, dtype)
        model = self._models[eng.dtype]
        pad = bucket - rows
        if pad:
            arrs = [torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
                    for a in arrs]
        outs = model.run(*arrs)
        with self._lock:
            eng.calls += 1
            eng.rows += rows
            eng.padded_rows += pad
        if pad:
            outs = tuple(o[:rows] if o.dim() else o for o in outs)
        return outs

    def run_padded(self, buckets, arrs, rows, dtype=None):
        bucket = pick_bucket(buckets, rows)
        if bucket is None:
            raise MXNetError(
                "serve: batch of %d rows exceeds the largest bucket %d"
                % (rows, buckets[-1]))
        return self.run(bucket, arrs, rows, dtype=dtype)

    def stats(self):
        with self._lock:
            engines = {}
            for e in self._engines.values():
                # primary engines keep the plain-bucket key; other dtypes
                # are namespaced "dtype:bucket"
                key = (str(e.bucket) if e.dtype == self.primary_dtype
                       else "%s:%d" % (e.dtype, e.bucket))
                engines[key] = {
                    "dtype": e.dtype,
                    "compile_ms": round(e.compile_ms, 3),
                    "warmup_ms": round(e.warmup_ms, 3),
                    "calls": e.calls,
                    "rows": e.rows,
                    "padded_rows": e.padded_rows,
                }
            return {
                "capacity": self.capacity,
                "builds": self.builds,
                "evictions": self.evictions,
                "dtypes": list(self.dtypes),
                "kernel_tier": self._model.meta.get("kernel_tier"),
                "engines": engines,
            }
