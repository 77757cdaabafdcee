"""Online inference server over one artifact.

Counterpart of predict and generate mode in ``mxnet_tpu/serve/
server.py``. Predict: a dynamic micro-batcher coalesces concurrent
requests into padded device batches under a max-batch/max-latency
policy, admission control bounds the queue and rejects early, and a
graceful drain finishes every admitted request on shutdown. Generate (a
generate artifact, with a :class:`~.decode.GenerateConfig`): the
continuous-batching :class:`~.decode.GenerateSession` replaces the
micro-batcher, and the server proxies requests, lifecycle and metrics
to it::

    server = Server("lm.mxtorch", config=GenerateConfig(timeout_ms=0))
    out = server.generate([3, 1, 4], max_new_tokens=16)  # {"tokens": ..}
    server.close(drain=True)

The request path makes ONE device-to-host copy per output of a response
batch: padding, execution and the slice back to real rows stay on the
device. The batcher thread runs under ``torch.inference_mode()``, which
is thread-local, so it is entered there (and again around each graph
run).

    server = Server("model.mxtorch", buckets=(1, 8, 32))
    pending = server.submit(data=x)        # never blocks; may raise
    out = pending.result(timeout=1.0)      # tuple of numpy arrays
    server.close(drain=True)

An int8-quantized twin (a format_version 4 artifact of the same model,
``quant.export_quantized``) serves beside the primary: requests route
per call with ``dtype=``, and a window holding both kinds runs one
padded device batch per dtype::

    server = Server("model.mxtorch", quantized="model.int8.mxtorch")
    out = server.predict(data=x, dtype="int8")

A recommend artifact (format_version 6, ``embed.serve.
export_recommend``) serves ragged id lists: the micro-batcher's queue,
window, drain and metrics as in predict, but each request is billed in
gather units (its ids, up to the engine's ``max_ids``; the queue's cost
cap is ``MXNET_SERVE_MAX_GATHERS``) and a batch runs the embed
package's cache-backed ``RecommendEngine``::

    server = Server("twotower.mxtorch")
    scores, items = server.recommend([3, 17, 17, 4096])   # top k

A failed batch fails its requests with the error (``Request.result``
raises it, the cause chained); it does not stop the server.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict

import numpy as _np
import torch

from ..base import MXNetError
from ..config import flags
from ..embed.serve import RecommendEngine, RecommendModel
from ..serving import CompiledModel, GenerateModel, load_artifact
from .admission import AdmissionQueue, DeadlineExceeded, Request, \
    ServerClosed
from .decode import GenerateConfig, GenerateSession
from .engine_cache import check_buckets, pick_bucket
from .metrics import ServeMetrics

__all__ = ["Server", "ServeConfig"]


class ServeConfig:
    """Serving knobs; every default comes from the MXNET_SERVE_* flags."""

    def __init__(self, buckets=None, batch_timeout_ms=None,
                 queue_depth=None, timeout_ms=None, cache_engines=None,
                 warmup=None, drain_timeout_s=None):
        self.buckets = buckets    # None -> artifact-appropriate default
        self.batch_timeout_ms = (flags.serve_batch_timeout_ms
                                 if batch_timeout_ms is None
                                 else float(batch_timeout_ms))
        self.queue_depth = (flags.serve_queue_depth if queue_depth is None
                            else int(queue_depth))
        self.timeout_ms = (flags.serve_timeout_ms if timeout_ms is None
                           else float(timeout_ms))
        self.cache_engines = cache_engines
        self.warmup = warmup
        self.drain_timeout_s = (flags.serve_drain_timeout_s
                                if drain_timeout_s is None
                                else float(drain_timeout_s))


class Server:
    """Dynamic micro-batching server over a :class:`CompiledModel` or a
    recommend engine, or the continuous-batching decode engine over a
    :class:`GenerateModel`.

    ``model`` is a loaded model or an artifact path, loaded onto
    ``device`` (default cuda:0). ``auto_start=False`` leaves the batcher
    (or scheduler) thread unstarted: requests queue until
    :meth:`run_once` (``session.run_round`` in generate mode) or
    :meth:`start`. ``quantized=`` (predict mode) attaches the int8 twin
    of the model, a path or a loaded format_version 4
    :class:`CompiledModel`, served with ``dtype="int8"``. ``draft=``
    (generate mode) switches speculative decoding: "auto" speculates iff
    the artifact bundles an int8 draft, "on" requires one (the session
    raises without it), "off" decodes one token a step; it sets the
    config's ``speculative`` to None, True or False. A
    ``RecommendModel`` (or a ``RecommendEngine``) serves in recommend
    mode, with the engine's defaults: buckets (1, 4, 16) and a cache of
    ``MXNET_EMBED_CACHE_ROWS`` rows.
    """

    def __init__(self, model, config=None, auto_start=True, device=None,
                 draft=None, quantized=None, **overrides):
        if not isinstance(model, (CompiledModel, GenerateModel,
                                  RecommendModel, RecommendEngine)):
            model = load_artifact(model, device=device)
        if isinstance(model, (RecommendModel, RecommendEngine)):
            if quantized is not None or draft is not None:
                raise MXNetError(
                    "Server: quantized=/draft= do not apply to "
                    "recommend artifacts")
            self._init_recommend(model, config, auto_start, overrides)
            return
        if isinstance(model, GenerateModel):
            if quantized is not None:
                raise MXNetError("Server: quantized= is a predict-mode "
                                 "option; this is a generate artifact")
            if config is None:
                config = GenerateConfig(**overrides)
            elif overrides:
                raise MXNetError("Server: pass either config or kwargs, "
                                 "not both")
            if not isinstance(config, GenerateConfig):
                raise MXNetError(
                    "Server: a generate artifact takes a GenerateConfig "
                    "(continuous-batching knobs), not ServeConfig")
            if draft is not None:
                if draft not in ("auto", "on", "off"):
                    raise MXNetError("Server: draft= must be 'auto', "
                                     "'on' or 'off' (got %r)" % (draft,))
                config.speculative = {"auto": None, "on": True,
                                      "off": False}[draft]
            self.mode = "generate"
            self.model = model
            self.config = config
            self.session = GenerateSession(model, config=config,
                                           auto_start=auto_start)
            self.metrics_ = self.session.metrics_
            return
        if isinstance(config, GenerateConfig):
            raise MXNetError("Server: a GenerateConfig needs a generate "
                             "artifact; this one is a predict artifact")
        if draft is not None:
            raise MXNetError("Server: draft= is a generate-mode option; "
                             "predict artifacts have no draft model")
        self.session = None
        if config is None:
            config = ServeConfig(**overrides)
        elif overrides:
            raise MXNetError("Server: pass either config or kwargs, "
                             "not both")
        self.mode = "predict"
        self.model = model
        self.config = config
        self.buckets = check_buckets(config.buckets, model)
        if model.engine_cache is None or model.buckets != self.buckets:
            model.set_buckets(self.buckets,
                              cache_engines=config.cache_engines,
                              warmup=config.warmup)
        self._cache = model.engine_cache
        if quantized is not None:
            # the int8 sibling artifact: the same model, quantized, served
            # side by side per bucket
            if not isinstance(quantized, (CompiledModel, GenerateModel)):
                quantized = load_artifact(quantized, device=model.device)
            if not isinstance(quantized, CompiledModel):
                raise MXNetError(
                    "Server: quantized= must be a predict artifact")
            if not quantized.quantized:
                raise MXNetError(
                    "Server: quantized= artifact is not format_version 4 "
                    "(quant.export_quantized produces one)")
            if "int8" not in self._cache.dtypes:  # cache may be reused
                self._cache.add_model(quantized)
        self.metrics_ = ServeMetrics()
        self._queue = AdmissionQueue(
            config.queue_depth,
            retry_after_fn=lambda q: self.metrics_.estimate_drain_s(
                q.pending_rows()))
        self._thread = None
        self._closed = threading.Event()
        if auto_start:
            self.start()

    def _init_recommend(self, model, config, auto_start, overrides):
        """Recommend mode: predict's queue, window, drain and metrics,
        with requests billed in gather units and batches run by the
        cache-backed engine."""
        self.mode = "recommend"
        self.session = None
        if config is None:
            config = ServeConfig(**overrides)
        elif overrides:
            raise MXNetError("Server: pass either config or kwargs, "
                             "not both")
        if isinstance(model, RecommendModel):
            model = model.engine()
        self.engine = model
        self.model = model.model
        self.config = config
        self.buckets = model.buckets
        self.metrics_ = ServeMetrics()
        # retry-after is the pending gather units times the per-gather
        # roofline; the cost cap rejects on the same unit
        self._queue = AdmissionQueue(
            config.queue_depth,
            retry_after_fn=lambda q: (q.pending_units()
                                      * self.engine.gather_unit_s()),
            max_units=flags.serve_max_gathers)
        self._thread = None
        self._closed = threading.Event()
        if auto_start:
            self.start()

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        if self.mode == "generate":
            self.session.start()
            return self
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._loop,
                                            name="mxtorch-serve-batcher",
                                            daemon=True)
            self._thread.start()
        return self

    @property
    def draining(self):
        if self.mode == "generate":
            return self.session.draining
        return self._queue.closed and not self._closed.is_set()

    @property
    def closed(self):
        if self.mode == "generate":
            return self.session.closed
        return self._closed.is_set()

    def close(self, drain=True, timeout=None):
        """Shut down. ``drain=True``: stop admitting, finish every queued
        request, then return. ``drain=False``: fail queued requests with
        ServerClosed (counted as dropped). Generate mode:
        :meth:`GenerateSession.close`."""
        if self.mode == "generate":
            return self.session.close(drain=drain, timeout=timeout)
        evicted = self._queue.close(drain=drain)
        for r in evicted:
            r._fail(ServerClosed("serve: server closed before this "
                                 "request was dispatched"))
        if evicted:
            self.metrics_.note_drop(len(evicted))
        if drain:
            budget = (self.config.drain_timeout_s if timeout is None
                      else timeout)
            if self._thread is not None and self._thread.is_alive():
                self._thread.join(budget)
                if self._thread.is_alive():
                    raise MXNetError(
                        "serve: drain did not finish within %.1fs (%d "
                        "requests still queued)"
                        % (budget, self._queue.pending_count()))
            else:
                # no batcher thread (auto_start=False): drain inline
                t_end = time.monotonic() + budget
                while self._queue.pending_count():
                    if time.monotonic() > t_end:
                        raise MXNetError(
                            "serve: inline drain did not finish within "
                            "%.1fs" % budget)
                    self.run_once(block=False)
        self._closed.set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if not self.closed:
            self.close(drain=True)

    # -- request path -------------------------------------------------------
    def _require_mode(self, mode, what):
        if self.mode != mode:
            other = {"generate": "submit_generate()/generate()",
                     "recommend": "submit_recommend()/recommend()",
                     "predict": "submit()/predict()"}[self.mode]
            raise MXNetError("Server.%s: this server holds a %s artifact; "
                             "use %s" % (what, self.mode, other))

    def submit_generate(self, prompt, max_new_tokens=None,
                        temperature=0.0, seed=0, timeout_ms=None):
        """Generate-mode admit (never blocks); see
        :meth:`GenerateSession.submit`."""
        self._require_mode("generate", "submit_generate")
        return self.session.submit(prompt, max_new_tokens=max_new_tokens,
                                   temperature=temperature, seed=seed,
                                   timeout_ms=timeout_ms)

    def generate(self, prompt, **kw):
        """Blocking generate-mode convenience: submit + result."""
        self._require_mode("generate", "generate")
        return self.session.generate(prompt, **kw)

    def _prepare(self, data, kwdata):
        if data and kwdata:
            raise MXNetError("Server.submit: pass inputs positionally or "
                             "by name, not both")
        if kwdata:
            names = self.model.input_names
            extra = sorted(set(kwdata) - set(names))
            missing = sorted(set(names) - set(kwdata))
            if extra or missing:
                raise MXNetError(
                    "Server.submit: artifact inputs are %s%s%s"
                    % (names,
                       ("; missing %s" % missing) if missing else "",
                       ("; unexpected %s" % extra) if extra else ""))
            data = [kwdata[n] for n in names]
        arrs = self.model._check_inputs(list(data))
        rows = int(arrs[0].shape[0]) if arrs[0].dim() else 1
        if rows > self.buckets[-1]:
            raise MXNetError(
                "Server.submit: request batch of %d rows exceeds the "
                "largest bucket %d; split the request or serve with "
                "larger buckets" % (rows, self.buckets[-1]))
        return arrs, rows

    def submit(self, *data, timeout_ms=None, dtype=None, **kwdata):
        """Admit one request; never blocks. Returns a :class:`Request`
        whose ``.result()`` blocks for the response. ``dtype`` routes to
        an attached precision variant ("f32"/"int8"; default the primary
        artifact). Raises ServerBusy (queue full), ServerClosed, or
        MXNetError (validation)."""
        self._require_mode("predict", "submit")
        if dtype is not None and dtype not in self._cache.dtypes:
            raise MXNetError(
                "Server.submit: no %r engines on this server; available "
                "dtypes are %s (pass quantized= at construction to "
                "attach an int8 artifact)"
                % (dtype, list(self._cache.dtypes)))
        arrs, rows = self._prepare(data, kwdata)
        return self._admit(Request(tuple(arrs), rows,
                                   self._deadline(timeout_ms),
                                   dtype=dtype or self._cache.primary_dtype))

    def _deadline(self, timeout_ms):
        if timeout_ms is None:
            timeout_ms = self.config.timeout_ms
        return (time.monotonic() + timeout_ms / 1e3
                if timeout_ms and timeout_ms > 0 else None)

    def _admit(self, req):
        """Queue ``req`` (a rejection counted) and return it."""
        try:
            self._queue.submit(req)
        except ServerClosed:
            raise
        except Exception:
            self.metrics_.note_reject()
            raise
        self.metrics_.note_submit(req.rows)
        self.metrics_.set_queue_depth(self._queue.pending_count())
        return req

    def predict(self, *data, timeout_ms=None, dtype=None, **kwdata):
        """Blocking convenience: submit + result."""
        req = self.submit(*data, timeout_ms=timeout_ms, dtype=dtype,
                          **kwdata)
        return req.result(timeout=_budget(req))

    def submit_recommend(self, ids, timeout_ms=None):
        """Admit one recommend request (a ragged id list); never blocks.
        It is billed in gather units, ``len(ids)`` up to the engine's
        ``max_ids``, against the queue's cost cap."""
        self._require_mode("recommend", "submit_recommend")
        arr = _np.asarray(list(ids), dtype=_np.int64).reshape(-1)
        gathers = max(1, min(arr.size, self.engine.max_ids))
        return self._admit(Request((arr,), 1, self._deadline(timeout_ms),
                                   units=gathers))

    def recommend(self, ids, timeout_ms=None):
        """Blocking convenience: submit_recommend + result, the
        ``(scores, item_ids)`` host arrays of length ``k``."""
        req = self.submit_recommend(ids, timeout_ms=timeout_ms)
        return req.result(timeout=_budget(req))

    # -- batcher ------------------------------------------------------------
    def run_once(self, block=True):
        """One coalescing round: take a window's worth of requests, drop
        the expired, dispatch one padded bucket batch, distribute the
        results. Returns the number of requests taken."""
        reqs = self._queue.take(self.buckets[-1],
                                self.config.batch_timeout_ms / 1e3,
                                block=block)
        self.metrics_.set_queue_depth(self._queue.pending_count())
        if not reqs:
            return 0
        now = time.monotonic()
        live = []
        for r in reqs:
            if r.deadline is not None and now > r.deadline:
                self.metrics_.note_expire()
                r._fail(DeadlineExceeded(
                    "serve: deadline passed %.1fms before dispatch"
                    % ((now - r.deadline) * 1e3)))
            else:
                live.append(r)
        if self.mode == "recommend":
            if live:
                self._dispatch_recommend(live)
            return len(reqs)
        # one padded device batch per dtype group (f32 and int8 requests
        # share a window but run on different engines)
        groups = OrderedDict()
        for r in live:
            groups.setdefault(r.dtype, []).append(r)
        for dtype, group in groups.items():
            self._dispatch_group(dtype, group)
        return len(reqs)

    def _dispatch_group(self, dtype, live):
        rows = sum(r.rows for r in live)
        bucket = pick_bucket(self.buckets, rows)
        # take() caps at the largest bucket, so bucket is never None
        try:
            with torch.inference_mode():
                if len(live) == 1:
                    stacked = list(live[0].arrays)
                else:
                    stacked = [torch.cat([r.arrays[i] for r in live])
                               for i in range(len(self.model.input_names))]
                t0 = time.perf_counter()
                outs = self._cache.run(bucket, stacked, rows, dtype=dtype)
                # ONE device-to-host copy per output for the whole batch
                host = [o.cpu().numpy() for o in outs]
                exec_ms = (time.perf_counter() - t0) * 1e3
        except Exception as e:
            self.metrics_.note_error(len(live))
            if isinstance(e, MXNetError):
                err = e
            else:
                err = MXNetError("%s: %s" % (type(e).__name__, e))
                err.__cause__ = e
            for r in live:
                r._fail(err)
            return
        self.metrics_.note_batch(bucket, rows, bucket - rows, exec_ms,
                                 dtype=dtype)
        t_done = time.monotonic()
        off = 0
        for r in live:
            r.bucket = bucket
            r._complete(tuple(h[off:off + r.rows] for h in host))
            off += r.rows
            self.metrics_.note_request_done(
                bucket, (t_done - r.t_submit) * 1e3, dtype=dtype)

    def _dispatch_recommend(self, live):
        rows = len(live)
        bucket = pick_bucket(self.buckets, rows)
        try:
            with torch.inference_mode():
                t0 = time.perf_counter()
                # the plan and upload, one scoring pass and one
                # device-to-host copy for the whole batch
                scores, items = self.engine.recommend_batch(
                    [r.arrays[0] for r in live], bucket=bucket)
                exec_ms = (time.perf_counter() - t0) * 1e3
        except Exception as e:
            self.metrics_.note_error(len(live))
            if isinstance(e, MXNetError):
                err = e
            else:
                err = MXNetError("%s: %s" % (type(e).__name__, e))
                err.__cause__ = e
            for r in live:
                r._fail(err)
            return
        self.metrics_.note_batch(bucket, rows, bucket - rows, exec_ms)
        t_done = time.monotonic()
        for j, r in enumerate(live):
            r.bucket = bucket
            r._complete((scores[j], items[j]))
            self.metrics_.note_request_done(
                bucket, (t_done - r.t_submit) * 1e3)

    def _loop(self):
        with torch.inference_mode():
            while True:
                try:
                    self.run_once(block=True)
                except Exception:
                    # a batch failure already failed its requests; a bug
                    # in the loop itself must not silently kill serving
                    if self._queue.closed:
                        break
                    time.sleep(0.01)
                    continue
                if self._queue.closed and self._queue.pending_count() == 0:
                    break

    # -- observability ------------------------------------------------------
    def metrics(self):
        """JSON-able snapshot: request counters, queue depth, per-bucket
        latency percentiles / occupancy / padding waste, engine stats.
        Generate mode: decode counters, TTFT/TPOT percentiles, slot and
        page occupancy."""
        if self.mode == "generate":
            snap = self.session.metrics()
            snap["mode"] = "generate"
            return snap
        if self.mode == "recommend":
            snap = self.metrics_.snapshot()
            snap["mode"] = "recommend"
            snap["embed"] = self.engine.stats()
            snap["buckets_configured"] = list(self.buckets)
            snap["status"] = ("closed" if self.closed
                              else "draining" if self.draining else "ok")
            return snap
        snap = self.metrics_.snapshot(engine_stats=self._cache.stats())
        snap["mode"] = "predict"
        snap["buckets_configured"] = list(self.buckets)
        snap["status"] = ("closed" if self.closed
                          else "draining" if self.draining else "ok")
        return snap


def _budget(req):
    """Seconds a blocking call waits for ``req``: its deadline plus a
    second, or forever without one."""
    return (None if req.deadline is None
            else max(0.001, req.deadline - time.monotonic()) + 1.0)
