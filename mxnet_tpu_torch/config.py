"""Typed config/flag registry (the subset of ``mxnet_tpu/config.py`` that
the port reads).

Every flag has a name, an environment variable, a parser, a default and a
docstring; values are read from the environment once and can be
overridden per thread::

    from mxnet_tpu_torch import config
    config.flags.kernel_tier                  # "auto"
    with config.override(kernel_tier="off"): ...

The one deliberate difference from the JAX package: ``kernel_tier``
defaults to ``auto`` here. The JAX package defaults to ``off`` because
its CPU suite runs the Pallas kernels in the interpreter; in the port a
CUDA tensor launches the hand-written kernel and a CPU tensor takes the
kernel's plain PyTorch version, so ``auto`` costs the CPU nothing.
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Callable, Dict, NamedTuple

__all__ = ["Flag", "flags", "register_flag", "override", "compute_dtype"]


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


class Flag(NamedTuple):
    name: str          # python attribute name
    env: str           # environment variable consulted at startup
    type: Callable     # parser applied to the env string
    default: Any
    doc: str


_REGISTRY: Dict[str, Flag] = {}
_LOCK = threading.Lock()


class _Flags:
    """Attribute-style access to resolved flag values."""

    def __init__(self):
        self._values: Dict[str, Any] = {}
        self._tls = threading.local()

    def _resolve(self, name: str) -> Any:
        flag = _REGISTRY[name]
        raw = os.environ.get(flag.env)
        if raw is None:
            return flag.default
        try:
            return flag.type(raw)
        except (TypeError, ValueError):
            return flag.default

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        overrides = getattr(self._tls, "overrides", None)
        if overrides and name in overrides:
            return overrides[name]
        if name not in self._values:
            if name not in _REGISTRY:
                raise AttributeError("no such flag: %r" % name)
            self._values[name] = self._resolve(name)
        return self._values[name]


flags = _Flags()


def register_flag(name: str, env: str, type: Callable, default: Any,
                  doc: str) -> Flag:
    with _LOCK:
        f = Flag(name, env, type, default, doc)
        _REGISTRY[name] = f
        return f


@contextlib.contextmanager
def override(**kwargs):
    """Thread-local temporary flag overrides."""
    tls = flags._tls
    prev = getattr(tls, "overrides", None)
    for k in kwargs:
        if k not in _REGISTRY:
            raise KeyError("no such flag: %r" % k)
    merged = dict(prev or {})
    merged.update(kwargs)
    tls.overrides = merged
    try:
        yield
    finally:
        tls.overrides = prev


_DTYPE_ALIASES = {
    "bf16": "bfloat16", "bfloat16": "bfloat16",
    "f16": "float16", "fp16": "float16", "half": "float16",
    "float16": "float16",
}
_DTYPE_OFF = ("float32", "fp32", "f32", "off", "none", "no")


def compute_dtype(default=None):
    """Resolve the session dtype policy (``MXNET_COMPUTE_DTYPE``, as the
    JAX package's ``config.compute_dtype`` does) to ``"bfloat16"``,
    ``"float16"`` or None (no downcast). ``auto`` gives ``default``,
    the calling path's own choice; ``float32``/``off`` gives None; an
    unknown value raises ValueError."""
    val = str(flags.compute_dtype).strip().lower()
    if val in ("", "auto"):
        return default
    if val in _DTYPE_OFF:
        return None
    name = _DTYPE_ALIASES.get(val)
    if name is None:
        raise ValueError(
            "MXNET_COMPUTE_DTYPE=%r not understood (expected auto, "
            "bfloat16, float16, or float32/off)" % val)
    return name


register_flag("compute_dtype", "MXNET_COMPUTE_DTYPE", str, "auto",
              "Session-wide mixed-precision compute dtype policy, as in "
              "the JAX package. 'auto' (default): each path keeps its "
              "contextual default (Module's fused train step computes in "
              "bf16 over f32 master weights when the optimizer has "
              "multi_precision, else in the parameter dtype). "
              "'bfloat16'/'float16' (aliases bf16/fp16/f16/half): the "
              "fused train step casts its data and f32 parameters (not "
              "BatchNorm's gamma and beta) to that dtype; the masters "
              "and optimizer state stay f32. 'float32'/'off'/'none': "
              "never downcast, multi_precision's bf16 included.")
register_flag("kernel_tier", "MXNET_KERNEL_TIER", str, "auto",
              "Kernel tier dispatch policy (mxnet_tpu_torch/kernels/). "
              "'auto' (default): a planned fusion runs its hand-written "
              "kernel wherever the eligibility guard passes (a CPU tensor "
              "takes the kernel's plain PyTorch version). 'safe': no "
              "tuning cache exists in the port yet, so every call-site "
              "falls back with the reason recorded. 'off': every op runs "
              "its plain PyTorch implementation.")
register_flag("trainer_fused_update", "MXNET_TRAINER_FUSED_UPDATE",
              _parse_bool, True,
              "Gluon Trainer.step applies every parameter's update in one "
              "pass through the optimizer's fused_ops, in place, instead "
              "of one Updater call per parameter; the same numbers as the "
              "per-parameter path.")
register_flag("engine_depth", "MXNET_ENGINE_DEPTH", int, 2,
              "Bounded in-flight dispatch depth for the async training "
              "loops (Module.fit, gluon.Trainer.step): up to this many "
              "dispatched steps may be pending on the device before the "
              "host blocks on the oldest. The counterpart of the "
              "reference ThreadedEngine's bounded pending-op queue. "
              "1 = fully synchronous stepping; 0/negative = unbounded "
              "(host never throttles; device errors surface late).")
register_flag("steps_per_dispatch", "MXNET_STEPS_PER_DISPATCH", int, 16,
              "K used by fit()'s automatic K-step dispatch "
              "(module/fused.py run_k; a captured CUDA graph of the step "
              "on the card) when the caller leaves steps_per_dispatch=None "
              "and no per-step host observer (batch_end_callback, "
              "monitor, lr scheduler, host-side metric, checkpoint "
              "manager) forces per-step dispatch.")
register_flag("device_metrics", "MXNET_DEVICE_METRICS", _parse_bool, True,
              "Fold supported eval metrics (acc/top_k/ce/nll/loss) into "
              "the fused train step as device-resident (sum, count) "
              "accumulators, transferring to host only at display/epoch "
              "boundaries. Off: per-batch host update (reference "
              "semantics, one device->host sync per batch).")
register_flag("ddp", "MXNET_DDP", _parse_bool, False,
              "Route dist_sync gradient exchange through the bucketed "
              "all-reduce (parallel/ddp.py): gradients are partitioned "
              "into size-bounded dtype-homogeneous buckets and each bucket "
              "is one flattened all-reduce over the process group after "
              "the backward, the optimizer replicated on every rank. Off: "
              "the kvstore push/pull path (one collective per tensor). "
              "python -m mxnet_tpu_torch.tools.launch --ddp exports this "
              "to every worker.")
register_flag("ddp_axis", "MXNET_DDP_AXIS", str, "dp",
              "Name of the data-parallel axis the DDP reducer reduces "
              "over (the JAX package's mesh axis; the port's group has "
              "this one axis).")
register_flag("ddp_bucket_mb", "MXNET_DDP_BUCKET_MB", float, 0.0,
              "Gradient bucket size in MiB for the DDP all-reduce path. "
              "0 (default) = auto: sized from the group link's bandwidth "
              "(perfmodel) so one bucket's transfer time amortizes a "
              "collective's launch overhead (clamped to [1, 64] MiB).")
register_flag("serve_buckets", "MXNET_SERVE_BUCKETS", str, "1,2,4,8,16,32",
              "Batch-size buckets the online serving runtime pads "
              "coalesced request batches to, comma separated ascending.")
register_flag("serve_batch_timeout_ms", "MXNET_SERVE_BATCH_TIMEOUT_MS",
              float, 2.0,
              "Micro-batching window: after the first queued request, "
              "wait up to this long for more requests to coalesce before "
              "dispatching a (possibly padded) device batch.")
register_flag("serve_queue_depth", "MXNET_SERVE_QUEUE_DEPTH", int, 256,
              "Admission-control bound: max requests queued ahead of the "
              "micro-batcher; beyond it a submit is rejected at once with "
              "a retry-after hint. 0/negative = unbounded.")
register_flag("serve_timeout_ms", "MXNET_SERVE_TIMEOUT_MS", float, 1000.0,
              "Default per-request deadline. A request still queued when "
              "its deadline passes is expired, never dispatched. "
              "0 = no deadline.")
register_flag("serve_cache_engines", "MXNET_SERVE_CACHE_ENGINES", int, 8,
              "LRU capacity of the per-bucket engine cache. "
              "0/negative = unbounded.")
register_flag("serve_warmup", "MXNET_SERVE_WARMUP", _parse_bool, True,
              "Run one zero batch through every freshly built bucket "
              "engine before it serves traffic.")
register_flag("serve_drain_tokens", "MXNET_SERVE_DRAIN_TOKENS", int, 32,
              "Bounded-drain token budget for continuous-batching decode: "
              "on graceful shutdown each active generation may produce at "
              "most this many MORE tokens before it is evicted with a "
              "resumable cursor. Without the bound a single long "
              "max_new_tokens request holds the drain hostage. "
              "0/negative = evict immediately at drain.")
register_flag("serve_decode_window", "MXNET_SERVE_DECODE_WINDOW", int, 16,
              "Decode metrics window: fold the decode step and token "
              "counts into the session's metrics every this many decode "
              "steps, from host-held scheduler state only (no extra "
              "device-to-host copies).")
register_flag("serve_drain_timeout_s", "MXNET_SERVE_DRAIN_S", float, 30.0,
              "Graceful-shutdown budget: how long Server.close(drain=True) "
              "waits for queued requests to finish.")
register_flag("embed_cache_rows", "MXNET_EMBED_CACHE_ROWS", int, 1024,
              "Device-resident hot-row capacity of the embedding cache "
              "(embed/cache.py): the served table keeps this many rows on "
              "the card and spills the cold tail to the host store. Size "
              "it above the per-step working set; the cache's hit rate "
              "says when it is too small.")
register_flag("embed_host_budget_mb", "MXNET_EMBED_HOST_BUDGET_MB",
              float, 0.0,
              "Host-memory budget (MiB) for the embedding spill store. "
              "0 (default) = unbounded. When set, the store raises "
              "instead of growing past it: the logical table may exceed "
              "the budget only as long as the touched cold tail stays "
              "inside it.")
register_flag("serve_max_gathers", "MXNET_SERVE_MAX_GATHERS", int, 65536,
              "Admission cap for the recommend queue in pending gather "
              "units (one unit = one embedding row fetched). Recommend "
              "requests are ragged, so the queue bills and rejects on "
              "gather counts, not request counts.")
register_flag("cpu_worker_nthreads", "MXNET_CPU_WORKER_NTHREADS", int, 4,
              "Host thread-pool width for IO decode/augment work "
              "(parity: MXNET_CPU_WORKER_NTHREADS).")
register_flag("data_staged_feed", "MXNET_DATA_STAGED_FEED", _parse_bool,
              True,
              "Let Module.fit stage each K-step window's stacked device "
              "feed on a feeder thread (data/feed.py), double-buffered on "
              "a side stream of its own so it overlaps the windows in "
              "flight. Only data is staged: keys and hyperparameters stay "
              "on the main thread, so the staged path is bitwise the "
              "unstaged one. Off: the grouped step stacks its own feed.")
register_flag("data_feed_depth", "MXNET_DATA_FEED_DEPTH", int, 2,
              "Staged windows in flight for the K-step device feed "
              "(2 = double buffering). Each staged window holds K stacked "
              "batches of device memory, so keep this small.")
register_flag("data_decode_threads", "MXNET_DATA_DECODE_THREADS", int, 0,
              "Decode/augment worker threads for StreamingDataIter "
              "(data/record_stream.py). 0 (default): cpu_worker_nthreads, "
              "the same pool width ImageRecordIter uses.")
