"""Artifacts: freeze a model into one file and serve it.

Counterpart of ``mxnet_tpu/serving.py`` for predict artifacts
(format_version 2, and 4 for int8-quantized graphs from
:mod:`~mxnet_tpu_torch.quant`) and generate artifacts (format_version 3,
and 5 with chunked prefill and, optionally, the int8 speculative
draft); recommend artifacts (format_version 6) are written and read by
:mod:`~mxnet_tpu_torch.embed.serve`. The JAX
package stages its programs out as StableHLO; the port's artifact
carries what the port needs to rebuild them: the graph as symbol JSON
(predict) or the decoder geometry (generate), and the weights as an npz.

File layout (``.mxtorch``): 8-byte magic ``MXTORCH1``, u32 metadata
length, metadata JSON (the JAX package's keys: ``inputs``,
``num_outputs``, ``platforms``, ``dynamic_batch``, ``kernel_tier``,
``format_version``, ``generate`` for a generate artifact and ``quant``
for an int8 one), then for predict the symbol JSON (``symbol_bytes``
long) and the parameters as an npz (``arg:<name>`` / ``aux:<name>``),
for generate the decoder weights as an npz (``generate.params.bytes``
long) and, in a speculative artifact, the int8 draft's after them
(``generate.draft_params.bytes`` long).

Surface:
  * export_compiled(sym, arg_params, aux_params, data_shapes, path)
  * CompiledModel.load(path, buckets=None, device=None) -> .predict(**data)
    (``.quantized`` for a format_version 4 artifact)
  * export_generate(params, spec, path, chunked=None, draft_params=None,
    speculate_k=None)
  * GenerateModel.load(path, device=None), load_bundled_params(path)
  * load_artifact(path, device=None) - any kind, by format_version
  * params_from_reference(arg_params, aux_params, symbol, device,
    data_shapes=...) - the JAX package's numpy parameters as tensors
    (for a decoder: ``serve.decode_model.params_from_reference``)
"""
from __future__ import annotations

import io
import json
import struct

import numpy as _np
import torch

from .base import MXNetError, dtype_name, normalize_dtype
from .context import resolve_device
from .executor import _as_tensor, _graph_eval_fn
from .kernels import graph_fuse as _gfuse
from .kernels import int8_dequant as _int8_dequant
from .kernels import tier as _tier
from .symbol import load_json

__all__ = ["export_compiled", "CompiledModel", "load_artifact",
           "params_from_reference", "export_generate", "GenerateModel",
           "load_bundled_params"]

_MAGIC = b"MXTORCH1"
_FORMAT_VERSION = 2       # the JAX package's f32 predict version
_QUANT_VERSION = 4        # an int8-quantized predict graph
_PREDICT_VERSIONS = (_FORMAT_VERSION, _QUANT_VERSION)
_GENERATE_VERSIONS = (3, 5)   # plain; with chunked prefill
_RECOMMEND_VERSION = 6        # two tables as data (embed/serve.py)


def _is_dynamic_dim(d):
    return d is None or d == -1 or isinstance(d, str)


def _probe_shapes(data_shapes):
    """Concrete shapes for inference: a symbolic batch becomes 2."""
    return {k: tuple(2 if _is_dynamic_dim(d) else int(d) for d in v)
            for k, v in data_shapes.items()}


def _label_names(symbol, arg_params, data_shapes):
    return [n for n in symbol.list_arguments()
            if n.endswith("label") and n not in arg_params
            and n not in data_shapes]


def _checked_params(symbol, arg_params, aux_params, data_shapes):
    """Every parameter name and shape checked against
    ``symbol.infer_shape``; labels the caller did not bind get zeros
    (inference ignores them). -> (args, aux) dicts of CPU tensors."""
    probe = _probe_shapes(data_shapes)
    arg_shapes, _, aux_shapes = symbol.infer_shape_partial(**probe)
    labels = set(_label_names(symbol, arg_params, data_shapes))
    want_args = {n: s for n, s in zip(symbol.list_arguments(), arg_shapes)
                 if n not in data_shapes}
    want_aux = dict(zip(symbol.list_auxiliary_states(), aux_shapes))
    out = []
    for kind, want, given in (("argument", want_args, arg_params),
                              ("auxiliary state", want_aux, aux_params)):
        missing = sorted(n for n in want if n not in given
                         and n not in labels)
        extra = sorted(n for n in given if n not in want)
        if missing or extra:
            raise MXNetError("parameters do not match the symbol: %s(s)%s%s"
                             % (kind,
                                " missing %s" % missing if missing else "",
                                " unexpected %s" % extra if extra else ""))
        tensors = {}
        for n, shape in want.items():
            if n in labels:
                tensors[n] = torch.zeros(shape if shape is not None
                                         else (1,), dtype=torch.float32)
                continue
            t = _as_tensor(given[n])
            if shape is not None and tuple(t.shape) != tuple(shape):
                raise MXNetError("%s %r has shape %s, the symbol needs %s"
                                 % (kind, n, tuple(t.shape), tuple(shape)))
            tensors[n] = t
        out.append(tensors)
    return out[0], out[1]


def params_from_reference(arg_params, aux_params, symbol, device=None, *,
                          data_shapes):
    """The JAX package's parameters (numpy arrays or NDArrays, names
    unchanged) as the port's tensors on ``device`` (default cuda:0).

    Convolution weights are OIHW and FullyConnected weights (hidden, in)
    in both packages, so values move across unchanged; every name and
    shape is checked against ``symbol.infer_shape`` at ``data_shapes``.
    The int8 ``*_weight_q`` arrays of a quantized graph cross unchanged.
    Labels are inputs, not parameters: none is returned, so the result
    exports at any batch.
    """
    dev = resolve_device(device)
    args, aux = _checked_params(symbol, dict(arg_params), dict(aux_params),
                                data_shapes)
    labels = set(_label_names(symbol, arg_params, data_shapes))
    return ({k: v.to(dev) for k, v in args.items() if k not in labels},
            {k: v.to(dev) for k, v in aux.items()})


_QUANT_OPS = ("_contrib_quantized_fc_int8", "_contrib_quantized_conv_int8")


def _kernel_census(symbol):
    """Kernels the fusion plan routes in this graph under the current
    tier, by kernel form: {"bn_act": 33, "bn_act_res": 16} at ResNet-50;
    each quantized site's epilogue counts as one ``int8_dequant``
    ({"int8_dequant": 54} at ResNet-50 quantized)."""
    nodes = symbol._topo()
    plans, _ = _gfuse.plan(nodes, list(symbol._entries))
    census = {}
    for p in plans.values():
        name = p.kind + ("_res" if p.kind == "bn_act"
                         and p.res_entry is not None else "")
        census[name] = census.get(name, 0) + 1
    if _tier.enabled():
        n = sum(1 for nd in nodes if not nd.is_variable
                and nd.op.name in _QUANT_OPS)
        if n:
            census[_int8_dequant.OP_NAME] = n
    return census


def export_compiled(symbol, arg_params, aux_params, data_shapes, path,
                    dtype="float32", dynamic_batch=False, device=None,
                    format_version=_FORMAT_VERSION, extra_meta=None):
    """Freeze (symbol, params) into an artifact at ``path``.

    data_shapes: dict name -> shape. With ``dynamic_batch=True`` (or a
    leading dim of None/-1) one artifact serves any batch size. Before
    writing, the graph runs once at the probe batch on ``device``
    (default cuda:0), as the JAX package traces it at export, so a graph
    that cannot run fails here and not at serving time.
    ``format_version`` is a predict version (2 = f32, 4 = int8-quantized;
    the quantization pipeline passes 4); ``extra_meta`` is merged into
    the metadata (the quant report).
    """
    if int(format_version) not in _PREDICT_VERSIONS:
        raise MXNetError("export_compiled emits predict artifacts "
                         "(format_version %s), not %s"
                         % (list(_PREDICT_VERSIONS), format_version))
    dev = resolve_device(device)
    data_shapes = {k: tuple(v) for k, v in data_shapes.items()}
    if any(_is_dynamic_dim(s[0]) for s in data_shapes.values() if s):
        dynamic_batch = True
    args, aux = _checked_params(symbol, dict(arg_params), dict(aux_params),
                                data_shapes)
    probe = _probe_shapes(data_shapes)
    tdtype = normalize_dtype(dtype)
    model = CompiledModel(symbol, args, aux, {
        "inputs": [{"name": n, "shape": list(probe[n]),
                    "dtype": dtype_name(tdtype)} for n in data_shapes]},
        dev)
    model.run(*[torch.zeros(probe[n], dtype=tdtype, device=dev)
                for n in data_shapes])
    meta = {
        "inputs": [{"name": n,
                    "shape": ([None] + list(probe[n][1:]) if dynamic_batch
                              else list(probe[n])),
                    "dtype": dtype_name(tdtype)} for n in data_shapes],
        "num_outputs": len(symbol._entries),
        "platforms": ["cuda", "cpu"],
        "dynamic_batch": bool(dynamic_batch),
        "kernel_tier": {"tier": _tier.tier(),
                        "kernels": _kernel_census(symbol)},
        "format_version": int(format_version),
    }
    meta.update(extra_meta or {})
    sym_json = symbol.tojson().encode()
    meta["symbol_bytes"] = len(sym_json)
    buf = io.BytesIO()
    _np.savez(buf, **{"arg:" + k: v.cpu().numpy() for k, v in args.items()},
              **{"aux:" + k: v.cpu().numpy() for k, v in aux.items()})
    mjson = json.dumps(meta).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(mjson)))
        f.write(mjson)
        f.write(sym_json)
        f.write(buf.getvalue())
    return meta


def _read_meta(f, path):
    if f.read(8) != _MAGIC:
        raise MXNetError("%r is not an mxnet_tpu_torch artifact" % path)
    (n,) = struct.unpack("<I", f.read(4))
    return json.loads(f.read(n).decode())


def _read_artifact(path):
    with open(path, "rb") as f:
        meta = _read_meta(f, path)
        if int(meta.get("format_version", 0)) not in _PREDICT_VERSIONS:
            raise MXNetError("artifact %r has format_version %s; a predict "
                             "model reads %s (open any kind with "
                             "load_artifact)" % (
                                 path, meta.get("format_version"),
                                 list(_PREDICT_VERSIONS)))
        symbol = load_json(f.read(meta["symbol_bytes"]).decode())
        npz = _np.load(io.BytesIO(f.read()))
        args, aux = {}, {}
        for key in npz.files:
            kind, name = key.split(":", 1)
            (args if kind == "arg" else aux)[name] = torch.from_numpy(
                npz[key])
    return meta, symbol, args, aux


class CompiledModel:
    """A loaded artifact on one device: call with data, get outputs.

    ``buckets``: optional ascending batch-size buckets. When set, a call
    whose batch is not a bucket is zero-padded up to the nearest bucket
    and the outputs sliced back, each bucket served by a lazily built,
    warmed engine from a shared LRU (:mod:`mxnet_tpu_torch.serve.
    engine_cache`). The kernel tier in force when the model is built is
    the one its graph runs under. ``quantized`` is True for an
    int8-quantized artifact (format_version 4), which the serve layer
    labels "int8".
    """

    def __init__(self, symbol, arg_params, aux_params, meta, device,
                 buckets=None, cache_engines=None, warmup=None):
        self.symbol = symbol
        self.meta = meta
        self.device = device
        self.input_names = [i["name"] for i in meta["inputs"]]
        self.dynamic_batch = bool(meta.get("dynamic_batch", False))
        self.quantized = int(meta.get("format_version",
                                      _FORMAT_VERSION)) == _QUANT_VERSION
        self._args = {k: v.to(device) for k, v in arg_params.items()}
        self._aux = {k: v.to(device) for k, v in aux_params.items()}
        self._eval = _graph_eval_fn(symbol)
        self.kernel_tier = _tier.tier()
        self._cache = None
        self.buckets = None
        if buckets:
            self.set_buckets(buckets, cache_engines=cache_engines,
                             warmup=warmup)

    @classmethod
    def load(cls, path, buckets=None, device=None, cache_engines=None,
             warmup=None):
        """Load an artifact onto ``device`` (default cuda:0; raises
        without a card unless the CPU is asked for)."""
        dev = resolve_device(device)
        meta, symbol, args, aux = _read_artifact(path)
        return cls(symbol, args, aux, meta, dev, buckets=buckets,
                   cache_engines=cache_engines, warmup=warmup)

    def run(self, *arrs):
        """The graph on device tensors already checked and batched ->
        tuple of device tensors."""
        arg_vals = dict(self._args)
        arg_vals.update(zip(self.input_names, arrs))
        with torch.inference_mode():
            outs, _ = self._eval(arg_vals, self._aux, False)
        return tuple(outs)

    # -- bucketed execution -------------------------------------------------
    def set_buckets(self, buckets, cache_engines=None, warmup=None):
        from .serve.engine_cache import BucketedEngineCache, check_buckets
        buckets = check_buckets(buckets, self)
        self._cache = BucketedEngineCache(self, capacity=cache_engines,
                                          warmup=warmup)
        self.buckets = buckets
        return self

    @property
    def engine_cache(self):
        return self._cache

    # -- validation ---------------------------------------------------------
    def _check_one(self, name, spec, arr):
        """Validate one input against the signature -> a tensor of the
        artifact's dtype on the model's device. The batch dim is free for
        dynamic or bucketed models."""
        want_dtype = normalize_dtype(spec["dtype"])
        want_shape = spec["shape"]
        t = arr if isinstance(arr, torch.Tensor) else torch.as_tensor(
            _np.asarray(arr))
        shape = tuple(t.shape)
        if len(shape) != len(want_shape):
            raise MXNetError(
                "CompiledModel: input %r expects rank %d (shape %s), got "
                "rank %d (shape %s)" % (name, len(want_shape),
                                        _fmt_shape(want_shape), len(shape),
                                        shape))
        for axis, (w, g) in enumerate(zip(want_shape, shape)):
            if axis == 0 and (w is None or self.dynamic_batch
                              or self.buckets):
                continue
            if w != g:
                raise MXNetError(
                    "CompiledModel: input %r expects shape %s, got %s "
                    "(mismatch at axis %d)" % (name, _fmt_shape(want_shape),
                                               shape, axis))
        if t.dtype != want_dtype and not torch.can_cast(t.dtype, want_dtype):
            raise MXNetError(
                "CompiledModel: input %r expects dtype %s, got %s (refusing "
                "an unsafe cast)" % (name, dtype_name(want_dtype),
                                     dtype_name(t.dtype)))
        return t.to(device=self.device, dtype=want_dtype)

    def _check_inputs(self, arrs):
        if len(arrs) != len(self.input_names):
            raise MXNetError(
                "CompiledModel: expects %d input(s) %s, got %d"
                % (len(self.input_names), self.input_names, len(arrs)))
        out = [self._check_one(name, spec, a) for name, spec, a in
               zip(self.input_names, self.meta["inputs"], arrs)]
        batches = [a.shape[0] if a.dim() else 0 for a in out]
        if len(set(batches)) > 1:
            raise MXNetError(
                "CompiledModel: inconsistent batch sizes across inputs: %s"
                % dict(zip(self.input_names, batches)))
        return out

    # -- execution ----------------------------------------------------------
    def __call__(self, *data):
        arrs = self._check_inputs(data)
        if self._cache is None:
            return self.run(*arrs)
        rows = int(arrs[0].shape[0])
        top = self.buckets[-1]
        if rows <= top:
            return self._cache.run_padded(self.buckets, arrs, rows)
        # larger than the biggest bucket: chunk through it
        parts = [self._cache.run_padded(
                    self.buckets, [a[lo:lo + top] for a in arrs],
                    min(top, rows - lo))
                 for lo in range(0, rows, top)]
        return tuple(torch.cat(outs) for outs in zip(*parts))

    def predict(self, **data):
        extra = sorted(set(data) - set(self.input_names))
        missing = sorted(set(self.input_names) - set(data))
        if extra or missing:
            raise MXNetError(
                "CompiledModel.predict: artifact inputs are %s%s%s"
                % (self.input_names,
                   ("; missing %s" % missing) if missing else "",
                   ("; unexpected %s" % extra) if extra else ""))
        return self(*[data[n] for n in self.input_names])


def _fmt_shape(shape):
    return "(" + ", ".join("N" if d is None else str(d)
                           for d in shape) + ")"


# -- generate artifacts (format_version 3 and 5) ----------------------------

def _generate_census(spec, k=None):
    """Kernels the tier in force dispatches per run of each program at
    this geometry: {"prefill": {"flash_attn": L}, "decode":
    {"flash_attn_paged": L}, ...}; a site the paged guard declines
    gathers its context through ``take_rows`` twice (K and V). With a
    speculation depth ``k``, also the draft's chunk and the speculative
    step (k draft token-steps at W = 1 and the verifier at W = k+1)."""
    from .kernels import attention as _attn
    from .kernels import take as _take
    if _tier.tier() != "auto":
        return {}
    L, C, H = spec.num_layers, spec.dim, spec.num_heads
    S, P, MP = spec.max_slots, spec.max_prompt_len, spec.max_pages_per_slot
    f32 = torch.float32
    q = (S, H, P, spec.head_dim)

    def paged(s, w):
        if _attn.paged_eligible((s, w, C), (spec.cache_rows, C), (s, MP),
                                (s,), f32, H, spec.page_size) is None:
            return {_attn.PAGED_OP_NAME: L}
        if _take.eligible((spec.cache_rows, C), f32,
                          (s, spec.max_context), torch.int64) is None:
            return {_take.OP_NAME: 2 * L}
        return {}

    out = {"prefill": ({_attn.OP_NAME: L}
                       if _attn.eligible(q, q, q, f32) is None else {}),
           "decode": paged(S, 1), "chunk_prefill": paged(1, P)}
    if k is not None:
        out["draft_chunk_prefill"] = out["chunk_prefill"]
        step = {name: k * n for name, n in out["decode"].items()}
        for name, n in paged(S, k + 1).items():
            step[name] = step.get(name, 0) + n
        out["draft_verify"] = step
    return out


def export_generate(params, spec, path, chunked=None, draft_params=None,
                    speculate_k=None):
    """Freeze a decoder (weights + :class:`~mxnet_tpu_torch.serve.
    decode_model.DecoderSpec` geometry) into a generate artifact.

    ``params`` are the JAX package's numpy dict (``init_params``) or the
    port's tensors; every name and shape is checked against the spec.
    The decoder is f32. With ``chunked=True`` (implied by
    ``draft_params``) the artifact is format_version 5 and prompts
    longer than ``max_prompt_len`` stream through ``chunk_prefill``;
    otherwise format_version 3. ``draft_params`` (a
    :func:`~mxnet_tpu_torch.serve.decode_model.quantize_decoder_params`
    dict of the same architecture, normally the int8 twin of
    ``params``) is bundled beside the weights, and the artifact then
    serves the speculative step drafting ``speculate_k`` tokens per step
    (default: the :func:`~mxnet_tpu_torch.serve.decode_model.
    suggest_speculation_depth` pick, recorded in
    ``meta["generate"]["speculate_k"]``). A draft without chunked
    prefill raises: the draft cache is filled through it. The weights
    travel whole (the JAX package's ``bundle_params=True``).
    ``meta["kernel_tier"]`` records the tier in force and the kernels it
    dispatches per program run at this geometry.
    """
    from .serve import decode_model as _dm
    spec = _dm.DecoderSpec(*spec).validate()
    if chunked is None:
        chunked = draft_params is not None
    if draft_params is not None and not chunked:
        raise MXNetError("export_generate: a speculative artifact needs "
                         "chunked prefill (the draft cache is populated "
                         "through it); drop chunked=False")
    blobs = [_params_npz(_dm.params_from_reference(params, spec, "cpu"))]
    gen_meta = {"spec": spec._asdict(), "dtype": "float32",
                "params": {"bytes": len(blobs[0])}}
    k = None
    if draft_params is not None:
        blobs.append(_params_npz(_dm.params_from_reference(
            draft_params, spec, "cpu")))
        gen_meta["draft_params"] = {"bytes": len(blobs[1])}
        k = speculate_k
        if k is None:
            k = _dm.suggest_speculation_depth(spec)
        k = max(1, min(int(k), spec.max_prompt_len))
        gen_meta["speculate_k"] = k
    P = spec.max_prompt_len
    meta = {
        "format_version": 5 if chunked else 3,
        "platforms": ["cuda", "cpu"],
        "dynamic_batch": True,
        # the prefill signature, v2-shaped so BucketedEngineCache serves
        # it unchanged
        "inputs": [
            {"name": "tokens", "shape": [None, P], "dtype": "int32"},
            {"name": "lengths", "shape": [None], "dtype": "int32"},
            {"name": "temperatures", "shape": [None], "dtype": "float32"},
            {"name": "seeds", "shape": [None], "dtype": "int32"},
        ],
        "num_outputs": 3,
        "generate": gen_meta,
        "kernel_tier": {"tier": _tier.tier(),
                        "kernels": _generate_census(spec, k)},
    }
    mjson = json.dumps(meta).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(mjson)))
        f.write(mjson)
        for blob in blobs:
            f.write(blob)
    return meta


def _params_npz(tensors):
    buf = io.BytesIO()
    _np.savez(buf, **{k: v.numpy() for k, v in tensors.items()})
    return buf.getvalue()


def _read_npz(f, nbytes):
    with _np.load(io.BytesIO(f.read(int(nbytes)))) as z:
        return {k: z[k] for k in z.files}


def _read_generate(path):
    """(meta, params, draft_params or None) of a generate artifact."""
    with open(path, "rb") as f:
        meta = _read_meta(f, path)
        if int(meta.get("format_version", 0)) not in _GENERATE_VERSIONS:
            raise MXNetError("artifact %r has format_version %s, not a "
                             "generate artifact (3 or 5)"
                             % (path, meta.get("format_version")))
        gen = meta["generate"]
        params = _read_npz(f, gen["params"]["bytes"])
        draft = (_read_npz(f, gen["draft_params"]["bytes"])
                 if gen.get("draft_params") else None)
    return meta, params, draft


def load_bundled_params(path):
    """The decoder weights a generate artifact carries, as
    ``(params, draft_params_or_None)`` numpy dicts."""
    return _read_generate(path)[1:]


class PrefillModel:
    """The prefill function as a bucketed engine: the artifact's
    v2-shaped signature (tokens, lengths, temperatures, seeds) with a
    dynamic batch, served through :class:`~mxnet_tpu_torch.serve.
    engine_cache.BucketedEngineCache` like a predict model. Inputs stay
    host arrays until the prefill function copies them to the device,
    so it can see on the host which rows sample."""

    def __init__(self, fn, meta, device):
        self._fn = fn
        self.meta = {"inputs": meta["inputs"],
                     "kernel_tier": meta.get("kernel_tier")}
        self.input_names = [i["name"] for i in meta["inputs"]]
        self.dynamic_batch = True
        self.device = device
        self._cache = None
        self.buckets = None

    def run(self, *arrs):
        return tuple(self._fn(*arrs))

    def set_buckets(self, buckets, cache_engines=None, warmup=None):
        from .serve.engine_cache import BucketedEngineCache, parse_buckets
        self._cache = BucketedEngineCache(self, capacity=cache_engines,
                                          warmup=warmup)
        self.buckets = parse_buckets(buckets)
        return self

    @property
    def engine_cache(self):
        return self._cache

    def __call__(self, *arrs):
        arrs = [torch.as_tensor(_np.asarray(a), dtype=normalize_dtype(
            s["dtype"])) for a, s in zip(arrs, self.meta["inputs"])]
        if self._cache is None:
            return self.run(*arrs)
        return self._cache.run_padded(self.buckets, arrs,
                                      int(arrs[0].shape[0]))


class GenerateModel:
    """A loaded generate artifact on one device: the decoder's weights
    on the device and the programs over them, each a plain function
    from ``serve.decode_model``: ``prefill`` (a :class:`PrefillModel`),
    ``decode``, ``commit`` and, for format_version 5, ``chunk_prefill``.
    A format_version 5 artifact that bundles an int8 draft also has
    ``draft_chunk_prefill`` and ``draft_verify`` (``speculative`` true,
    ``speculate_k`` its depth); one without a draft serves as a plain
    chunk-capable engine. The kernel tier in force at load is the one
    every program runs under. Execution is :class:`mxnet_tpu_torch.
    serve.decode.GenerateSession`'s."""

    def __init__(self, params, meta, device, draft_params=None):
        from .serve import decode_model as _dm
        self.meta = meta
        self.device = device
        spec = self.spec
        self.params = _dm.params_from_reference(params, spec, device)
        self.prefill = PrefillModel(_dm.make_prefill(self.params, spec),
                                    meta, device)
        self.decode = _dm.make_decode(self.params, spec)
        self.commit = _dm.make_commit(spec)
        v5 = int(meta["format_version"]) == 5
        self.chunk_prefill = (_dm.make_chunk_prefill(self.params, spec)
                              if v5 else None)
        self.draft_params = self.draft_verify = None
        self.draft_chunk_prefill = None
        self.speculate_k = 0
        if v5 and draft_params is not None:
            # int8 weights aligned for the product once, here
            self.draft_params = _dm._int8_aligned(_dm.params_from_reference(
                draft_params, spec, device))
            self.speculate_k = int(meta["generate"]["speculate_k"])
            self.draft_chunk_prefill = _dm.make_chunk_prefill(
                self.draft_params, spec)
            self.draft_verify = _dm.make_draft_verify(
                self.params, self.draft_params, spec, self.speculate_k)

    @property
    def spec(self):
        from .serve.decode_model import DecoderSpec
        return DecoderSpec(**self.meta["generate"]["spec"])

    @property
    def has_chunk_prefill(self):
        """Prompts longer than max_prompt_len stream through fixed-shape
        chunks (format_version 5)."""
        return self.chunk_prefill is not None

    @property
    def speculative(self):
        """The artifact bundles the int8 draft: sessions speculate
        unless asked not to."""
        return self.draft_verify is not None

    @classmethod
    def load(cls, path, device=None):
        """Load onto ``device`` (default cuda:0; raises without a card
        unless the CPU is asked for)."""
        dev = resolve_device(device)
        meta, params, draft = _read_generate(path)
        return cls(params, meta, dev, draft)


def load_artifact(path, **kw):
    """Open any ``.mxtorch`` artifact through the format-version
    dispatch: :class:`CompiledModel` for predict artifacts
    (format_version 2, and 4 for int8-quantized), :class:`GenerateModel`
    for generate artifacts (3 and 5), and the embed package's
    ``RecommendModel`` for recommend artifacts (6)."""
    with open(path, "rb") as f:
        version = int(_read_meta(f, path).get("format_version", 0))
    if version in _GENERATE_VERSIONS:
        return GenerateModel.load(path, **kw)
    if version == _RECOMMEND_VERSION:
        from .embed.serve import RecommendModel
        return RecommendModel.load(path, **kw)
    return CompiledModel.load(path, **kw)
