"""Key-value store for parameter synchronization (counterpart of
``mxnet_tpu/kvstore.py``), one process.

``init``/``push``/``pull``/``row_sparse_pull``/``pushpull``/
``broadcast`` keep the JAX package's rules:

* a push of a list of values sums them, left to right, in the first
  value's dtype (``_reduce``); one value is copied;
* with an optimizer set (``set_optimizer``, or an updater through
  ``_set_updater``) a push applies the update to the stored weight;
  without one, the pushed value REPLACES the stored value;
* ``pull`` skips row_sparse values under ``ignore_sparse=True``;
* ``set_gradient_compression({"type": "2bit", "threshold": t})``
  quantizes every dense push to {-t, 0, +t} with the error carried per
  key (``_compress``), the same round trip the JAX package applies in one
  process; ``_pack_2bit`` and ``_dequantize_2bit`` are its wire form.

Every name in ``_VALID`` creates a store. In one process ``dist_*``
behaves as the JAX package's does there: the store applies the update on
push and no cross-process reduce runs. Values stay on the device they
came from: the store keeps torch tensors (row_sparse values as
``RowSparseNDArray``), and a card tensor is summed, quantized and
updated on the card. The 2-bit quantize is plain torch operations, as the
JAX package's is plain ``jnp`` outside any Pallas kernel. A launcher
environment naming more than one worker raises (ROADMAP A6c), as do the
server commands and the dead-node count.
"""
from __future__ import annotations

import numpy as _np
import torch

from .base import MXNetError
from . import optimizer as _opt
from .ndarray.ndarray import NDArray
from .ndarray import sparse as _sp
from .parallel import dist as _dist

__all__ = ["KVStore", "create"]


def _is_sparse(v):
    return isinstance(v, _sp.BaseSparseNDArray)


def _dense_tensor(v):
    """A value's dense tensor (an NDArray's own, a tensor itself, a numpy
    array on the host)."""
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, NDArray):
        return v._data
    return torch.from_numpy(_np.ascontiguousarray(_np.asarray(v)))


class KVStore:
    def __init__(self, kv_type="local"):
        self._type = kv_type
        self._store = {}
        self._updater = None
        self._optimizer = None
        self._compression_params = None
        self._residuals = {}
        self._last_wire_bytes = None   # payload of the last push on a wire
        # dist_* joins the launcher's group; one process has none to join
        # (a world of more than one raises, ROADMAP A6c)
        if kv_type.startswith("dist"):
            _dist.init()

    # ------------------------------------------------------------- metadata
    @property
    def type(self):
        return self._type

    @property
    def rank(self):
        return _dist.rank()

    @property
    def num_workers(self):
        return _dist.num_workers()

    def get_num_dead_node(self, node_id=0, timeout=60):
        """Workers whose heartbeat went stale: the heartbeats belong to
        the multi-process launcher, which is not ported."""
        raise _dist.multi_process_error("get_num_dead_node")

    # ----------------------------------------------------------------- init
    def init(self, key, value):
        keys, values = _key_value(key, value)
        for k, v in zip(keys, values):
            v0 = v[0] if isinstance(v, list) else v
            if _is_sparse(v0):
                self._store[k] = _sp.RowSparseNDArray(
                    v0._values.clone(), v0._indices.clone(), v0.shape,
                    ctx=v0.context) if v0.stype == "row_sparse" else \
                    _sp.cast_storage(v0.todense().copy(), v0.stype)
            else:
                self._store[k] = _dense_tensor(v0).detach().clone()

    # ----------------------------------------------------------------- push
    def push(self, key, value, priority=0):
        keys, values = _key_value(key, value)
        for k, vs in zip(keys, values):
            if not isinstance(vs, list):
                vs = [vs]
            agg = self._reduce(vs)
            if self._compression_params and not _is_sparse(agg):
                # the quantize -> dequantize round trip of the wire, so
                # training converges as it would across processes
                agg = self._compress(k, agg)
            if self._updater is not None:
                if k not in self._store:
                    raise MXNetError("key %r not initialized" % k)
                self._updater(k, agg, self._store[k])
            else:
                # no updater: the merged push REPLACES the stored value
                self._store[k] = agg

    def _reduce(self, vs):
        """Sum a list of values, left to right in the first one's dtype;
        one value is copied (a row_sparse one passes as it is)."""
        if len(vs) == 1:
            v0 = vs[0]
            return v0 if _is_sparse(v0) else \
                _dense_tensor(v0).detach().clone()
        if any(isinstance(v, _sp.RowSparseNDArray) for v in vs):
            out = vs[0] if isinstance(vs[0], _sp.RowSparseNDArray) else \
                _sp.cast_storage(vs[0], "row_sparse")
            for v in vs[1:]:
                if not isinstance(v, _sp.RowSparseNDArray):
                    v = _sp.cast_storage(v if isinstance(v, NDArray)
                                         else NDArray(_dense_tensor(v)),
                                         "row_sparse")
                out = _sp.add(out, v)
            return out
        acc = _dense_tensor(vs[0]).detach()
        for v in vs[1:]:
            t = _dense_tensor(v).detach()
            acc = acc + t.to(device=acc.device, dtype=acc.dtype)
        return acc

    # ----------------------------------------------------------------- pull
    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Copy the stored values into ``out``; row_sparse values are
        skipped under ``ignore_sparse=True`` (``row_sparse_pull`` takes
        them) and densified into dense outputs otherwise."""
        keys, outs = _key_value(key, out)
        for k, os_ in zip(keys, outs):
            if k not in self._store:
                raise MXNetError("key %r not initialized" % k)
            src = self._store[k]
            if isinstance(src, _sp.RowSparseNDArray) and ignore_sparse:
                continue
            if not isinstance(os_, list):
                os_ = [os_]
            for o in os_:
                if _is_sparse(src) and isinstance(o, _sp.RowSparseNDArray) \
                        and isinstance(src, _sp.RowSparseNDArray):
                    _copy_rsp(src, o)
                else:
                    _copy_dense(src._data if _is_sparse(src) else src, o)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows ``row_ids`` (one id array, or one per
        output)."""
        keys, outs = _key_value(key, out)
        if row_ids is None:
            raise MXNetError("row_sparse_pull requires row_ids")
        rids = row_ids if isinstance(row_ids, list) else [row_ids]
        for k, os_ in zip(keys, outs):
            src = self._store[k]
            if not isinstance(os_, list):
                os_ = [os_]
            if len(rids) == 1:
                rids = rids * len(os_)
            for o, rid in zip(os_, rids):
                rsp = src if isinstance(src, _sp.RowSparseNDArray) else \
                    _sp.cast_storage(src if isinstance(src, NDArray)
                                     else NDArray(src), "row_sparse")
                rid = rid.asnumpy() if hasattr(rid, "asnumpy") else rid
                sub = _sp.retain(rsp, rid)
                if isinstance(o, _sp.RowSparseNDArray):
                    _copy_rsp(sub, o)
                else:
                    _copy_dense(sub._data, o)

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out, priority)

    broadcast = pull

    # ------------------------------------------------------------ optimizer
    def set_optimizer(self, optimizer):
        self._optimizer = optimizer
        self._updater = _opt.get_updater(optimizer)

    def _set_updater(self, updater):
        self._updater = updater

    def set_gradient_compression(self, compression_params):
        """2-bit gradient compression with the error carried per key."""
        if compression_params.get("type") not in ("2bit",):
            raise MXNetError("unsupported compression type %r"
                             % compression_params.get("type"))
        self._compression_params = {
            "type": "2bit",
            "threshold": float(compression_params.get("threshold", 0.5))}

    def _compress(self, key, grad):
        """``grad`` plus the key's residual, quantized to {-t, 0, +t}; the
        residual becomes what the quantize left out."""
        thr = self._compression_params["threshold"]
        g = _dense_tensor(grad)
        res = self._residuals.get(key)
        if res is None:
            res = torch.zeros_like(g)
        acc = g + res
        q = _quantize(acc, thr).to(g.dtype)
        self._residuals[key] = acc - q
        return q

    # ------------------------------------------------------------- persist
    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("no optimizer set")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("no optimizer set")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read(), device=self._state_device)

    def _state_device(self, key):
        v = self._store.get(key)
        if isinstance(v, torch.Tensor):
            return v.device
        return v._values.device if v is not None else "cpu"

    def _barrier(self):
        _dist.barrier()

    def _send_command_to_servers(self, head, body):
        """Control message to the server group: only dist_async has one
        (ROADMAP A6c); elsewhere a dropped message would fake success."""
        raise MXNetError(
            "kvstore type %r has no parameter server to command "
            "(server-side control messages exist only for dist_async; "
            "sync modes run their updates inside the compiled step)"
            % self._type)


def _copy_dense(src, o):
    """``src`` (a tensor) into the output ``o`` (a tensor, a dense or a
    row_sparse NDArray), in place where the output is dense."""
    with torch.no_grad():
        if isinstance(o, torch.Tensor):
            o.copy_(src)
        elif isinstance(o, _sp.RowSparseNDArray):
            rsp = _sp.cast_storage(NDArray(src.detach().clone()),
                                   "row_sparse")
            _copy_rsp(rsp, o)
        else:
            t = o._data
            if tuple(t.shape) == tuple(src.shape):
                t.copy_(src)
            else:
                o._rebind(src.detach().to(t.device, t.dtype).clone())


def _copy_rsp(src, o):
    """``src`` (row_sparse) into the row_sparse output ``o``, on ``o``'s
    device."""
    dev = o._values.device
    o._values = src._values.detach().to(dev).clone()
    o._indices = src._indices.to(dev).clone()
    o._shape = tuple(src.shape)
    o._invalidate()


def _quantize(acc, thr):
    return torch.where(acc >= thr, torch.full_like(acc, thr),
                       torch.where(acc <= -thr, torch.full_like(acc, -thr),
                                   torch.zeros_like(acc)))


def _pack_2bit(g, res, thr):
    """Quantize g + res to {-thr, 0, +thr} and pack the 2-bit codes four
    per uint8 (code 1 = +thr, 2 = -thr, 0 = zero), where g lies ->
    (packed uint8 tensor, new residual)."""
    acc = g + res
    plus = acc >= thr
    minus = acc <= -thr
    q = torch.where(plus, torch.full_like(acc, thr),
                    torch.where(minus, torch.full_like(acc, -thr),
                                torch.zeros_like(acc))).to(g.dtype)
    codes = (plus.to(torch.uint8) + 2 * minus.to(torch.uint8)).reshape(-1)
    pad = (-codes.numel()) % 4
    if pad:
        codes = torch.cat([codes, codes.new_zeros(pad)])
    c = codes.reshape(-1, 4)
    packed = c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)
    return packed.to(torch.uint8), acc - q


def _dequantize_2bit(packed, shape, thr):
    """Unpack uint8-packed 2-bit codes back to a float32 array of
    ``shape``: numpy in, numpy out; a tensor is unpacked where it lies."""
    if isinstance(packed, torch.Tensor):
        p = packed.to(torch.uint8)
        n = int(_np.prod(shape)) if shape else 1
        codes = torch.stack([p & 3, (p >> 2) & 3, (p >> 4) & 3,
                             (p >> 6) & 3], dim=1).reshape(-1)[:n]
        lut = torch.tensor([0.0, thr, -thr, 0.0], dtype=torch.float32,
                           device=p.device)
        return lut[codes.long()].reshape(shape)
    packed = _np.asarray(packed, dtype=_np.uint8)
    n = int(_np.prod(shape)) if shape else 1
    codes = _np.empty((packed.size, 4), _np.uint8)
    codes[:, 0] = packed & 3
    codes[:, 1] = (packed >> 2) & 3
    codes[:, 2] = (packed >> 4) & 3
    codes[:, 3] = (packed >> 6) & 3
    lut = _np.array([0.0, thr, -thr, 0.0], _np.float32)
    return lut[codes.ravel()[:n]].reshape(shape)


def _key_value(key, value):
    if isinstance(key, (str, int)):
        return [key], [value]
    return list(key), list(value)


_VALID = {"local", "device", "local_allreduce", "local_device",
          "tpu_sync", "nccl", "dist_sync", "dist_async", "dist_sync_device",
          "dist_device_sync"}


def create(name="local"):
    if not isinstance(name, str) or name not in _VALID:
        raise ValueError("unknown kvstore type %r (valid: %s)"
                         % (name, sorted(_VALID)))
    return KVStore(name)
