"""Key-value store for parameter synchronization (counterpart of
``mxnet_tpu/kvstore.py``).

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
  key (``_compress``); ``_pack_2bit`` and ``_dequantize_2bit`` are its
  wire form.

Every name in ``_VALID`` creates a store. ``dist_*`` joins the
launcher's process group (``parallel.dist``, ``python -m
mxnet_tpu_torch.tools.launch``); in one process it behaves as the JAX
package's does there: the store applies the update on push and no
cross-process reduce runs. Across processes:

* ``dist_sync``: ``init`` is a broadcast of rank 0's value (a
  row_sparse value densified for it); ``push`` all-reduces the
  aggregate over the group (a row_sparse one densified for the
  collective and cast back), then applies the update on every rank, so
  every rank holds the same weights. With 2-bit compression the packed
  codes are what crosses the group: every rank all-gathers them and sums
  their dequantized values in rank order (``_dist_reduce_2bit``). Every
  rank must push the same keys in the same order.
* ``dist_async``: rank 0 runs the apply-on-push server
  (``parallel/async_server.py``) on its device, its port broadcast once;
  every rank's push goes to it and is applied at once, with no barrier,
  and a pull fetches the weights as they stand.

Values stay on the device they came from: the store keeps torch tensors
(row_sparse values as ``RowSparseNDArray``), and a card tensor is summed,
quantized, reduced and updated on the card (the group's collectives take
card tensors; ``parallel.dist``). The 2-bit quantize is plain torch
operations, as the JAX package's is plain ``jnp`` outside any Pallas
kernel. ``get_num_dead_node`` counts the ranks whose heartbeat went stale
(``parallel/fault.py``); ``_send_command_to_servers`` reaches the
``dist_async`` server and is refused elsewhere.
"""
from __future__ import annotations

import os
import pickle
import types

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
        # dist_* joins the launcher's group; in one process there is none
        # and the store is local
        self._dist = False
        self._async_server = None
        self._async_client = None
        if kv_type.startswith("dist"):
            self._dist = _dist.init() and _dist.num_workers() > 1
        if self._dist and kv_type == "dist_async":
            self._start_async()

    def _start_async(self):
        """dist_async: rank 0 hosts the apply-on-push server thread on
        its device, every rank connects a client; one broadcast shares
        the port, and after it no rank waits for another."""
        from .context import resolve_device
        from .parallel import async_server as _async
        coord = _dist.env_spec()[0]
        host = _async._host_of(coord) if coord else None
        if _dist.rank() == 0:
            # with a job secret the server binds the coordinator's
            # interface (remote workers, authenticated frames); without
            # one it stays on loopback
            bind = None
            if os.environ.get("MXNET_KVSTORE_SECRET") and \
                    not os.environ.get("MXNET_KVSTORE_BIND"):
                bind = host
            self._async_server = _async.Server(bind=bind,
                                               device=resolve_device())
            port = self._async_server.port
        else:
            port = 0
        port = int(_dist.broadcast(torch.tensor([port], dtype=torch.int64),
                                   root=0)[0])
        self._async_client = _async.Client(
            os.environ.get("MXNET_ASYNC_SERVER_HOST") or host
            or "127.0.0.1", port)

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
        """Number of workers whose heartbeat went stale (the reference's
        ps-lite scheduler heartbeats). ``node_id`` selects a ps-lite node
        group there; here only workers exist, so it is ignored. The beats
        are the per-rank files under the launcher's heartbeat directory
        (``parallel/fault.py``)."""
        from .parallel import fault as _fault
        return len(_fault.dead_nodes(self.num_workers, timeout=timeout))

    # ----------------------------------------------------------------- init
    def init(self, key, value):
        keys, values = _key_value(key, value)
        for k, v in zip(keys, values):
            v0 = v[0] if isinstance(v, list) else v
            if self._async_client is not None:
                dense = v0.todense()._data if _is_sparse(v0) \
                    else _dense_tensor(v0)
                self._async_client.call("init", k,
                                        dense.detach().cpu().numpy())
                # the template a pull fills: shape, dtype, device, stype
                self._store[k] = _sp.cast_storage(
                    v0.todense().copy(), v0.stype) if _is_sparse(v0) \
                    else _dense_tensor(v0).detach().clone()
                continue
            if self._dist and _is_sparse(v0):
                # rank 0's value everywhere; a sparse one crosses dense
                dense = _dist.broadcast(v0.todense()._data, root=0)
                self._store[k] = _sp.cast_storage(
                    NDArray(dense, ctx=v0.context), v0.stype)
            elif self._dist:
                self._store[k] = _dist.broadcast(
                    _dense_tensor(v0).detach(), root=0)
            elif _is_sparse(v0):
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
            if self._async_client is not None:
                self._push_async(k, agg)
                continue
            if self._compression_params and self._dist and \
                    not _is_sparse(agg):
                # the packed 2-bit codes cross the group, summed after
                # unpacking; the residual stays on this rank
                agg = self._dist_reduce_2bit(k, agg)
            else:
                if self._compression_params and not _is_sparse(agg):
                    # in one process: the quantize -> dequantize round
                    # trip of the wire, so training converges alike
                    agg = self._compress(k, agg)
                if self._dist:
                    agg = self._dist_reduce(agg)
            if self._updater is not None:
                if k not in self._store:
                    raise MXNetError("key %r not initialized" % k)
                self._updater(k, agg, self._store[k])
            else:
                # no updater: the merged push REPLACES the stored value
                self._store[k] = agg

    def _push_async(self, k, agg):
        """dist_async: this rank's gradient to the server, which applies
        it at once: no reduce across ranks, no barrier."""
        g = agg.todense()._data if _is_sparse(agg) else agg
        if self._compression_params:
            packed, shape, thr = self._quantize_wire(k, g)
            self._async_client.call("pushq", k, packed.cpu().numpy(),
                                    shape, thr)
        else:
            g = g.detach().cpu().numpy()
            self._last_wire_bytes = g.nbytes
            self._async_client.call("push", k, g)

    def _quantize_wire(self, key, grad):
        """This rank's 2-bit quantize, packed four codes a byte where the
        gradient lies; the residual stays here -> (packed uint8 tensor,
        shape, threshold)."""
        thr = self._compression_params["threshold"]
        g = _dense_tensor(grad)
        res = self._residuals.get(key)
        if res is None:
            res = torch.zeros_like(g)
        packed, self._residuals[key] = _pack_2bit(g, res, thr)
        self._last_wire_bytes = packed.numel()
        return packed, tuple(g.shape), thr

    def _dist_reduce_2bit(self, key, agg):
        """dist_sync with compression: every rank's packed codes
        gathered (the only bytes that cross the group), dequantized and
        summed in rank order where the gradient lies."""
        packed, shape, thr = self._quantize_wire(key, agg)
        total = None
        for row in _dist.allgather(packed):          # (world, nbytes)
            d = _dequantize_2bit(row, shape, thr)
            total = d if total is None else total + d
        return total

    def _dist_reduce(self, agg):
        """The sum over the group (the reference's worker-to-server
        aggregation as a symmetric all-reduce); a row_sparse aggregate
        crosses dense and comes back row_sparse. ``agg`` is
        :meth:`_reduce`'s own buffer, so it is summed in place."""
        if _is_sparse(agg):
            dense = _dist.allreduce_sum(agg.todense()._data, owned=True)
            return _sp.cast_storage(NDArray(dense, ctx=agg.context),
                                    agg.stype)
        return _dist.allreduce_sum(agg, owned=True)

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
            if self._async_client is not None:
                # the server's weights as they stand now
                cur = torch.from_numpy(self._async_client.call("pull", k))
                if _is_sparse(src):
                    src = _sp.cast_storage(
                        NDArray(cur.to(src._values.device),
                                ctx=src.context), src.stype)
                else:
                    src = cur.to(src.device)
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
        if self._async_client is not None:
            # the update runs on the server: the optimizer travels
            # pickled, and the workers keep no updater
            self._async_client.call("set_optimizer", _pickle_optimizer(
                optimizer))
            self._updater = None
            return
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
        """Control message to the server group (the reference's
        kSetOptimizer and profiler commands): delivered to the dist_async
        server; refused elsewhere, where no server exists and a dropped
        message would fake success."""
        if self._async_client is not None:
            self._async_client.call("command", head, body)
            return
        raise MXNetError(
            "kvstore type %r has no parameter server to command "
            "(server-side control messages exist only for dist_async; "
            "sync modes run their updates inside the compiled step)"
            % self._type)


def _pickle_optimizer(optimizer):
    """The optimizer as the dist_async server unpickles it: a Gluon
    Trainer's ``param_dict`` of Parameters (tensors on this rank's card)
    travels as their ``lr_mult``/``wd_mult`` only, which is all the
    optimizer reads from it."""
    keep = optimizer.param_dict
    optimizer.param_dict = {
        i: types.SimpleNamespace(lr_mult=getattr(p, "lr_mult", 1.0),
                                 wd_mult=getattr(p, "wd_mult", 1.0))
        for i, p in keep.items()}
    try:
        return pickle.dumps(optimizer)
    finally:
        optimizer.param_dict = keep


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
