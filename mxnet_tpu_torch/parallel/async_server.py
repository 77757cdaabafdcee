"""Asynchronous parameter server for ``kvstore='dist_async'``
(counterpart of ``mxnet_tpu/parallel/async_server.py``).

In async mode the server applies EVERY worker push to the global weights
at once, with no aggregation barrier and no waiting for the other
workers, and a pull returns whatever the weights are now (the
reference's ``kvstore_dist_server.h`` ``ApplyUpdates``, async arm).
Workers go at their own pace.

The server is a background thread on rank 0. It keeps the weights as
torch tensors on rank 0's device (``Server(device=)``; the kvstore
passes the device rank 0 runs on) and applies each push there through
the port's ``Updater`` (:meth:`Server._apply`), the update the local
kvstore runs.

Wire protocol and trust model, as the JAX package's:

* Frame: ``<Q total_len> <32B HMAC-SHA256 tag> <payload>``; the payload
  is ``<I header_len> <JSON header> <raw tensor bytes>``. Tensors travel
  as raw little-endian numpy buffers described by the header's dtype and
  shape: no pickle on the tensor path.
* Every frame is authenticated with HMAC over a shared secret
  (``MXNET_KVSTORE_SECRET``) BEFORE anything is parsed; a bad tag drops
  the connection. Without a secret the server makes a process-local one
  and binds loopback only. A non-loopback bind (``MXNET_KVSTORE_BIND``)
  without a secret is refused.
* Each connection opens with a server-issued random challenge, and frame
  n MACs ``challenge || n || payload``: a replayed or reordered frame
  fails like a forgery.
* ``set_optimizer`` is the one pickled payload (the reference ships the
  pickled optimizer the same way); it is unpickled only after the frame
  has been authenticated.
* Each client THREAD has its own connection, so one worker's push and
  pull on two threads overlap. ``Server.close`` drains: handlers finish
  their current request before the listener stops. The client retries
  the idempotent calls (init, pull, stats) with backoff after a lost
  connection, never a push.

Fault points (``parallel/faultinject.py``): ``call`` on the client before
each request is sent, ``serve`` on the server after each request is
authenticated.
"""
from __future__ import annotations

import hashlib
import hmac
import json
import os
import pickle
import secrets as _secrets
import socket
import socketserver
import struct
import threading
import weakref

import time as _time

import numpy as _np
import torch

from . import faultinject

__all__ = ["Server", "Client"]

_TAG_LEN = 32

# refuse absurd frame-length claims BEFORE buffering the payload — an
# unauthenticated peer controls the length field (tag checks come after
# the read), so the default bounds what such a peer can make us buffer to
# 256 MiB per connection. Tunable for jobs shipping truly huge single
# tensors (a 4 GiB-era default let one pre-auth connection pin ~4 GiB).
_MAX_FRAME = int(os.environ.get("MXNET_KVSTORE_MAX_FRAME", str(256 << 20)))

# process-local default secret: single-process topologies (server thread +
# in-process clients) share it implicitly; separate processes must export
# MXNET_KVSTORE_SECRET (the launcher, python -m
# mxnet_tpu_torch.tools.launch, makes one per job)
_process_secret = _secrets.token_bytes(32)


def _secret():
    """Derived HMAC key. Called once per Server/Client construction —
    not per frame — so env lookup + sha256 stay off the hot path."""
    s = os.environ.get("MXNET_KVSTORE_SECRET")
    if s:
        return hashlib.sha256(s.encode()).digest()
    return _process_secret


def _is_loopback(bind):
    return bind in ("127.0.0.1", "localhost", "::1")


class _Channel:
    """Per-connection anti-replay state: a server-issued random challenge
    plus a monotonic frame counter, both mixed into every frame's HMAC
    input (frame #n MACs ``challenge || n || payload``). The request/reply
    protocol is lock-step, so both ends advance the same counter sequence;
    a frame captured earlier (same connection or any previous one) MACs
    over the wrong (challenge, counter) pair and is rejected exactly like
    a forgery — replays and reordering are dropped, not applied."""

    __slots__ = ("challenge", "n")

    def __init__(self, challenge):
        self.challenge = challenge
        self.n = 0

    def _mac_prefix(self):
        # consumed exactly once per frame, in wire order
        prefix = self.challenge + struct.pack("<Q", self.n)
        self.n += 1
        return prefix


def _send_frame(sock, header, blob=b"", key=None, chan=None):
    hdr = json.dumps(header).encode()
    payload = struct.pack("<I", len(hdr)) + hdr + blob
    prefix = chan._mac_prefix() if chan is not None else b""
    tag = hmac.new(key or _secret(), prefix + payload,
                   hashlib.sha256).digest()
    sock.sendall(struct.pack("<Q", _TAG_LEN + len(payload)) + tag + payload)


def _host_of(addr):
    """Host part of a ``host:port`` coordinator address; tolerates
    bracketed IPv6 (``[::1]:9091`` -> ``::1``)."""
    host = addr.rsplit(":", 1)[0]
    if host.startswith("[") and host.endswith("]"):
        host = host[1:-1]
    return host


def _recv_exact(sock, n):
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return bytes(buf)


def _recv_frame(sock, key=None, chan=None):
    (total,) = struct.unpack("<Q", _recv_exact(sock, 8))
    if total < _TAG_LEN + 4 or total > _MAX_FRAME:
        raise ConnectionError("malformed frame (claimed %d bytes)" % total)
    tag = _recv_exact(sock, _TAG_LEN)
    payload = _recv_exact(sock, total - _TAG_LEN)
    # authenticate BEFORE parsing anything; the channel prefix makes a
    # replayed/reordered frame fail exactly like a forgery
    prefix = chan._mac_prefix() if chan is not None else b""
    want = hmac.new(key or _secret(), prefix + payload,
                    hashlib.sha256).digest()
    if not hmac.compare_digest(tag, want):
        raise ConnectionError("frame failed authentication"
                              + (" (stale counter/replay?)"
                                 if chan is not None else ""))
    (hlen,) = struct.unpack("<I", payload[:4])
    header = json.loads(payload[4:4 + hlen].decode())
    return header, payload[4 + hlen:]


def _pack_array(arr):
    arr = _np.ascontiguousarray(arr)
    return ({"dtype": arr.dtype.str, "shape": list(arr.shape)},
            arr.tobytes())


def _unpack_array(meta, blob):
    return _np.frombuffer(blob, dtype=_np.dtype(meta["dtype"])) \
        .reshape(meta["shape"]).copy()


class Server:
    """Rank-0 async parameter server thread.

    ``bind``: interface to listen on. Defaults to ``MXNET_KVSTORE_BIND``,
    else loopback. Non-loopback binds require MXNET_KVSTORE_SECRET.
    ``device``: where the weights live and the updates run (the current
    context, cuda:0 unless scoped, when None)."""

    def __init__(self, bind=None, device=None):
        bind = bind or os.environ.get("MXNET_KVSTORE_BIND") or "127.0.0.1"
        if not _is_loopback(bind) and \
                not os.environ.get("MXNET_KVSTORE_SECRET"):
            raise RuntimeError(
                "async kvstore server: refusing to bind non-loopback "
                "interface %r without MXNET_KVSTORE_SECRET set — remote "
                "peers must authenticate" % bind)
        from ..context import resolve_device
        self.device = resolve_device(device)
        self._store = {}          # key -> tensor on self.device
        self._updater = None
        self._locks = {}          # per-key: pushes to different keys overlap
        self._glock = threading.Lock()
        self._push_log = []       # (monotonic_ts, key) — test observability
        self._commands = []
        self._hmac_key = _secret()
        # shutdown drain: handlers poll this between requests, so stopping
        # lets every in-flight push/pull FINISH (and its reply flush)
        # instead of a daemon thread dying mid-_apply with half-updated
        # weights and a worker wedged on a reply that never comes
        self._stop = threading.Event()
        self._active = 0          # connections currently inside handle()
        self._closed = False
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                import select
                with outer._glock:
                    outer._active += 1
                try:
                    # per-connection anti-replay channel: issue a fresh
                    # random challenge in a hello frame (MAC'd with the
                    # shared key alone — the peer can't know the challenge
                    # yet), then every subsequent frame in either direction
                    # MACs over challenge || counter || payload
                    challenge = _secrets.token_bytes(16)
                    _send_frame(self.request,
                                {"op": "hello",
                                 "challenge": challenge.hex()},
                                key=outer._hmac_key)
                    chan = _Channel(challenge)
                    while not outer._stop.is_set():
                        # wait for readability OUTSIDE _recv_frame: a plain
                        # socket timeout could fire mid-frame and desync
                        # the stream; this poll only gates the idle gap
                        # between requests
                        ready, _, _ = select.select([self.request], [], [],
                                                    0.5)
                        if not ready:
                            continue
                        header, blob = _recv_frame(self.request,
                                                   key=outer._hmac_key,
                                                   chan=chan)
                        # injected server-side drop ("conn_drop@serve=OP"):
                        # raised OUTSIDE the dispatch try so it falls
                        # through to the outer handler and severs the
                        # connection exactly like a peer failure
                        faultinject.fire("serve", op=header.get("op"))
                        try:
                            reply_hdr, reply_blob = outer._dispatch(header,
                                                                    blob)
                        except Exception as e:  # authenticated-but-bad
                            # frame (e.g. version skew): protocol error
                            # reply, not a handler traceback + disconnect
                            if os.environ.get("MXNET_ASYNC_DEBUG"):
                                import traceback
                                traceback.print_exc()
                            reply_hdr, reply_blob = {
                                "status": "err",
                                "error": "%s: %s" % (type(e).__name__,
                                                     e)}, b""
                        _send_frame(self.request, reply_hdr, reply_blob,
                                    key=outer._hmac_key, chan=chan)
                        if header.get("op") == "shutdown":
                            return
                except (ConnectionError, OSError, ValueError):
                    return  # incl. failed authentication: drop the peer
                finally:
                    with outer._glock:
                        outer._active -= 1

        class TS(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._srv = TS((bind, 0), Handler)
        self.bind = bind
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True,
                                        name="mxnet-async-server")
        self._thread.start()

    # ------------------------------------------------------------- dispatch
    def _key_lock(self, key):
        with self._glock:
            return self._locks.setdefault(key, threading.Lock())

    def _dispatch(self, header, blob):
        import time
        op = header.get("op")
        key = header.get("key")
        if op == "init":
            with self._key_lock(key):
                # first writer wins (reference server: init is idempotent)
                if key not in self._store:
                    self._store[key] = self._tensor(
                        _unpack_array(header, blob))
            return {"status": "ok"}, b""
        if op == "push":
            return self._handle_push(key, _unpack_array(header, blob), time)
        if op == "pushq":
            # 2-bit wire-compressed push: the worker shipped PACKED codes
            # (~16x smaller than f32); dequantize server-side
            from ..kvstore import _dequantize_2bit
            packed = _np.frombuffer(blob, _np.uint8)
            return self._handle_push(
                key, _dequantize_2bit(packed, tuple(header["shape"]),
                                      header["thr"]), time)
        if op == "pull":
            with self._key_lock(key):
                if key not in self._store:
                    return {"status": "err",
                            "error": "key %r not initialized" % key}, b""
                meta, raw = _pack_array(self._store[key].cpu().numpy())
                meta["status"] = "ok"
                return meta, raw
        if op == "set_optimizer":
            from .. import optimizer as _opt
            # opaque payload — reached only through an authenticated frame
            optimizer = pickle.loads(blob)
            self._updater = _opt.get_updater(optimizer)
            return {"status": "ok"}, b""
        if op == "command":
            # reference kSetOptimizer-style control messages
            # (include/mxnet/kvstore.h:49); recorded and ack'd
            self._commands.append((header["head"], header["body"]))
            return {"status": "ok"}, b""
        if op == "stats":
            return {"status": "ok",
                    "stats": {"pushes": list(self._push_log),
                              "commands": [list(c) for c in
                                           self._commands]}}, b""
        if op == "shutdown":
            # the requesting handler still has its "ok" reply to flush, so
            # the full drain runs on a side thread; close() waits for the
            # active-handler census (this connection included) to hit zero
            threading.Thread(target=self.close, daemon=True).start()
            return {"status": "ok"}, b""
        return {"status": "err", "error": "unknown op %r" % (op,)}, b""

    def close(self, drain_s=5.0):
        """Stop accepting work and shut the listener down after a BOUNDED
        drain: handlers finish (at most) their current request — replies
        flushed, no weight left half-applied — then exit at the next
        stop-event poll. Idempotent; safe from any thread."""
        with self._glock:
            if self._closed:
                return
            self._closed = True
        self._stop.set()
        deadline = _time.monotonic() + max(drain_s, 0.0)
        while _time.monotonic() < deadline:
            with self._glock:
                if self._active == 0:
                    break
            _time.sleep(0.05)
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join(timeout=max(drain_s, 1.0))

    def _tensor(self, arr):
        return torch.from_numpy(_np.ascontiguousarray(arr)).to(self.device)

    def _handle_push(self, key, grad, time):
        with self._key_lock(key):
            if key not in self._store:
                return {"status": "err",
                        "error": "key %r not initialized" % key}, b""
            if self._updater is None:
                self._store[key] = self._tensor(grad)
            else:
                self._apply(key, grad)
        self._push_log.append((time.monotonic(), key))
        return {"status": "ok"}, b""

    def _apply(self, key, grad):
        """Apply one push through the port's Updater, on the server's
        device, in place on the stored weight (the local kvstore's
        update)."""
        g = self._tensor(grad).to(self._store[key].dtype)
        self._updater(_key_int(key), g, self._store[key])
        if self.device.type == "cuda":
            # the reply says the update is applied: a pull on another
            # connection must read it
            torch.cuda.current_stream(self.device).synchronize()


def _key_int(key):
    """Updaters index per-key optimizer state by int when possible."""
    try:
        return int(key)
    except (TypeError, ValueError):
        return key


class Client:
    """One worker's connection pool to the async server.

    Connections are per-thread (thread-local), so calls from different
    threads — e.g. a trainer pushing while a prefetcher pulls — overlap
    on independent sockets instead of serializing behind one lock."""

    def __init__(self, host, port, timeout=60.0):
        self._addr = (host, port)
        self._timeout = timeout
        self._hmac_key = _secret()
        self._tls = threading.local()
        self._conns = []          # weakrefs: threads own their sockets
        self._conns_lock = threading.Lock()
        self._closed = threading.Event()
        self._connect()  # fail fast on a bad address

    def _connect(self):
        if self._closed.is_set():
            # a racing call() in another thread must not resurrect a
            # connection after close() — it would hang on a server that
            # is itself draining
            raise ConnectionError("async kvstore client is closed")
        sock = getattr(self._tls, "sock", None)
        if sock is None:
            sock = socket.create_connection(self._addr,
                                            timeout=self._timeout)
            # the server opens every connection with a hello frame carrying
            # the anti-replay challenge; all later frames MAC over it plus
            # the lock-step frame counter
            hello, _ = _recv_frame(sock, key=self._hmac_key)
            if hello.get("op") != "hello" or "challenge" not in hello:
                _close_quietly(sock)
                raise ConnectionError(
                    "async server handshake: expected hello frame, got %r"
                    % (hello.get("op"),))
            self._tls.chan = _Channel(bytes.fromhex(hello["challenge"]))
            self._tls.sock = sock
            with self._conns_lock:
                self._conns = [r for r in self._conns if r() is not None]
                self._conns.append(weakref.ref(sock))
            # close promptly when the owning thread dies (its Thread
            # object is collected), not at interpreter exit — otherwise
            # short-lived kvstore-touching threads leak fds + matching
            # server handler threads
            weakref.finalize(threading.current_thread(), _close_quietly,
                             sock)
        return sock, self._tls.chan

    # ops safe to retry after a connection failure: init is idempotent
    # server-side (first writer wins), pull/stats are pure reads. A push
    # is NOT — the server may have applied the update before the reply
    # was lost, and re-pushing would apply the gradient twice.
    _IDEMPOTENT = frozenset(("init", "pull", "stats"))

    def call(self, op, *args):
        header = {"op": op}
        blob = b""
        if op in ("init", "push"):
            key, value = args
            meta, blob = _pack_array(value)
            header.update(meta, key=key)
        elif op == "pushq":
            key, packed, shape, thr = args
            header.update(key=key, shape=list(shape), thr=float(thr))
            blob = _np.ascontiguousarray(packed, _np.uint8).tobytes()
        elif op == "pull":
            header["key"] = args[0]
        elif op == "set_optimizer":
            blob = args[0]
        elif op == "command":
            header.update(head=args[0], body=args[1])
        elif op in ("stats", "shutdown"):
            pass
        else:
            raise ValueError("unknown kvstore op %r" % op)

        retries = int(os.environ.get("MXNET_KVSTORE_RETRIES", "3")) \
            if op in self._IDEMPOTENT else 0
        backoff = float(os.environ.get("MXNET_KVSTORE_RETRY_BACKOFF",
                                       "0.05"))
        attempt = 0
        while True:
            sock, chan = self._connect()
            try:
                # injected client-side drop ("conn_drop@call=OP") lands
                # here so the cleanup + retry path below handles it like
                # a real mid-call connection loss
                faultinject.fire("call", op=op)
                _send_frame(sock, header, blob, key=self._hmac_key,
                            chan=chan)
                reply, rblob = _recv_frame(sock, key=self._hmac_key,
                                           chan=chan)
                break
            except OSError as e:
                # timeout / ConnectionError: the request-reply stream (and
                # the channel counter) is desynced — drop the thread-local
                # socket so the next attempt reconnects cleanly (fresh
                # hello challenge) instead of reusing it
                self._tls.sock = None
                self._tls.chan = None
                _close_quietly(sock)
                if attempt < retries and not self._closed.is_set():
                    attempt += 1
                    _time.sleep(min(2.0, backoff * (2 ** (attempt - 1))))
                    continue
                if op in ("push", "pushq"):
                    # fail fast, naming who died: a lost push may already
                    # be applied server-side, so retrying is unsound — the
                    # caller must treat this as fatal and resume from a
                    # checkpoint instead
                    from ..base import MXNetError
                    from . import fault
                    nw = int(os.environ.get("MXNET_NUM_WORKERS", "1"))
                    dead = fault.dead_nodes(nw, timeout=_dead_timeout())
                    raise MXNetError(
                        "async kvstore: connection lost during %r (%s); "
                        "push is not retried (may already be applied "
                        "server-side). dead node(s): %s"
                        % (op, e, dead if dead else "none detected yet"))
                raise
        if reply.get("status") != "ok":
            from ..base import MXNetError
            raise MXNetError("async server: %s" % reply.get("error"))
        if "dtype" in reply:
            return _unpack_array(reply, rblob)
        if "stats" in reply:
            # JSON carries tuples as lists; restore the documented shape
            st = reply["stats"]
            st["pushes"] = [tuple(p) for p in st.get("pushes", [])]
            st["commands"] = [tuple(c) for c in st.get("commands", [])]
            return st
        return None

    def close(self):
        self._closed.set()   # before the socket sweep: no reconnect race
        with self._conns_lock:
            refs, self._conns = self._conns, []
        for ref in refs:
            sock = ref()
            if sock is not None:
                _close_quietly(sock)


def _dead_timeout():
    try:
        return float(os.environ.get("MXNET_HEARTBEAT_TIMEOUT", "60"))
    except ValueError:
        return 60.0


def _close_quietly(sock):
    try:
        sock.close()
    except OSError:
        pass
