"""Atomic training-state checkpoints (counterpart of
``mxnet_tpu/checkpoint.py``).

``CheckpointManager`` persists the full training state (parameters, aux
states, the optimizer's state and update counts, the random key chain,
the loop position and the data cursor) so that a restart resumes
bitwise where the last snapshot left off.

Durability, per snapshot ``ckpt-<step>``, as in the JAX package:

1. ``ckpt-<step>.npz`` goes to a temp file in the same directory, is
   fsync'd, then ``os.replace``'d into place, and the directory is
   fsync'd so that the rename itself is durable;
2. only then is ``ckpt-<step>.json`` committed the same way: the
   manifest, with the data file's size and CRC32.

No manifest means no snapshot; a manifest whose size or CRC does not
match the data is a torn snapshot, which ``restore`` skips with a
warning for the one before it. Saves may run on a background thread
(``async_save``), which only ever sees host arrays: the helpers below
copy the device tensors to the host first. Retention keeps the newest
``keep_n`` snapshots, at least 2.

The npz keys are the JAX package's (``arg:``, ``aux:``,
``param:<i>:<name>``, ``__opt__``, ``__rng__``, ``__data_cursor__`` and
``__bytes_keys__``), so a snapshot written by either package restores
in the other. Every snapshot's manifest carries its layout record
(``meta["layout"]``, a ``parallel/layout.py`` manifest: the inferred
all-replicated layout unless the caller passes one), so a run saved at
world N restores at another world size: ``restore_resharded`` gathers
every old rank's snapshot at the newest step that all of them committed
and re-slices it for this rank, and ``reshard_checkpoint`` (``python -m
mxnet_tpu_torch.tools.reshard``) writes a new root for another world.
Fault points (``parallel/faultinject.py``): ``ckpt`` between the data
file and the manifest (``phase="pre_manifest"``) and after the manifest
(``phase="committed"``).

Environment: ``MXNET_CHECKPOINT_DIR`` turns checkpoints on in
``Module.fit`` and the Gluon ``Trainer``, ``MXNET_CHECKPOINT_EVERY``
(default 1) and ``MXNET_CHECKPOINT_KEEP`` (default 5) set the period and
the retention, and ``MXNET_RESUME_DIR`` makes the next run resume
(``should_resume``).
"""
from __future__ import annotations

import contextlib
import io
import json
import logging
import os
import pickle
import threading
import zlib

import numpy as _np

__all__ = ["CheckpointManager", "atomic_replace", "atomic_write_bytes",
           "module_state", "restore_module", "trainer_state",
           "restore_trainer", "reshard_checkpoint", "encode_cursor",
           "cursor_from_state"]

_log = logging.getLogger("mxnet_tpu_torch.checkpoint")

_MANIFEST_VERSION = 1


# ---------------------------------------------------------------------------
# atomic file primitives
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def atomic_replace(path):
    """Yield a temp-file path; on a clean exit the temp file is fsync'd
    and renamed onto ``path`` (and the directory fsync'd). On an error it
    is removed and ``path`` is untouched: a kill at any point leaves the
    old complete file or the new complete file, never a torn one."""
    path = os.fspath(path)
    d = os.path.dirname(os.path.abspath(path))
    tmp = os.path.join(d, ".%s.tmp.%d" % (os.path.basename(path),
                                          os.getpid()))
    try:
        yield tmp
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, path)
        _fsync_dir(d)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def atomic_write_bytes(path, blob):
    """Write ``blob`` to ``path`` atomically (temp, fsync, rename)."""
    with atomic_replace(path) as tmp:
        with open(tmp, "wb") as f:
            f.write(blob)


def _fsync_dir(d):
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return  # no directory fds here; the rename is atomic all the same
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


# ---------------------------------------------------------------------------
# state <-> bytes
# ---------------------------------------------------------------------------

def _encode_state(state):
    """A {name: array-or-bytes} dict as npz bytes: ``bytes`` values
    (pickled optimizer state, the key chain) are stored as uint8 arrays
    and their keys listed under ``__bytes_keys__``."""
    arrays = {}
    bytes_keys = []
    for k, v in state.items():
        if isinstance(v, (bytes, bytearray)):
            arrays[k] = _np.frombuffer(bytes(v), dtype=_np.uint8)
            bytes_keys.append(k)
        else:
            arrays[k] = _np.asarray(v)
    buf = io.BytesIO()
    _np.savez(buf, __bytes_keys__=_np.array(bytes_keys, dtype=object),
              **arrays)
    return buf.getvalue()


def _decode_state(blob):
    with _np.load(io.BytesIO(blob), allow_pickle=True) as z:
        bytes_keys = set(z["__bytes_keys__"].tolist())
        out = {}
        for k in z.files:
            if k == "__bytes_keys__":
                continue
            out[k] = z[k].tobytes() if k in bytes_keys else z[k]
    return out


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------

class CheckpointManager:
    """Atomic, CRC-checked, retention-managed training checkpoints in one
    directory (``<root>/rank_<r>`` when ``per_rank``, as in the JAX
    package, so that both packages read each other's roots)."""

    def __init__(self, directory, keep_n=None, save_every=None,
                 async_save=True, per_rank=True, rank=None, world=None):
        if keep_n is None:
            keep_n = int(os.environ.get("MXNET_CHECKPOINT_KEEP", "5"))
        if save_every is None:
            save_every = int(os.environ.get("MXNET_CHECKPOINT_EVERY", "1"))
        self.root = os.fspath(directory)
        self.keep_n = max(2, int(keep_n))
        self.save_every = max(1, int(save_every))
        self.async_save = bool(async_save)
        if rank is None:
            rank = int(os.environ.get("MXNET_WORKER_RANK", "0"))
        if world is None:
            world = int(os.environ.get("MXNET_NUM_WORKERS", "1"))
        self._rank = int(rank)
        self._world = int(world)
        self.directory = (os.path.join(self.root, "rank_%d" % self._rank)
                          if per_rank else self.root)
        os.makedirs(self.directory, exist_ok=True)
        self._thread = None
        self._save_err = None
        self._lock = threading.Lock()

    # -- env-driven construction -------------------------------------------

    @staticmethod
    def from_env():
        """A manager on MXNET_RESUME_DIR or MXNET_CHECKPOINT_DIR, or None
        when neither is set (checkpoints off)."""
        d = os.environ.get("MXNET_RESUME_DIR") or \
            os.environ.get("MXNET_CHECKPOINT_DIR")
        return CheckpointManager(d) if d else None

    @staticmethod
    def should_resume():
        return bool(os.environ.get("MXNET_RESUME_DIR"))

    # -- paths --------------------------------------------------------------

    def _data_path(self, step):
        return os.path.join(self.directory, "ckpt-%d.npz" % step)

    def _manifest_path(self, step):
        return os.path.join(self.directory, "ckpt-%d.json" % step)

    # -- save ---------------------------------------------------------------

    def save(self, state, step, epoch=0, nbatch=0, meta=None, blocking=None):
        """Snapshot ``state`` ({name: host array or bytes}) as ``step``;
        with ``async_save`` the encode and the writes run on a background
        thread."""
        if blocking is None:
            blocking = not self.async_save
        self.wait()  # one save in flight at a time; raises a failed one
        if blocking:
            self._write(state, step, epoch, nbatch, meta)
        else:
            t = threading.Thread(
                target=self._write_guard,
                args=(state, step, epoch, nbatch, meta),
                name="mxnet-ckpt-save", daemon=True)
            self._thread = t
            t.start()

    def maybe_save(self, state_fn, step, epoch=0, nbatch=0, meta=None):
        """Save iff ``step`` is on the ``save_every`` grid; ``state_fn``
        (and the copy to the host) runs only then."""
        if step % self.save_every != 0:
            return False
        self.save(state_fn(), step, epoch=epoch, nbatch=nbatch, meta=meta)
        return True

    def wait(self):
        """Join the save in flight; raise its error, if any."""
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        with self._lock:
            err, self._save_err = self._save_err, None
        if err is not None:
            raise err

    def _write_guard(self, *args):
        try:
            self._write(*args)
        except BaseException as e:  # raised by the next wait()/save()
            with self._lock:
                self._save_err = e
            _log.error("async checkpoint save failed: %s", e)

    def _write(self, state, step, epoch, nbatch, meta):
        from .parallel import faultinject as _fi
        meta = dict(meta or {})
        if "layout" not in meta:
            # every snapshot carries its layout: by default the inferred
            # all-replicated (DDP) one; a sharded caller passes its own
            try:
                from .parallel import layout as _layout
                meta["layout"] = _layout.infer_manifest(
                    state, self._world).to_dict()
            except Exception as e:
                _log.warning("checkpoint: could not derive a layout "
                             "manifest (%s); snapshot will only restore "
                             "at world %d", e, self._world)
        blob = _encode_state(state)
        data_path = self._data_path(step)
        atomic_write_bytes(data_path, blob)
        # a kill here leaves data without a manifest: no snapshot
        _fi.fire("ckpt", step=step, path=data_path, phase="pre_manifest")
        manifest = {
            "version": _MANIFEST_VERSION,
            "step": int(step),
            "epoch": int(epoch),
            "nbatch": int(nbatch),
            "data": os.path.basename(data_path),
            "size": len(blob),
            "crc32": zlib.crc32(blob) & 0xFFFFFFFF,
            "rank": self._rank,
            "world": self._world,
            "meta": meta,
        }
        atomic_write_bytes(self._manifest_path(step),
                           json.dumps(manifest, indent=1).encode())
        # a truncation here corrupts a committed snapshot: the CRC check
        # at restore skips it
        _fi.fire("ckpt", step=step, path=data_path, phase="committed")
        self._retain()

    def _retain(self):
        steps = sorted(_steps_in(self.directory))
        for s in steps[:-self.keep_n]:
            for p in (self._manifest_path(s), self._data_path(s)):
                with contextlib.suppress(OSError):
                    os.unlink(p)

    # -- restore ------------------------------------------------------------

    def steps(self):
        """Steps with a committed manifest, newest first."""
        return sorted(_steps_in(self.directory), reverse=True)

    def restore(self, step=None):
        """The newest valid snapshot at or before ``step`` (the newest of
        all when None), skipping torn ones -> ``(state, manifest)``, or
        ``(None, None)`` when there is none."""
        for s in self.steps():
            if step is not None and s > step:
                continue
            got = _load_snapshot(self.directory, s)
            if got is not None:
                return got
        return None, None

    def restore_latest(self):
        return self.restore()

    def restore_resharded(self, step=None):
        """This rank's state from a root written at ANY world size. At
        this manager's world it is :meth:`restore`; otherwise every old
        rank's snapshot at the newest step all of them committed is
        gathered per the layout record in its meta and re-sliced for
        this rank of this world (a missing or corrupt record falls back
        to the inferred all-replicated layout). -> ``(state, manifest)``
        with ``meta["resharded_from"]``, or ``(None, None)``."""
        state, manifest = self.restore(step)
        if manifest is not None and \
                int(manifest.get("world", self._world)) == self._world:
            return state, manifest
        states, manifests, s = _load_rank_states(self.root, step)
        if not states:
            return state, manifest
        from .parallel import layout as _layout
        r0 = min(manifests)
        man0 = manifests[r0]
        old_world = int(man0.get("world", len(states)))
        layout = _layout_of(man0, states[r0], old_world)
        new_states, new_layout = _layout.reshard_states(
            states, layout, self._world)
        out_meta = dict(man0.get("meta") or {})
        out_meta["layout"] = new_layout.to_dict()
        out_meta["resharded_from"] = {"world": old_world, "step": s}
        out = dict(man0, rank=self._rank, world=self._world,
                   meta=out_meta)
        return new_states.get(self._rank), out


def _load_snapshot(directory, step):
    """One committed snapshot from ``directory``; None when the manifest
    is unreadable or the data fails its size or CRC check."""
    mpath = os.path.join(directory, "ckpt-%d.json" % step)
    try:
        with open(mpath, "rb") as f:
            manifest = json.loads(f.read().decode())
    except (OSError, ValueError) as e:
        _log.warning("checkpoint %s: unreadable manifest (%s); "
                     "skipping", mpath, e)
        return None
    dpath = os.path.join(directory, manifest.get("data", ""))
    try:
        with open(dpath, "rb") as f:
            blob = f.read()
    except OSError as e:
        _log.warning("checkpoint step %d: missing data file (%s); "
                     "skipping", step, e)
        return None
    crc = zlib.crc32(blob) & 0xFFFFFFFF
    if len(blob) != manifest.get("size") or crc != manifest.get("crc32"):
        _log.warning(
            "checkpoint step %d: CRC/size mismatch (have %d bytes, crc "
            "%08x; manifest says %s/%s), corrupt or truncated; skipping",
            step, len(blob), crc, manifest.get("size"),
            manifest.get("crc32"))
        return None
    try:
        state = _decode_state(blob)
    except Exception as e:
        _log.warning("checkpoint step %d: undecodable payload (%s); "
                     "skipping", step, e)
        return None
    return state, manifest


def _steps_in(directory):
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    out = []
    for n in names:
        if n.startswith("ckpt-") and n.endswith(".json"):
            try:
                out.append(int(n[5:-5]))
            except ValueError:
                continue
    return out


def _rank_dirs(root):
    """{rank: path} of a checkpoint root's ``rank_<r>`` directories."""
    out = {}
    try:
        names = os.listdir(root)
    except OSError:
        return out
    for name in names:
        if name.startswith("rank_"):
            try:
                out[int(name[5:])] = os.path.join(root, name)
            except ValueError:
                continue
    return out


def _load_rank_states(root, step=None):
    """Every rank's (state, manifest) at the newest step committed by
    ALL ranks (at most ``step``) -> ``(states_by_rank,
    manifests_by_rank, step)``, empty dicts when there is no such step.
    A rank directory with no snapshot (a manager of a larger world that
    was only constructed) holds no shard and does not veto the step."""
    dirs = {r: d for r, d in _rank_dirs(root).items() if _steps_in(d)}
    if not dirs:
        return {}, {}, None
    common = None
    for d in dirs.values():
        steps = set(_steps_in(d))
        common = steps if common is None else (common & steps)
    for s in sorted((s for s in (common or ())
                     if step is None or s <= step), reverse=True):
        states, manifests = {}, {}
        for r, d in sorted(dirs.items()):
            got = _load_snapshot(d, s)
            if got is None:
                break
            states[r], manifests[r] = got
        else:
            return states, manifests, s
    return {}, {}, None


def _layout_of(manifest, state, world):
    """The ``LayoutManifest`` a snapshot was written under, from its
    meta; the inferred all-replicated layout when the record is missing,
    corrupt, or claims another world than the rank directories hold."""
    from .parallel import layout as _layout
    rec = (manifest.get("meta") or {}).get("layout")
    if rec is not None:
        try:
            man = _layout.LayoutManifest.from_dict(rec)
            if man.world == int(world):
                return man
            _log.warning("checkpoint: layout manifest claims world %d "
                         "but %d rank snapshots exist; re-inferring",
                         man.world, world)
        except (ValueError, TypeError, KeyError) as e:
            _log.warning("checkpoint: corrupt layout manifest (%s); "
                         "falling back to the replicated layout", e)
    return _layout.infer_manifest(state, world)


def reshard_checkpoint(src_root, new_world, dst_root=None, step=None):
    """Rewrite a multi-rank checkpoint root for another world size:
    every parameter gathered per the snapshots' layout, re-sliced for
    ``new_world`` ranks and committed as ``rank_0 .. rank_{W-1}`` under
    ``dst_root`` (default ``<src_root>-w<N>``, never in place: a shrink
    would leave surplus old rank directories beside the new ones). The
    optimizer state and the key chain travel replicated; the data cursor
    is dropped (a cursor is fingerprinted by rank and world). Returns a
    report dict (``python -m mxnet_tpu_torch.tools.reshard`` prints
    it)."""
    new_world = int(new_world)
    if new_world < 1:
        raise ValueError("reshard_checkpoint: new_world must be >= 1")
    from .parallel import layout as _layout
    states, manifests, s = _load_rank_states(src_root, step)
    if not states:
        raise ValueError("reshard_checkpoint: no common committed step "
                         "across rank dirs in %r" % src_root)
    r0 = min(manifests)
    man0 = manifests[r0]
    old_world = int(man0.get("world", len(states)))
    layout = _layout_of(man0, states[r0], old_world)
    new_states, new_layout = _layout.reshard_states(states, layout,
                                                    new_world)
    dst_root = (os.fspath(dst_root) if dst_root
                else "%s-w%d" % (os.fspath(src_root).rstrip("/"),
                                 new_world))
    meta = dict(man0.get("meta") or {})
    meta["layout"] = new_layout.to_dict()
    meta["resharded_from"] = {"world": old_world, "step": s}
    for r, st in sorted(new_states.items()):
        cm = CheckpointManager(dst_root, rank=r, world=new_world,
                               async_save=False)
        cm.save(st, s, epoch=int(man0.get("epoch", 0)),
                nbatch=int(man0.get("nbatch", 0)), meta=meta,
                blocking=True)
    return {
        "kind": "checkpoint",
        "src": os.fspath(src_root),
        "dst": dst_root,
        "step": s,
        "old_world": old_world,
        "new_world": new_world,
        "params": len([k for k in new_states[0]
                       if not k.startswith("__")]),
        "layout_fingerprint": new_layout.fingerprint(),
    }


# ---------------------------------------------------------------------------
# state capture and restore for the Module and Gluon layers
# ---------------------------------------------------------------------------

def _rng_blob():
    from . import random as _random
    key, np_state = _random.get_state()
    if key is not None:
        key = _np.asarray(key, dtype=_np.uint32)
    return pickle.dumps((key, np_state), protocol=2)


def _set_rng_blob(blob):
    from . import random as _random
    _random.set_state(pickle.loads(bytes(blob)))


def module_state(module):
    """A Module's full training state as a flat dict of host arrays and
    bytes."""
    from .ndarray import asnumpy_all
    arg_params, aux_params = module.get_params()
    keys = ["arg:" + k for k in arg_params] + ["aux:" + k for k in aux_params]
    state = dict(zip(keys, asnumpy_all(*arg_params.values(),
                                       *aux_params.values())))
    opt = getattr(module, "_optimizer_state_bytes", None)
    if callable(opt):
        blob = opt()
        if blob is not None:
            state["__opt__"] = blob
    state["__rng__"] = _rng_blob()
    return state


def restore_module(module, state):
    """Restore a Module (the parameters into its executor and its
    kvstore, the optimizer state, the key chain) from a
    :func:`module_state` snapshot."""
    arg_params = {k[4:]: v for k, v in state.items()
                  if k.startswith("arg:")}
    aux_params = {k[4:]: v for k, v in state.items()
                  if k.startswith("aux:")}
    module.set_params(arg_params, aux_params, allow_missing=False,
                      force_init=True)
    sync = getattr(module, "_sync_params_to_kvstore", None)
    if callable(sync):
        sync()
    if "__opt__" in state:
        setter = getattr(module, "_set_optimizer_state_bytes", None)
        if callable(setter):
            setter(state["__opt__"])
    if "__rng__" in state:
        _set_rng_blob(state["__rng__"])


DATA_CURSOR_KEY = "__data_cursor__"


def encode_cursor(cursor):
    """A data-iterator cursor dict as canonical-JSON bytes (the npz's
    bytes path); None stays None."""
    if cursor is None:
        return None
    return json.dumps(cursor, sort_keys=True).encode("utf-8")


def cursor_from_state(state):
    """The data cursor a snapshot carried, or None."""
    blob = state.get(DATA_CURSOR_KEY)
    if blob is None:
        return None
    try:
        return json.loads(bytes(blob).decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return None


def trainer_state(trainer):
    """A Gluon ``Trainer``'s full training state. Parameters are keyed by
    position and name: names match across a restart, but Gluon's naming
    renumbers prefixes when a net is built again in one process, so a
    restore falls back to the position when the name is gone."""
    from .ndarray import asnumpy_all
    state = {"param:%d:%s" % (i, p.name): v for i, (p, v) in enumerate(zip(
        trainer._params, asnumpy_all(*[p.data() for p in trainer._params])))}
    state["__opt__"] = trainer._updater_state_bytes()
    state["__rng__"] = _rng_blob()
    return state


def restore_trainer(trainer, state):
    by_name = {p.name: p for p in trainer._params}
    for k, v in state.items():
        if not k.startswith("param:"):
            continue
        _, idx, name = k.split(":", 2)
        p = by_name.get(name)
        if p is None:
            i = int(idx)
            if i < len(trainer._params) and \
                    tuple(trainer._params[i].shape) == tuple(v.shape):
                p = trainer._params[i]
                _log.warning(
                    "restore_trainer: no parameter named %r; matched "
                    "snapshot slot %d to %r by position", name, i, p.name)
        if p is None:
            _log.warning("restore_trainer: snapshot parameter %r (slot "
                         "%s) has no match in this trainer; skipping",
                         name, idx)
            continue
        p.set_data(v)
    if "__opt__" in state:
        trainer._set_updater_state_bytes(state["__opt__"])
    if "__rng__" in state:
        _set_rng_blob(state["__rng__"])
