"""The process group on ``torch.distributed`` (counterpart of
``mxnet_tpu/parallel/dist.py``).

The environment names are the JAX package's (the launcher,
``python -m mxnet_tpu_torch.tools.launch``, sets them; the reference's
``DMLC_*`` names are honoured):

=========================  ==============================  ================
purpose                    native name                     reference name
=========================  ==============================  ================
coordinator address        MXNET_COORDINATOR_ADDRESS       DMLC_PS_ROOT_URI
                                                           (+_PORT)
world size                 MXNET_NUM_WORKERS               DMLC_NUM_WORKER
process rank               MXNET_WORKER_RANK               DMLC_WORKER_ID
=========================  ==============================  ================

The group is ``gloo``, one process per device, joined at
``tcp://<coordinator>`` (rank 0 hosts the store). Gloo is the backend
that runs two ranks on one card (NCCL refuses them) and on the CPU; it
moves a card tensor through host memory, so each collective on one
synchronizes its stream and crosses the host link both ways. The data
stays where it lies: a collective takes a tensor on the card or the CPU
and returns one on the same device (a numpy array comes back as numpy).
The collectives here are the four that gloo takes on CUDA tensors as
they are: ``all_reduce``, ``broadcast``, the list form of
``all_gather``, and ``barrier``.

Unlike JAX, torch needs no join before the first device use, so nothing
joins at import: the first :func:`init`, :func:`rank` or
:func:`num_workers` under a launcher environment does. A run with no
launcher environment, or a world of one, joins nothing: :func:`init`
returns False, :func:`rank` is 0 and :func:`num_workers` 1. The group
has a finite timeout (``_TIMEOUT_S``, 300 s): a
rank whose peer hangs gets an error, not a wait without end; a peer that
died closes its connections, and the collective fails at once. On a
loopback coordinator gloo binds the loopback interface
(``GLOO_SOCKET_IFNAME=lo`` unless set): a host that cannot resolve its
own name cannot reach the others through it.

:func:`stats` keeps, per kind of collective, the calls, the bytes each
rank contributed and the host milliseconds they took (the stream's
synchronization and the host staging included).
"""
from __future__ import annotations

import datetime
import os
import time

import numpy as _np
import torch

__all__ = ["init", "initialized", "rank", "num_workers", "barrier",
           "barrier_stats", "allreduce_sum", "allreduce_tree", "allgather",
           "broadcast", "env_spec", "stats", "reset_stats", "shutdown"]

_INITIALIZED = False
_TIMEOUT_S = 300
_STATS = {}
_BARRIER_TAGS = {}


def env_spec():
    """(coordinator, num_workers, rank) from the environment, or
    (None, None, None) when no launcher context is present."""
    addr = os.environ.get("MXNET_COORDINATOR_ADDRESS")
    if addr is None and os.environ.get("DMLC_PS_ROOT_URI"):
        addr = "%s:%s" % (os.environ["DMLC_PS_ROOT_URI"],
                          os.environ.get("DMLC_PS_ROOT_PORT", "9091"))
    n = os.environ.get("MXNET_NUM_WORKERS",
                       os.environ.get("DMLC_NUM_WORKER"))
    r = os.environ.get("MXNET_WORKER_RANK",
                       os.environ.get("DMLC_WORKER_ID"))
    return (addr,
            int(n) if n is not None else None,
            int(r) if r is not None else None)


def _host_of(addr):
    """Host part of ``host:port``; a bracketed IPv6 host loses its
    brackets."""
    host = addr.rsplit(":", 1)[0]
    if host.startswith("[") and host.endswith("]"):
        host = host[1:-1]
    return host


def _externally_initialized():
    """The caller joined a default group themselves (the plain
    ``torch.distributed`` recipe): it is this package's group."""
    import torch.distributed as td
    return td.is_available() and td.is_initialized()


def init(coordinator=None, num_workers_=None, rank_=None, strict=True):
    """Join the process group (idempotent). Arguments default to the
    launcher environment; a default group the caller initialized counts
    as joined; a no-launcher run is a one-process group (False).

    A non-worker ``DMLC_ROLE`` (a ps-lite scheduler or server process)
    never joins. A world of more than one without a rank raises, since
    every worker joining as rank 0 would hang the group; with
    ``strict=False`` (the join that :func:`rank` and
    :func:`num_workers` make) it quietly stays out."""
    global _INITIALIZED
    if _INITIALIZED:
        return True
    from . import fault as _fault
    if _externally_initialized():
        import torch.distributed as td
        _INITIALIZED = True
        _fault.start(td.get_rank())
        return True
    role = os.environ.get("DMLC_ROLE")
    if role is not None and role != "worker":
        return False
    env_addr, env_n, env_r = env_spec()
    coordinator = coordinator or env_addr
    num_workers_ = num_workers_ if num_workers_ is not None else env_n
    rank_ = rank_ if rank_ is not None else env_r
    if coordinator is None or not num_workers_ or num_workers_ <= 1:
        return False
    if rank_ is None:
        if not strict:
            return False
        raise ValueError(
            "distributed launch is missing the worker rank: set "
            "MXNET_WORKER_RANK (or DMLC_WORKER_ID), or pass rank_=; "
            "every worker registering as rank 0 would hang the group")
    if _host_of(coordinator) in ("127.0.0.1", "localhost", "::1"):
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch.distributed as td
    td.init_process_group(
        "gloo", init_method="tcp://%s" % coordinator,
        world_size=int(num_workers_), rank=int(rank_),
        timeout=datetime.timedelta(seconds=_TIMEOUT_S))
    _INITIALIZED = True
    _fault.start(int(rank_))   # a no-op without a heartbeat directory
    return True


def initialized():
    """Whether this process is in a multi-process group (never joins)."""
    return _INITIALIZED or _externally_initialized()


def _joined():
    if not _INITIALIZED:
        init(strict=False)
    return _INITIALIZED


def rank():
    if not _joined():
        return 0
    import torch.distributed as td
    return td.get_rank()


def num_workers():
    if not _joined():
        return 1
    import torch.distributed as td
    return td.get_world_size()


def shutdown():
    """Leave the group (tests and workers that end cleanly) and stop the
    heartbeat."""
    global _INITIALIZED
    from . import fault as _fault
    _fault.stop()
    if _INITIALIZED:
        import torch.distributed as td
        if td.is_initialized():
            td.destroy_process_group()
    _INITIALIZED = False


# ------------------------------------------------------------------ stats
def _note(kind, nbytes, t0):
    s = _STATS.setdefault(kind, {"calls": 0, "bytes": 0, "ms": 0.0})
    s["calls"] += 1
    s["bytes"] += int(nbytes)
    s["ms"] += (time.perf_counter() - t0) * 1e3


def stats():
    """{kind: {"calls", "bytes", "ms"}} of this process's collectives:
    the bytes this rank put in, the host ms from the call to its end."""
    return {k: dict(v) for k, v in _STATS.items()}


def reset_stats():
    _STATS.clear()


def _as_tensor(value, owned=False):
    """(tensor, back): a tensor to run a collective on and the function
    returning the result in the caller's kind (numpy stays numpy). The
    caller's own storage is copied first unless ``owned``: a buffer the
    caller has just made for the collective is reduced in place."""
    if isinstance(value, torch.Tensor):
        if owned and value.is_contiguous():
            return value.detach(), (lambda t: t)
        return value.detach().clone().contiguous(), (lambda t: t)
    data = getattr(value, "_data", None)
    if isinstance(data, torch.Tensor):
        return data.detach().clone().contiguous(), (lambda t: t)
    arr = _np.ascontiguousarray(_np.asarray(value))
    return torch.from_numpy(arr.copy()), (lambda t: t.numpy())


# ------------------------------------------------------------ collectives
def barrier(tag="mxnet_tpu_barrier"):
    """Block until every process reaches the same point (reference
    kvstore_dist.h Barrier RPC); ``barrier_stats()`` counts the calls
    by tag."""
    _BARRIER_TAGS[tag] = _BARRIER_TAGS.get(tag, 0) + 1
    if not _joined():
        return
    import torch.distributed as td
    t0 = time.perf_counter()
    td.barrier()
    _note("barrier", 0, t0)


def barrier_stats():
    """{tag: call count} for this process."""
    return dict(_BARRIER_TAGS)


def allreduce_sum(value, owned=False):
    """Sum over all processes; every rank gets the result, on the device
    ``value`` lies on. With ``owned`` a contiguous tensor is summed in
    place (the caller made it for this call and keeps no other use)."""
    if not _joined():
        return value
    import torch.distributed as td
    t, back = _as_tensor(value, owned)
    t0 = time.perf_counter()
    td.all_reduce(t, op=td.ReduceOp.SUM)
    _note("allreduce", t.numel() * t.element_size(), t0)
    return back(t)


def allreduce_tree(tree, bucket_bytes=None):
    """Sum every tensor of a list (or a dict's values) over all
    processes: the tensors flattened into size-bounded, dtype-homogeneous
    buckets (``ddp.partition_buckets``, in production order) and ONE
    all-reduce a bucket, not one a tensor. Returns the same structure."""
    if not _joined():
        return tree
    from . import ddp as _ddp
    if isinstance(tree, dict):
        keys = list(tree)
        out = allreduce_tree([tree[k] for k in keys], bucket_bytes)
        return dict(zip(keys, out))
    leaves = [v if isinstance(v, torch.Tensor) else
              getattr(v, "_data", None) if isinstance(
                  getattr(v, "_data", None), torch.Tensor)
              else torch.from_numpy(_np.asarray(v)) for v in tree]
    if not leaves:
        return list(tree)
    entries = [(i, tuple(t.shape), t.dtype) for i, t in enumerate(leaves)]
    buckets = _ddp.partition_buckets(entries, bucket_bytes, reverse=False)
    out = [None] * len(leaves)
    for b in buckets:
        _ddp.reduce_bucket(b, leaves, out)
    return out


def allgather(value):
    """Every rank's value, stacked in rank order: ``(world, ...)``."""
    if not _joined():
        t, back = _as_tensor(value)
        return back(t[None])
    import torch.distributed as td
    t, back = _as_tensor(value)
    parts = [torch.empty_like(t) for _ in range(td.get_world_size())]
    t0 = time.perf_counter()
    td.all_gather(parts, t)
    _note("allgather", t.numel() * t.element_size(), t0)
    return back(torch.stack(parts))


def broadcast(value, root=0):
    """Every rank receives ``root``'s value (the reference's
    init-on-server)."""
    if not _joined():
        return value
    import torch.distributed as td
    t, back = _as_tensor(value)
    t0 = time.perf_counter()
    td.broadcast(t, src=int(root))
    _note("broadcast", t.numel() * t.element_size(), t0)
    return back(t)

