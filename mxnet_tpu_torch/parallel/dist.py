"""The process group, one-process part (counterpart of
``mxnet_tpu/parallel/dist.py``).

The environment names are the JAX package's (``tools/launch.py`` sets
them; the reference's ``DMLC_*`` names are honoured):

=========================  ==============================  ================
purpose                    native name                     reference name
=========================  ==============================  ================
coordinator address        MXNET_COORDINATOR_ADDRESS       DMLC_PS_ROOT_URI
                                                           (+_PORT)
world size                 MXNET_NUM_WORKERS               DMLC_NUM_WORKER
process rank               MXNET_WORKER_RANK               DMLC_WORKER_ID
=========================  ==============================  ================

A run with no launcher environment, or a world of one, is a one-process
group: :func:`init` returns False, :func:`rank` is 0 and
:func:`num_workers` 1, as in the JAX package. A world of more than one
worker, and the collectives, need the multi-process group (ROADMAP
A6c) and raise.
"""
from __future__ import annotations

import os

from ..base import MXNetError

__all__ = ["init", "initialized", "rank", "num_workers", "env_spec",
           "barrier"]

_A6C = ("multi-process training (dist_* across processes, the "
        "collectives, resharding and fault injection) is ROADMAP A6c, "
        "not ported yet")


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


def init(coordinator=None, num_workers_=None, rank_=None, strict=True):
    """Join the process group. A one-process run has nothing to join and
    returns False; a launcher environment naming more than one worker
    raises (ROADMAP A6c)."""
    role = os.environ.get("DMLC_ROLE")
    if role is not None and role != "worker":
        return False  # ps-lite scheduler/server processes never join
    _, env_n, _ = env_spec()
    n = num_workers_ if num_workers_ is not None else env_n
    if n is not None and n > 1:
        raise MXNetError("a launcher environment names %d workers: %s"
                         % (n, _A6C))
    return False


def initialized():
    """Whether a multi-process group was joined: never, in the port."""
    return False


def rank():
    return 0


def num_workers():
    return 1


def barrier(tag="mxnet_tpu_barrier"):
    """Every process at the same point: one process always is."""


def multi_process_error(what):
    """The error a multi-process feature raises."""
    return MXNetError("%s: %s" % (what, _A6C))
