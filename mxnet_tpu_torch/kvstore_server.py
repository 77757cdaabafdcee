"""Server-role entry point (counterpart of ``mxnet_tpu/kvstore_server.py``;
the reference's ``python/mxnet/kvstore_server.py``).

The reference's dist kvstore runs dedicated parameter-server processes.
The port has none: ``dist_sync`` is an all-reduce over the worker group
and ``dist_async``'s server is a thread on rank 0 (``kvstore.py``). A
launch script that still starts server or scheduler roles keeps working:
such a process calls :func:`_init_kvstore_server_module`, which logs why
and exits instead of serving forever, so that it never runs on into the
training script as a worker outside the group.
"""
import logging
import os
import sys

__all__ = ["KVStoreServer", "_init_kvstore_server_module"]


class KVStoreServer:
    """Stand-in for the ps-lite server loop: :meth:`run` logs and
    returns."""

    def __init__(self, kvstore=None):
        self.kvstore = kvstore

    def run(self):
        # warning level: an unconfigured root logger shows it, so the
        # operator sees why the server process ended
        logging.warning(
            "kvstore_server: this runtime has no parameter servers; "
            "gradients are all-reduced over the worker group; server "
            "process exiting cleanly")


def _init_kvstore_server_module():
    """On a process whose ``DMLC_ROLE`` is ``server`` or ``scheduler``:
    run the (empty) server loop and exit with 0."""
    if os.environ.get("DMLC_ROLE", "") in ("server", "scheduler"):
        KVStoreServer().run()
        sys.exit(0)
