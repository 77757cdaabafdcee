"""Deterministic fault injection for elastic-training tests (counterpart
of ``mxnet_tpu/parallel/faultinject.py``).

The reference framework's fault surface (ps-lite node death, dropped
connections, torn checkpoint writes) is only exercised in production;
this module makes every failure mode *reproducible* so the recovery
machinery (checkpoint/resume, launcher supervised restart, kvstore
client retry) can be tested on CPU with no chips and no flaky sleeps.

Faults are declared in the environment and fired at named injection
points inside the library::

    MXNET_FAULT_INJECT="kill@step=7:rank=0"

Grammar (comma-separated specs)::

    <action>@<point>=<match>[:key=val]...

Actions and their points:

``kill@step=N``
    SIGKILL the process when training step ``N`` begins (N steps have
    completed and been checkpointed).  Fired from ``Module.fit`` and
    ``gluon.Trainer.step``.  Options: ``rank=R`` (only that worker
    rank), ``sig=term`` (SIGTERM instead), ``rc=K`` (plain
    ``os._exit(K)``).
``delay@step=N:secs=S``
    Sleep ``S`` seconds (default 1.0) at step ``N`` — simulates a
    straggler so heartbeat/timeout knobs can be tuned in tests.
``conn_drop@call=OP[:count=K]``
    Drop the async-kvstore *client* connection before sending ``OP``
    (``pull``/``push``/...), ``K`` times (default 1).  Exercises the
    retry-with-backoff path in ``async_server.Client.call``.
``conn_drop@serve=OP[:count=K]``
    Same on the *server* side: the handler drops the connection when
    dispatching ``OP``.
``kill@ckpt=N`` / ``delay@ckpt=N``
    Fire between a checkpoint's data rename and its manifest rename —
    proves ``restore_latest`` ignores a data file with no manifest.
``truncate@ckpt=N[:bytes=B]``
    Corrupt the just-committed snapshot for step ``N`` by truncating
    ``B`` bytes (default 64) off its data file — proves the CRC check
    skips it.
``enospc@journal=OP``
    The storage fault model's "disk full": raise ``OSError(ENOSPC)``
    at a journal write site (``append``/``fsync``/``compact``).
    Unlimited by default — a full disk stays full until the spec is
    cleared, which is how the router's degraded-mode recovery
    (exit-without-restart) is tested.
``torn_write@journal=append[:bytes=B]``
    Power-loss semantics: the journal persists only the first ``B``
    bytes (default 6) of the record frame, then the append fails with
    ``OSError(EIO)``. Proves replay/replication tolerate a torn tail
    and that the writer repairs (truncates) it before appending again.
``slow_fsync@journal=fsync[:secs=S]``
    Sleep ``S`` seconds (default 0.05) inside the journal's fsync —
    a dying-disk straggler for group-commit latency tests.

Every spec accepts ``rank=R`` (matched against ``MXNET_WORKER_RANK``,
default 0), ``count=K`` (max number of firings; ``kill`` and
``conn_drop`` default to 1, everything else unlimited), and ``skip=N``
(ignore the first N matching occurrences before firing — e.g.
``kill@serve=decode_step:skip=6`` SIGKILLs a serving replica exactly 7
sampled tokens into a decode session, the deterministic mid-generation
death the fleet cursor-migration tests rely on).

The launcher (``python -m mxnet_tpu_torch.tools.launch``) clears
``MXNET_FAULT_INJECT`` for restarted worker incarnations, so an injected
kill is a *first-run* event and the supervised restart runs clean.

Where the port fires each point: ``step`` in ``Module.fit`` (both the
per-step and the grouped loop) and ``gluon.Trainer.step``; ``ckpt`` in
``CheckpointManager``'s write (between the data and the manifest, and
after the manifest); ``call`` and ``serve`` in the ``dist_async`` client
and server (``parallel/async_server.py``). The ``journal`` specs and the
serving replicas' ``@serve=predict_batch``/``@serve=decode_step`` parse
here but fire nowhere yet: the journal and the serving fleet are not
ported.
"""
from __future__ import annotations

import errno
import logging
import os
import signal
import sys
import threading
import time

__all__ = ["fire", "specs", "reset", "InjectedFault", "InjectedConnDrop",
           "InjectedENOSPC", "InjectedTornWrite"]

_log = logging.getLogger("mxnet_tpu_torch.faultinject")

_ACTIONS = ("kill", "delay", "conn_drop", "truncate", "raise",
            "enospc", "torn_write", "slow_fsync")

# point name -> the ctx key its @-match compares against
_POINT_MATCH_KEY = {"step": "step", "call": "op", "serve": "op",
                    "ckpt": "step", "journal": "op"}


class InjectedFault(RuntimeError):
    """Generic injected failure (action ``raise``)."""


class InjectedConnDrop(ConnectionError):
    """Injected connection drop — handled exactly like a real peer
    failure by both ends of the async kvstore protocol."""


class InjectedENOSPC(OSError):
    """Injected disk-full: an ``OSError`` with ``errno.ENOSPC``, so
    call sites that catch real storage failures catch this one the
    same way."""

    def __init__(self, point, raw):
        super().__init__(errno.ENOSPC,
                         "injected ENOSPC at %s (%r)" % (point, raw))


class InjectedTornWrite(OSError):
    """Injected torn write: the firing site must persist only the
    first ``keep_bytes`` of the payload it was about to write, then
    surface this as a failed write (``errno.EIO``)."""

    def __init__(self, keep_bytes, point, raw):
        super().__init__(errno.EIO,
                         "injected torn write at %s (%r)" % (point, raw))
        self.keep_bytes = int(keep_bytes)


class _Spec:
    __slots__ = ("action", "point", "match", "kwargs", "budget", "skip",
                 "raw")

    def __init__(self, action, point, match, kwargs, raw):
        self.action = action
        self.point = point
        self.match = match
        self.kwargs = kwargs
        self.raw = raw
        self.skip = int(kwargs.get("skip", 0))
        if "count" in kwargs:
            self.budget = int(kwargs["count"])
        elif action in ("kill", "conn_drop", "torn_write"):
            self.budget = 1
        else:
            # enospc deliberately unlimited: a full disk stays full
            # until the operator clears it (spec removed from the env)
            self.budget = -1  # unlimited

    def matches(self, ctx):
        key = _POINT_MATCH_KEY.get(self.point, self.point)
        if self.match != "" and str(ctx.get(key)) != self.match:
            return False
        want_rank = self.kwargs.get("rank")
        if want_rank is not None:
            have = os.environ.get("MXNET_WORKER_RANK",
                                  os.environ.get("DMLC_WORKER_ID", "0"))
            if str(want_rank) != str(have):
                return False
        return True


_lock = threading.Lock()
_cache_env = None
_cache_specs = ()


def _parse(text):
    out = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        action, sep, rest = part.partition("@")
        action = action.strip()
        if not sep or action not in _ACTIONS:
            _log.warning("MXNET_FAULT_INJECT: ignoring malformed spec %r "
                         "(want <action>@<point>=<match>[:k=v...], "
                         "actions: %s)", part, "/".join(_ACTIONS))
            continue
        toks = rest.split(":")
        point, _, match = toks[0].partition("=")
        kwargs = {}
        ok = True
        for t in toks[1:]:
            k, eq, v = t.partition("=")
            if not eq:
                _log.warning("MXNET_FAULT_INJECT: ignoring malformed "
                             "option %r in spec %r", t, part)
                ok = False
                break
            kwargs[k.strip()] = v.strip()
        if ok:
            out.append(_Spec(action, point.strip(), match.strip(),
                             kwargs, part))
    return tuple(out)


def specs():
    """Parsed specs for the current MXNET_FAULT_INJECT value (cached per
    value, so monkeypatching the env between tests just works)."""
    global _cache_env, _cache_specs
    env = os.environ.get("MXNET_FAULT_INJECT", "")
    with _lock:
        if env != _cache_env:
            _cache_env = env
            _cache_specs = _parse(env) if env else ()
        return _cache_specs


def reset():
    """Drop the parse cache and firing budgets (test isolation)."""
    global _cache_env, _cache_specs
    with _lock:
        _cache_env = None
        _cache_specs = ()


def _consume(spec):
    with _lock:
        if spec.skip > 0:
            spec.skip -= 1
            return False
        if spec.budget == 0:
            return False
        if spec.budget > 0:
            spec.budget -= 1
        return True


def fire(point, **ctx):
    """Evaluate the injection specs at a named point.

    Call sites pass the point name plus whatever context the grammar can
    match on (``step=``, ``op=``, ``path=``...).  No-op (a dict lookup
    and an env compare) unless MXNET_FAULT_INJECT is set.
    """
    sps = specs()
    if not sps:
        return
    for sp in sps:
        if sp.point != point or not sp.matches(ctx) or not _consume(sp):
            continue
        _apply(sp, point, ctx)


def _apply(sp, point, ctx):
    _log.warning("fault injection: firing %r at point %r (ctx %r)",
                 sp.raw, point, ctx)
    if sp.action == "kill":
        # make the death observable in streamed launcher logs before the
        # process vanishes mid-write
        sys.stdout.flush()
        sys.stderr.flush()
        if "rc" in sp.kwargs:
            os._exit(int(sp.kwargs["rc"]))
        sig = signal.SIGTERM if sp.kwargs.get("sig") == "term" \
            else signal.SIGKILL
        os.kill(os.getpid(), sig)
        time.sleep(60)  # SIGKILL delivery is not synchronous
    elif sp.action == "delay":
        time.sleep(float(sp.kwargs.get("secs", 1.0)))
    elif sp.action == "conn_drop":
        raise InjectedConnDrop(
            "injected connection drop at %s (%r)" % (point, sp.raw))
    elif sp.action == "truncate":
        path = ctx.get("path")
        if path and os.path.exists(path):
            nbytes = int(sp.kwargs.get("bytes", 64))
            size = os.path.getsize(path)
            with open(path, "r+b") as f:
                f.truncate(max(0, size - nbytes))
    elif sp.action == "raise":
        raise InjectedFault("injected fault at %s (%r)" % (point, sp.raw))
    elif sp.action == "enospc":
        raise InjectedENOSPC(point, sp.raw)
    elif sp.action == "torn_write":
        raise InjectedTornWrite(int(sp.kwargs.get("bytes", 6)),
                                point, sp.raw)
    elif sp.action == "slow_fsync":
        time.sleep(float(sp.kwargs.get("secs", 0.05)))
