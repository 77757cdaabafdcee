"""Local N-process launcher for ``dist_sync``/``dist_async`` training
(counterpart of the repo's ``tools/launch.py``).

Run it as ``python -m mxnet_tpu_torch.tools.launch``. The port needs no
scheduler or server processes, only N workers pointed at rank 0's
``torch.distributed`` store, so this launcher:

* picks a free coordinator port on the loopback interface for every
  attempt (a port the last attempt used may sit in TIME_WAIT);
* starts N copies of the command with MXNET_COORDINATOR_ADDRESS /
  MXNET_NUM_WORKERS / MXNET_WORKER_RANK set (and the reference's DMLC_*
  names, so scripts reading DMLC_NUM_WORKER keep working), and with
  ``GLOO_SOCKET_IFNAME=lo``: on one host the gloo group binds the
  loopback interface, since a host that cannot resolve its own name
  cannot reach its peers through it;
* streams each worker's output with a ``[worker N]`` prefix;
* when a worker fails, terminates the rest of the group (a peer would
  otherwise wait inside a collective) and returns the first failing
  rank's exit code; then SUPERVISES: up to ``--max-restarts`` times
  (default 3) the whole group is started again after a capped, jittered
  exponential backoff, on a fresh port, with ``MXNET_RESUME_DIR``
  pointed at the job's checkpoint directory and ``MXNET_FAULT_INJECT``
  cleared, so the workers resume from the last committed snapshot. A
  JSON summary goes to stderr whenever an attempt failed.

``--heartbeat-dir`` is where the workers' heartbeat files go
(``parallel/fault.py``; a fresh temporary directory per attempt by
default). ``--ddp`` exports ``MXNET_DDP=1`` (``--ddp-bucket-mb``:
``MXNET_DDP_BUCKET_MB``). ``-H host0,host1,...`` starts one worker per
host over ssh with the same environment, the coordinator on host 0 and
the job secret on stdin; ``--dry-run`` prints the commands instead of
running them.

Usage::

    # one host, N processes (on the CPU, or N ranks sharing cuda:0)
    python -m mxnet_tpu_torch.tools.launch -n 2 [--env K=V ...] \
        python train.py --kv-store dist_sync

    # several hosts, one process each
    python -m mxnet_tpu_torch.tools.launch -H host0,host1 --dry-run \
        python train.py --kv-store dist_sync
"""
import argparse
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading


def backoff_delay(attempt, base=1.0, cap=30.0, jitter=0.5, rng=None):
    """Capped jittered exponential backoff delay for restart ``attempt``
    (0-based): ``min(cap, base * 2**attempt)`` scaled by a uniform
    ``[1-jitter, 1+jitter]`` factor (the JAX package's
    ``fleet/supervisor.py`` schedule). The jitter spreads mass restarts
    apart; the cap bounds the time to recover."""
    import random
    rng = rng if rng is not None else random
    base = max(0.0, float(base))
    raw = min(float(cap), base * (2.0 ** int(attempt)))
    return raw * rng.uniform(1.0 - jitter, 1.0 + jitter)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _stream(proc, rank_, out):
    for line in proc.stdout:
        out.write("[worker %d] %s" % (rank_, line))
        out.flush()


def _worker_env(addr, num_workers, rank_, hb_dir, extra):
    """The environment contract every worker sees (single- and
    multi-host modes share it)."""
    host0, _, port = addr.rpartition(":")
    env = {
        "MXNET_COORDINATOR_ADDRESS": addr,
        "MXNET_NUM_WORKERS": str(num_workers),
        "MXNET_WORKER_RANK": str(rank_),
        "MXNET_HEARTBEAT_DIR": hb_dir,
        "MXNET_KVSTORE_SECRET": os.environ["MXNET_KVSTORE_SECRET"],
        # the reference's names
        "DMLC_PS_ROOT_URI": host0,
        "DMLC_PS_ROOT_PORT": port,
        "DMLC_NUM_WORKER": str(num_workers),
        "DMLC_WORKER_ID": str(rank_),
        "DMLC_ROLE": "worker",
    }
    for kv in extra:
        k, _, v = kv.partition("=")
        env[k] = v
    return env


def _ssh_command(host, env, command, cwd):
    """One remote worker: ssh <host> '<read secret from stdin> && cd
    <cwd> && env K=V... cmd'. The job secret travels on stdin, NOT in
    argv — /proc/<pid>/cmdline is world-readable on shared hosts."""
    import shlex
    exports = " ".join("%s=%s" % (k, shlex.quote(v))
                       for k, v in sorted(env.items()))
    remote = ("IFS= read -r MXNET_KVSTORE_SECRET && "
              "export MXNET_KVSTORE_SECRET && cd %s && env %s %s"
              % (shlex.quote(cwd), exports,
                 " ".join(shlex.quote(c) for c in command)))
    return ["ssh", "-o", "BatchMode=yes", "-o",
            "StrictHostKeyChecking=accept-new", host, remote]


def _multihost(args):
    """One worker per host entry over ssh (reference launch.py ssh
    launcher). --dry-run prints the per-host commands for scheduler-
    owned placement instead of executing."""
    hosts = [h.strip() for h in args.hosts.split(",") if h.strip()]
    n = args.num_workers or len(hosts)
    port = args.coordinator_port or 9091   # must be pre-agreed: remote
    # ssh accepts user@host; the coordinator address must not carry the
    # user part (workers dial it as a plain network address)
    host0 = hosts[0].rpartition("@")[2]
    addr = "%s:%d" % (host0, port)         # hosts can't ask us for a port
    if "MXNET_KVSTORE_SECRET" not in os.environ:
        import secrets as _secrets
        os.environ["MXNET_KVSTORE_SECRET"] = _secrets.token_hex(16)
    hb_dir = args.heartbeat_dir
    if hb_dir is None:
        hb_dir = tempfile.gettempdir() + "/mxnet_hb"
        sys.stderr.write(
            "launch: no --heartbeat-dir given; per-host %s is NOT "
            "shared, so cross-host failure detection via "
            "get_num_dead_node is off\n" % hb_dir)
    secret = os.environ["MXNET_KVSTORE_SECRET"]
    cmds = []
    for r in range(n):
        host = hosts[r % len(hosts)]
        env = _worker_env(addr, n, r, hb_dir, args.env)
        env.pop("MXNET_KVSTORE_SECRET")  # shipped on stdin, not argv
        cmds.append((r, host, _ssh_command(host, env, args.command,
                                           os.getcwd())))
    if args.dry_run:
        sys.stderr.write(
            "launch: export MXNET_KVSTORE_SECRET (same value "
            "everywhere) before running these; each command reads it "
            "from stdin\n")
        for r, host, cmd in cmds:
            # runnable as printed: the operator's env supplies the secret
            print("[rank %d @ %s] printf '%%s\\n' "
                  "\"$MXNET_KVSTORE_SECRET\" | %s" % (r, host,
                                                      " ".join(cmd)))
        return 0
    procs = []
    threads = []
    for r, host, cmd in cmds:
        p = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        try:
            p.stdin.write(secret + "\n")
            p.stdin.close()
        except (BrokenPipeError, OSError):
            pass  # ssh died instantly; _wait_group reaps it and
            # terminates the rest of the group
        procs.append(p)
        t = threading.Thread(target=_stream, args=(p, r, sys.stdout),
                             daemon=True)
        t.start()
        threads.append(t)
    rc, _ = _wait_group(procs, threads)
    return rc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-n", "--num-workers", type=int, default=None)
    ap.add_argument("-H", "--hosts", default=None,
                    help="comma-separated host list: one worker per "
                         "entry over ssh (multi-host mode)")
    ap.add_argument("--coordinator-port", type=int, default=None)
    ap.add_argument("--heartbeat-dir", default=None,
                    help="shared-filesystem dir for cross-host failure "
                         "detection (multi-host mode)")
    ap.add_argument("--dry-run", action="store_true",
                    help="print per-host commands instead of executing")
    ap.add_argument("--env", action="append", default=[],
                    help="extra K=V for the workers")
    ap.add_argument("--ddp", action="store_true",
                    help="bucketed data-parallel gradient all-reduce: "
                         "export MXNET_DDP=1 to every worker so dist_sync "
                         "training reduces gradients in bucketed "
                         "all-reduces after the backward (parallel/ddp.py) "
                         "instead of through the kvstore")
    ap.add_argument("--ddp-bucket-mb", type=float, default=None,
                    help="override the gradient bucket size in MiB "
                         "(MXNET_DDP_BUCKET_MB; default: auto from the "
                         "group link's bandwidth, perfmodel.py)")
    ap.add_argument("--max-restarts", type=int, default=3,
                    help="supervised restarts after a worker death "
                         "(single-host mode; 0 disables)")
    ap.add_argument("--restart-backoff", type=float, default=1.0,
                    help="base seconds for the capped jittered "
                         "exponential restart backoff")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="job checkpoint directory (exported as "
                         "MXNET_CHECKPOINT_DIR; restarted workers get it "
                         "as MXNET_RESUME_DIR). Default: a fresh temp dir "
                         "when --max-restarts > 0, else none")
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if not args.command:
        ap.error("no command given")
    # --ddp rides the existing --env plumbing so both the single-host and
    # the ssh multi-host path export the same contract
    if args.ddp:
        args.env = list(args.env) + ["MXNET_DDP=1"]
        if args.ddp_bucket_mb is not None:
            args.env.append("MXNET_DDP_BUCKET_MB=%g" % args.ddp_bucket_mb)
    elif args.ddp_bucket_mb is not None:
        ap.error("--ddp-bucket-mb requires --ddp")
    if args.hosts:
        return _multihost(args)
    if not args.num_workers:
        ap.error("-n is required in single-host mode")

    import json
    import random
    import shlex
    import time
    # per-job kvstore auth secret: separate worker processes must share it
    # to talk to the rank-0 async server (async_server.py trust model)
    if "MXNET_KVSTORE_SECRET" not in os.environ:
        import secrets as _secrets
        os.environ["MXNET_KVSTORE_SECRET"] = _secrets.token_hex(16)
    if args.dry_run:
        addr = "127.0.0.1:%d" % (args.coordinator_port or _free_port())
        sys.stderr.write(
            "launch: export MXNET_KVSTORE_SECRET (same value for "
            "every worker) before running these\n")
        for r in range(args.num_workers):
            env = _worker_env(addr, args.num_workers, r, "<heartbeat-dir>",
                              args.env)
            env.pop("MXNET_KVSTORE_SECRET")  # never print secrets in argv
            print("[rank %d @ localhost] env %s %s"
                  % (r, " ".join("%s=%s" % (k, shlex.quote(v))
                                 for k, v in sorted(env.items())),
                     " ".join(args.command)))
        return 0

    # a checkpoint dir the launcher knows about is what makes restarts
    # useful: restarted workers get it as MXNET_RESUME_DIR and continue
    # instead of recomputing from scratch
    ckpt_dir = args.checkpoint_dir
    if ckpt_dir is None:
        for kv in args.env:
            if kv.startswith(("MXNET_CHECKPOINT_DIR=", "MXNET_RESUME_DIR=")):
                ckpt_dir = kv.partition("=")[2]
    owns_ckpt = False
    if ckpt_dir is None and args.max_restarts > 0:
        ckpt_dir = tempfile.mkdtemp(prefix="mxnet_ckpt_")
        owns_ckpt = True

    attempts = []
    attempt = 0
    rc = 0
    while True:
        # fresh coordinator port + heartbeat dir per attempt: the old
        # port may sit in TIME_WAIT and stale heartbeat files would make
        # the new incarnation see phantom dead nodes
        port = args.coordinator_port or _free_port()
        addr = "127.0.0.1:%d" % port
        hb_dir = tempfile.mkdtemp(prefix="mxnet_hb_")
        extra_env = {}
        if ckpt_dir:
            extra_env["MXNET_CHECKPOINT_DIR"] = ckpt_dir
        if attempt > 0:
            extra_env["MXNET_RESUME_DIR"] = ckpt_dir or ""
            # injected faults are first-incarnation-only: the restarted
            # run resumes at the very step the fault fired at, and would
            # otherwise just die there again
            extra_env["MXNET_FAULT_INJECT"] = ""
        tic = time.time()
        procs = []
        threads = []
        for r in range(args.num_workers):
            env = dict(os.environ)
            env.update(_worker_env(addr, args.num_workers, r, hb_dir,
                                   args.env))
            env.setdefault("GLOO_SOCKET_IFNAME", "lo")
            env.update(extra_env)
            p = subprocess.Popen(args.command, env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
            procs.append(p)
            t = threading.Thread(target=_stream, args=(p, r, sys.stdout),
                                 daemon=True)
            t.start()
            threads.append(t)
        rc, dead = _wait_group(procs, threads)
        shutil.rmtree(hb_dir, ignore_errors=True)
        attempts.append({"attempt": attempt, "rc": rc, "dead_ranks": dead,
                         "duration_s": round(time.time() - tic, 3),
                         "resumed": attempt > 0})
        if rc == 0 or rc == 130 or attempt >= args.max_restarts:
            break
        delay = backoff_delay(attempt, base=args.restart_backoff,
                               cap=30.0, jitter=0.5, rng=random)
        sys.stderr.write(
            "launch: restarting the group (attempt %d/%d) in %.1fs; "
            "workers will resume from %s\n"
            % (attempt + 1, args.max_restarts, delay,
               ckpt_dir or "<no checkpoint dir>"))
        time.sleep(delay)
        attempt += 1
    if rc != 0 or attempt > 0:
        # structured failure summary: one parseable line for fleet tooling
        sys.stderr.write("launch: summary %s\n" % json.dumps(
            {"rc": rc, "restarts": attempt,
             "max_restarts": args.max_restarts,
             "checkpoint_dir": ckpt_dir, "attempts": attempts},
            sort_keys=True))
    if owns_ckpt and rc == 0:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return rc


def _wait_group(procs, threads):
    """Wait for the group; on the first nonzero exit, terminate the
    stragglers. Returns ``(rc, dead_ranks)``."""
    rc = 0
    dead = []
    try:
        # poll ALL workers: a failed one wedges the rest at their next
        # collective, so on first failure terminate the stragglers
        import time
        pending = set(procs)
        while pending:
            # rank order, not set order: when a death cascades (rank 0
            # dies -> peers abort on the lost coordinator), the lowest
            # dead rank is the root cause and its rc is the one reported
            for p in procs:
                if p not in pending:
                    continue
                r = p.poll()
                if r is None:
                    continue
                pending.discard(p)
                if r != 0 and rc == 0:
                    rc = r
                    dead = [i for i, q in enumerate(procs)
                            if q.poll() not in (None, 0)]
                    sys.stderr.write(
                        "launch: worker(s) %s died (rc=%d); "
                        "terminating the group\n" % (dead, r))
                    for q in procs:
                        if q.poll() is None:
                            q.terminate()
            if pending:
                time.sleep(0.2)
    except KeyboardInterrupt:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
        rc = 130
    for t in threads:
        t.join(timeout=5)
    return rc, dead


if __name__ == "__main__":
    sys.exit(main())
