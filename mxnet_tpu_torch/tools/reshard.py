"""Reshard a multi-rank checkpoint to another world size (counterpart of
the checkpoint mode of the repo's ``tools/reshard.py``).

A run killed at world N resumes at world N-k or N+k, bitwise::

    python -m mxnet_tpu_torch.tools.reshard --checkpoint /ckpt/run1 \\
        --world 3 [--dst /ckpt/run1-w3] [--step 1200]

Every parameter is gathered from the old layout (the layout manifest in
each snapshot's meta, ``parallel/layout.py``), re-sliced for the new
one, and committed under ``rank_0 .. rank_{W-1}`` of the destination
with the new manifest and fingerprint
(``checkpoint.reshard_checkpoint``). Prints a one-line JSON report and
exits 0. The artifact mode of the JAX package's tool (a generate
artifact re-targeted to another serving mesh) belongs to the mesh half
of the port and is not here.
"""
from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", metavar="ROOT", required=True,
                   help="CheckpointManager root (rank_* subdirs) to "
                        "reshard to --world ranks")
    p.add_argument("--world", type=int, required=True,
                   help="target world size")
    p.add_argument("--dst", default=None,
                   help="destination root (default: <ROOT>-w<WORLD>)")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step to reshard (default: newest "
                        "step committed by every rank)")
    args = p.parse_args(argv)
    if args.world < 1:
        p.error("--world must be >= 1")
    from ..checkpoint import reshard_checkpoint
    report = reshard_checkpoint(args.checkpoint, args.world,
                                dst_root=args.dst, step=args.step)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
