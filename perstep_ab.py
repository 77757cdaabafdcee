#!/usr/bin/env python3
"""A/B of the per-step ResNet-50 training step between two checkouts.

    python3 perstep_ab.py CHECKOUT [STEPS]

Runs the training leg of ``chip_smoke.py`` phase 13 from the checkout
at CHECKOUT (its own ``chip_smoke.py`` and ``mxnet_tpu_torch``): ResNet-50
v1 bf16 over f32 masters at batch 128, ``Module.fit`` with
``steps_per_dispatch=1`` for STEPS steps (default 42) of one synthetic
batch, and prints one JSON line with the step p50 over steps 2-STEPS
and the card's nvidia-smi line. Needs one CUDA card. Compare two
checkouts in one machine, in turns (A, B, B, A), each in its own
process: the steps are host-bound and the host's speed moves between
machines.
"""
import json
import os
import sys

import numpy as np

root = os.path.abspath(sys.argv[1])
steps = int(sys.argv[2]) if len(sys.argv) > 2 else 42
sys.path.insert(0, root)
os.chdir(root)
import torch  # noqa: E402
import chip_smoke as cs  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("perstep_ab: no CUDA device")
dev = torch.device("cuda", 0)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
sym = cs.resnet50()
p0, aux0 = cs.resnet_init(sym, dev)
X, Y = cs.image_batch(cs.RESNET_TRAIN["bf16_batch"])
_mod, _losses, stamps = cs.resnet_fit(sym, X, Y, dev, steps, p0, aux0,
                                      mp=True)
step_ms = [(b - a) * 1e3 for a, b in zip(stamps[1:], stamps[2:])]
print(json.dumps({"checkout": root, "p50_ms": float(np.median(step_ms)),
                  "steps_ms": step_ms, "card": cs.card_line()}))
