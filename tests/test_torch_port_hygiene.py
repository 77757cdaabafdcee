"""Port hygiene: ``mxnet_tpu_torch`` stands alone.

Importing it pulls in neither ``jax`` nor ``mxnet_tpu``, initializes no
CUDA context, builds nothing and joins no process group (not even under a
launcher's environment), and reading records through it maps nothing of
the JAX package's native library; no module of the package, nor
``chip_smoke.py``, nor the multi-process workers it and the tests launch,
imports either; entry points default to ``cuda:0`` and raise without a
card unless the CPU was asked for.
"""
import ast
import glob
import os
import subprocess
import sys

import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.context import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_pulls_in_no_jax_and_does_no_device_work(tmp_path):
    code = (
        "import os, sys\n"
        "import mxnet_tpu_torch\n"
        "from mxnet_tpu_torch.kernels import _build\n"
        "import mxnet_tpu_torch.tools.launch, mxnet_tpu_torch.tools.reshard\n"
        "import torch\n"
        # a launcher's environment: the join waits for the first use
        "import torch.distributed as td\n"
        "assert not td.is_initialized()\n"
        "assert not mxnet_tpu_torch.parallel.fault.active()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'mxnet_tpu' or m.startswith('mxnet_tpu.')]\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
        # records read through the port's pipeline map nothing of the
        # JAX package's native library
        "import numpy as np\n"
        "p = sys.argv[1]\n"
        "w = mxnet_tpu_torch.recordio.MXIndexedRecordIO(p[:-4] + '.idx', p,"
        " 'w')\n"
        "w.write_idx(0, mxnet_tpu_torch.recordio.pack(mxnet_tpu_torch."
        "recordio.IRHeader(0, 1.0, 0, 0), np.arange(6, dtype=np.float32)"
        ".tobytes()))\n"
        "w.close()\n"
        "it = mxnet_tpu_torch.data.StreamingDataIter(mxnet_tpu_torch.data."
        "ShardedRecordStream(p), mxnet_tpu_torch.data.RawTensorDecoder("
        "(2, 3)), 1, ctx=mxnet_tpu_torch.cpu())\n"
        "assert next(it).data[0].asnumpy().sum() == 15\n"
        "it.close()\n"
        "assert 'libmxtpu' not in open('/proc/self/maps').read()\n"
        "print('CLEAN', os.path.isdir(_build.BUILD_DIR))\n")
    env = dict(os.environ, PYTHONPATH=REPO,
               MXNET_COORDINATOR_ADDRESS="127.0.0.1:1",
               MXNET_NUM_WORKERS="2", MXNET_WORKER_RANK="1",
               MXNET_HEARTBEAT_DIR=str(tmp_path))
    before = os.path.isdir(os.path.join(REPO, "build", "mxnet_tpu_torch"))
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path / "r.rec")],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["CLEAN", str(before)]


def _port_sources():
    files = sorted(glob.glob(os.path.join(REPO, "mxnet_tpu_torch", "**",
                                          "*.py"), recursive=True))
    return files + [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(REPO, "tests", f) for f in (
            "torch_dist_worker.py", "torch_dist_common.py")]


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_port_file_imports_jax_or_the_jax_package(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "mxnet_tpu"), (path, mod)


def test_entry_points_default_to_cuda0_and_refuse_a_missing_card():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(mt.cpu()) == torch.device("cpu")
    with mt.cpu():
        assert resolve_device() == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device() == torch.device("cuda", 0)
        return
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        resolve_device(mt.gpu(0))
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.serving.CompiledModel.load(os.path.join(REPO, "missing.mxtorch"))


def test_no_port_source_names_the_jax_packages_native_library():
    """``mxnet_tpu/libmxtpu.so`` (engine, record scanner, storage pool)
    belongs to the JAX package: no port source names it (the import
    test above also reads records and finds it unmapped)."""
    for path in _port_sources():
        with open(path) as f:
            assert "libmxtpu" not in f.read(), path
