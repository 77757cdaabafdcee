"""Build the port's CUDA sources and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its
own by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/mxnet_tpu_torch/`` at the repository root, with ``NVCC_FLAGS``
and the source's own flags and libraries from ``EXTRA_FLAGS``. The
library's file name carries a hash of the sources and of every flag, so
an edited source or flag builds anew and an unchanged one is reused. Building happens at first use
(:func:`load`) or all at once (:func:`build`, one ``nvcc`` per source,
all started together). A failed build raises; nothing falls back.
Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

from ..base import MXNetError

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "EXTRA_FLAGS", "sources",
           "command", "build", "load", "build_log"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "mxnet_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# a source's own flags, after NVCC_FLAGS: the nvJPEG binding links the
# toolkit's libnvjpeg; the image augment kernel keeps every multiply and
# add rounded on its own, as its plain torch version does
EXTRA_FLAGS = {"nvjpeg_decode": ("-lnvjpeg",),
               "image_aug": ("-fmad=false",)}

_lock = threading.Lock()
_libs = {}


def sources():
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _nvcc():
    home = os.environ.get("CUDA_HOME")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.isfile(cand):
            return cand
    raise MXNetError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                     "the port's CUDA kernels are built from source")


def _flags(name, nvcc):
    """NVCC_FLAGS and ``name``'s own; a source that links a library of
    the toolkit finds it at run time through an rpath to the toolkit's
    library directory beside ``nvcc``."""
    extra = list(EXTRA_FLAGS.get(name, ()))
    if any(f.startswith("-l") for f in extra):
        lib = os.path.join(os.path.dirname(os.path.dirname(nvcc)), "lib64")
        extra += ["-Xlinker", "-rpath", "-Xlinker", lib]
    return list(NVCC_FLAGS) + extra


def command(name, output):
    """The nvcc command line that builds ``csrc/<name>.cu`` into
    ``output``."""
    nvcc = _nvcc()
    return [nvcc, *_flags(name, nvcc), "-o", output,
            os.path.join(CSRC_DIR, name + ".cu")]


def _target(name):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(" ".join(EXTRA_FLAGS.get(name, ())).encode())
    for p in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))) + [
            os.path.join(CSRC_DIR, name + ".cu")]:
        with open(p, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, "%s-%s.so" % (name, h.hexdigest()[:16]))


def build_log(name):
    """What nvcc printed for the current build of ``name`` (ptxas
    registers, shared memory, spills), or None before it is built."""
    path = _target(name) + ".log"
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return f.read()


def build(names=None):
    """Compile every listed source (default: all) that has no current
    library, one nvcc process per source, all at once -> {name: path}."""
    names = sources() if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = {n: _target(n) for n in names}
    procs = []
    for name, target in todo.items():
        if os.path.exists(target):
            continue
        tmp = "%s.%d.tmp" % (target, os.getpid())
        procs.append((name, target, tmp, subprocess.Popen(
            command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, target, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append("%s (exit %d):\n%s" % (name, proc.returncode, out))
            continue
        with open(target + ".log", "w") as f:
            f.write(out)
        os.replace(tmp, target)
    if failed:
        raise MXNetError("nvcc failed for " + "\n".join(failed))
    return todo


def load(name, signatures):
    """The ctypes library of ``csrc/<name>.cu``, built if needed.
    ``signatures`` maps each C function to ``(restype, argtypes)``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = list(argtypes)
            _libs[name] = lib
        return lib
