"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface,
``_build/lib<name>-<hash>.so``, and loaded with ctypes. The hash covers the
sources (every ``.cu`` and ``.cuh`` under ``csrc/``) and the flags, so an
edited kernel rebuilds and an unchanged one loads at once. ``build_all``
starts one ``nvcc`` per source, all at once; ``load`` builds on first use.

Nothing here falls back: a missing ``nvcc`` or a failed build raises.
Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(fallback):
        return fallback
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of scannertools_tpu_torch need "
        "the CUDA toolkit on PATH (or under /usr/local/cuda)")


def sources() -> List[str]:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC, "*.cu")))


def _so_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_all(names=None) -> Dict[str, str]:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` per source, all started together. Returns name -> .so path."""
    names = sources() if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = {n: _so_path(n) for n in names}
    todo = [n for n in names if not os.path.isfile(out[n])]
    if not todo:
        return out
    nvcc = _nvcc()
    procs = []
    for n in todo:
        tmp = f"{out[n]}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for n, tmp, proc in procs:
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{log}")
            continue
        os.replace(tmp, out[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(build_all([name])[name])
        return _LIBS[name]
