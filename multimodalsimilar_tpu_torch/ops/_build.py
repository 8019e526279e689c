"""Build and load the port's CUDA kernels (``csrc/*.cu``, which include
the shared ``csrc/*.cuh`` headers).

Each source compiles with nvcc for ``sm_90a`` into its own shared library
with a plain C interface, under the package's git-ignored ``build/``
directory, at first use; the library is loaded with ctypes. Nothing here
runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
NVCC_LIBS = ["-lcuda"]   # the driver's cuTensorMapEncodeTiled (TMA maps)
_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas register / shared-memory report of each build in this process
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _paths(name: str):
    return (os.path.join(CSRC, f"{name}.cu"),
            os.path.join(BUILD, f"lib{name}.so"))


def _stale(name: str) -> bool:
    """True when the library is missing or older than its ``.cu`` source
    or than any shared ``csrc/*.cuh`` header."""
    src, lib = _paths(name)
    if not os.path.exists(lib):
        return True
    deps = [src, *glob.glob(os.path.join(CSRC, "*.cuh"))]
    return os.path.getmtime(lib) < max(map(os.path.getmtime, deps))


def _start(name: str):
    """Start nvcc on ``csrc/{name}.cu``; returns (process, temp output)."""
    src, lib = _paths(name)
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{lib}.build.{os.getpid()}"
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src,
                             *NVCC_LIBS],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp


def _finish(name: str, started) -> None:
    proc, tmp = started
    out, _ = proc.communicate()
    build_logs[name] = out
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, _paths(name)[1])   # never dlopen a half-written file


def build_all() -> List[str]:
    """Compile every stale ``csrc/*.cu`` at once, one nvcc each, all
    started together; returns the kernel names."""
    names = sorted(os.path.splitext(os.path.basename(p))[0]
                   for p in glob.glob(os.path.join(CSRC, "*.cu")))
    with _lock:
        started = {n: _start(n) for n in names if _stale(n)}
        for n, st in started.items():
            _finish(n, st)
    return names


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/{name}.cu``, building it if stale."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                _finish(name, _start(name))
            lib = _libs[name] = ctypes.CDLL(_paths(name)[1])
        return lib
