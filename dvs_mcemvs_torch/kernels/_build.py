"""Build the CUDA sources in `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` compiles on first use into one shared library with a
plain C interface, `build/kernels/lib<name>-<hash>.so` under the repository
root (a git-ignored directory); the hash covers the source and the flags, so
an edited source is rebuilt.  `build` compiles several sources in parallel.
Nothing is compiled when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> (seconds spent compiling, 0.0 when the library was already built;
#          ptxas report of registers / shared memory / spills)
BUILD_INFO: Dict[str, tuple] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(*names: str) -> None:
    """Compile the libraries of `names` that are not built yet, one nvcc per
    source, all started together, and load them."""
    jobs = []
    try:
        for name in names:
            out = _target(name)
            if name in _LIBS or out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            jobs.append((name, out, tmp, proc, time.perf_counter()))
        for name, out, tmp, proc, t0 in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}.cu:\n{err}")
            os.replace(tmp, out)
            BUILD_INFO[name] = (time.perf_counter() - t0, err)
    finally:
        for _, _, tmp, proc, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    for name in names:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(_target(name)))
            BUILD_INFO.setdefault(name, (0.0, ""))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, compiled if needed."""
    if name not in _LIBS:
        build(name)
    return _LIBS[name]


def check(status: int, what: str) -> None:
    """Raise when a C entry point returned a nonzero cudaError_t."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
