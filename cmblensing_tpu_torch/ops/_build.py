"""Build and load the hand-written CUDA kernels.

``csrc/lenseflow.cu`` is compiled at first use with nvcc for sm_90a
into a shared library with a plain C interface, under ``build/`` at the
repository root, named by a hash of the source so that an edited source
is rebuilt. It is loaded with ctypes. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "lenseflow.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIB = None
# what the last build printed (ptxas register and shared-memory report);
# None when the library was already built
BUILD_LOG = None


def _nvcc():
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the LenseFlow kernels are built from "
                       "csrc/ with the CUDA toolkit at first use on a CUDA host")


def build():
    """Compile the kernels if this source has not been built yet; return
    the library's path."""
    global BUILD_LOG
    tag = hashlib.sha1(_SRC.read_bytes()).hexdigest()[:12]
    so = BUILD_DIR / f"liblenseflow_{tag}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG = r.stdout + r.stderr
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{BUILD_LOG}")
    os.replace(tmp, so)
    return so


def load():
    """The loaded kernel library (built first if needed)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.lf_velocity.argtypes = [I, P, P, P, P, P, I, I, I, F, P]
        lib.lf_velocity.restype = I
        lib.lf_deriv.argtypes = [P, P, P, P, P, P, I, I, I, P]
        lib.lf_deriv.restype = I
        lib.lf_rk4_update.argtypes = [P, P, P, P, ctypes.c_size_t, I, F, F, P]
        lib.lf_rk4_update.restype = I
        _LIB = lib
    return _LIB
