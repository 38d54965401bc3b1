"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled at first use with nvcc for sm_90a, one
nvcc process per source, all started together, and the objects are
linked into one shared library with a plain C interface, under
``build/`` at the repository root. The library is named by a hash of
every source and header in ``csrc/`` and of the flags made from the
host's table of tiles (``form_flags``), so that an edit to any of them
rebuilds. It is loaded with ctypes. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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


def form_flags():
    """The build's copy of which tile each factored kernel runs at radix 4
    and 8 (at 16 and 32 they all run the cluster tile), made from the
    host's table (ops/lenseflow_kernels.py::FORMS), so that only the forms
    it names are built: -DLF_FA_ON_TILE (K3), -DLF_BV_ON_TILE (K4) and
    -DLF_UNI_ON_TILE (K5), each a bitmask of the (tier, radix) on
    fact_tile, bit 2 tier + (radix == 8) (csrc/lenseflow_common.cuh::
    k3_on_tile .. k5_on_tile read them). K1 has the cluster tile alone: an
    entry of its that names another is refused."""
    from .lenseflow_kernels import FORMS, PRECISIONS
    other = [key for key, form in FORMS.items() if key[0] == "fderiv" and form != "cluster"]
    if other:
        raise ValueError(f"FORMS: K1 is built on the cluster tile alone, not at {other}")
    return [f"-DLF_{k.upper()}_ON_TILE="
            + str(sum(1 << (2 * t + (B == 8)) for t, p in enumerate(PRECISIONS) for B in (4, 8)
                      if FORMS[k, p, B] == "tile"))
            for k in ("fa", "bv", "uni")]


def _tag():
    h = hashlib.sha1(" ".join(form_flags()).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:12]


def build():
    """Compile the kernels if these sources have not been built yet;
    return the library's path."""
    global BUILD_LOG
    so = BUILD_DIR / f"liblenseflow_{_tag()}.so"
    if so.exists():
        return so
    nvcc = _nvcc()
    work = BUILD_DIR / f"{so.stem}.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [work / f"{s.stem}.o" for s in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, *form_flags(), "-c", "-o", str(o), str(s)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for s, o in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    BUILD_LOG = "".join(f"[{s.name}]\n{log}" for s, log in zip(srcs, logs))
    bad = [s.name for s, p in zip(srcs, procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"nvcc failed on {bad}:\n{BUILD_LOG}")
    tmp = work / so.name
    r = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                       capture_output=True, text=True)
    BUILD_LOG += r.stdout + r.stderr
    if r.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({r.returncode}):\n{BUILD_LOG}")
    os.replace(tmp, so)
    shutil.rmtree(work, ignore_errors=True)
    return so


def bind(lib):
    """Declare the C signatures of the kernel entry points on a loaded
    library."""
    P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    sigs = {
        "lf_velocity": [I, I, P, P, P, P, P, P, I, I, I, F, P],
        "lf_deriv": [I, P, P, P, P, P, P, I, I, I, P],
        "lf_rk4_update": [P, P, P, P, ctypes.c_size_t, I, F, F, P],
        "lf_p_planes": [P, P, ctypes.c_size_t, ctypes.c_size_t, F, P],
        "lf_fderiv": [I, P, P, P, P, P, P, P, P, I, I, I, I, I, P],
        "lf_fa_velocity": [I, I, I, P, P, P, P, P, P, P, I, I, I, I, I, I, P],
        "lf_bv_velocity": [I, I, P, P, P, P, P, P, P, P, I, I, I, I, I, I, F, P],
        "lf_uni_velocity": [I, I, I, P, P, L, L, L, L, P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                            F, P],
        "lf_uni_dense_velocity": [I, I, P, P, L, L, L, L, P, P, P, P, P, P, I, I, I, I, F, P],
        "lf_dense_init": [],
        "lf_factored_init": [],
        "lf_uni_init": [],
        "lf_uni_dense_init": [],
        "lf_fderiv_sm90_init": [],
        "lf_fa_sm90_init": [],
        "lf_bv_sm90_init": [],
        "lf_uni_sm90_init": [],
        "lf_fderiv_sm90_clusters": [I, I],
        "lf_fa_sm90_clusters": [I, I],
        "lf_bv_sm90_clusters": [I, I],
        "lf_uni_sm90_clusters": [I, I],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = I
    return lib


def load():
    """The loaded kernel library (built first if needed), its kernels
    allowed their dynamic shared memory; raises where a kernel's cluster
    does not fit on the card."""
    global _LIB
    if _LIB is None:
        lib = bind(ctypes.CDLL(str(build())))
        for init in (lib.lf_dense_init, lib.lf_factored_init, lib.lf_uni_init,
                     lib.lf_uni_dense_init, lib.lf_fderiv_sm90_init, lib.lf_fa_sm90_init,
                     lib.lf_bv_sm90_init, lib.lf_uni_sm90_init):
            rc = init()
            if rc != 0:
                raise RuntimeError(f"{init.__name__} failed with CUDA error {rc}")
        _LIB = lib
    return _LIB
