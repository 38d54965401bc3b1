"""Native (C++) runtime pieces, reached through ctypes: the asynchronous
chunked checkpoint writer and its reader (ckpt.cpp), the port's own copy
of the JAX package's, with the same on-disk records

    [u64 payload_len][u32 crc32][payload bytes]   (little-endian)

so that either package reads what the other wrote. The library is built
with g++ at first use into ``build/`` at the repository root, named by a
hash of its source; a build that fails raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

SRC = Path(__file__).resolve().parent / "ckpt.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lib = None
_lib_lock = threading.Lock()


def _so_path():
    tag = hashlib.sha1(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libckpt_{tag}.so"


def _build(so):
    """g++ into a file of this process's own, then renamed into place, so
    that processes building at once never load a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", tmp], capture_output=True,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building {SRC.name} failed:\n{res.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load():
    """The checkpoint library, built at first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            so = _so_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            lib.ckpt_open.restype = ctypes.c_void_p
            lib.ckpt_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
            lib.ckpt_write.restype = ctypes.c_int64
            lib.ckpt_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
            lib.ckpt_flush.restype = ctypes.c_int
            lib.ckpt_flush.argtypes = [ctypes.c_void_p]
            lib.ckpt_written.restype = ctypes.c_int64
            lib.ckpt_written.argtypes = [ctypes.c_void_p]
            lib.ckpt_close.restype = ctypes.c_int
            lib.ckpt_close.argtypes = [ctypes.c_void_p]
            lib.ckpt_scan.restype = ctypes.c_int64
            lib.ckpt_scan.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64),
                                      ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64]
            _lib = lib
        return _lib


def _scan(path):
    """(offsets, lengths) of the valid records' payloads, up to the first
    corrupt or partial one."""
    lib = load()
    empty = (ctypes.c_uint64 * 0)()
    n = lib.ckpt_scan(str(path).encode(), empty, empty, 0)
    if n < 0:
        raise FileNotFoundError(path)
    offsets, lengths = (ctypes.c_uint64 * n)(), (ctypes.c_uint64 * n)()
    lib.ckpt_scan(str(path).encode(), offsets, lengths, n)
    return list(offsets), list(lengths)


class CheckpointWriter:
    """Asynchronous append-only record writer (length prefix + CRC32)."""

    def __init__(self, path, append=False):
        self.path = str(path)
        lib = load()
        if append and os.path.exists(self.path):
            # cut a corrupt or partial tail left by a crash, so that the
            # records appended now stay reachable by the reader
            offsets, lengths = _scan(self.path)
            end = offsets[-1] + lengths[-1] if offsets else 0
            if end < os.path.getsize(self.path):
                with open(self.path, "r+b") as f:
                    f.truncate(end)
        self._h = lib.ckpt_open(self.path.encode(), 1 if append else 0)
        if not self._h:
            raise OSError(f"can't open {self.path}")

    def write(self, payload: bytes):
        if load().ckpt_write(self._h, payload, len(payload)) < 0:
            raise OSError("checkpoint write failed")

    def flush(self):
        if load().ckpt_flush(self._h) != 0:
            raise OSError("checkpoint flush failed")

    def close(self):
        if self._h:
            rc = load().ckpt_close(self._h)
            self._h = None
            if rc != 0:
                raise OSError("checkpoint close failed")

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_records(path):
    """The payloads of every valid record, in order, up to the first
    corrupt or partial one (a crash's tail)."""
    offsets, lengths = _scan(path)
    out = []
    with open(path, "rb") as f:
        for off, ln in zip(offsets, lengths):
            f.seek(off)
            out.append(f.read(ln))
    return out


def scan_count(path):
    """The number of valid records."""
    return len(_scan(path)[0])
