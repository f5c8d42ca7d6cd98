"""Native (C++) host helpers: trivy_native.cpp beside this file, built
with the host's C++ compiler (`c++`, else `g++`: the compiler nvcc
itself needs) into one shared library loaded through ctypes.

The build happens on first use, never at import, into
`trivy_tpu_torch/_build/` under a name that carries the sha256 of the
source and the flags. It compiles into a temporary directory and
publishes the library with `os.replace`, under a lock, so concurrent
processes and threads never load a partial file. A build that fails
raises NativeError with the compiler's output: there is no Python
fallback. The plain versions the tests hold these against are
`ops.ac._pack_one_py` and `ops.hashing.fnv1a64`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "trivy_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
# C entry point → (argument types, return type)
_SIGNATURES = {
    "fnv1a64_batch": ((_P, _P, _I64, _P), None),
    "lower_pack_chunks": ((_P, _I64, _I32, _I32, _P, _I32, _P), None),
    "contains_lower": ((_P, _I64, _P, _I64), _I32),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# seconds the last build in this process took (0.0 when the library was
# already built); None until library() first runs
build_seconds: float | None = None


class NativeError(RuntimeError):
    """The native library could not be built or loaded."""


def compiler() -> str:
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise NativeError("no host C++ compiler (c++ or g++) on PATH: the "
                      "native helpers cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode() + b"\0")
    with open(SRC, "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the library if it is missing → its path."""
    global build_seconds
    lib_path = os.path.join(BUILD_DIR, f"libtrivy_native-{_source_hash()}.so")
    if os.path.exists(lib_path):
        build_seconds = 0.0
        return lib_path
    cxx = compiler()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_lib = os.path.join(tmp, "lib.so")
        p = subprocess.run([cxx, *FLAGS, SRC, "-o", tmp_lib],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if p.returncode != 0:
            raise NativeError(f"{cxx} failed on {os.path.basename(SRC)}:\n"
                              + p.stdout.decode(errors="replace"))
        os.replace(tmp_lib, lib_path)
    build_seconds = time.perf_counter() - t0
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL(build())
            except OSError as e:
                raise NativeError(f"cannot load the native library: {e}") \
                    from e
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = restype
            _lib = lib
        return _lib


def fnv1a64_batch(keys: list[bytes]) -> np.ndarray:
    """FNV-1a 64 of each byte string → uint64[len(keys)]."""
    lib = library()
    out = np.empty(len(keys), dtype=np.uint64)
    if not keys:
        return out
    data = b"".join(keys)
    offsets = np.zeros(len(keys) + 1, dtype=np.int64)
    np.cumsum([len(k) for k in keys], out=offsets[1:])
    buf = np.frombuffer(data, dtype=np.uint8) if data else \
        np.zeros(1, np.uint8)
    lib.fnv1a64_batch(buf.ctypes.data, offsets.ctypes.data, len(keys),
                      out.ctypes.data)
    return out


def lower_pack_chunks(data: bytes, chunk_len: int,
                      overlap: int) -> np.ndarray:
    """Lowercase (A-Z only) and chunk one file → uint8[n, chunk_len],
    rows at a stride of max(1, chunk_len - overlap), the last one
    zero-padded."""
    if chunk_len < 1 or overlap < 0:
        raise ValueError(f"chunk_len {chunk_len} < 1 or overlap {overlap} < 0")
    lib = library()
    if not data:
        return np.zeros((0, chunk_len), np.uint8)
    stride = max(1, chunk_len - overlap)
    max_chunks = (len(data) + stride - 1) // stride + 1
    out = np.empty((max_chunks, chunk_len), dtype=np.uint8)
    n = ctypes.c_int32(0)
    buf = np.frombuffer(data, dtype=np.uint8)
    lib.lower_pack_chunks(buf.ctypes.data, len(data), chunk_len, overlap,
                          out.ctypes.data, max_chunks, ctypes.byref(n))
    return out[:n.value]


def contains_lower(hay: bytes, needle: bytes) -> bool:
    """Whether `needle` (lowercase) occurs in `hay`, case-insensitively
    over A-Z."""
    lib = library()
    hb = np.frombuffer(hay, np.uint8) if hay else np.zeros(1, np.uint8)
    nb = np.frombuffer(needle, np.uint8) if needle else np.zeros(1, np.uint8)
    return bool(lib.contains_lower(hb.ctypes.data, len(hay),
                                   nb.ctypes.data, len(needle)))
