"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The sources compile with nvcc for sm_90a into one shared library with a
plain C interface, loaded through ctypes. The build happens on first
use, into `trivy_tpu_torch/_build/` (not committed), under a name that
carries a hash of the sources, so an edited source rebuilds and an
unchanged one is loaded as it is. Each source compiles in its own nvcc
process, all started together, and the objects link into the library.
The constants a kernel shares with the Python side (ops/constants.py)
reach it as -D flags, so they are defined in one place.

Nothing here runs when the module is imported: the CPU tests import
every module of the package on machines without nvcc.
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

from . import constants as C

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("shiftor.cu", "csr_join.cu")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
# the constants the kernels share with the Python side
DEFINES = (f"-DJOIN_TILE={C.JOIN_TILE}", f"-DPREFIX_TOKENS={C.PREFIX_TOKENS}")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point → argument types (each returns a cudaError_t as int)
# the join's leading arguments: token vectors, flags, prefix planes,
# shapes, version pool, CSR descriptors, total, t_pad, dense bits, scratch
_JOIN = (_P, _P, _P, _P, _P, _I, _I, _P, _I, _P, _P, _P, _I, _I, _I, _P, _P)
_SIGNATURES = {
    "trivy_shiftor": (_P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _I, _P),
    "trivy_csr_join": _JOIN + (_P,),
    "trivy_csr_join_compact": _JOIN + (_P, _P, _I, _P, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# seconds the last build in this process took (0.0 when the library was
# already built); None until library() first runs
build_seconds: float | None = None


class KernelError(RuntimeError):
    """A kernel failed to build or to launch."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelError("nvcc not found: the CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join((ARCH, *DEFINES)).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the kernels if their library is missing → its path."""
    global build_seconds
    lib_path = os.path.join(BUILD_DIR, f"libtrivy_kernels-{_source_hash()}.so")
    if os.path.exists(lib_path):
        build_seconds = 0.0
        return lib_path
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name in SOURCES:
            obj = os.path.join(tmp, name + ".o")
            cmd = [nvcc, ARCH, *DEFINES, "-std=c++17", "-O3",
                   "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-c", os.path.join(CSRC, name),
                   "-o", obj]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        objs, log = [], []
        for name, obj, p in procs:
            out, _ = p.communicate()
            log.append(f"== {name}\n{out.decode(errors='replace')}")
            if p.returncode != 0:
                raise KernelError(f"nvcc failed on {name}:\n{log[-1]}")
            objs.append(obj)
        tmp_lib = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, ARCH, "-shared", "-o", tmp_lib, *objs],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
        if link.returncode != 0:
            raise KernelError("nvcc link failed:\n"
                              + link.stdout.decode(errors="replace"))
        with open(os.path.join(BUILD_DIR, "ptxas.log"), "w") as f:
            f.write("\n".join(log))
        # atomic publish: concurrent builders never load a partial file
        os.replace(tmp_lib, lib_path)
    build_seconds = time.perf_counter() - t0
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if rc != 0:
        raise KernelError(f"{name} launch failed: cudaError {rc}")


_count_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to a wrapper's `launches`, under a lock: several servers
    in one process (a fleet's replicas) launch from their own detectd
    threads, and `+=` on an attribute is not atomic."""
    with _count_lock:
        wrapper.launches += 1
