"""Build the port's native libraries from the repository's sources.

Two shared libraries, each with a plain C interface loaded through ctypes:

- ``watershed_sweep``: ``csrc/watershed_sweep.cu``, compiled by ``nvcc`` for
  ``sm_90a`` (Hopper).  Only a CUDA tensor ever asks for it.
- ``meshpack``: the JAX package's host STL packer
  ``invesalius3_tpu/native/meshpack.cpp``, compiled by ``g++`` by path (the
  JAX package's own loader imports jax).

Nothing is built on import.  Each library is built at first use into
``_build/`` next to this file, named by a hash of its sources and flags, so
a changed source rebuilds and an unchanged one loads the cached file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE / "_build"
CUDA_SOURCES = (_HERE / "csrc" / "watershed_sweep.cu",)
MESHPACK_SOURCE = _HERE.parent / "invesalius3_tpu" / "native" / "meshpack.cpp"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# per library: seconds the compiler took in this process (0.0 = cached) and
# its stderr (ptxas register / shared-memory report for the CUDA build)
BUILD_LOG: Dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the watershed sweep kernel")


def _compile(name: str, compiler: str, flags: List[str],
             sources) -> Path:
    h = hashlib.sha256(" ".join([Path(compiler).name, *flags]).encode())
    for src in sources:
        h.update(Path(src).read_bytes())
    out = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        BUILD_LOG[name] = {"seconds": 0.0, "log": "cached"}
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [compiler, *flags, *(str(s) for s in sources), "-o", str(tmp)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"building {name} failed ({' '.join(cmd)}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                       "log": proc.stderr.strip()}
    return out


def _load(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        if name == "watershed_sweep":
            lib = ctypes.CDLL(str(_compile(name, _nvcc(), NVCC_FLAGS,
                                           CUDA_SOURCES)))
            lib.ws_sweep.restype = ctypes.c_int
            lib.ws_sweep.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        elif name == "meshpack":
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError("g++ not found: it builds the STL packer")
            lib = ctypes.CDLL(str(_compile(name, gxx, GXX_FLAGS,
                                           (MESHPACK_SOURCE,))))
            lib.stl_pack_mt.restype = ctypes.c_int
            lib.stl_pack_mt.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_int]
        else:
            raise KeyError(name)
        _libs[name] = lib
        return lib


def watershed_sweep_lib() -> ctypes.CDLL:
    return _load("watershed_sweep")


def meshpack_lib() -> ctypes.CDLL:
    return _load("meshpack")


def build_all() -> Dict[str, dict]:
    """Build (or load from the cache) every library; returns BUILD_LOG."""
    watershed_sweep_lib()
    meshpack_lib()
    return dict(BUILD_LOG)
