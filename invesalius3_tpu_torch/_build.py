"""Build the port's native libraries from the repository's sources.

Seven shared libraries, each with a plain C interface loaded through ctypes:

- ``watershed_sweep``: ``csrc/watershed_sweep.cu``, compiled by ``nvcc`` for
  ``sm_90a`` (Hopper).  Only a CUDA tensor ever asks for it.
- ``ray_projections``: ``csrc/ray_projections.cu`` (LMIP, MIDA and MIDA's
  min/max pass), the same way, with ``-fmad=false`` so that no product and
  sum is contracted into a fused multiply-add: the kernels then round as
  PyTorch's separate elementwise kernels do.
- ``conv_wgrad``: ``csrc/conv_wgrad.cu``, the weight gradient of a 3D
  convolution with one input or one output channel, the same way.
- ``cdb_epilogue``: ``csrc/cdb_epilogue.cu``, the transition between two
  convolutions of FastSurferCNN's competitive dense block, with
  ``-fmad=false`` too.
- ``meshpack``: the host STL packer ``csrc/meshpack.cpp`` (the port's own
  copy of the JAX package's record packer), compiled by ``g++``.
- ``decimate``: the host QEM edge-collapse decimator ``csrc/decimate.cpp``
  (the port's own copy of the JAX package's), compiled by ``g++``.
- ``codecs``: the host DICOM decoders ``csrc/codecs.cpp`` (lossless JPEG and
  PackBits; the port's own copy of the JAX package's), compiled by ``g++``.

Every source lies in this package: the port builds nothing from the JAX
package's tree.

Nothing is built on import.  Each library is built at first use into
``_build/`` next to this file, named by a hash of its sources and flags, so
a changed source rebuilds and an unchanged one loads the cached file.
``build_all`` starts every compiler at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Tuple

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

P, I, I64, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's CUDA kernels")


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: it builds the STL packer, the "
                           "decimator and the DICOM codecs")
    return gxx


class _Lib(NamedTuple):
    compiler: Callable[[], str]
    flags: List[str]
    sources: Tuple[Path, ...]
    # C function name -> argtypes (a function returns int unless ``returns``
    # names another type)
    functions: Dict[str, list]
    returns: Dict[str, type] = {}


LIBS: Dict[str, _Lib] = {
    "watershed_sweep": _Lib(
        _nvcc, NVCC_FLAGS, (_HERE / "csrc" / "watershed_sweep.cu",),
        {"ws_sweep": [P, P, P, I, I, I, I, I, P]}),
    "ray_projections": _Lib(
        _nvcc, NVCC_FLAGS + ["-fmad=false"],
        (_HERE / "csrc" / "ray_projections.cu",),
        {"lmip_rays": [P, P, I, I] + [I64] * 6 + [F, F, P],
         "mida_rays": [P, P, I, I] + [I64] * 12 + [P, F, F, P],
         "slab_minmax": [P, I] + [I64] * 6 + [P, P],
         "ray_workspace_bytes": []}),
    "conv_wgrad": _Lib(
        _nvcc, NVCC_FLAGS, (_HERE / "csrc" / "conv_wgrad.cu",),
        {"conv_wgrad_grid": [I, I],
         "conv_wgrad": [P, P, P, P] + [I] * 9 + [P]}),
    "cdb_epilogue": _Lib(
        _nvcc, NVCC_FLAGS + ["-fmad=false"], (_HERE / "csrc" / "cdb_epilogue.cu",),
        {"cdb_epilogue": [P, I, P, P, P, P, P, P, P, I, I64, I64, I, I, P]}),
    "meshpack": _Lib(
        _gxx, GXX_FLAGS, (_HERE / "csrc" / "meshpack.cpp",),
        {"stl_pack_mt": [P, I64, P, I64, P, I]}),
    "decimate": _Lib(
        _gxx, GXX_FLAGS, (_HERE / "csrc" / "decimate.cpp",),
        {"decimate_qem": [P, I64, P, I64, I64, P, P, P, P]}),
    "codecs": _Lib(
        _gxx, GXX_FLAGS, (_HERE / "csrc" / "codecs.cpp",),
        {"jpegll_decode": [P, I64, P, I64, P, P, P],
         "packbits_decode": [P, I64, P, I64]},
        {"packbits_decode": I64}),
}

_locks = {name: threading.Lock() for name in LIBS}
_libs: Dict[str, ctypes.CDLL] = {}
# per library: seconds the compiler took in this process (0.0 = cached) and
# its stderr (ptxas register / shared-memory report for the CUDA builds)
BUILD_LOG: Dict[str, dict] = {}


def _compile(name: str, compiler: str, flags: List[str], sources) -> Path:
    h = hashlib.sha256(" ".join([Path(compiler).name, *flags]).encode())
    for src in sources:
        h.update(Path(src).read_bytes())
    out = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        BUILD_LOG[name] = {"seconds": 0.0, "log": "cached"}
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
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
    spec = LIBS[name]
    with _locks[name]:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        lib = ctypes.CDLL(str(_compile(name, spec.compiler(), spec.flags,
                                       spec.sources)))
        for fn, argtypes in spec.functions.items():
            getattr(lib, fn).restype = spec.returns.get(fn, ctypes.c_int)
            getattr(lib, fn).argtypes = argtypes
        _libs[name] = lib
        return lib


def watershed_sweep_lib() -> ctypes.CDLL:
    return _load("watershed_sweep")


def ray_projections_lib() -> ctypes.CDLL:
    return _load("ray_projections")


def conv_wgrad_lib() -> ctypes.CDLL:
    return _load("conv_wgrad")


def cdb_epilogue_lib() -> ctypes.CDLL:
    return _load("cdb_epilogue")


def meshpack_lib() -> ctypes.CDLL:
    return _load("meshpack")


def decimate_lib() -> ctypes.CDLL:
    return _load("decimate")


def codecs_lib() -> ctypes.CDLL:
    return _load("codecs")


def build_all() -> Dict[str, dict]:
    """Build (or load from the cache) every library, all compilers started
    together; returns BUILD_LOG."""
    with ThreadPoolExecutor(max_workers=len(LIBS)) as pool:
        for fut in [pool.submit(_load, name) for name in LIBS]:
            fut.result()
    return dict(BUILD_LOG)
