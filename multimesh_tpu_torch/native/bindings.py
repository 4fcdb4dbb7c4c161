"""ctypes bindings for the native host runtime (``native/src/mmt_native.cpp``).

The JAX package's ``native/bindings.py`` over the same C++ source, with
the same functions.  The library is built here at first use, with
``g++ -O3 -fPIC -fopenmp -std=c++17`` (no ``-march=native``: the
library runs on the host that builds it; no ``-fopenmp`` where the
compiler cannot link OpenMP, and then the source's ``#pragma omp`` loops
run serially with the same results), into ``_build/`` next to this
package, named by a hash of the source and the flags; ``MMT_NATIVE_LIB``
names a library to load instead.  All functions are batched and operate
on contiguous float64/int64 numpy arrays.  The runtime is a host-side
validation oracle: nothing on the card's path calls it, and nothing
falls back to it.
"""
from __future__ import annotations

import ctypes as C
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np

_cache: list = []

SOURCE = (pathlib.Path(__file__).resolve().parents[2] / "native" / "src"
          / "mmt_native.cpp")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
OPENMP_FLAG = "-fopenmp"

_F64_1 = np.ctypeslib.ndpointer(np.float64, ndim=1, flags="C_CONTIGUOUS")
_F64_2 = np.ctypeslib.ndpointer(np.float64, ndim=2, flags="C_CONTIGUOUS")
_F64_3 = np.ctypeslib.ndpointer(np.float64, ndim=3, flags="C_CONTIGUOUS")
_I64_1 = np.ctypeslib.ndpointer(np.int64, ndim=1, flags="C_CONTIGUOUS")
_I64_2 = np.ctypeslib.ndpointer(np.int64, ndim=2, flags="C_CONTIGUOUS")
_U8_1 = np.ctypeslib.ndpointer(np.uint8, ndim=1, flags="C_CONTIGUOUS")


def _env_lib() -> pathlib.Path | None:
    env = os.environ.get("MMT_NATIVE_LIB")
    if not env:
        return None
    if not os.path.exists(env):
        # an explicitly requested library must not silently fall back to
        # a built one (the user would validate against the wrong binary)
        raise FileNotFoundError(f"MMT_NATIVE_LIB={env!r} does not exist")
    return pathlib.Path(env)


def _cxx() -> str | None:
    return shutil.which(os.environ.get("CXX", "g++"))


@functools.lru_cache(maxsize=None)
def _openmp(cxx: str) -> bool:
    """Whether ``cxx`` compiles and links ``-fopenmp`` code on this host
    (a toolchain may ship without libgomp)."""
    BUILD_DIR.mkdir(exist_ok=True)
    probe = BUILD_DIR / f"openmp_probe.{os.getpid()}.so"
    proc = subprocess.run([cxx, OPENMP_FLAG, *CXX_FLAGS, "-x", "c++", "-",
                           "-o", str(probe)],
                          input="int probe() { return 0; }",
                          capture_output=True, text=True)
    probe.unlink(missing_ok=True)
    return proc.returncode == 0


def flags() -> tuple:
    """The compiler flags of the library on this host."""
    cxx = _cxx()
    return (*CXX_FLAGS, OPENMP_FLAG) if cxx and _openmp(cxx) else CXX_FLAGS


def library_path() -> pathlib.Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(flags()).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmmt_native_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the source unless the library for it exists; a private
    temporary name, then an atomic rename, so that processes building it
    at once never load a half-written library.  A failed compile
    raises."""
    out = library_path()
    if out.exists():
        return out
    cxx = _cxx()
    if cxx is None:
        raise FileNotFoundError("no C++ compiler (set CXX or install g++)")
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *flags(), "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed with code {proc.returncode}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def available() -> bool:
    """True when ``MMT_NATIVE_LIB`` names a library, or the source and a
    C++ compiler to build it are here."""
    return _env_lib() is not None or (SOURCE.exists()
                                      and _cxx() is not None)


def load():
    if _cache:
        return _cache[0]
    lib = C.CDLL(str(_env_lib() or build()))

    lib.mmt_centroids.restype = None
    lib.mmt_centroids.argtypes = [
        C.c_int64, C.c_int64, C.c_int64, _I64_2, _F64_2, _F64_2,
    ]
    lib.mmt_gll_basis.restype = None
    lib.mmt_gll_basis.argtypes = [
        C.c_int64, C.c_int32, C.c_int32, _F64_2, _F64_2,
    ]
    lib.mmt_inverse_map.restype = None
    lib.mmt_inverse_map.argtypes = [
        C.c_int64, C.c_int32, C.c_int32, _F64_3, _F64_2, C.c_int32,
        C.c_double, _F64_2, _U8_1,
    ]
    lib.mmt_locate.restype = C.c_int64
    lib.mmt_locate.argtypes = [
        C.c_int64, C.c_int64, C.c_int64, C.c_int32, C.c_int32, _F64_2,
        _I64_2, _F64_3, C.c_double, C.c_int32, C.c_double, C.c_double,
        C.c_int32, C.c_double, _I64_1, _F64_2, _F64_2,
    ]
    _cache.append(lib)
    return lib


def centroids(connectivity: np.ndarray, points: np.ndarray) -> np.ndarray:
    lib = load()
    conn = np.ascontiguousarray(connectivity, np.int64)
    pts = np.ascontiguousarray(points, np.float64)
    out = np.empty((conn.shape[0], pts.shape[1]))
    lib.mmt_centroids(conn.shape[0], conn.shape[1], pts.shape[1], conn,
                      pts, out)
    return out


# the C runtime's Basis1D uses fixed stack storage (kMaxOrder = 8 in
# native/src/mmt_native.cpp); out-of-range orders must fail loudly here,
# never reach the kernels
_MAX_ORDER = 8


def _check_order(order: int):
    if not 1 <= int(order) <= _MAX_ORDER:
        raise ValueError(
            f"order must be in [1, {_MAX_ORDER}], got {order}"
        )


def gll_basis(order: int, ref: np.ndarray) -> np.ndarray:
    _check_order(order)
    lib = load()
    ref = np.ascontiguousarray(ref, np.float64)
    n, dim = ref.shape
    out = np.empty((n, (order + 1) ** dim))
    lib.mmt_gll_basis(n, order, dim, ref, out)
    return out


def inverse_map(
    elem_nodes: np.ndarray,
    points: np.ndarray,
    order: int,
    max_iter: int = 50,
    rtol: float = 1e-12,
):
    _check_order(order)
    lib = load()
    nodes = np.ascontiguousarray(elem_nodes, np.float64)
    pts = np.ascontiguousarray(points, np.float64)
    n, dim = pts.shape
    # the C kernels index without bounds checks: mismatched shapes must
    # fail loudly here, not as OOB reads
    if nodes.shape[0] != n:
        raise ValueError(
            f"elem_nodes has {nodes.shape[0]} rows for {n} points"
        )
    if nodes.shape[1] != (order + 1) ** dim:
        raise ValueError(
            f"elem_nodes has {nodes.shape[1]} nodes/element, expected "
            f"{(order + 1) ** dim} for order {order} in {dim}D"
        )
    refs = np.empty((n, dim))
    conv = np.empty(n, np.uint8)
    lib.mmt_inverse_map(n, order, dim, nodes, pts, max_iter, rtol, refs,
                        conv)
    return refs, conv.astype(bool)


_FALLBACK_MODES = {"sentinel": 0, "snap": 1, "best": 2}


def locate(
    points: np.ndarray,
    candidates: np.ndarray,
    all_nodes: np.ndarray,
    order: int,
    accept_tol: float = 1.05,
    fallback: str = "sentinel",
    snap_clip: float = 1.02,
    fallback_max: float = 1.5,
    max_iter: int = 50,
    rtol: float = 1e-12,
):
    """Candidate-scan locate; returns (elements, refs, weights, n_failed)."""
    _check_order(order)
    lib = load()
    pts = np.ascontiguousarray(points, np.float64)
    cand = np.ascontiguousarray(candidates, np.int64)
    nodes = np.ascontiguousarray(all_nodes, np.float64)
    n, dim = pts.shape
    nn = (order + 1) ** dim
    # the C kernel indexes all_nodes by candidate id without bounds
    # checks: validate here so bad inputs raise instead of reading OOB
    if nodes.shape[1] != nn:
        raise ValueError(
            f"all_nodes has {nodes.shape[1]} nodes/element, expected "
            f"{nn} for order {order} in {dim}D"
        )
    if cand.shape[0] != n:
        raise ValueError(
            f"candidates has {cand.shape[0]} rows for {n} points"
        )
    if cand.size and (cand.min() < 0 or cand.max() >= nodes.shape[0]):
        raise ValueError(
            f"candidate ids outside [0, {nodes.shape[0]})"
        )
    elements = np.empty(n, np.int64)
    refs = np.empty((n, dim))
    weights = np.empty((n, nn))
    failed = lib.mmt_locate(
        n, cand.shape[1], nodes.shape[0], order, dim, pts, cand, nodes,
        accept_tol, _FALLBACK_MODES[fallback], snap_clip, fallback_max,
        max_iter, rtol, elements, refs, weights,
    )
    return elements, refs, weights, int(failed)
