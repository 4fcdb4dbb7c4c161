"""Build the CUDA kernels of ``csrc/`` and bind them with ctypes.

Every ``csrc/*.cu`` file exposes a plain C entry point (pointers, sizes
and the CUDA stream as arguments, the launch's ``cudaError_t`` as the
return value), so no PyTorch headers are involved; the ``csrc/*.cuh``
headers they include are shared device code.  One ``nvcc`` per source
compiles them all at once, in parallel, and one more links the objects
into a single shared library.  The library lands in ``_build/`` next to
this file, named by a hash of the sources, headers and flags: an edit
to any of them rebuilds it on first use, and an unchanged tree reuses
it.

Nothing here falls back: a missing ``nvcc`` or a failed compile raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

_HERE = pathlib.Path(__file__).resolve().parent
SOURCE_DIR = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I64, _I32, _F32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_float)
# entry point -> argtypes (restype is int: the cudaError_t of the launch)
_SIGNATURES = {
    # points, ids, perm, ctr, inv_scale, nodes, M, E, order, dim, iters,
    # clamp, refs, res, stream
    "mmt_newton_rows": (_P, _P, _P, _P, _P, _P, _I64, _I64, _I32, _I32,
                        _I32, _F32, _P, _P, _P),
    # ids, M, E, counts, tile_sums, n_tiles, perm, stream
    "mmt_group_rows": (_P, _I64, _I64, _P, _P, _I64, _P, _P),
    # queries, centroids, center, C, E, dim, out, stream
    "mmt_nearest_centroid": (_P, _P, _P, _I64, _I64, _I32, _P, _P),
    # points, ids, perm, ref0, ctr, inv_scale, nodes64, M, E, order, dim,
    # iters, ref_hi, ref_lo, ok, stream
    "mmt_polish_pairs": (_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I32, _I32,
                         _I32, _P, _P, _P, _P),
    # ref_hi, ref_lo, elements, perm, fields, M, E, F, order, dim, out,
    # stream
    "mmt_apply_pairs": (_P, _P, _P, _P, _P, _I64, _I64, _I32, _I32, _I32,
                        _P, _P),
    # words, R, band, out, stream
    "mmt_content_sums": (_P, _I64, _I64, _P, _P),
}

_library = None
build_log: str = ""  # nvcc/ptxas output of this process's compile


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
            "kernels of multimesh_tpu_torch cannot be built"
        )
    return path


def library_path() -> pathlib.Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*SOURCE_DIR.glob("*.cu"), *SOURCE_DIR.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmmt_kernels_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    # private temporary names, then an atomic rename: concurrent builders
    # (several test processes) never load a half-written library
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    sources = sorted(SOURCE_DIR.glob("*.cu"))
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    procs = [subprocess.Popen([nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    failed = [proc.returncode for proc in procs if proc.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc(), *NVCC_FLAGS[:2], "-shared", "-o",
                               str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        failed = [link.returncode] if link.returncode != 0 else []
    build_log = "".join(logs)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with code {failed[0]}:\n{build_log}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.mmt_group_scan_tile.argtypes = []
        lib.mmt_group_scan_tile.restype = ctypes.c_int
        lib.mmt_error_string.argtypes = [ctypes.c_int]
        lib.mmt_error_string.restype = ctypes.c_char_p
        _library = lib
    return _library


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.mmt_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
