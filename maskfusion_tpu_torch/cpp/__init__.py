"""The native host library ``mfcore`` (``mfcore.cpp``), bound with ctypes.

Port of ``maskfusion_tpu/cpp/__init__.py``: the same C functions with the same
signatures.  No binary is kept in the repository: ``build()`` compiles
``mfcore.cpp`` with g++ into ``build/mfcore/`` at the repository root, named
by a hash of the source, the flags and the host's ``-march=native`` target,
at first use and atomically (concurrent builds agree).  A failed build raises
with the compiler's output.  The sparse Cholesky (``mf_chol_*``) is compiled
only where Eigen's headers are found (``has_chol``).

The segmenter and the engine take the native path by default.  Inside
``with disabled():`` ``active()`` returns None and they take their numpy /
scipy versions, the plain references the tests hold the native path to.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "mfcore.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mfcore"
_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]
_EIGEN_DIR = Path("/usr/include/eigen3")

_lib: Optional[ctypes.CDLL] = None
_disabled = False


def _cxx() -> str:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("g++ not found: mfcore needs a C++17 compiler")
    return cxx


def _flags() -> list:
    if (_EIGEN_DIR / "Eigen" / "Sparse").exists():
        return _FLAGS + ["-DMF_HAVE_EIGEN", f"-I{_EIGEN_DIR}"]
    return list(_FLAGS)


def library_path() -> Path:
    """build/mfcore/libmfcore_<hash>.so: a library built for another host's
    -march=native never loads here."""
    target = subprocess.run(
        [_cxx(), "-march=native", "-Q", "--help=target"],
        capture_output=True, text=True, check=True).stdout
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_flags()).encode())
    h.update(target.encode())
    return _BUILD_DIR / f"libmfcore_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile mfcore.cpp (if not built yet); raises with the compiler's
    output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        tmp_so = Path(tmp) / out.name
        res = subprocess.run(
            [_cxx(), *_flags(), "-o", str(tmp_so), str(_SRC), "-lz"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building {_SRC.name} failed:\n{res.stdout}")
        os.replace(tmp_so, out)
    return out


def load() -> ctypes.CDLL:
    """The library, built at first use, with every function's signature."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")

    lib.mf_connected_components.restype = ctypes.c_int32
    lib.mf_connected_components.argtypes = [
        u8p, ctypes.c_int32, ctypes.c_int32, i32p, i32p, i32p, ctypes.c_int32]
    lib.mf_reassign_edges.restype = None
    lib.mf_reassign_edges.argtypes = [
        i32p, f32p, i32p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_float, ctypes.c_int32]
    lib.mf_label_stats.restype = None
    lib.mf_label_stats.argtypes = [
        i32p, u8p, i32p, u8p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, i32p, i32p]
    lib.mf_model_seg_overlap.restype = None
    lib.mf_model_seg_overlap.argtypes = [
        u8p, u8p, i32p, ctypes.c_int64, i32p]
    lib.mf_depth_moments.restype = None
    lib.mf_depth_moments.argtypes = [
        u8p, f32p, ctypes.c_int64, i64p, f64p, f64p]
    lib.mf_u8_bboxes.restype = None
    lib.mf_u8_bboxes.argtypes = [u8p, ctypes.c_int32, ctypes.c_int32, i32p]
    lib.mf_inflate.restype = ctypes.c_int64
    lib.mf_inflate.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    lib.mf_depth_mm_to_m.restype = None
    lib.mf_depth_mm_to_m.argtypes = [u16p, f32p, ctypes.c_int64]
    # sparse Cholesky (compiled only when Eigen's headers were found)
    try:
        lib.mf_chol_create.restype = ctypes.c_void_p
        lib.mf_chol_create.argtypes = [ctypes.c_int32, i32p, i32p, f32p]
        lib.mf_chol_refactor.restype = ctypes.c_int32
        lib.mf_chol_refactor.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, i32p, i32p, f32p]
        lib.mf_chol_solve.restype = ctypes.c_int32
        lib.mf_chol_solve.argtypes = [ctypes.c_void_p, f32p, f32p]
        lib.mf_chol_destroy.restype = None
        lib.mf_chol_destroy.argtypes = [ctypes.c_void_p]
        lib.has_chol = True
    except AttributeError:
        lib.has_chol = False
    _lib = lib
    return _lib


def active() -> Optional[ctypes.CDLL]:
    """The library for the callers' native paths; None inside
    ``disabled()``, where they take their numpy versions."""
    return None if _disabled else load()


@contextlib.contextmanager
def disabled(off: bool = True):
    """Run the block on the numpy / scipy versions of every native call
    (the plain references; process-wide); ``disabled(False)`` turns the
    native paths back on inside an outer ``disabled()``."""
    global _disabled
    saved, _disabled = _disabled, off
    try:
        yield
    finally:
        _disabled = saved
