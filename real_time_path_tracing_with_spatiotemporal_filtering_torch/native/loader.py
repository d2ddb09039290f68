"""ctypes binding for the native OBJ loader (objloader.cpp).

The library is built at first use with the system ``g++`` and the JAX
package's native/Makefile flags, into ``_build/`` beside the package (listed
in ``.gitignore``), under a name keyed by a hash of the source and the
flags, as ops/cuda/_build.py builds the kernels. Each process compiles to a
file of its own and moves it into place with ``os.replace``, so processes
that build at the same time each load a whole library.

There is no quiet fallback: a missing compiler or a failed build raises,
with the compiler's log. The Python parser (scene/obj.load_obj_python) runs
only when a caller asks for it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "objloader.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-shared"]

_lock = threading.Lock()
_lib = None


def _cxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the native OBJ loader cannot be built "
                           "(scene/obj.load_obj_python parses in Python)")
    return found


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libptsf_objloader_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the loader if its library is missing; returns its path."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}) building the OBJ loader:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def library():
    """The loaded library with its C ABI declared, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.ptsf_load_obj.restype = ctypes.c_void_p
            lib.ptsf_load_obj.argtypes = [ctypes.c_char_p]
            lib.ptsf_mesh_counts.restype = None
            lib.ptsf_mesh_counts.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.ptsf_mesh_copy.restype = None
            lib.ptsf_mesh_copy.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.ptsf_mesh_free.restype = None
            lib.ptsf_mesh_free.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


def load_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(vertices (V, 3) float32, indices (T, 3) int32) of the OBJ file at
    ``path``; raises FileNotFoundError on a missing file and ValueError
    on a face index out of range."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"OBJ file not found: {path!r}")
    lib = library()
    handle = lib.ptsf_load_obj(path.encode())
    if not handle:
        raise ValueError(f"native loader failed to parse {path!r}")
    try:
        nv = ctypes.c_int64()
        nt = ctypes.c_int64()
        lib.ptsf_mesh_counts(handle, ctypes.byref(nv), ctypes.byref(nt))
        verts = np.empty((nv.value, 3), np.float32)
        idx = np.empty((nt.value, 3), np.int32)
        lib.ptsf_mesh_copy(
            handle,
            verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return verts, idx
    finally:
        lib.ptsf_mesh_free(handle)
