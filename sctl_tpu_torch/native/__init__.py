"""ctypes bindings of the native host runtime (sctl_native.cpp; the
counterpart of sctl_tpu/native/__init__.py).

The library is built with g++ (OpenMP) at first use into
`sctl_tpu_torch/_build/`, and rebuilt when the source is newer.  Each
entry point has a numpy plain version (`*_plain`), which runs where no
g++ is found, as in the JAX package; where g++ is found, a failed build
raises instead of falling back.  `available()` says which path runs.
Both paths give the same bits: the radix sorts are stable, as numpy's
stable argsort.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "sctl_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_SO = BUILD_DIR / "libsctl_native.so"
_lib = None


def build(force: bool = False) -> Path:
    """Compile sctl_native.cpp into the shared library (unless it is
    newer than the source) and return its path; raise with the
    compiler's output when g++ is missing or fails."""
    if (not force and _SO.exists()
            and _SO.stat().st_mtime >= _SRC.stat().st_mtime):
        return _SO
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native runtime is not built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_so = Path(tmp) / _SO.name
        run = subprocess.run(
            [gxx, "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
             "-std=c++17", str(_SRC), "-o", str(tmp_so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            timeout=300)
        if run.returncode:
            raise RuntimeError("g++ failed on sctl_native.cpp:\n" + run.stdout)
        os.replace(tmp_so, _SO)
    return _SO


def get_lib():
    """The loaded library, built at first use; None where there is no
    g++ (the numpy plain versions run)."""
    global _lib
    if _lib is not None:
        return _lib
    if shutil.which("g++") is None and not _SO.exists():
        return None
    lib = ctypes.CDLL(str(build()))
    dbl, u64 = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint64)
    i64 = ctypes.POINTER(ctypes.c_int64)
    lib.morton_encode_3d.argtypes = [dbl, ctypes.c_int64, ctypes.c_int, u64]
    lib.morton_encode_2d.argtypes = lib.morton_encode_3d.argtypes
    lib.sort_keys_u64.argtypes = [u64, i64, ctypes.c_int64]
    lib.box_counts.argtypes = [i64, ctypes.c_int64, ctypes.c_int64, i64]
    lib.sort_small_keys.argtypes = [i64, ctypes.c_int64, ctypes.c_int, i64,
                                    i64]
    _lib = lib
    return _lib


def available() -> bool:
    """True when the entry points run the native library (built here if
    needed), False when they run their numpy plain versions."""
    return get_lib() is not None


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def morton_encode_plain(coords: np.ndarray, depth: int) -> np.ndarray:
    """Plain version of `morton_encode`: the keys at the maximum depth
    with the bits below `depth` cleared."""
    from ..tree import morton as mt
    coords = np.ascontiguousarray(coords, dtype=np.float64)
    return mt.morton_encode(coords, depth=depth, dim=coords.shape[1])


def morton_encode(coords: np.ndarray, depth: int) -> np.ndarray:
    """Morton keys (uint64, at the maximum depth's bit positions) of
    (n, dim) coordinates in [0, 1) at `depth` bits a dimension,
    OpenMP-parallel."""
    coords = np.ascontiguousarray(coords, dtype=np.float64)
    n, dim = coords.shape
    lib = get_lib()
    if lib is None:
        return morton_encode_plain(coords, depth)
    out = np.empty(n, dtype=np.uint64)
    fn = lib.morton_encode_3d if dim == 3 else lib.morton_encode_2d
    fn(_ptr(coords, ctypes.c_double), n, depth, _ptr(out, ctypes.c_uint64))
    return out


def argsort_u64_plain(keys: np.ndarray):
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    perm = np.argsort(keys, kind="stable")
    return keys[perm], perm


def argsort_u64(keys: np.ndarray):
    """Stable parallel radix sort of uint64 keys -> (sorted keys,
    permutation)."""
    lib = get_lib()
    if lib is None:
        return argsort_u64_plain(keys)
    keys = np.ascontiguousarray(keys, dtype=np.uint64).copy()
    perm = np.empty(len(keys), dtype=np.int64)
    lib.sort_keys_u64(_ptr(keys, ctypes.c_uint64),
                      _ptr(perm, ctypes.c_int64), len(keys))
    return keys, perm


def argsort_small_plain(keys: np.ndarray, key_bits: int):
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    perm = np.argsort(keys, kind="stable")
    return keys[perm], perm


def argsort_small(keys: np.ndarray, key_bits: int):
    """Stable sort of int64 keys below 2^key_bits (key_bits <= 24)
    carrying their indices -> (sorted keys, permutation): the uniform
    tree's sort of box ids."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    n = len(keys)
    lib = get_lib()
    if lib is None or key_bits > 24 or n >= (1 << 40):
        return argsort_small_plain(keys, key_bits)
    perm = np.empty(n, dtype=np.int64)
    out = np.empty(n, dtype=np.int64)
    lib.sort_small_keys(_ptr(keys, ctypes.c_int64), n, key_bits,
                        _ptr(perm, ctypes.c_int64), _ptr(out, ctypes.c_int64))
    return out, perm


def box_counts_plain(sorted_box_ids: np.ndarray, n_boxes: int) -> np.ndarray:
    ids = np.ascontiguousarray(sorted_box_ids, dtype=np.int64)
    ids = ids[(ids >= 0) & (ids < n_boxes)]
    return np.bincount(ids, minlength=n_boxes)[:n_boxes]


def box_counts(sorted_box_ids: np.ndarray, n_boxes: int) -> np.ndarray:
    """counts[b] = number of ids equal to b, for b in [0, n_boxes); ids
    outside are not counted."""
    lib = get_lib()
    if lib is None:
        return box_counts_plain(sorted_box_ids, n_boxes)
    ids = np.ascontiguousarray(sorted_box_ids, dtype=np.int64)
    out = np.empty(n_boxes, dtype=np.int64)
    lib.box_counts(_ptr(ids, ctypes.c_int64), len(ids), n_boxes,
                   _ptr(out, ctypes.c_int64))
    return out
