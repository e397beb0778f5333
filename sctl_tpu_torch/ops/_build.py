"""Build and load the port's CUDA kernels.

The sources under `sctl_tpu_torch/csrc/` have a plain C interface (no
PyTorch headers), so each compiles in seconds.  At first use one
`nvcc -c` per `*.cu` file, all started together, compiles them for
`sm_90a`, and one more links the objects into
`sctl_tpu_torch/_build/libsctl_kernels.so`, which is loaded with
ctypes.  The library is rebuilt when a source is newer than it.

A missing `nvcc` or a failed build raises: there is no other path for a
CUDA tensor.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "libsctl_kernels.so"

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signature of every exported launcher: pointers, ints, then the
# stream; each returns a cudaError_t as int.  The two `_smem` queries
# take nothing, the `_occupancy` queries no stream.  The pair kernels
# take the formula index of csrc/ukernels.cuh (ops/uker.py FORMULA)
# first among the ints; each has a float32 and a float64 build (`_f64`,
# or `_f32` and `_f64` for the direct sum) of one signature, and its
# occupancy query takes the formula and 1 for the float64 build.
_SURFACE = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
_L2T = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
_STENCIL = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
_ULIST = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
_DIRECT = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
SIGNATURES = {
    "sctl_surface_pair": _SURFACE,
    "sctl_surface_pair_f64": _SURFACE,
    "sctl_l2t_surface": _L2T,
    "sctl_l2t_surface_f64": _L2T,
    "sctl_m2l_grid_blocked": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "sctl_m2l_grid": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "sctl_p2p_stencil": _STENCIL,
    "sctl_p2p_stencil_f64": _STENCIL,
    "sctl_p2p_stencil9": _STENCIL,
    "sctl_p2p_stencil9_f64": _STENCIL,
    "sctl_p2p_ulist": _ULIST,
    "sctl_p2p_ulist_f64": _ULIST,
    "sctl_p2p_direct_f32": _DIRECT,
    "sctl_p2p_direct_f64": _DIRECT,
    # no stream: the dynamic shared memory of a block, in bytes; the
    # pair kernels' resident blocks an SM, into the last pointer
    "sctl_m2l_grid_blocked_smem": [],
    "sctl_m2l_grid_smem": [],
    "sctl_p2p_stencil9_occupancy": [_I, _I, _I, _I, _P, _P],
    "sctl_p2p_direct_occupancy": [_I, _I, _P, _P],
    "sctl_surface_pair_occupancy": [_I, _I, _I, _P, _P],
    "sctl_l2t_surface_occupancy": [_I, _I, _I, _I, _P, _P],
}

_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "sctl_tpu_torch are built on the card's host")
    return path


def _ptxas_summary(log: str) -> list:
    """The -Xptxas -v lines that name a kernel, its registers, shared
    memory and spills, and any note on its wgmma pipeline."""
    keep = re.compile(r"Compiling entry|Used \d+ registers|spill|wgmma")
    return [ln.strip() for ln in log.splitlines() if keep.search(ln)]


def build(force: bool = False) -> Path:
    """Compile csrc/*.cu, one nvcc each in parallel, and link them
    into the shared library; returns its path."""
    sources = sorted(SRC_DIR.glob("*.cu"))
    deps = sources + sorted(SRC_DIR.glob("*.cuh"))
    out = BUILD_DIR / LIB_NAME
    newest = max(p.stat().st_mtime for p in deps)
    if not force and out.exists() and out.stat().st_mtime >= newest:
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources]
        procs = [subprocess.Popen(
            [nvcc, *_ARCH, *_FLAGS, "-c", "-Xptxas", "-v", str(src), "-o",
             str(obj)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for src, obj in zip(sources, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [(src.name, log) for src, p, log in zip(sources, procs, logs)
                  if p.returncode]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name}:\n{log}" for name, log in failed))
        tmp_so = Path(tmp) / LIB_NAME
        run = subprocess.run(
            [nvcc, *_ARCH, "-shared", *map(str, objs), "-o", str(tmp_so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if run.returncode:
            raise RuntimeError("nvcc link failed:\n" + run.stdout)
        os.replace(tmp_so, out)
    secs = time.perf_counter() - t0
    print(f"[sctl_tpu_torch build] {len(sources)} sources in parallel, "
          f"{secs:.1f} s wall", flush=True)
    for ln in _ptxas_summary("\n".join(logs)):
        print(f"[sctl_tpu_torch ptxas] {ln}", flush=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Call a launcher on the current stream; raise on a CUDA error."""
    import torch
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), name)(*args, stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")
