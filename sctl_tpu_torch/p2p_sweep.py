"""The layouts of two pair kernels, measured side by side on one card.

    python -m sctl_tpu_torch.p2p_sweep

csrc/p2p_direct.cu holds one layout (`R` targets a thread) and
csrc/p2p_stencil9.cu one (`S` lanes a target).  This script builds
copies of those sources with R = 1, 2 and 4 and with S = 1 and 2, each
into its own library under sctl_tpu_torch/_build/sweep/ (one nvcc each,
all started together), prints each copy's ptxas registers, and times
the copies in turns (1 2 4 4 2 1) at chip_smoke.py's shapes:
- the direct sum: the float64 Stokes3D-FxU oracle (1,000 targets x 1e7
  sources) and the float32 Stokes3D-FxU case (4,096 x 39,000);
- the slab stencil: Laplace3D-FxU at phase 4's widths (n = 64, cap_s 56,
  cap_t 48, SL 512) with each box's real sources and targets drawn
  around 1e7 / 64^3 points (Poisson), the slab compacted by the counts
  as KIFMM lays it out;
with the resident blocks an SM from the occupancy API and each copy's
largest difference from the port's own kernel on the same inputs.
Needs a card and nvcc; the port itself never builds or reads these
copies.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys

import numpy as np
import torch

from .ops import _build
from .ops._launch_checks import n_sms
from .ops.kernels import Laplace3D_FxU, Stokes3D_FxU
from .ops.p2p import p2p, p2p_grid, p2p_stencil9, slab_gather, slab_index
from .ops.uker import FORMULA

SWEEPS = {"p2p_direct.cu": ("R", (1, 2, 4)),
          "p2p_stencil9.cu": ("S", (1, 2))}
DIRECT = {"f64 oracle": (torch.float64, 1000, 10_000_000),
          "f32 case": (torch.float32, 4096, 39_000)}
# phase 4's slab stencil: depth 6, 1e7 points
N, CAP_S, CAP_T, MEAN = 64, 56, 48, 1e7 / 64 ** 3


def build_variants() -> dict:
    """(source, value) -> the loaded library of that source with its
    layout constant set to the value."""
    out_dir = _build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src_name, (const, values) in SWEEPS.items():
        src = (_build.SRC_DIR / src_name).read_text()
        pat = rf"constexpr int {const} = \d+;"
        if len(re.findall(pat, src)) != 1:
            raise RuntimeError(f"p2p_sweep: no single `{pat}` in {src_name}")
        for v in values:
            stem = f"{src_name[:-3]}_{const}{v}"
            cu = out_dir / f"{stem}.cu"
            cu.write_text(re.sub(pat, f"constexpr int {const} = {v};", src))
            procs[src_name, v] = (out_dir / f"lib{stem}.so", subprocess.Popen(
                [_build._nvcc(), *_build._ARCH, *_build._FLAGS, "-shared",
                 "-Xptxas", "-v", f"-I{_build.SRC_DIR}", str(cu), "-o",
                 str(out_dir / f"lib{stem}.so")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (src_name, v), (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"p2p_sweep: nvcc failed for {src_name}, "
                               f"{v}:\n{log}")
        print(f"{src_name} {SWEEPS[src_name][0]} = {v}: ptxas registers "
              f"{_registers(log)}", flush=True)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _build.SIGNATURES.items():
            if hasattr(lib, name):
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = ctypes.c_int
        libs[src_name, v] = lib
    return libs


def _registers(log: str) -> dict:
    """Mangled-name tag -> ptxas registers, for the float32 and float64
    Stokes3D-FxU direct sums and the Laplace3D-FxU slab stencil."""
    tags = ("p2p_direct_kernelIfLi3E", "p2p_direct_kernelIdLi3E",
            "p2p_stencil9_kernelILi0E")
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = next((t for t in tags if t in m.group(1)), None)
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur:
            out[cur] = int(m.group(1))
            cur = None
    return out


def _blocks(fn, *args) -> int:
    blocks = ctypes.c_int(0)
    err = fn(*args, ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"occupancy: CUDA error {err}")
    return blocks.value


def run_direct(lib, dt, xt, xs, f):
    """One launch of a direct-sum copy on the port's grid rule ->
    (the summed splits, its layout)."""
    lay = (ctypes.c_int * 3)()
    f64 = dt == torch.float64
    ker = FORMULA[Stokes3D_FxU.name]
    blocks = _blocks(lib.sctl_p2p_direct_occupancy, ker, int(f64), lay)
    T, S = xt.shape[0], xs.shape[0]
    nsplit, chunk = p2p_grid(T, S, lay[0] * lay[1], lay[2],
                             blocks * n_sms(xt.device))
    part = torch.empty((nsplit, T, 3), dtype=dt, device=xt.device)
    fn = lib.sctl_p2p_direct_f64 if f64 else lib.sctl_p2p_direct_f32
    err = fn(xt.data_ptr(), xs.data_ptr(), None, f.data_ptr(),
             part.data_ptr(), ker, T, S, nsplit, chunk,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch: CUDA error {err}")
    return part.sum(0), f"{blocks} blocks an SM, {nsplit} source splits"


def run_stencil9(lib, args):
    """One launch of a slab-stencil copy -> (output, its layout)."""
    _, n, SL, cap_t, xt, xs, f, _, cnt9, cnt_t = args
    ker = FORMULA[Laplace3D_FxU.name]
    out = torch.empty((n, n, n, cap_t, 1), device=xt.device)
    err = lib.sctl_p2p_stencil9(
        xt.data_ptr(), xs.data_ptr(), None, f.data_ptr(), cnt9.data_ptr(),
        cnt_t.data_ptr(), out.data_ptr(), ker, n, SL, cap_t,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch: CUDA error {err}")
    lay = (ctypes.c_int * 2)()
    blocks = _blocks(lib.sctl_p2p_stencil9_occupancy, ker, 0, SL, cap_t,
                     lay)
    return out, f"{lay[1]} threads a block, {blocks} blocks an SM"


def stencil9_case(rng):
    """Phase 4's widths with Poisson counts, on the card: the arguments
    of `p2p_stencil9`."""
    n, B = N, N ** 3
    SL = -(-9 * CAP_S // 128) * 128
    cnt_s = np.minimum(rng.poisson(MEAN, B), CAP_S)
    cnt_t = np.minimum(rng.poisson(MEAN, B), CAP_T)
    lo = np.stack(np.meshgrid(*([np.arange(n)] * 3), indexing="ij"),
                  -1).reshape(-1, 1, 3)
    dev = "cuda"
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                    device=dev)
    cnt = lambda c: torch.as_tensor(c.reshape(n, n, n).astype(np.int32),
                                    device=dev)
    idx, cnt9 = slab_index(torch.arange(B, device=dev), n, CAP_S, SL,
                           cnt(cnt_s))
    xs = slab_gather(f32((lo + rng.random((B, CAP_S, 3))) / n), idx)
    f = slab_gather(f32(rng.normal(size=(B, CAP_S, 1))), idx)
    xt = f32(((lo + rng.random((B, CAP_T, 3))) / n).reshape(
        n, n, n, CAP_T, 3).transpose(0, 1, 2, 4, 3))
    return (Laplace3D_FxU, n, SL, CAP_T, xt, xs, f, None, cnt9, cnt(cnt_t))


def _ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def sweep(label, values, run, ref, reps):
    """Time run(v) for each v in turns (v..., reversed), then print each
    with its layout and its largest difference from `ref`."""
    times = {v: [] for v in values}
    for v in values + values[::-1]:
        times[v].append(_ms(lambda: run(v), reps))
    for v in values:
        out, lay = run(v)
        diff = float((out - ref).abs().max() / ref.abs().max())
        print(f"{label}: {v}: {' '.join(f'{t:.4f}' for t in times[v])} ms, "
              f"{lay}, max rel difference from the port's kernel "
              f"{diff:.3e}", flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("p2p_sweep: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    libs = build_variants()
    rng = np.random.default_rng(0)
    for label, (dt, T, S) in DIRECT.items():
        xs = torch.as_tensor(rng.random((S, 3)), dtype=dt, device="cuda")
        f = torch.as_tensor(rng.normal(size=(S, 3)), dtype=dt,
                            device="cuda")
        xt = xs[:T].contiguous()
        sweep(f"p2p {label} ({T} x {S}), R targets a thread",
              SWEEPS["p2p_direct.cu"][1],
              lambda v: run_direct(libs["p2p_direct.cu", v], dt, xt, xs, f),
              p2p(Stokes3D_FxU, xt, xs, None, f),
              3 if dt == torch.float64 else 20)
        del xs, f, xt
    args = stencil9_case(rng)
    sweep(f"p2p_stencil9 phase 4 widths ({int(args[8].sum())} real slab "
          f"slots), S lanes a target", SWEEPS["p2p_stencil9.cu"][1],
          lambda v: run_stencil9(libs["p2p_stencil9.cu", v], args),
          p2p_stencil9(*args), 5)
    return 0


if __name__ == "__main__":
    sys.exit(main())
