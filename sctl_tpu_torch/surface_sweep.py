"""The two shared-surface kernels' layouts, measured side by side on one
card.

    python -m sctl_tpu_torch.surface_sweep

csrc/surface_pair.cu holds one layout (`kMaxK` boxes a warp at most,
taken in turn before the block writes its output stage) and
csrc/l2t_surface.cu one (`TPT` targets a thread).  This script builds
copies of those sources with kMaxK = 1, 2 and 4 and with TPT = 1, 2 and
4, each into its own library under sctl_tpu_torch/_build/sweep/ (one
nvcc each, all started together), prints each copy's ptxas registers,
and times the copies in turns (1 2 4 4 2 1), Laplace3D-FxU, at
chip_smoke.py's two shapes with each box's real sources and targets
drawn around the runs' means (Poisson):
- phase 4: B = 262,144 boxes (depth 6), cap_s 56, cap_t 48, ns 152
  (p = 6);
- phase 7: B = 32,768 boxes (depth 5), cap_s 344, cap_t 328, ns 296
  (p = 8);
with each copy's layout and resident blocks an SM from the occupancy
API and its largest difference from the port's own kernel on the same
inputs.  Needs a card and nvcc; the port itself never builds or reads
these copies.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys

import numpy as np
import torch

from .fmm.kifmm import cube_surface
from .ops import _build
from .ops.kernels import Laplace3D_FxU
from .ops.sl import l2t_surface, surface_pair
from .ops.uker import FORMULA

SWEEPS = {"surface_pair.cu": ("kMaxK", (1, 2, 4)),
          "l2t_surface.cu": ("TPT", (1, 2, 4))}
# (label, boxes, cap_s, cap_t, p, mean real points a box)
SHAPES = (("phase 4", 262_144, 56, 48, 6, 1e7 / 262_144),
          ("phase 7", 32_768, 344, 328, 8, 1e7 / 32_768))
LAP = FORMULA[Laplace3D_FxU.name]


def build_variants() -> dict:
    """(source, value) -> (the loaded library of that source with its
    layout constant set to the value, its Laplace3D-FxU registers)."""
    out_dir = _build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src_name, (const, values) in SWEEPS.items():
        src = (_build.SRC_DIR / src_name).read_text()
        pat = rf"constexpr int {const} = \d+;"
        if len(re.findall(pat, src)) != 1:
            raise RuntimeError(f"surface_sweep: no single `{pat}` in "
                               f"{src_name}")
        for v in values:
            stem = f"{src_name[:-3]}_{const}{v}"
            cu = out_dir / f"{stem}.cu"
            cu.write_text(re.sub(pat, f"constexpr int {const} = {v};", src))
            so = out_dir / f"lib{stem}.so"
            procs[src_name, v] = (so, subprocess.Popen(
                [_build._nvcc(), *_build._ARCH, *_build._FLAGS, "-shared",
                 "-Xptxas", "-v", f"-I{_build.SRC_DIR}", str(cu), "-o",
                 str(so)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for (src_name, v), (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"surface_sweep: nvcc failed for {src_name}"
                               f", {v}:\n{log}")
        regs = re.findall(r"_kernelILi0E(?:Li\d+E)*EEv.*?Used (\d+) "
                          r"registers", log, re.S)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _build.SIGNATURES.items():
            if hasattr(lib, name):
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = ctypes.c_int
        libs[src_name, v] = (lib, regs)
    return libs


def case(rng, B, cap_s, cap_t, p, mean):
    """Phase-shaped S2M and L2T inputs on the card: each box's real
    points its first slots, the densities zero past them."""
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                    device="cuda")
    i32 = lambda a: torch.as_tensor(a.astype(np.int32), device="cuda")
    surf = f32(cube_surface(p) * (2.95 / 2))
    cnt_s = np.minimum(rng.poisson(mean, B), cap_s)
    cnt_t = np.minimum(rng.poisson(mean, B), cap_t)
    real = (np.arange(cap_s) < cnt_s[:, None]).reshape(1, -1)
    return dict(
        surf=surf, cap_s=cap_s, cap_t=cap_t,
        pts=f32(rng.random((3, B * cap_s)) - 0.5),
        f=f32(rng.normal(size=(1, B * cap_s)) * real),
        xt=f32(rng.random((3, B * cap_t)) - 0.5),
        q=f32(rng.normal(size=(1, surf.shape[0], B))),
        cnt_s=i32(cnt_s), cnt_t=i32(cnt_t),
        pairs=(int(cnt_s.sum()) * surf.shape[0],
               int(cnt_t.sum()) * surf.shape[0]))


def run(src_name, lib, c):
    """One launch of a copy on the case -> its output."""
    ns, B = c["surf"].shape[0], c["q"].shape[2]
    stream = torch.cuda.current_stream().cuda_stream
    if src_name == "surface_pair.cu":
        out = torch.empty((1, ns, B), device="cuda")
        err = lib.sctl_surface_pair(
            c["surf"].data_ptr(), c["pts"].data_ptr(), None,
            c["f"].data_ptr(), c["cnt_s"].data_ptr(), out.data_ptr(), LAP,
            ns, B, c["cap_s"], stream)
    else:
        out = torch.empty((1, B * c["cap_t"]), device="cuda")
        err = lib.sctl_l2t_surface(
            c["surf"].data_ptr(), c["xt"].data_ptr(), c["q"].data_ptr(),
            c["cnt_t"].data_ptr(), out.data_ptr(), LAP, ns, B, c["cap_t"],
            stream)
    if err:
        raise RuntimeError(f"launch: CUDA error {err}")
    return out


def layout(src_name, lib, c) -> str:
    ns = c["surf"].shape[0]
    blocks = ctypes.c_int(0)
    if src_name == "surface_pair.cu":
        lay = (ctypes.c_int * 4)()
        err = lib.sctl_surface_pair_occupancy(LAP, 0, ns, lay,
                                              ctypes.byref(blocks))
        text = f"{lay[3]} boxes a warp, {lay[0]} surface points a lane"
    else:
        lay = (ctypes.c_int * 3)()
        err = lib.sctl_l2t_surface_occupancy(LAP, 0, ns, c["cap_t"], lay,
                                             ctypes.byref(blocks))
        text = f"{lay[1]} boxes x {lay[2]} threads a block"
    if err:
        raise RuntimeError(f"occupancy: CUDA error {err}")
    return f"{text}, {blocks.value} blocks an SM"


def ms(fn, reps=10) -> float:
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("surface_sweep: needs a CUDA device")
    libs = build_variants()
    for (src_name, v), (_, regs) in libs.items():
        print(f"{src_name} {SWEEPS[src_name][0]} = {v}: ptxas registers "
              f"of the Laplace3D-FxU instantiations {regs}", flush=True)
    rng = np.random.default_rng(0)
    for label, *shape in SHAPES:
        c = case(rng, *shape)
        refs = {"surface_pair.cu": surface_pair(
                    Laplace3D_FxU, c["surf"], c["pts"], c["f"], c["cap_s"],
                    None, c["cnt_s"]),
                "l2t_surface.cu": l2t_surface(
                    Laplace3D_FxU, c["surf"], c["xt"], c["q"], c["cap_t"],
                    c["cnt_t"])}
        for k, (src_name, (const, values)) in enumerate(SWEEPS.items()):
            times = {v: [] for v in values}
            for v in values + values[::-1]:
                lib = libs[src_name, v][0]
                times[v].append(ms(lambda: run(src_name, lib, c)))
            for v in values:
                lib = libs[src_name, v][0]
                ref = refs[src_name]
                diff = float((run(src_name, lib, c) - ref).abs().max()
                             / ref.abs().max())
                print(f"{label}, {src_name[:-3]} ({c['q'].shape[2]} boxes, "
                      f"{c['pairs'][k]} real pairs): {const} = {v}: "
                      f"{['%.4f' % t for t in times[v]]} ms, "
                      f"{layout(src_name, lib, c)}, difference from the "
                      f"port's kernel {diff:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
