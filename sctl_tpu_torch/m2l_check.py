"""A short card check of the two M2L kernels on the tensor cores.

    python -m sctl_tpu_torch.m2l_check

Builds the kernels, then runs `m2l_grid_blocked` and `m2l_grid` on
random operator stacks and grids from a seeded generator: small and
ragged shapes, the p=6 run's levels 5 and 6 (K = 1024, N = 576) and
the p=8 run's levels 4 and 5 (r = 80, r2 = 256), with the wrappers'
split of the K range into partial sums and without it (nsplit 1).  For
each: the relative max error against the plain version, against a
float64 evaluation of the same inputs beside the float32 plain
version's (and, for the blocked kernel, the 3xTF32 emulation's), and at
the real shapes the kernel's time from CUDA events; last, whether one
launch repeats bit for bit.  It prints and checks nothing else: the
card tests (tests/test_torch_kernels_cuda.py) hold the bars.  The
first call on the card after a change to csrc/m2l_tc.cuh.
"""

import subprocess
import sys
import time

import torch

from .ops import _build
from .ops.m2l import (blocked_operands, grid_operands, m2l_grid,
                      m2l_grid_blocked, m2l_grid_blocked_plain,
                      m2l_grid_blocked_tf32x3, m2l_grid_plain)

T0 = time.perf_counter()


def log(msg):
    print(f"[{time.perf_counter() - T0:7.1f}] {msg}", flush=True)


def rel(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


def ms(fn, reps=5):
    """Mean milliseconds of fn() over `reps` launches after a warm-up."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def blocked(gen, h, K, N, timeit=False, nsplit=None):
    qp = torch.zeros((h + 2,) * 3 + (K,), device="cuda")
    qp[1:-1, 1:-1, 1:-1] = torch.randn((h, h, h, K), device="cuda",
                                       generator=gen)
    mats = torch.randn((26, K, N), device="cuda", generator=gen) / K ** 0.5
    mtc = blocked_operands(mats)
    out = m2l_grid_blocked(qp, mats, mtc, nsplit=nsplit)
    torch.cuda.synchronize()
    ref = m2l_grid_blocked_plain(qp, mats)
    r64 = m2l_grid_blocked_plain(qp.double(), mats.double())
    msg = (f"blocked h={h} K={K} N={N} nsplit={nsplit}: vs plain "
           f"{rel(out, ref):.3e}, vs f64 {rel(out, r64):.3e}, plain vs f64 "
           f"{rel(ref, r64):.3e}, emu vs f64 "
           f"{rel(m2l_grid_blocked_tf32x3(qp, mats), r64):.3e}")
    if timeit:
        t_k = ms(lambda: m2l_grid_blocked(qp, mats, mtc, nsplit))
        t_p = ms(lambda: m2l_grid_blocked_plain(qp, mats), 2)
        msg += f", kernel {t_k:.3f} ms, plain {t_p:.3f} ms"
    log(msg)


def grid(gen, n, r, r2, timeit=False, nsplit=None):
    qp = torch.zeros((n + 6,) * 3 + (r2,), device="cuda")
    qp[3:-3, 3:-3, 3:-3] = torch.randn((n, n, n, r2), device="cuda",
                                       generator=gen)
    mats = torch.randn((316, r2, r), device="cuda", generator=gen) / r2 ** 0.5
    mtc = grid_operands(mats)
    out = m2l_grid(qp, mats, mtc, nsplit=nsplit)
    torch.cuda.synchronize()
    ref = m2l_grid_plain(qp, mats)
    r64 = m2l_grid_plain(qp.double(), mats.double())
    msg = (f"grid n={n} r={r} r2={r2} nsplit={nsplit}: vs plain "
           f"{rel(out, ref):.3e}, vs f64 {rel(out, r64):.3e}, plain vs f64 "
           f"{rel(ref, r64):.3e}")
    if timeit:
        msg += (f", kernel "
                f"{ms(lambda: m2l_grid(qp, mats, mtc, nsplit=nsplit)):.3f} ms")
    log(msg)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("m2l_check: no CUDA device")
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    _build.build(force=True)
    lib = _build.library()
    log(f"smem blocked {lib.sctl_m2l_grid_blocked_smem()} grid "
        f"{lib.sctl_m2l_grid_smem()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    blocked(gen, 4, 1024, 576)
    grid(gen, 4, 80, 256)
    grid(gen, 8, 80, 256)
    blocked(gen, 8, 1024, 576)
    blocked(gen, 4, 4096, 1984)
    grid(gen, 8, 72, 100)
    for h in (16, 32):
        blocked(gen, h, 1024, 576, True)
        blocked(gen, h, 1024, 576, True, nsplit=1)
    grid(gen, 16, 80, 256, True)
    grid(gen, 32, 80, 256, True)
    grid(gen, 32, 80, 256, True, nsplit=1)
    qp = torch.randn((34,) * 3 + (1024,), device="cuda", generator=gen)
    mats = torch.randn((26, 1024, 576), device="cuda", generator=gen)
    mtc = blocked_operands(mats)
    a, b = m2l_grid_blocked(qp, mats, mtc), m2l_grid_blocked(qp, mats, mtc)
    log(f"repeat bit-for-bit {torch.equal(a, b)}")


if __name__ == "__main__":
    sys.exit(main())
