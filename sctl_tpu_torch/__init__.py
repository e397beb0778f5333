"""sctl_tpu_torch: the PyTorch / CUDA (NVIDIA Hopper) port of sctl_tpu.

The first slice holds the uniform-tree Laplace KIFMM: the kernel
layer, direct sums, the uniform Morton tree, the KIFMM operators,
setup and evaluation, and the `ParticleFMM` facade.  The second holds
the Stokes BIE solve: the Stokes kernels, the adaptive-tree FMM, the
patch geometry and device near quadrature, the boundary integral
operator and GMRES.  The third holds `ParticleFMM` over all eight
kernels: the direct sum and the uniform KIFMM for the six kernels with
a tree path.  Later slices hold `ParticleFMM(accuracy=8)`, the Krylov
layer (`linalg`: the host and device GMRES, Krylov recycling, flexible
and longdouble GMRES), `ParticleFMM.eval_tensor`, the BIE solve in
float64 on the card, the KIFMM in float64 on the card, the rest of the
single-device BIE layer (the host near path, the near cache, the
legacy quadrature), the spectral layer (`linalg`: spherical harmonic
transforms and the Stokes potentials on the sphere, the SDC
integrator, the FFT facade, Chebyshev bases, quadrature rules and
Lagrange interpolation; `quadmath`, double-double arithmetic;
`mathutils`; `tree.vtu`, the VTK writer), and the rest of the
single-device library: `profile` (Tic/Toc blocks, counters and the
report, wired through the FMMs, the BIE operator, GMRES and `p2p`),
`containers` (Vector, Matrix, Permutation, Tensor and the array
files), `utils` (`par`, `debug`, `checkpoint`), `native` (the C++ host
runtime: Morton keys and radix sorts), the full `tree.morton` and
`tree.tree` API in 2-D and 3-D, and `fmm.KIFMMLd` (the longdouble host
KIFMM); and the distributed FMM layer: `comm` (`Comm` over a
`torch.distributed` group, the data-movement verbs, `run_ranks`),
`tree.DistPtTree`, `fmm.KIFMMDist` (slab-sharded), the ring direct sum
`ParticleFMM.eval_direct_ring`, `AdaptiveFMM.eval_sharded`, and GMRES
and SDC over a comm.  Every TPU kernel on these paths is hand-written
CUDA under `csrc/`; the spectral layer's products and FFTs are torch's
batched GEMMs and `torch.fft`.
"""

from . import config, mathutils, quadmath
from .config import set_precision
from .containers import (Matrix, Permutation, Tensor, Vector, read_array,
                         write_array)
from .profile import Profile

__all__ = ["config", "quadmath", "mathutils", "Profile", "Vector",
           "Matrix", "Permutation", "Tensor", "write_array", "read_array"]

set_precision()
