// S2M check potentials: every box's source slots paired with the
// shared upward-check surface.
//
// Replaces: sctl_tpu/ops/pallas_sl.py `surface_pair` (pl.pallas_call at
// :254).  out[j, m, b] = sum_s K(surf[m] - pts[:, b*cap + s]) f[:, b*cap
// + s] (component j < k1, unscaled, box-local coordinates), for the S2M
// kernels Laplace3D-FxU and -DxU and Stokes3D-FxU, -DxU and -FSxU; the
// double layers read the slots' normals (the JAX package's `nrm_l`,
// pallas_sl.py:197).  The formula is a template parameter
// (ukernels.cuh).
//
// Bound on the H100: the pairs.  At 1e7 points, depth 6: B = 262,144
// boxes, cap = 56 slots, ns = 152 surface points, 2.2e9 pair
// evaluations, each one rsqrt (MUFU, 16 per SM per clock) and the
// formula's f32 operations; the bytes (4 B * (3 + k0) * B * cap in,
// 4 B * k1 * ns * B out, under 1 GB) take less time than the pairs.
//
// Design: one block owns 32 boxes, one per lane; its slots sit in
// shared memory (struct of arrays, row stride odd so the 32 lanes hit
// 32 banks).  Each warp walks surface points m = warp, warp + 8, ...;
// the surface point is a warp-wide broadcast, each lane sums its box's
// slots in k1 registers and the 32 lanes write 32 adjacent outputs of
// row (j, m).  The TPU's bf16 hi/lo one-hot matmuls (pallas_sl.py:62-68)
// serve its matrix unit only and are not carried over.
#include "common.cuh"
#include "ukernels.cuh"

namespace {

constexpr int kBoxes = 32;   // boxes per block (one per lane)
constexpr int kWarps = 8;

// floats of shared memory per box slot
template <int KER>
constexpr int slot_floats() {
  return 3 + (sctl::Dims<KER>::nrm ? 3 : 0) + sctl::Dims<KER>::k0;
}

template <int KER>
__global__ void __launch_bounds__(kBoxes * kWarps)
surface_pair_kernel(const float* __restrict__ surf,
                    const float* __restrict__ pts,
                    const float* __restrict__ nrm,
                    const float* __restrict__ f, float* __restrict__ out,
                    int ns, int B, int cap) {
  using D = sctl::Dims<KER>;
  constexpr int K0 = D::k0, K1 = D::k1, NN = D::nrm ? 3 : 0;
  extern __shared__ float sm[];
  const int stride = cap | 1;
  const int plane = kBoxes * stride;
  // planes: x, y, z, then the normals, then the densities
  const int b0 = blockIdx.x * kBoxes;
  const long N = (long)B * cap;
  for (int i = threadIdx.x; i < kBoxes * cap; i += blockDim.x) {
    const int j = i / cap, s = i - j * cap;
    const int o = j * stride + s;
    const long g = (long)b0 * cap + i;
    const bool ok = b0 + j < B;
#pragma unroll
    for (int c = 0; c < 3; ++c) sm[c * plane + o] = ok ? pts[c * N + g] : 0.f;
#pragma unroll
    for (int c = 0; c < NN; ++c)
      sm[(3 + c) * plane + o] = ok ? nrm[c * N + g] : 0.f;
#pragma unroll
    for (int c = 0; c < K0; ++c)
      sm[(3 + NN + c) * plane + o] = ok ? f[c * N + g] : 0.f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* bx = sm + lane * stride;
  for (int m = warp; m < ns; m += kWarps) {
    const float cx = surf[3 * m], cy = surf[3 * m + 1],
                cz = surf[3 * m + 2];
    float acc[K1];
#pragma unroll
    for (int j = 0; j < K1; ++j) acc[j] = 0.f;
    for (int s = 0; s < cap; ++s) {
      float fv[K0], nv[3];
#pragma unroll
      for (int c = 0; c < K0; ++c) fv[c] = bx[(3 + NN + c) * plane + s];
#pragma unroll
      for (int c = 0; c < NN; ++c) nv[c] = bx[(3 + c) * plane + s];
      sctl::uker_acc<KER>(cx - bx[s], cy - bx[plane + s],
                          cz - bx[2 * plane + s], fv, nv, acc);
    }
    if (b0 + lane < B) {
#pragma unroll
      for (int j = 0; j < K1; ++j)
        out[((long)j * ns + m) * B + b0 + lane] = acc[j];
    }
  }
}

template <int KER>
struct Launch {
  static int run(const float* surf, const float* pts, const float* nrm,
                 const float* f, float* out, int ns, int B, int cap,
                 cudaStream_t stream) {
    const size_t smem =
        sizeof(float) * slot_floats<KER>() * kBoxes * (cap | 1);
    cudaError_t err = allow_smem(surface_pair_kernel<KER>, smem);
    if (err != cudaSuccess) return (int)err;
    const int grid = (B + kBoxes - 1) / kBoxes;
    surface_pair_kernel<KER><<<grid, kBoxes * kWarps, smem, stream>>>(
        surf, pts, nrm, f, out, ns, B, cap);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// surf (ns, 3), pts (3, B*cap), nrm (3, B*cap) (double layers only,
// else null), f (k0, B*cap), out (k1, ns, B); all float32.  ker: the
// formula index of ukernels.cuh, one of the S2M kernels.
SCTL_API int sctl_surface_pair(const float* surf, const float* pts,
                               const float* nrm, const float* f, float* out,
                               int ker, int ns, int B, int cap,
                               cudaStream_t stream) {
  using namespace sctl;
  return dispatch_formula<Launch, kLapFxU, kLapDxU, kStkFxU, kStkDxU,
                          kStkFSxU>(ker, surf, pts, nrm, f, out, ns, B, cap,
                                    stream);
}
