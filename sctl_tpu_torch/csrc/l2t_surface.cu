// L2T: each box's downward-equivalent densities on the shared surface
// evaluated at the box's target slots.
//
// Replaces: sctl_tpu/ops/pallas_sl.py `l2t_surface` (pl.pallas_call at
// :354).  out[j, b*cap_t + t] = sum_m K(xt[:, b*cap_t + t] - surf[m])
// q[:, m, b] (component j < k1, unscaled, box-local coordinates), for
// the L2T kernels Laplace3D-FxU and -FxdU and Stokes3D-FSxU; the
// formula is a template parameter (ukernels.cuh).
//
// Bound on the H100: the pairs.  At 1e7 points, depth 6: B = 262,144,
// cap_t = 48, ns = 152, 1.9e9 pair evaluations (one rsqrt each and the
// formula's f32 operations); the bytes (targets, densities and
// outputs, under 1 GB) take less.
//
// Design: one block owns 32 boxes; their (k0 x ns x 32) densities and
// the surface sit in shared memory.  Threads walk the block's
// 32*cap_t target slots in order, so target loads and output stores
// are coalesced; every lane of a warp reads the same surface point
// (broadcast) and at most two boxes' densities.  The TPU's hi/lo
// one-hot expansion of the densities (pallas_sl.py:288-293) is not
// carried over: a thread reads its box's densities directly.
#include "common.cuh"
#include "ukernels.cuh"

namespace {

constexpr int kBoxes = 32;
constexpr int kThreads = 256;

template <int KER>
__global__ void __launch_bounds__(kThreads)
l2t_surface_kernel(const float* __restrict__ surf,
                   const float* __restrict__ xt,
                   const float* __restrict__ q, float* __restrict__ out,
                   int ns, int B, int cap_t) {
  using D = sctl::Dims<KER>;
  constexpr int K0 = D::k0, K1 = D::k1;
  extern __shared__ float sm[];
  float* sq = sm;                       // (k0, ns, kBoxes)
  float* s3 = sm + K0 * ns * kBoxes;    // (ns, 3)
  const int b0 = blockIdx.x * kBoxes;
  for (int i = threadIdx.x; i < K0 * ns * kBoxes; i += blockDim.x) {
    const int cm = i / kBoxes, j = i - cm * kBoxes;
    sq[i] = b0 + j < B ? q[(long)cm * B + b0 + j] : 0.f;
  }
  for (int i = threadIdx.x; i < 3 * ns; i += blockDim.x) s3[i] = surf[i];
  __syncthreads();
  const long T = (long)B * cap_t;
  for (int i = threadIdx.x; i < kBoxes * cap_t; i += blockDim.x) {
    const long g = (long)b0 * cap_t + i;
    if (g >= T) break;
    const int j = i / cap_t;
    const float x = xt[g], y = xt[T + g], z = xt[2 * T + g];
    float acc[K1];
#pragma unroll
    for (int c = 0; c < K1; ++c) acc[c] = 0.f;
    for (int m = 0; m < ns; ++m) {
      float fv[K0];
#pragma unroll
      for (int c = 0; c < K0; ++c) fv[c] = sq[(c * ns + m) * kBoxes + j];
      sctl::uker_acc<KER>(x - s3[3 * m], y - s3[3 * m + 1],
                          z - s3[3 * m + 2], fv, (const float*)nullptr,
                          acc);
    }
#pragma unroll
    for (int c = 0; c < K1; ++c) out[c * T + g] = acc[c];
  }
}

template <int KER>
struct Launch {
  static int run(const float* surf, const float* xt, const float* q,
                 float* out, int ns, int B, int cap_t, cudaStream_t stream) {
    const size_t smem =
        sizeof(float) * ns * (sctl::Dims<KER>::k0 * kBoxes + 3);
    cudaError_t err = allow_smem(l2t_surface_kernel<KER>, smem);
    if (err != cudaSuccess) return (int)err;
    const int grid = (B + kBoxes - 1) / kBoxes;
    l2t_surface_kernel<KER><<<grid, kThreads, smem, stream>>>(
        surf, xt, q, out, ns, B, cap_t);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// surf (ns, 3), xt (3, B*cap_t), q (k0, ns, B), out (k1, B*cap_t);
// float32.  ker: the formula index of ukernels.cuh, one of the L2T
// kernels.
SCTL_API int sctl_l2t_surface(const float* surf, const float* xt,
                              const float* q, float* out, int ker, int ns,
                              int B, int cap_t, cudaStream_t stream) {
  using namespace sctl;
  return dispatch_formula<Launch, kLapFxU, kLapFxdU, kStkFSxU>(
      ker, surf, xt, q, out, ns, B, cap_t, stream);
}
