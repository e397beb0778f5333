// L2T: each box's downward-equivalent densities on the shared surface
// evaluated at the box's target slots.
//
// Replaces: sctl_tpu/ops/pallas_sl.py `l2t_surface` (pl.pallas_call at
// :354).  out[b*cap_t + t] = sum_m q[m, b] / |xt[:, b*cap_t + t] -
// surf[m]| (unscaled, box-local coordinates).
//
// Bound on the H100: the pairs.  At 1e7 points, depth 6: B = 262,144,
// cap_t = 48, ns = 152, 1.9e9 pair evaluations (one rsqrt each); the
// bytes (targets, densities and outputs, about 0.4 GB) take far less.
//
// Design: one block owns 32 boxes; their (ns x 32) densities and the
// surface sit in shared memory.  Threads walk the block's 32*cap_t
// target slots in order, so target loads and output stores are
// coalesced; every lane of a warp reads the same surface point
// (broadcast) and at most two boxes' densities.  The TPU's hi/lo
// one-hot expansion of the densities (pallas_sl.py:288-293) is not
// carried over: a thread reads its box's density directly.
#include "common.cuh"

namespace {

constexpr int kBoxes = 32;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
l2t_surface_kernel(const float* __restrict__ surf,
                   const float* __restrict__ xt,
                   const float* __restrict__ q, float* __restrict__ out,
                   int ns, int B, int cap_t) {
  extern __shared__ float sm[];
  float* sq = sm;                       // (ns, kBoxes)
  float* s3 = sm + ns * kBoxes;         // (ns, 3)
  const int b0 = blockIdx.x * kBoxes;
  for (int i = threadIdx.x; i < ns * kBoxes; i += blockDim.x) {
    const int m = i / kBoxes, j = i - m * kBoxes;
    sq[i] = b0 + j < B ? q[(long)m * B + b0 + j] : 0.f;
  }
  for (int i = threadIdx.x; i < 3 * ns; i += blockDim.x) s3[i] = surf[i];
  __syncthreads();
  const long T = (long)B * cap_t;
  for (int i = threadIdx.x; i < kBoxes * cap_t; i += blockDim.x) {
    const long g = (long)b0 * cap_t + i;
    if (g >= T) break;
    const int j = i / cap_t;
    const float x = xt[g], y = xt[T + g], z = xt[2 * T + g];
    float acc = 0.f;
    for (int m = 0; m < ns; ++m) {
      const float dx = x - s3[3 * m], dy = y - s3[3 * m + 1],
                  dz = z - s3[3 * m + 2];
      acc += sq[m * kBoxes + j] * rinv_masked(dx * dx + dy * dy + dz * dz);
    }
    out[g] = acc;
  }
}

}  // namespace

// surf (ns, 3), xt (3, B*cap_t), q (ns, B), out (B*cap_t); float32.
SCTL_API int sctl_l2t_surface(const float* surf, const float* xt,
                              const float* q, float* out, int ns, int B,
                              int cap_t, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ns * (kBoxes + 3);
  cudaError_t err = allow_smem(l2t_surface_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + kBoxes - 1) / kBoxes;
  l2t_surface_kernel<<<grid, kThreads, smem, stream>>>(surf, xt, q, out,
                                                       ns, B, cap_t);
  return (int)cudaGetLastError();
}
