// Near-field P2P over the packed 9-column slab.
//
// Replaces: sctl_tpu/ops/pallas_p2p.py `p2p_stencil9`
// (pl.pallas_call at :425).  For target box (x, y, z) in raster order
// and its slot t:
//   out[x, y, z, t] = sum_{s < 3 SL} f[x, y, z SL + s]
//                     / |xt[x, y, z, :, t] - xs[x, y, :, z SL + s]|
// where slab entry z' of column (x, y) holds the 9 (dx, dy) neighbour
// columns' box (x+dx, y+dy, z'-1), so the 27-box neighbourhood is the
// one window [z SL, (z+3) SL).  Boundary zeros and slot padding are in
// the slab (zero density); r2 = 0 is masked.  Unscaled.
//
// Bound on the H100: the pairs.  At 1e7 points, depth 6: n = 64,
// cap_t = 48, SL = 512: 64^3 * 48 * 1536 = 1.9e10 pair evaluations
// (about 1.0e10 of them real points), one rsqrt each, 16 rsqrt per SM
// per clock; the slabs (2.2 GB) are read once per 4 z-boxes.
//
// Design: one block per (column, 4 consecutive z boxes), one thread per
// target slot.  The block stages the union of its windows, (4+2) SL
// slots, in shared memory as float4 (x, y, z, f): each staged source
// serves up to 3 * 4 * cap_t targets, and each pair costs one
// broadcast shared load, the distance and one masked rsqrt into an f32
// register sum.
#include "common.cuh"

namespace {

constexpr int kZ = 4;   // z boxes per block

__global__ void p2p_stencil9_kernel(const float* __restrict__ xt,
                                    const float* __restrict__ xs,
                                    const float* __restrict__ f,
                                    float* __restrict__ out, int n, int SL,
                                    int cap_t) {
  extern __shared__ float4 win[];
  const int col = blockIdx.y;                // x * n + y
  const int z0 = blockIdx.x * kZ;
  const int nz = min(kZ, n - z0);
  const long slab = (long)(n + 2) * SL;
  const float* xc = xs + (long)col * 3 * slab;
  const float* fc = f + (long)col * slab;
  const long base = (long)z0 * SL;
  const int W = (nz + 2) * SL;
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    const long g = base + i;
    win[i] = make_float4(xc[g], xc[slab + g], xc[2 * slab + g], fc[g]);
  }
  __syncthreads();
  const int zl = threadIdx.x / cap_t, t = threadIdx.x - zl * cap_t;
  if (zl >= nz) return;
  const long box = (long)col * n + z0 + zl;
  const float* xb = xt + box * 3 * cap_t;
  const float x = xb[t], y = xb[cap_t + t], z = xb[2 * cap_t + t];
  const float4* w = win + zl * SL;
  float acc = 0.f;
  for (int s = 0; s < 3 * SL; ++s) {
    const float4 q = w[s];
    const float dx = x - q.x, dy = y - q.y, dz = z - q.z;
    acc += q.w * rinv_masked(dx * dx + dy * dy + dz * dz);
  }
  out[box * cap_t + t] = acc;
}

}  // namespace

// xt (n, n, n, 3, cap_t), xs (n, n, 3, (n+2)*SL), f (n, n, (n+2)*SL),
// out (n, n, n, cap_t); float32.
SCTL_API int sctl_p2p_stencil9(const float* xt, const float* xs,
                               const float* f, float* out, int n, int SL,
                               int cap_t, cudaStream_t stream) {
  const size_t smem = sizeof(float4) * (kZ + 2) * SL;
  cudaError_t err = allow_smem(p2p_stencil9_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = (kZ * cap_t + 31) / 32 * 32;
  dim3 grid((n + kZ - 1) / kZ, n * n);
  p2p_stencil9_kernel<<<grid, threads, smem, stream>>>(xt, xs, f, out, n,
                                                       SL, cap_t);
  return (int)cudaGetLastError();
}
