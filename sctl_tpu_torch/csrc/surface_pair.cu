// S2M check potentials: every box's source slots paired with the
// shared upward-check surface.
//
// Replaces: sctl_tpu/ops/pallas_sl.py `surface_pair` (pl.pallas_call at
// :254).  out[m, b] = sum_s f[b*cap + s] / |surf[m] - pts[:, b*cap + s]|
// (unscaled, box-local coordinates), out laid out (ns, B).
//
// Bound on the H100: the pairs.  At 1e7 points, depth 6: B = 262,144
// boxes, cap = 56 slots, ns = 152 surface points, 2.2e9 pair
// evaluations, each one rsqrt (MUFU, 16 per SM per clock) and about 9
// f32 operations; the bytes (4 B * 4 * B * cap in, 4 B * ns * B out,
// about 0.4 GB) take far less time than the pairs.
//
// Design: one block owns 32 boxes, one per lane; its slots sit in
// shared memory (struct of arrays, row stride odd so the 32 lanes hit
// 32 banks).  Each warp walks surface points m = warp, warp + 8, ...;
// the surface point is a warp-wide broadcast, each lane sums its box's
// slots in registers and the 32 lanes write 32 adjacent outputs of row
// m.  The TPU's bf16 hi/lo one-hot matmuls (pallas_sl.py:62-68) serve
// its matrix unit only and are not carried over.
#include "common.cuh"

namespace {

constexpr int kBoxes = 32;   // boxes per block (one per lane)
constexpr int kWarps = 8;

__global__ void __launch_bounds__(kBoxes * kWarps)
surface_pair_kernel(const float* __restrict__ surf,
                    const float* __restrict__ pts,
                    const float* __restrict__ f, float* __restrict__ out,
                    int ns, int B, int cap) {
  extern __shared__ float sm[];
  const int stride = cap | 1;
  float* sx = sm;
  float* sy = sx + kBoxes * stride;
  float* sz = sy + kBoxes * stride;
  float* sf = sz + kBoxes * stride;
  const int b0 = blockIdx.x * kBoxes;
  const long N = (long)B * cap;
  for (int i = threadIdx.x; i < kBoxes * cap; i += blockDim.x) {
    const int j = i / cap, s = i - j * cap;
    const int o = j * stride + s;
    const long g = (long)b0 * cap + i;
    const bool ok = b0 + j < B;
    sx[o] = ok ? pts[g] : 0.f;
    sy[o] = ok ? pts[N + g] : 0.f;
    sz[o] = ok ? pts[2 * N + g] : 0.f;
    sf[o] = ok ? f[g] : 0.f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* bx = sx + lane * stride;
  const float* by = sy + lane * stride;
  const float* bz = sz + lane * stride;
  const float* bf = sf + lane * stride;
  for (int m = warp; m < ns; m += kWarps) {
    const float cx = surf[3 * m], cy = surf[3 * m + 1],
                cz = surf[3 * m + 2];
    float acc = 0.f;
    for (int s = 0; s < cap; ++s) {
      const float dx = cx - bx[s], dy = cy - by[s], dz = cz - bz[s];
      acc += bf[s] * rinv_masked(dx * dx + dy * dy + dz * dz);
    }
    if (b0 + lane < B) out[(long)m * B + b0 + lane] = acc;
  }
}

}  // namespace

// surf (ns, 3), pts (3, B*cap), f (B*cap), out (ns, B); all float32.
SCTL_API int sctl_surface_pair(const float* surf, const float* pts,
                               const float* f, float* out, int ns, int B,
                               int cap, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 4 * kBoxes * (cap | 1);
  cudaError_t err = allow_smem(surface_pair_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + kBoxes - 1) / kBoxes;
  surface_pair_kernel<<<grid, kBoxes * kWarps, smem, stream>>>(
      surf, pts, f, out, ns, B, cap);
  return (int)cudaGetLastError();
}
