// Sibling-blocked M2L (V list) on the parent grid.
//
// Replaces: sctl_tpu/ops/pallas_m2l.py `m2l_grid_blocked`
// (pl.pallas_call at :272).  With p = (x, y, z) a parent box and D_k
// (k < 26) the parent-neighbour directions:
//   out[p, :] = sum_k qp[p + 1 + D_k, :] @ W_k
// qp is the zero-margin parent grid ((h+2)^3, K = 8*r2), W the block
// operator stack (26, K, N = 8*r), out (h^3, N).
//
// Bound on the H100: f32 operations on the CUDA cores.  At level 6 of
// the 1e7-point run (h = 32, K = 1024, N = 576) it is
// 2 * 32^3 * 26 * 1024 * 576 = 1.0e12 flop, 15 ms at 67 TFLOP/s;
// the bytes (qp 0.15 GB, W 61 MB, out 75 MB) take 0.09 ms.
//
// Design: a register-blocked SGEMM whose A rows are gathered by index
// arithmetic (no window is materialized).  A block owns a 128 x 64
// output tile and accumulates over the 26 directions and K in steps of
// 16 through shared memory; each thread keeps an 8 x 4 tile in
// registers.  Full float32 on the CUDA cores: the TPU's three-pass
// bf16 split (pallas_m2l.py:44-53) exists for its matrix unit, and
// TF32 would lose the f32 accuracy the FMM needs.
#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 64, BK = 16, TM = 8, TN = 4;
constexpr int kThreads = (BM / TM) * (BN / TN);   // 256

__global__ void __launch_bounds__(kThreads)
m2l_blocked_kernel(const float* __restrict__ qp,
                   const float* __restrict__ mats,
                   const int* __restrict__ dirs, float* __restrict__ out,
                   int h, int K, int N) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int M = h * h * h, hp = h + 2;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // this thread's A-load row (gathered) and k range
  const int arow = tid >> 1, ak = (tid & 1) * (BK / 2);
  const int p = m0 + arow;
  const bool avalid = p < M;
  const int px = p / (h * h), py = (p / h) % h, pz = p % h;
  // this thread's B-load row and columns
  const int brow = tid / (BN / 4), bc = (tid % (BN / 4)) * 4;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int d = 0; d < 26; ++d) {
    const long src =
        ((long)((px + 1 + dirs[3 * d]) * hp + py + 1 + dirs[3 * d + 1]) *
             hp + pz + 1 + dirs[3 * d + 2]) * K;
    const float* Wd = mats + (long)d * K * N;
    for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int k = k0 + ak + i;
        As[ak + i][arow] = (avalid && k < K) ? qp[src + k] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + brow, c = n0 + bc + j;
        Bs[brow][bc + j] = (k < K && c < N) ? Wd[(long)k * N + c] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&As[kk][ty * TM + 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
        const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bb[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty * TM + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx * TN + j;
      if (c < N) out[(long)r * N + c] = acc[i][j];
    }
  }
}

}  // namespace

// qp ((h+2)^3, K), mats (26, K, N), dirs (26, 3) int32 on the device,
// out (h^3, N); float32.
SCTL_API int sctl_m2l_grid_blocked(const float* qp, const float* mats,
                                   const int* dirs, float* out, int h,
                                   int K, int N, cudaStream_t stream) {
  const int M = h * h * h;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  m2l_blocked_kernel<<<grid, kThreads, 0, stream>>>(qp, mats, dirs, out, h,
                                                    K, N);
  return (int)cudaGetLastError();
}
