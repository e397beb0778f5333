// The 316-offset V-list (M2L) sweep of one uniform-grid level.
//
// Replaces: sctl_tpu/ops/pallas_m2l.py `m2l_grid` (pl.pallas_call at
// :149).  With qp the V-projected grid ((n+6)^3, r2, 3-wide zero
// margins), A_o^T = mats[o] (316, r2, r) and, for the child parity
// c = 4(x%2) + 2(y%2) + z%2 of box p = (x, y, z), its 189 valid
// offsets d_o (ops/m2l.py `parity_offsets`):
//   out[p, :] = sum_{o valid for c} qp[p + 3 + d_o, :] @ mats[o]
// out (n^3, r) in raster order.
//
// Bound on the H100: f32 operations on the CUDA cores,
// 2 n^3 189 r r2 flop at 67 TFLOP/s.  At the p=8 caps (r = 80,
// r2 = 256) that is 2.5e11 flop, 3.79 ms, at level 5 (n = 32), 0.47 ms
// at level 4 and 0.06 ms at level 3; the bytes (qp 56 MB at level 5,
// the stack 26 MB) take 0.03 ms.
//
// Design: the TPU kernel runs all 316 offsets on every box and zeroes
// the invalid ones with a mask (1.67x the needed flops), and splits f32
// into bf16 hi/lo parts for its matrix unit.  Here the target boxes are
// grouped by parity: parity c's boxes 2b + c (b in the h^3 parent grid,
// h = n/2) sum exactly their 189 offsets, so each parity is one
// register-blocked SGEMM (h^3 rows) x (189 r2) -> r whose A rows are
// gathered from qp at 2b + c + 3 + d_o by index arithmetic, as
// m2l_blocked.cu gathers (no window is materialized).  A block owns a
// 128-box x 80-rank output tile: r = 80 at the p=8 caps is one tile
// with no padding (a 64-wide tile would pad it to 128 and waste 37.5%).
// Each of its 256 threads keeps 8 boxes x 5 ranks in registers (ranks
// tx + 16 j, so the shared-memory reads of a warp hit distinct banks).
// K runs over the offsets and, within one, over r2 in steps of 16
// through shared memory.  Each offset's products are summed apart and
// then added to the total, so no register sum runs over all 189 r2
// terms.  Where the boxes alone give fewer than two blocks an SM, the
// grid also splits the offsets (blockIdx.z = parity x split) into
// partial outputs that the wrapper adds; no atomics, so a run repeats
// bit for bit.  Full float32 on the CUDA cores: no TF32, no bf16.
#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 80, BK = 16, TM = 8, TN = 5;
constexpr int kThreads = (BM / TM) * (BN / TN);   // 256
constexpr int kValid = 189;                        // offsets a parity

__global__ void __launch_bounds__(kThreads, 2)
m2l_grid_kernel(const float* __restrict__ qp, const float* __restrict__ mats,
                const int4* __restrict__ offs, float* __restrict__ out,
                int n, int r2, int r, int nsplit, int chunk) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int h = n / 2, M = h * h * h, np6 = n + 6;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int c = blockIdx.z / nsplit, split = blockIdx.z % nsplit;
  const int cx = (c >> 2) & 1, cy = (c >> 1) & 1, cz = c & 1;
  const int j0 = split * chunk, j1 = min(kValid, j0 + chunk);

  // this thread's A-load row (a target box of parity c) and k range
  const int arow = tid >> 1, ak = (tid & 1) * (BK / 2);
  const int b = m0 + arow;
  const bool avalid = b < M;
  const int ax = 2 * (b / (h * h)) + cx + 3, ay = 2 * ((b / h) % h) + cy + 3,
            az = 2 * (b % h) + cz + 3;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int jo = j0; jo < j1; ++jo) {
    const int4 d = offs[c * kValid + jo];      // (dx, dy, dz, o)
    const long src =
        ((long)(ax + d.x) * np6 + ay + d.y) * np6 * r2 + (long)(az + d.z) * r2;
    const float* Wo = mats + (long)d.w * r2 * r;
    float part[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[i][j] = 0.f;
    for (int k0 = 0; k0 < r2; k0 += BK) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int k = k0 + ak + i;
        As[ak + i][arow] = (avalid && k < r2) ? qp[src + k] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < BK * BN / kThreads; ++i) {
        const int e = tid + i * kThreads;
        const int kk = e / BN, cc = e % BN;
        const int k = k0 + kk, col = n0 + cc;
        Bs[kk][cc] = (k < r2 && col < r) ? Wo[(long)k * r + col] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&As[kk][ty * TM + 4]);
        const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float bb[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) bb[j] = Bs[kk][tx + j * (BN / TN)];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            part[i][j] = fmaf(a[i], bb[j], part[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j];
  }

  float* o = out + (long)split * n * n * n * r;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int bo = m0 + ty * TM + i;
    if (bo >= M) continue;
    const long box = ((long)(2 * (bo / (h * h)) + cx) * n +
                      2 * ((bo / h) % h) + cy) * n + 2 * (bo % h) + cz;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + j * (BN / TN);
      if (col < r) o[box * r + col] = acc[i][j];
    }
  }
}

}  // namespace

// qp ((n+6)^3, r2), mats (316, r2, r), offs (8, 189) int4 (dx, dy, dz,
// o) on the device, out (nsplit, n^3, r): split s sums the offsets
// [s chunk, (s+1) chunk) of each parity; float32, n even.
SCTL_API int sctl_m2l_grid(const float* qp, const float* mats,
                           const int* offs, float* out, int n, int r2,
                           int r, int nsplit, int chunk,
                           cudaStream_t stream) {
  const int M = (n / 2) * (n / 2) * (n / 2);
  dim3 grid((r + BN - 1) / BN, (M + BM - 1) / BM, 8 * nsplit);
  m2l_grid_kernel<<<grid, kThreads, 0, stream>>>(
      qp, mats, reinterpret_cast<const int4*>(offs), out, n, r2, r, nsplit,
      chunk);
  return (int)cudaGetLastError();
}
