// Sibling-blocked M2L (V list) on the parent grid.
//
// Replaces: sctl_tpu/ops/pallas_m2l.py `m2l_grid_blocked`
// (pl.pallas_call at :272).  With p = (x, y, z) a parent box and D_k
// (k < 26) the parent-neighbour directions:
//   out[p, :] = sum_k qp[p + 1 + D_k, :] @ W_k
// qp is the zero-margin parent grid ((h+2)^3, K = 8*r2), W the block
// operator stack (26, K, N = 8*r), out (h^3, N).
//
// Bound on the H100: operations.  At level 6 of the 1e7-point run (h =
// 32, K = 1024, N = 576) the nonzero operator blocks need 9.1e11 flop:
// 13.6 ms on the CUDA cores at 67 TFLOP/s, 5.5 ms as three TF32 passes
// on the tensor cores at 495 TFLOP/s; the bytes (qp 0.16 GB, W 61 MB,
// out 75 MB) take 0.09 ms.
//
// Design: the tensor-core engine of m2l_tc.cuh (3xTF32, wgmma, a cp.async
// ring), whose A rows are gathered here by index arithmetic: row p + 1 + D_k
// of qp, no window materialized.  B is the stack transposed to K-major and
// split into TF32 hi and lo parts at setup, (2, 26, N, K).  A block owns 128
// parents x 144 columns (N = 576 at p = 6 is four tiles); the grid's third
// axis splits the 26 K ranges into partial outputs that the wrapper adds (no
// atomics, so a run repeats bit for bit), chosen so that every level fills
// the card.
#include "m2l_tc.cuh"

namespace {

constexpr int BN = 144, STAGES = 4;

struct Gather {
  const float* qp;
  const int* shifts;       // 26 row shifts, in shared memory
  int h, M, N, K;
  static constexpr int D = 26;
  __device__ int row(int p) const {
    if (p >= M) return -1;
    const int hp = h + 2;
    return ((p / (h * h) + 1) * hp + (p / h) % h + 1) * hp + p % h + 1;
  }
  __device__ long shift(int j) const { return shifts[j]; }
  __device__ int op(int j) const { return j; }
  __device__ long out_row(int p) const { return p; }
};

__global__ void __launch_bounds__(m2l_tc::kThreads, 1)
m2l_blocked_kernel(const float* __restrict__ qp,
                   const float* __restrict__ mats_tc,
                   const int* __restrict__ dirs, float* __restrict__ out,
                   int h, int K, int N, int chunk) {
  __shared__ int shifts[Gather::D];
  const int hp = h + 2;
  if (threadIdx.x < Gather::D) {
    const int* d = dirs + 3 * threadIdx.x;
    shifts[threadIdx.x] = (d[0] * hp + d[1]) * hp + d[2];
  }
  __syncthreads();
  const int M = h * h * h;
  const int iters = Gather::D * ((K + m2l_tc::BK - 1) / m2l_tc::BK);
  const int it0 = blockIdx.z * chunk, it1 = min(iters, it0 + chunk);
  const Gather g{qp, shifts, h, M, N, K};
  m2l_tc::run<BN, STAGES>(g, mats_tc, mats_tc + (long)Gather::D * N * K,
                          out + (long)blockIdx.z * M * N, it0, it1);
}

}  // namespace

// qp ((h+2)^3, K); mats_tc (2, 26, N, K): the operator stack's TF32 hi
// and lo parts, K-major; dirs (26, 3) int32 on the device; out
// (nsplit, h^3, N): split s sums the iterations [s chunk, (s+1) chunk) of the
// 26 ceil(K / 32) (K slice, direction) steps; float32, K % 4 == 0,
// N % 8 == 0.
SCTL_API int sctl_m2l_grid_blocked(const float* qp, const float* mats_tc,
                                   const int* dirs, float* out, int h,
                                   int K, int N, int nsplit, int chunk,
                                   cudaStream_t stream) {
  constexpr int smem = m2l_tc::smem_bytes<BN, STAGES>();
  cudaError_t err = allow_smem(m2l_blocked_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int M = h * h * h;
  dim3 grid((M + m2l_tc::BM - 1) / m2l_tc::BM, (N + BN - 1) / BN, nsplit);
  m2l_blocked_kernel<<<grid, m2l_tc::kThreads, smem, stream>>>(
      qp, mats_tc, dirs, out, h, K, N, chunk);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a block of the kernel, in bytes.
SCTL_API int sctl_m2l_grid_blocked_smem() {
  return m2l_tc::smem_bytes<BN, STAGES>();
}
