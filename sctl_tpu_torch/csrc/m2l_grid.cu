// The 316-offset V-list (M2L) sweep of one uniform-grid level.
//
// Replaces: sctl_tpu/ops/pallas_m2l.py `m2l_grid` (pl.pallas_call at
// :149).  With qp the V-projected grid ((n+6)^3, r2, 3-wide zero
// margins), A_o = mats[o] (316, r, r2) and, for the child parity
// c = 4(x%2) + 2(y%2) + z%2 of box p = (x, y, z), its 189 valid
// offsets d_o (ops/m2l.py `parity_offsets`):
//   out[p, :] = sum_{o valid for c} qp[p + 3 + d_o, :] @ A_o^T
// out (n^3, r) in raster order.
//
// Bound on the H100: operations, 2 n^3 189 r r2 flop.  At the p=8 caps
// (r = 80, r2 = 256) and level 5 (n = 32) that is 2.5e11 flop: 3.79 ms
// on the CUDA cores at 67 TFLOP/s, 1.54 ms as three TF32 passes on the
// tensor cores at 495 TFLOP/s; the bytes (qp 56 MB, the stack 26 MB)
// take 0.03 ms.
//
// Design: the TPU kernel runs all 316 offsets on every box and zeroes the
// invalid ones with a mask (1.67x the needed flops).  Here the target boxes
// are grouped by parity: parity c's boxes 2b + c (b in the h^3 parent grid,
// h = n/2) sum exactly their 189 offsets, so each parity is one GEMM (h^3
// rows) x (189 r2) -> r on the tensor-core engine of m2l_tc.cuh (3xTF32,
// wgmma, a cp.async ring), whose A rows are gathered here from qp at 2b + c
// + 3 + d_o by index arithmetic (no window is materialized).  B is the stack
// A_o (r, r2), already K-major, split into TF32 hi and lo parts at setup,
// (2, 316, r, r2). A block owns 128 boxes x 80 ranks: r = 80 at the p=8 caps
// is one tile with no padding.  The grid's third axis is parity x split: the
// splits sum parts of the (K slice, offset) steps into partial outputs that
// the wrapper adds (no atomics, so a run repeats bit for bit), chosen so
// that every level fills the card.
#include "m2l_tc.cuh"

namespace {

constexpr int BN = 80, STAGES = 5;
constexpr int kValid = 189;                        // offsets a parity

struct Gather {
  const float* qp;
  const int* shifts;       // parity c's 189 row shifts, in shared memory
  const int* ops;          // and their offsets' indices o
  int h, n, M, N, K, cx, cy, cz;
  static constexpr int D = kValid;
  __device__ int row(int b) const {
    if (b >= M) return -1;
    const int np6 = n + 6;
    return ((2 * (b / (h * h)) + cx + 3) * np6 + 2 * ((b / h) % h) + cy +
            3) * np6 + 2 * (b % h) + cz + 3;
  }
  __device__ long shift(int j) const { return shifts[j]; }
  __device__ int op(int j) const { return ops[j]; }
  __device__ long out_row(int b) const {
    return ((long)(2 * (b / (h * h)) + cx) * n + 2 * ((b / h) % h) + cy) *
               n + 2 * (b % h) + cz;
  }
};

__global__ void __launch_bounds__(m2l_tc::kThreads, 1)
m2l_grid_kernel(const float* __restrict__ qp,
                const float* __restrict__ mats_tc,
                const int4* __restrict__ offs, float* __restrict__ out,
                int n, int r2, int r, int nsplit, int chunk) {
  __shared__ int shifts[kValid], ops[kValid];
  const int c = blockIdx.z / nsplit, split = blockIdx.z % nsplit;
  const int np6 = n + 6;
  for (int j = threadIdx.x; j < kValid; j += blockDim.x) {
    const int4 d = offs[c * kValid + j];           // (dx, dy, dz, o)
    shifts[j] = (d.x * np6 + d.y) * np6 + d.z;
    ops[j] = d.w;
  }
  __syncthreads();
  const int h = n / 2, M = h * h * h;
  const int iters = kValid * ((r2 + m2l_tc::BK - 1) / m2l_tc::BK);
  const int it0 = split * chunk, it1 = min(iters, it0 + chunk);
  const Gather g{qp, shifts, ops, h, n, M, r, r2,
                 (c >> 2) & 1, (c >> 1) & 1, c & 1};
  m2l_tc::run<BN, STAGES>(g, mats_tc, mats_tc + 316L * r * r2,
                          out + (long)split * n * n * n * r, it0, it1);
}

}  // namespace

// qp ((n+6)^3, r2); mats_tc (2, 316, r, r2): the stack's TF32 hi and
// lo parts; offs (8, 189) int4 (dx, dy, dz, o) on the device; out
// (nsplit, n^3, r): split s sums the iterations [s chunk, (s+1) chunk)
// of each parity's 189 ceil(r2 / 32) (K slice, offset) steps; float32,
// n even, r2 % 4 == 0, r % 2 == 0.
SCTL_API int sctl_m2l_grid(const float* qp, const float* mats_tc,
                           const int* offs, float* out, int n, int r2,
                           int r, int nsplit, int chunk,
                           cudaStream_t stream) {
  constexpr int smem = m2l_tc::smem_bytes<BN, STAGES>();
  cudaError_t err = allow_smem(m2l_grid_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int M = (n / 2) * (n / 2) * (n / 2);
  dim3 grid((M + m2l_tc::BM - 1) / m2l_tc::BM, (r + BN - 1) / BN,
            8 * nsplit);
  m2l_grid_kernel<<<grid, m2l_tc::kThreads, smem, stream>>>(
      qp, mats_tc, reinterpret_cast<const int4*>(offs), out, n, r2, r,
      nsplit, chunk);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a block of the kernel, in bytes.
SCTL_API int sctl_m2l_grid_smem() { return m2l_tc::smem_bytes<BN, STAGES>(); }
