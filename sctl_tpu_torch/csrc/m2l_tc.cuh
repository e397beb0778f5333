// The tensor-core tile engine of the two M2L kernels (m2l_blocked.cu,
// m2l_grid.cu), for sm_90a.
//
// Both compute a GEMM whose A rows are gathered from a padded grid and
// summed over D shifts (directions or offsets):
//   out[p, :] = sum_{j < D} qp[row(p) + shift_j, :K] @ B[op_j]^T
// with B[o] a K-major (N, K) operator.  A kernel supplies only its
// gather (a struct with row, shift, op and out_row; see the kernels);
// the engine owns the output tile, the K loop, the pipeline and the
// epilogue.
//
// f32 on the tensor cores (3xTF32).  With x = hi + lo, hi =
// rna_tf32(x), lo = rna_tf32(x - hi), |x - hi - lo| <= 2^-22 |x|, the
// products lo*hi + hi*lo + hi*hi (smallest first; lo*lo dropped) are
// summed in f32.  A is split in registers as it is read; B, a constant
// operator stack, arrives split once at setup (ops/m2l.py
// `tf32x3_operands`: hi and lo stacks, (2, n_ops, N, K)).  The hi part
// is rounded explicitly (cvt.rna): wgmma ignores the low 13 mantissa
// bits of an f32 operand, so an unrounded hi would be truncated there
// and lo = x - hi would carry nothing.
//
// The tensor cores add into their accumulator with truncation, a bias
// that grows with the length of the sum (a model of it at K = 26 * 1024
// gives 2.4e-4 of the maximum).  So each stage's 12 products go into a
// fresh accumulator (scale-d 0 on the first), the 8 small ones first,
// so that only the 4 main ones truncate a sum of the main terms' size;
// the stage's sum is then added into the block's sum on the CUDA
// cores, rounded to nearest; and the wrappers split long K ranges into
// partial outputs that they add (ops/m2l.py `_splits`), so that no
// block's sum runs over more than 256 stages.
//
// Tile: a block of two warpgroups owns BM = 128 rows x BN columns, warpgroup
// g rows 64g..64g+63, one wgmma.m64nBNk8 per k step, A from registers and B
// from shared memory.  A stage is BK = 32 of K for one shift: A (128 x 32
// f32 of gathered rows, row stride 36 floats, so the fragment loads are free
// of bank conflicts) and B hi, B lo (BN x 32 each, K-major in the 128-byte
// swizzle that the wgmma descriptor reads), all by 16-byte cp.async copies
// into a ring of STAGES stages in dynamic shared memory: while one stage is
// multiplied, the next STAGES - 1 are in flight, and the block waits for the
// next stage and issues the copies of the one after while the tensor cores
// work.  Rows past M, columns past N and K past its end are zero-filled by
// the copies.  The iterations run K-slice-major and shift-minor (it = ks * D
// + j): the blocks in flight read one 32-wide K slice of the grid through
// all D shifts, so that slice stays in L2, and they share B's slices.  A
// block takes the iterations [it0, it1) of its split.
#pragma once
#include <cstdint>

#include "common.cuh"

namespace m2l_tc {

constexpr int BM = 128, BK = 32, kThreads = 256;
constexpr int kAStride = BK + 4;                   // floats per A row
constexpr int kABytes = BM * kAStride * 4;         // 18,432

template <int BN>
struct Tile {
  static constexpr int kBBytes = BN * BK * 4;      // one of hi, lo
  static constexpr int kStage = 2 * kBBytes + kABytes;
  static_assert(kBBytes % 1024 == 0 && kStage % 1024 == 0,
                "the swizzled B tiles need 1024-byte alignment");
};

// Dynamic shared memory of a block, with room to align it to 1024.
template <int BN, int STAGES>
constexpr int smem_bytes() { return STAGES * Tile<BN>::kStage + 1024; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-fills when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// the copies' writes, seen by the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving register accesses across a wgmma wait
__device__ __forceinline__ void pin(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// x rounded to TF32, to nearest with ties away (the low 13 bits zero)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D (64 x BN) = A (64 x 8 tf32, registers) B^T (+ D when scale_d);
// written out for the two widths the kernels take.
template <int BN>
__device__ void wgmma_tf32(float (&d)[BN / 2], const uint32_t (&a)[4],
                           uint64_t desc, int scale_d);

// D (64 x 80) += A (64 x 8, registers) B^T; B K-major in shared memory.
template <>
__device__ __forceinline__ void wgmma_tf32<80>(float (&d)[40],
                                               const uint32_t (&a)[4],
                                               uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

// D (64 x 144) += A (64 x 8, registers) B^T; B K-major in shared memory.
template <>
__device__ __forceinline__ void wgmma_tf32<144>(float (&d)[72],
                                               const uint32_t (&a)[4],
                                               uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %77, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71"
      "}, {%72, %73, %74, %75}, %76, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}


// The block's (m-tile, n-tile) = (blockIdx.x, blockIdx.y) over the
// iterations [it0, it1), its sums written to out (rows g.out_row(p),
// N columns).
template <int BN, int STAGES, class G>
__device__ __forceinline__ void run(const G& g, const float* __restrict__ bhi,
                                    const float* __restrict__ blo,
                                    float* __restrict__ out, int it0,
                                    int it1) {
  using T = Tile<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int K = g.K, N = g.N, D = g.D;

  // this thread's copies: A rows (tid >> 3) + 32 i, 16-byte chunk tid & 7
  const int ac = tid & 7;
  int arow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) arow[i] = g.row(m0 + (tid >> 3) + 32 * i);

  auto load = [&](int it, int slot) {
    const int ks = it / D, j = it - ks * D;
    uint8_t* st = smem + slot * T::kStage;
    const long sh = g.shift(j);
    const int ka = ks * BK + 4 * ac;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = arow[i] >= 0 && ka < K;
      const float* src = ok ? g.qp + (arow[i] + sh) * (long)K + ka : g.qp;
      cp_async16(smem_u32(st + 2 * T::kBBytes +
                          ((tid >> 3) + 32 * i) * (kAStride * 4) + 16 * ac),
                 src, ok);
    }
    const long brow = (long)g.op(j) * N + n0;
#pragma unroll
    for (int q = 0; q < BN / 16; ++q) {            // 2 BN 8 chunks
      const int e = tid + kThreads * q;
      const int hl = e / (BN * 8), rem = e - hl * (BN * 8);
      const int nn = rem >> 3, c = rem & 7, kb = ks * BK + 4 * c;
      const bool ok = n0 + nn < N && kb < K;
      const float* src =
          ok ? (hl ? blo : bhi) + (brow + nn) * K + kb : bhi;
      cp_async16(smem_u32(st + hl * T::kBBytes + nn * 128 +
                          ((c ^ (nn & 7)) << 4)),
                 src, ok);
    }
  };

  const int wg = tid >> 7, w = (tid >> 5) & 3, lane = tid & 31;
  const int fr = wg * 64 + w * 16 + (lane >> 2), fc = lane & 3;
  float acc[BN / 2], tmp[BN / 2];
#pragma unroll
  for (int q = 0; q < BN / 2; ++q) acc[q] = tmp[q] = 0.f;

  const int n_it = it1 - it0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_it) load(it0 + s, s);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  fence_proxy_async();
  __syncthreads();                // stage 0 landed
  for (int i = 0; i < n_it; ++i) {
    const uint8_t* st = smem + (i % STAGES) * T::kStage;
    const float* As = reinterpret_cast<const float*>(st + 2 * T::kBBytes);
    uint32_t ahi[4][4], alo[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int c = 8 * s + fc;
      const float x[4] = {As[fr * kAStride + c], As[(fr + 8) * kAStride + c],
                          As[fr * kAStride + c + 4],
                          As[(fr + 8) * kAStride + c + 4]};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        ahi[s][q] = tf32_rna(x[q]);
        alo[s][q] = tf32_rna(x[q] - __uint_as_float(ahi[s][q]));
      }
    }
    const uint32_t bh = smem_u32(st), bl = smem_u32(st + T::kBBytes);
#pragma unroll
    for (int q = 0; q < BN / 2; ++q) pin(tmp[q]);
    wgmma_fence();
    // the small terms of the stage first, then its main terms: each
    // wgmma truncates the sum it returns, so the fewer of them add to
    // a sum of the main terms' size, the smaller the bias
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      wgmma_tf32<BN>(tmp, alo[s], desc_sw128(bh + 32 * s), s > 0);
      wgmma_tf32<BN>(tmp, ahi[s], desc_sw128(bl + 32 * s), 1);
    }
#pragma unroll
    for (int s = 0; s < 4; ++s)
      wgmma_tf32<BN>(tmp, ahi[s], desc_sw128(bh + 32 * s), 1);
    wgmma_commit();

    // while the tensor cores run stage i: wait for stage i + 1 and
    // refill the slot of stage i - 1 (its products were waited for)
    cp_async_wait<STAGES - 3>();
    fence_proxy_async();
    __syncthreads();
    if (i + STAGES - 1 < n_it)
      load(it0 + i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();

    wgmma_wait<0>();
#pragma unroll
    for (int q = 0; q < BN / 2; ++q) {
      pin(tmp[q]);
      acc[q] += tmp[q];
    }
  }
  cp_async_wait<0>();

  // accumulator (row fr + 8 h, columns 8 q + 2 fc, +1) = acc[4 q + 2 h, +1]
#pragma unroll
  for (int q = 0; q < BN / 8; ++q) {
    const int col = n0 + 8 * q + 2 * fc;
    if (col >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = m0 + fr + 8 * h;
      if (p < g.M)
        *reinterpret_cast<float2*>(out + g.out_row(p) * N + col) =
            make_float2(acc[4 * q + 2 * h], acc[4 * q + 2 * h + 1]);
    }
  }
}

}  // namespace m2l_tc
