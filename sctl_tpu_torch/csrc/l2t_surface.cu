// L2T: each box's downward-equivalent densities on the shared surface
// evaluated at the box's real target slots.
//
// Replaces: sctl_tpu/ops/pallas_sl.py `l2t_surface` (pl.pallas_call at
// :354).  A box's real targets are its first cnt_t[b] slots (int32 per
// box, Morton order, clipped here to cap_t; null means every slot, the
// JAX function's definition).  For a real target slot t < cnt_t[b]:
//   out[j, b*cap_t + t] = sum_m K(xt[:, b*cap_t + t] - surf[m])
//                         q[:, m, b]
// (component j < k1, unscaled, box-local coordinates, r2 = 0 masked);
// the target slots at or past cnt_t[b] are written 0, as the stencils
// do.  The L2T kernels Laplace3D-FxU and -FxdU and Stokes3D-FSxU; the
// formula is a template parameter (ukernels.cuh).
//
// Bound on the H100: the real pairs, one rsqrt each at 16 per SM per
// clock.  At 1e7 points, depth 6 (B = 262,144, cap_t 48, ns 152):
// 1.51e9 real pairs, 0.36 ms; the bytes (targets, densities, outputs,
// 0.4 GB) take 0.11 ms.  What holds a lean pair loop is the issue rate
// (128 lane-instructions a clock per SM), about 10 instructions a
// Laplace pair (chip_smoke.py reads the loop's count with cuobjdump).
// Every padded slot would be 1.91e9 slot pairs; the default formula
// form's rsqrtf carries a denormal fix-up.
//
// Design: a block owns G consecutive boxes (G a power of two from the
// target capacity, about kMaxThreads threads a block; a template
// constant, so that the records' stride is an immediate offset).  It
// stages one float4 record a surface point and box in shared memory,
// (x, y, z, q_0) and, for Stokes3D-FSxU's four densities, a second,
// surface-point-major with the boxes adjacent, so that the loads of the
// (k0, ns, B) densities read G adjacent boxes and the stores are
// conflict-free.  It packs its boxes' real targets one after another,
// TPT consecutive targets of one box a thread
// (sctl_tpu_torch/surface_sweep.py times TPT = 1, 2 and 4 side by
// side).  Each thread walks the ns records of its box: the lanes of a
// warp read one address, or the adjacent ones of the two or three boxes
// the warp spans, so one load serves TPT pairs.  Only the real targets
// are evaluated; the warps past the block's real targets skip the loop.
// Each thread sums each tile of kTile surface points into fresh f32
// partial sums and adds them to its totals, as every pair kernel since
// p2p_direct.cu; no atomics, so a launch repeats bit for bit.  A warp's
// stores fill adjacent target slots of a component row.  The TPU's hi/lo
// one-hot expansion of the densities (pallas_sl.py:288-293) is not
// carried over: a thread reads its box's records directly.
//
// The double build (the float64 KIFMM on the card) is the same kernel on
// Real = double: the same real targets by the per-box counts, fresh
// partial sums a tile, the lean double rsqrt (ukernels.cuh) and the same
// summation order, so a launch repeats bit for bit.  A surface point's
// values take two double2 records (four for Stokes3D-FSxU) where float's
// take one float4 (two) (Rec16, common.cuh), so kSmem holds the records
// of half as many boxes (at phase 4's widths still the threads' 16).
// Bound: the DP pipe (64 lane-operations a clock per SM): 14 DP
// instructions a Laplace pair (chip_smoke.py reads them from the SASS).
#include "common.cuh"
#include "ukernels.cuh"

namespace {

constexpr int TPT = 2;              // targets a thread
constexpr int kTile = 64;           // surface points summed apart
constexpr int kMaxThreads = 512;
constexpr int kMaxG = 16;           // boxes a block (a power of two)
constexpr int kSmem = 96 * 1024;    // record bytes a block, for 2 an SM

// 16-byte records of a surface point: x, y, z and the box's k0 densities
template <typename Real, int KER>
__host__ __device__ constexpr int records() {
  return sctl::records_of<Real>(3 + sctl::Dims<KER>::k0);
}

template <typename Real, int KER, int G>
__global__ void __launch_bounds__(kMaxThreads)
l2t_surface_kernel(const Real* __restrict__ surf,
                   const Real* __restrict__ xt,
                   const Real* __restrict__ q,
                   const int* __restrict__ cnt_t, Real* __restrict__ out,
                   int ns, int B, int cap_t) {
  using D = sctl::Dims<KER>;
  using V = sctl::Rec16<Real>;
  using Rec = typename V::T;
  constexpr int K0 = D::k0, K1 = D::k1, R = records<Real, KER>(), W = V::W;
  extern __shared__ float4 rec_raw[];
  Rec* rec = reinterpret_cast<Rec*>(rec_raw);   // (ns, G, R)
  // real targets of the block's boxes; the first thread of each box
  __shared__ int ct[G], toff[G + 1];
  const int b0 = blockIdx.x * G, nb = min(G, B - b0);
  const int tid = threadIdx.x;
  if (tid < G)
    ct[tid] = tid >= nb ? 0
              : cnt_t ? max(0, min(cnt_t[b0 + tid], cap_t)) : cap_t;
  __syncthreads();
  if (tid == 0) {
    toff[0] = 0;
    for (int j = 0; j < G; ++j)
      toff[j + 1] = toff[j] + (ct[j] + TPT - 1) / TPT;
  }
  // the records, the block's boxes adjacent for each surface point
  for (int i = tid; i < ns * G; i += blockDim.x) {
    const int m = i / G, j = i - m * G;
    Real v[W * R];
#pragma unroll
    for (int c = 0; c < W * R; ++c) v[c] = Real(0);
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = surf[3 * m + c];
    if (j < nb) {
#pragma unroll
      for (int c = 0; c < K0; ++c)
        v[3 + c] = q[((long)c * ns + m) * B + b0 + j];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) rec[(long)i * R + r] = V::pack(v + W * r);
  }
  // the padded target slots of the block's boxes come out zero
  const long T = (long)B * cap_t;
  for (int i = tid; i < nb * cap_t; i += blockDim.x) {
    const int j = i / cap_t, t = i - j * cap_t;
    if (t >= ct[j]) {
      const long slot = (long)b0 * cap_t + i;
#pragma unroll
      for (int c = 0; c < K1; ++c) out[c * T + slot] = Real(0);
    }
  }
  __syncthreads();
  for (int g = tid; g < toff[nb]; g += blockDim.x) {
    int j = 0;
    for (int k = 1; k < nb; ++k) j += g >= toff[k];
    const int t0 = (g - toff[j]) * TPT;
    const int live = min(TPT, ct[j] - t0);
    const long slot = (long)(b0 + j) * cap_t + t0;
    Real x[TPT], y[TPT], z[TPT], acc[TPT][K1];
#pragma unroll
    for (int k = 0; k < TPT; ++k) {
      // a slot past the box's count sums a dummy and is not stored
      x[k] = k < live ? xt[slot + k] : Real(0);
      y[k] = k < live ? xt[T + slot + k] : Real(0);
      z[k] = k < live ? xt[2 * T + slot + k] : Real(0);
#pragma unroll
      for (int c = 0; c < K1; ++c) acc[k][c] = Real(0);
    }
    const Rec* rb = rec + j * R;    // (m, j) at rb[m * G * R]
    for (int m0 = 0; m0 < ns; m0 += kTile) {
      const int m1 = min(ns, m0 + kTile);
      Real part[TPT][K1];
#pragma unroll
      for (int k = 0; k < TPT; ++k)
#pragma unroll
        for (int c = 0; c < K1; ++c) part[k][c] = Real(0);
#pragma unroll 4
      for (int m = m0; m < m1; ++m) {
        Real v[W * R];
#pragma unroll
        for (int r = 0; r < R; ++r) V::unpack(rb[m * G * R + r], v + W * r);
#pragma unroll
        for (int k = 0; k < TPT; ++k)
          sctl::uker_acc<KER, true>(x[k] - v[0], y[k] - v[1], z[k] - v[2],
                                    v + 3, (const Real*)nullptr, part[k]);
      }
#pragma unroll
      for (int k = 0; k < TPT; ++k)
#pragma unroll
        for (int c = 0; c < K1; ++c) acc[k][c] += part[k][c];
    }
#pragma unroll
    for (int k = 0; k < TPT; ++k) {
      if (k < live) {
#pragma unroll
        for (int c = 0; c < K1; ++c) out[c * T + slot + k] = acc[k][c];
      }
    }
  }
}

// boxes a block and threads a block at (ns, cap_t): about kMaxThreads
// threads of TPT targets, at most kMaxG boxes and kSmem bytes of records
// (one box at least), a power of two, so that the records' stride is a
// constant and the loop's loads take immediate offsets
template <typename Real, int KER>
void layout(int ns, int cap_t, int* G, int* threads) {
  const int per_box = (cap_t + TPT - 1) / TPT;
  int g = kMaxThreads / (per_box > 0 ? per_box : 1);
  const int by_smem =
      kSmem / (int)(sizeof(typename sctl::Rec16<Real>::T) *
                    records<Real, KER>() * ns);
  g = g < by_smem ? g : by_smem;
  *G = 1;
  while (*G * 2 <= g && *G * 2 <= kMaxG) *G *= 2;
  const int up = (*G * per_box + 31) / 32 * 32;
  *threads = up < 32 ? 32 : up > kMaxThreads ? kMaxThreads : up;
}

template <typename Real, int KER>
size_t smem_bytes(int ns, int G) {
  return sizeof(typename sctl::Rec16<Real>::T) * records<Real, KER>() *
         (size_t)ns * G;
}

// launch (blocks == null) or the resident blocks an SM (the occupancy
// API) of the instantiation with G boxes a block
template <typename Real, int KER, int G>
int run_g(const Real* surf, const Real* xt, const Real* q,
          const int* cnt_t, Real* out, int ns, int B, int cap_t,
          int threads, cudaStream_t stream, int* blocks) {
  const size_t smem = smem_bytes<Real, KER>(ns, G);
  cudaError_t err = allow_smem(l2t_surface_kernel<Real, KER, G>, smem);
  if (err != cudaSuccess) return (int)err;
  if (blocks)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, l2t_surface_kernel<Real, KER, G>, threads, smem);
  l2t_surface_kernel<Real, KER, G>
      <<<(B + G - 1) / G, threads, smem, stream>>>(surf, xt, q, cnt_t, out,
                                                   ns, B, cap_t);
  return (int)cudaGetLastError();
}

template <typename Real, int KER>
int run_layout(const Real* surf, const Real* xt, const Real* q,
               const int* cnt_t, Real* out, int ns, int B, int cap_t,
               cudaStream_t stream, int* lay, int* blocks) {
  lay[0] = TPT;
  layout<Real, KER>(ns, cap_t, &lay[1], &lay[2]);
  switch (lay[1]) {
    case 1: return run_g<Real, KER, 1>(surf, xt, q, cnt_t, out, ns, B,
                                       cap_t, lay[2], stream, blocks);
    case 2: return run_g<Real, KER, 2>(surf, xt, q, cnt_t, out, ns, B,
                                       cap_t, lay[2], stream, blocks);
    case 4: return run_g<Real, KER, 4>(surf, xt, q, cnt_t, out, ns, B,
                                       cap_t, lay[2], stream, blocks);
    case 8: return run_g<Real, KER, 8>(surf, xt, q, cnt_t, out, ns, B,
                                       cap_t, lay[2], stream, blocks);
    default: return run_g<Real, KER, 16>(surf, xt, q, cnt_t, out, ns, B,
                                         cap_t, lay[2], stream, blocks);
  }
}

template <typename Real>
struct Launch {
  template <int KER>
  struct Of {
    static int run(const Real* surf, const Real* xt, const Real* q,
                   const int* cnt_t, Real* out, int ns, int B, int cap_t,
                   cudaStream_t stream) {
      int lay[3];
      return run_layout<Real, KER>(surf, xt, q, cnt_t, out, ns, B, cap_t,
                                   stream, lay, nullptr);
    }
  };
};

// the block at these widths and the resident blocks an SM
template <typename Real>
struct Occupancy {
  template <int KER>
  struct Of {
    static int run(int ns, int cap_t, int* lay, int* blocks) {
      return run_layout<Real, KER>(nullptr, nullptr, nullptr, nullptr,
                                   nullptr, ns, 0, cap_t, nullptr, lay,
                                   blocks);
    }
  };
};

template <typename Real>
int l2t_surface(const Real* surf, const Real* xt, const Real* q,
                const int* cnt_t, Real* out, int ker, int ns, int B,
                int cap_t, cudaStream_t stream) {
  using namespace sctl;
  return dispatch_formula<Launch<Real>::template Of, kLapFxU, kLapFxdU,
                          kStkFSxU>(ker, surf, xt, q, cnt_t, out, ns, B,
                                    cap_t, stream);
}

}  // namespace

// surf (ns, 3), xt (3, B*cap_t), q (k0, ns, B), cnt_t (B) int32 real
// targets of each box, its first (null: all cap_t), out (k1, B*cap_t);
// float32 (sctl_l2t_surface) or float64 (sctl_l2t_surface_f64).  ker:
// the formula index of ukernels.cuh, one of the L2T kernels.
SCTL_API int sctl_l2t_surface(const float* surf, const float* xt,
                              const float* q, const int* cnt_t, float* out,
                              int ker, int ns, int B, int cap_t,
                              cudaStream_t stream) {
  return l2t_surface<float>(surf, xt, q, cnt_t, out, ker, ns, B, cap_t,
                            stream);
}

SCTL_API int sctl_l2t_surface_f64(const double* surf, const double* xt,
                                  const double* q, const int* cnt_t,
                                  double* out, int ker, int ns, int B,
                                  int cap_t, cudaStream_t stream) {
  return l2t_surface<double>(surf, xt, q, cnt_t, out, ker, ns, B, cap_t,
                             stream);
}

// The block at (ns, cap_t) of the float (f64 = 0) or double build,
// [targets a thread, boxes a block, threads a block], into
// layout[0..2], and the resident blocks an SM of formula ker into
// *blocks (the occupancy API).
SCTL_API int sctl_l2t_surface_occupancy(int ker, int f64, int ns, int cap_t,
                                        int* layout, int* blocks) {
  using namespace sctl;
  if (f64)
    return dispatch_formula<Occupancy<double>::Of, kLapFxU, kLapFxdU,
                            kStkFSxU>(ker, ns, cap_t, layout, blocks);
  return dispatch_formula<Occupancy<float>::Of, kLapFxU, kLapFxdU,
                          kStkFSxU>(ker, ns, cap_t, layout, blocks);
}
