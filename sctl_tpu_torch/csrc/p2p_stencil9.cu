// Near-field P2P over the packed 9-column slab, real slots only.
//
// Replaces: sctl_tpu/ops/pallas_p2p.py `p2p_stencil9`
// (pl.pallas_call at :425).  Slab entry z' of column (x, y) holds the 9
// (dx, dy) neighbour columns' box (x+dx, y+dy, z'-1) points, so the
// 27-box neighbourhood of target box (x, y, z) is the three entries
// z, z+1, z+2.  The port compacts each entry at setup (ops/p2p.py
// `slab_index`): its boxes' real points are its first cnt9[x, y, z']
// slots, zeros past them (null cnt9: all SL slots, the JAX layout).  For
// a real target slot t < cnt_t[x, y, z] (null cnt_t: all cap_t):
//   out[x, y, z, t, :] = sum_{j < 3} sum_{s < cnt9[x, y, z+j]}
//       K(xt[x, y, z, :, t] - xs[x, y, :, (z+j) SL + s])
//       f[x, y, :, (z+j) SL + s]
// with r2 = 0 masked; target slots at or past cnt_t are written 0.  The
// JAX function sums every slot, whose padding carries zero density, so
// skipping it changes only the order of the f32 sums.  Unscaled.  The
// formula is a template parameter (ukernels.cuh): the six kernels with a
// tree path; the double layers read the slab's normals.
//
// Bound on the H100: the real pairs, one rsqrt each at 16 per SM per
// clock.  At 1e7 points, depth 6 (n = 64, cap_s 56, cap_t 48, SL 512):
// 9.94e9 real pairs, 2.4 ms.  Every padded slot pair (1.93e10) in the
// default formula form (19.5 SASS instructions a pair) puts the
// issue-slot floor (128 lane-instructions a clock per SM) at 11.3 ms;
// the real pairs in the lean form (11.5 a pair, chip_smoke.py reads it)
// at 3.4 ms: the issue rate, not the rsqrt units, is the limit.
//
// Design: one block per (column, 4 consecutive z boxes).  The block
// stages the real runs of its 6 entries one after another in shared
// memory: float4 (x, y, z, f_0), then one plane per further density and
// normal component.  Box z's window is then one contiguous run of about
// 1,030 sources.  The 4 boxes' real targets are packed one after
// another, S = 2 neighbouring lanes a target, each summing every other
// source of the window (a warp may hold two boxes' targets: its lanes
// run their own windows at the same pace), so no lane idles on a padded
// slot, and the block has twice the warps of one lane a target to hide
// the loop's latencies with (4 blocks an SM by the shared memory).  On
// phase 4's widths S = 2 read 4.69 ms against 6.66 for one lane a
// target (sctl_tpu_torch/p2p_sweep.py; PERF.md section 6).  Each lane
// sums each entry's pairs into fresh f32 partial sums (the rule of every
// pair kernel since p2p_direct.cu: one running f32 sum a thread drifted
// to 5.0e-6 of the maximum) in the lean formula form, 8 pairs a loop
// pass; the two lanes meet by one warp shuffle.  No atomics: a launch
// repeats bit for bit.
//
// The double build (the float64 KIFMM on the card) is the same kernel on
// Real = double: the same compacted entries and counts, fresh partial
// sums an entry, the lean double rsqrt (ukernels.cuh) and the same
// summation order and shuffle, so a launch repeats bit for bit.  A
// slot's (x, y, z, f_0) take two double2 records where float's take one
// float4 (Rec16, common.cuh), and the further planes are double: phase
// 4's window (6 SL slots of 4 values, SL 512) is 98 KB against 49 KB, so
// 2 blocks an SM fit where float fits 4 (the route rule `stencil9_fits`
// counts 8 bytes a value).  The block takes at most 512 threads, so that
// the double sums keep 128 registers a thread (targets past 256 lanes'
// worth go in passes).  Bound: the DP pipe (64 lane-operations a clock
// per SM): 14 DP instructions a Laplace pair (chip_smoke.py reads them
// from the SASS).
#include "common.cuh"
#include "ukernels.cuh"

namespace {

constexpr int kZ = 4;               // z boxes per block
constexpr int S = 2;                // lanes a target

// threads a block at most: 1,024 in float, 512 in double
template <typename Real>
__host__ __device__ constexpr int max_threads() {
  return sizeof(Real) == 4 ? 1024 : 512;
}

// planes beyond the (x, y, z, f_0) of a slot
template <int KER>
constexpr int extra_planes() {
  return sctl::Dims<KER>::k0 - 1 + (sctl::Dims<KER>::nrm ? 3 : 0);
}

template <typename Real, int KER>
__global__ void __launch_bounds__(max_threads<Real>())
p2p_stencil9_kernel(const Real* __restrict__ xt,
                    const Real* __restrict__ xs,
                    const Real* __restrict__ ns,
                    const Real* __restrict__ f,
                    const int* __restrict__ cnt9,
                    const int* __restrict__ cnt_t, Real* __restrict__ out,
                    int n, int SL, int cap_t) {
  using D = sctl::Dims<KER>;
  using V = sctl::Rec16<Real>;
  using Rec = typename V::T;
  constexpr int K0 = D::k0, K1 = D::k1, NN = D::nrm ? 3 : 0;
  constexpr int W = V::W, R0 = 4 / W;      // records of (x, y, z, f_0)
  extern __shared__ float4 smem[];
  Rec* win = reinterpret_cast<Rec*>(smem);
  // real slots of the block's 6 entries and real targets of its 4
  // boxes; then the staged offset of each entry and each box's first
  // thread
  __shared__ int c9[kZ + 2], ct[kZ], soff[kZ + 3], toff[kZ + 1];
  const int col = blockIdx.y;                // x * n + y
  const int z0 = blockIdx.x * kZ;
  const int nz = min(kZ, n - z0);
  const int tid = threadIdx.x;
  if (tid < kZ + 2)
    c9[tid] = tid >= nz + 2 ? 0
              : cnt9 ? max(0, min(cnt9[(long)col * (n + 2) + z0 + tid], SL))
                     : SL;
  else if (tid < 2 * kZ + 2)
    ct[tid - kZ - 2] = tid - kZ - 2 >= nz ? 0
                       : cnt_t ? max(0, min(cnt_t[(long)col * n + z0 + tid
                                                  - kZ - 2], cap_t))
                               : cap_t;
  __syncthreads();
  if (tid == 0) {
    soff[0] = toff[0] = 0;
    for (int j = 0; j < kZ + 2; ++j) soff[j + 1] = soff[j] + c9[j];
    for (int j = 0; j < kZ; ++j) toff[j + 1] = toff[j] + ct[j];
  }
  __syncthreads();

  const long slab = (long)(n + 2) * SL;
  const Real* xc = xs + (long)col * 3 * slab;
  const Real* nc = NN ? ns + (long)col * 3 * slab : nullptr;
  const Real* fc = f + (long)col * K0 * slab;
  const int Wmax = (kZ + 2) * SL;
  Real* ext = reinterpret_cast<Real*>(win + Wmax * R0);   // (E, Wmax)
  for (int j = 0; j < nz + 2; ++j) {
    const int m = c9[j];
    const long g0 = (long)(z0 + j) * SL;
    for (int i = tid; i < m; i += blockDim.x) {
      const long g = g0 + i;
      const int w = soff[j] + i;
      const Real v[4] = {xc[g], xc[slab + g], xc[2 * slab + g], fc[g]};
#pragma unroll
      for (int r = 0; r < R0; ++r) win[w * R0 + r] = V::pack(v + W * r);
#pragma unroll
      for (int c = 1; c < K0; ++c) ext[(c - 1) * Wmax + w] = fc[c * slab + g];
#pragma unroll
      for (int c = 0; c < NN; ++c)
        ext[(K0 - 1 + c) * Wmax + w] = nc[c * slab + g];
    }
  }
  // the padded target slots of the block's boxes come out zero
  const long box0 = (long)col * n + z0;
  for (int i = tid; i < nz * cap_t; i += blockDim.x) {
    const int zl = i / cap_t, t = i - zl * cap_t;
    if (t >= ct[zl]) {
      Real* o = out + ((box0 + zl) * cap_t + t) * K1;
#pragma unroll
      for (int j = 0; j < K1; ++j) o[j] = Real(0);
    }
  }
  __syncthreads();
  // S lanes a target, each summing every S-th source of its window; the
  // targets in passes of blockDim / S (one pass while S kZ cap_t fits)
  const int sub = tid % S;
  for (int g0 = 0; g0 < toff[nz]; g0 += blockDim.x / S) {
    const int g = g0 + tid / S;
    const bool live = g < toff[nz];
    int zl = 0;
#pragma unroll
    for (int j = 1; j < kZ; ++j) zl += g >= toff[j];
    const int t = g - toff[zl];
    const Real* xb = xt + (box0 + zl) * 3 * cap_t;
    Real x = Real(0), y = Real(0), z = Real(0);
    if (live) {
      x = xb[t];
      y = xb[cap_t + t];
      z = xb[2 * cap_t + t];
    }
    Real acc[K1];
#pragma unroll
    for (int j = 0; j < K1; ++j) acc[j] = Real(0);
#pragma unroll 1
    for (int e = zl; live && e < zl + 3; ++e) {   // the window's entries
      Real part[K1];
#pragma unroll
      for (int j = 0; j < K1; ++j) part[j] = Real(0);
      const int hi = soff[e + 1];
#pragma unroll 8
      for (int s = soff[e] + sub; s < hi; s += S) {
        Real q[4];
#pragma unroll
        for (int r = 0; r < R0; ++r) V::unpack(win[s * R0 + r], q + W * r);
        Real fv[K0], nv[3];
        fv[0] = q[3];
#pragma unroll
        for (int c = 1; c < K0; ++c) fv[c] = ext[(c - 1) * Wmax + s];
#pragma unroll
        for (int c = 0; c < NN; ++c) nv[c] = ext[(K0 - 1 + c) * Wmax + s];
        sctl::uker_acc<KER, true>(x - q[0], y - q[1], z - q[2], fv, nv,
                                  part);
      }
#pragma unroll
      for (int j = 0; j < K1; ++j) acc[j] += part[j];
    }
    // the S lanes of a target: a butterfly over neighbouring lanes
#pragma unroll
    for (int o = 1; o < S; o <<= 1)
#pragma unroll
      for (int j = 0; j < K1; ++j)
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
    if (live && sub == 0) {
      Real* o = out + ((box0 + zl) * cap_t + t) * K1;
#pragma unroll
      for (int j = 0; j < K1; ++j) o[j] = acc[j];
    }
  }
}

// S lanes for each target slot of kZ boxes, rounded to a warp, at most
// max_threads
template <typename Real>
int threads(int cap_t) {
  const int up = (S * kZ * cap_t + 31) / 32 * 32;
  return up < max_threads<Real>() ? up : max_threads<Real>();
}

template <typename Real, int KER>
size_t smem_bytes(int SL) {
  return sizeof(Real) * (4 + extra_planes<KER>()) * (size_t)(kZ + 2) * SL;
}

template <typename Real>
struct Launch {
  template <int KER>
  struct Of {
    static int run(const Real* xt, const Real* xs, const Real* ns,
                   const Real* f, const int* cnt9, const int* cnt_t,
                   Real* out, int n, int SL, int cap_t,
                   cudaStream_t stream) {
      const size_t smem = smem_bytes<Real, KER>(SL);
      cudaError_t err = allow_smem(p2p_stencil9_kernel<Real, KER>, smem);
      if (err != cudaSuccess) return (int)err;
      dim3 grid((n + kZ - 1) / kZ, n * n);
      p2p_stencil9_kernel<Real, KER>
          <<<grid, threads<Real>(cap_t), smem, stream>>>(
              xt, xs, ns, f, cnt9, cnt_t, out, n, SL, cap_t);
      return (int)cudaGetLastError();
    }
  };
};

// resident blocks an SM at these widths, from the occupancy API
template <typename Real>
struct Occupancy {
  template <int KER>
  struct Of {
    static int run(int SL, int cap_t, int* layout, int* blocks) {
      layout[0] = S;
      layout[1] = threads<Real>(cap_t);
      const size_t smem = smem_bytes<Real, KER>(SL);
      cudaError_t err = allow_smem(p2p_stencil9_kernel<Real, KER>, smem);
      if (err != cudaSuccess) return (int)err;
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, p2p_stencil9_kernel<Real, KER>, layout[1], smem);
    }
  };
};

template <typename Real>
int p2p_stencil9(const Real* xt, const Real* xs, const Real* ns,
                 const Real* f, const int* cnt9, const int* cnt_t,
                 Real* out, int ker, int n, int SL, int cap_t,
                 cudaStream_t stream) {
  using namespace sctl;
  return dispatch_formula<Launch<Real>::template Of, kLapFxU, kLapDxU,
                          kLapFxdU, kStkFxU, kStkDxU, kStkFSxU>(
      ker, xt, xs, ns, f, cnt9, cnt_t, out, n, SL, cap_t, stream);
}

}  // namespace

// xt (n, n, n, 3, cap_t), xs (n, n, 3, (n+2)*SL), ns (n, n, 3,
// (n+2)*SL) (double layers only, else null), f (n, n, k0, (n+2)*SL),
// cnt9 (n, n, n+2) int32 real slots of each slab entry, its first (null:
// all SL), cnt_t (n, n, n) int32 real target slots (null: all cap_t),
// out (n, n, n, cap_t, k1); float32 (sctl_p2p_stencil9) or float64
// (sctl_p2p_stencil9_f64).  ker: the formula index of ukernels.cuh, one
// of the six kernels with a tree path.
SCTL_API int sctl_p2p_stencil9(const float* xt, const float* xs,
                               const float* ns, const float* f,
                               const int* cnt9, const int* cnt_t, float* out,
                               int ker, int n, int SL, int cap_t,
                               cudaStream_t stream) {
  return p2p_stencil9<float>(xt, xs, ns, f, cnt9, cnt_t, out, ker, n, SL,
                             cap_t, stream);
}

SCTL_API int sctl_p2p_stencil9_f64(const double* xt, const double* xs,
                                   const double* ns, const double* f,
                                   const int* cnt9, const int* cnt_t,
                                   double* out, int ker, int n, int SL,
                                   int cap_t, cudaStream_t stream) {
  return p2p_stencil9<double>(xt, xs, ns, f, cnt9, cnt_t, out, ker, n, SL,
                              cap_t, stream);
}

// The block at (SL, cap_t) of the float (f64 = 0) or double build,
// [lanes a target, threads], into layout[0..1], and the resident blocks
// an SM of formula ker into *blocks (the occupancy API).
SCTL_API int sctl_p2p_stencil9_occupancy(int ker, int f64, int SL,
                                         int cap_t, int* layout,
                                         int* blocks) {
  using namespace sctl;
  if (f64)
    return dispatch_formula<Occupancy<double>::Of, kLapFxU, kLapDxU,
                            kLapFxdU, kStkFxU, kStkDxU, kStkFSxU>(
        ker, SL, cap_t, layout, blocks);
  return dispatch_formula<Occupancy<float>::Of, kLapFxU, kLapDxU, kLapFxdU,
                          kStkFxU, kStkDxU, kStkFSxU>(ker, SL, cap_t, layout,
                                                      blocks);
}
