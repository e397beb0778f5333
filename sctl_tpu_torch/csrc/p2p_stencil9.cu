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
#include "common.cuh"
#include "ukernels.cuh"

namespace {

constexpr int kZ = 4;               // z boxes per block
constexpr int S = 2;                // lanes a target
constexpr int kMaxThreads = 1024;

// float planes beyond the float4 (x, y, z, f_0) of a slot
template <int KER>
constexpr int extra_planes() {
  return sctl::Dims<KER>::k0 - 1 + (sctl::Dims<KER>::nrm ? 3 : 0);
}

template <int KER>
__global__ void __launch_bounds__(kMaxThreads)
p2p_stencil9_kernel(const float* __restrict__ xt,
                    const float* __restrict__ xs,
                    const float* __restrict__ ns,
                    const float* __restrict__ f,
                    const int* __restrict__ cnt9,
                    const int* __restrict__ cnt_t, float* __restrict__ out,
                    int n, int SL, int cap_t) {
  using D = sctl::Dims<KER>;
  constexpr int K0 = D::k0, K1 = D::k1, NN = D::nrm ? 3 : 0;
  extern __shared__ float4 win[];
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
  const float* xc = xs + (long)col * 3 * slab;
  const float* nc = NN ? ns + (long)col * 3 * slab : nullptr;
  const float* fc = f + (long)col * K0 * slab;
  const int Wmax = (kZ + 2) * SL;
  float* ext = reinterpret_cast<float*>(win + Wmax);   // (E, Wmax)
  for (int j = 0; j < nz + 2; ++j) {
    const int m = c9[j];
    const long g0 = (long)(z0 + j) * SL;
    for (int i = tid; i < m; i += blockDim.x) {
      const long g = g0 + i;
      const int w = soff[j] + i;
      win[w] = make_float4(xc[g], xc[slab + g], xc[2 * slab + g], fc[g]);
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
      float* o = out + ((box0 + zl) * cap_t + t) * K1;
#pragma unroll
      for (int j = 0; j < K1; ++j) o[j] = 0.f;
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
    const float* xb = xt + (box0 + zl) * 3 * cap_t;
    float x = 0.f, y = 0.f, z = 0.f;
    if (live) {
      x = xb[t];
      y = xb[cap_t + t];
      z = xb[2 * cap_t + t];
    }
    float acc[K1];
#pragma unroll
    for (int j = 0; j < K1; ++j) acc[j] = 0.f;
#pragma unroll 1
    for (int e = zl; live && e < zl + 3; ++e) {   // the window's entries
      float part[K1];
#pragma unroll
      for (int j = 0; j < K1; ++j) part[j] = 0.f;
      const int hi = soff[e + 1];
#pragma unroll 8
      for (int s = soff[e] + sub; s < hi; s += S) {
        const float4 q = win[s];
        float fv[K0], nv[3];
        fv[0] = q.w;
#pragma unroll
        for (int c = 1; c < K0; ++c) fv[c] = ext[(c - 1) * Wmax + s];
#pragma unroll
        for (int c = 0; c < NN; ++c) nv[c] = ext[(K0 - 1 + c) * Wmax + s];
        sctl::uker_acc<KER, true>(x - q.x, y - q.y, z - q.z, fv, nv, part);
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
      float* o = out + ((box0 + zl) * cap_t + t) * K1;
#pragma unroll
      for (int j = 0; j < K1; ++j) o[j] = acc[j];
    }
  }
}

// S lanes for each target slot of kZ boxes, rounded to a warp, at most
// kMaxThreads
int threads(int cap_t) {
  const int up = (S * kZ * cap_t + 31) / 32 * 32;
  return up < kMaxThreads ? up : kMaxThreads;
}

template <int KER>
size_t smem_bytes(int SL) {
  return (sizeof(float4) + sizeof(float) * extra_planes<KER>())
         * (size_t)(kZ + 2) * SL;
}

template <int KER>
struct Launch {
  static int run(const float* xt, const float* xs, const float* ns,
                 const float* f, const int* cnt9, const int* cnt_t,
                 float* out, int n, int SL, int cap_t, cudaStream_t stream) {
    const size_t smem = smem_bytes<KER>(SL);
    cudaError_t err = allow_smem(p2p_stencil9_kernel<KER>, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((n + kZ - 1) / kZ, n * n);
    p2p_stencil9_kernel<KER><<<grid, threads(cap_t), smem, stream>>>(
        xt, xs, ns, f, cnt9, cnt_t, out, n, SL, cap_t);
    return (int)cudaGetLastError();
  }
};

// resident blocks an SM at these widths, from the occupancy API
template <int KER>
struct Occupancy {
  static int run(int SL, int cap_t, int* layout, int* blocks) {
    layout[0] = S;
    layout[1] = threads(cap_t);
    const size_t smem = smem_bytes<KER>(SL);
    cudaError_t err = allow_smem(p2p_stencil9_kernel<KER>, smem);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, p2p_stencil9_kernel<KER>, threads(cap_t), smem);
  }
};

}  // namespace

// xt (n, n, n, 3, cap_t), xs (n, n, 3, (n+2)*SL), ns (n, n, 3,
// (n+2)*SL) (double layers only, else null), f (n, n, k0, (n+2)*SL),
// cnt9 (n, n, n+2) int32 real slots of each slab entry, its first (null:
// all SL), cnt_t (n, n, n) int32 real target slots (null: all cap_t),
// out (n, n, n, cap_t, k1); float32.  ker: the formula index of
// ukernels.cuh, one of the six kernels with a tree path.
SCTL_API int sctl_p2p_stencil9(const float* xt, const float* xs,
                               const float* ns, const float* f,
                               const int* cnt9, const int* cnt_t, float* out,
                               int ker, int n, int SL, int cap_t,
                               cudaStream_t stream) {
  using namespace sctl;
  return dispatch_formula<Launch, kLapFxU, kLapDxU, kLapFxdU, kStkFxU,
                          kStkDxU, kStkFSxU>(ker, xt, xs, ns, f, cnt9, cnt_t,
                                             out, n, SL, cap_t, stream);
}

// The block at (SL, cap_t), [lanes a target, threads], into
// layout[0..1], and the resident blocks an SM of formula ker into
// *blocks (the occupancy API).
SCTL_API int sctl_p2p_stencil9_occupancy(int ker, int SL, int cap_t,
                                         int* layout, int* blocks) {
  using namespace sctl;
  return dispatch_formula<Occupancy, kLapFxU, kLapDxU, kLapFxdU, kStkFxU,
                          kStkDxU, kStkFSxU>(ker, SL, cap_t, layout, blocks);
}
