// Near-field P2P over 9 shifted halo columns, real slots only.
//
// Replaces: sctl_tpu/ops/pallas_p2p.py `p2p_stencil` (pl.pallas_call
// at :340).  Boxes in raster order; column (x, y) of the halo arrays
// holds its n boxes' cap source slots z-major between cap-wide zero
// margins (ops/p2p.py `to_halo`), so target box (x, y, z)'s neighbours
// in column (x+dx, y+dy) are the boxes z-1 .. z+1 at slots
// [(z'+1) cap, (z'+2) cap).  A box's real points are its first cnt
// slots (cnt_s, cnt_t: int32 per box, raster order, clipped here to
// cap and cap_t; null means every slot).  For a real target slot
// t < cnt_t[x, y, z]:
//   out[x, y, z, t, :] = sum_{dx, dy, dz in -1..1, box in the domain}
//       sum_{s < cnt_s[box]} K(xt[x, y, z, :, t] - xs[box slot s])
//                            f[box slot s]
// with r2 = 0 masked; target slots at or past cnt_t are written 0.
// Padded slots carry zero density in the JAX function, so skipping
// them changes only the order of the f32 sums.  Unscaled.  The formula
// is a template parameter (ukernels.cuh): the six kernels with a tree
// path; the double layers read the normals.
//
// Bound on the H100: the real pairs, one rsqrt each at 16 per SM per
// clock (the formula's f32 operations at 67 TFLOP/s bound the Stokes
// kernels instead).  ParticleFMM(accuracy=8) at 1e7 uniform points
// (depth 5, cap 344, cap_t 328): 7.71e10 real pairs, 18.4 ms; the bytes
// (0.3 GB) take 0.1 ms.  What holds the kernel is the issue rate (128
// lane-instructions a clock per SM), not the rsqrt units: the default
// formula form's rsqrtf carries a denormal fix-up around a predicated
// MUFU, and PR 7's kernel also paid the loop's bookkeeping for each of
// its 9.98e10 slot pairs.  The Laplace single layer's unrolled loop
// here spends 11 SASS instructions a pair: three subtractions, three
// for r2, MUFU.RSQ, a compare and a select, the FMA, and a share of one
// shared load and of the loop (chip_smoke.py reads it with cuobjdump;
// PERF.md section 6).
//
// Design: one block per (target box, chunk of targets).  Each thread
// holds R = 2 target points and their sums in registers, and S = 2
// neighbouring lanes split each staged tile's sources between them, so
// one shared load of a source serves two pairs and the loop's
// bookkeeping is paid once for two.  A warp covers 32 targets; the block
// ceil(cap_t / 2) 2 threads rounded to a warp.  (One, two and four
// targets a thread, with one or two lanes a target group, all read
// within the run-to-run noise once the formula was lean; PERF.md
// section 6.)  For each of the 9 neighbour columns in the domain, the
// block stages the real slots of its (up to) three boxes as one run, in
// tiles of 512: float4 (x, y, z, f_0) and one plane per further density
// and normal component.  Warps whose targets are all past cnt_t skip the
// pairs.  The formula is ukernels.cuh's lean form (flush-to-zero rsqrt,
// fused sums) and the source loop is unrolled to about 8 pairs a pass.
// Each thread sums a tile's pairs into fresh f32 partial sums and adds
// them to its totals: in p2p_direct.cu a single running f32 sum a thread
// reached 5.006e-6 of the maximum against a float64 sum (Stokes DxU),
// over its 5e-6 bar.  The two lanes of a target group meet by one warp
// shuffle: no atomics, so a launch repeats bit for bit.
//
// The double build (the float64 KIFMM and ParticleFMM on the card) is
// the same kernel on Real = double: the same real slots by the per-box
// counts, fresh partial sums a tile, the lean double rsqrt
// (ukernels.cuh) and the same summation order and shuffle, so a launch
// repeats bit for bit.  A slot's (x, y, z, f_0) take two double2 records
// where float's take one float4 (Rec16, common.cuh); the tile stays 512
// slots, so the static shared memory is 16 KB of records and at most
// 20 KB of further planes (Stokes3D-DxU), 36 KB, under the 48 KB a block
// takes without the opt-in.  Bound: the DP pipe (64 lane-operations a
// clock per SM): 14 DP instructions a Laplace pair (chip_smoke.py reads
// them from the SASS).
#include "common.cuh"
#include "ukernels.cuh"

namespace {

constexpr int kTile = 512;         // source slots staged at a time
constexpr int kMaxThreads = 512;
constexpr int R = 2;               // targets a thread
constexpr int S = 2;               // lanes sharing a target group's sources

template <typename Real, int KER>
__global__ void __launch_bounds__(kMaxThreads)
p2p_stencil_kernel(const Real* __restrict__ xt,
                   const Real* __restrict__ xs,
                   const Real* __restrict__ ns,
                   const Real* __restrict__ f,
                   const int* __restrict__ cnt_s,
                   const int* __restrict__ cnt_t, Real* __restrict__ out,
                   int n, int cap, int cap_t) {
  using D = sctl::Dims<KER>;
  using V = sctl::Rec16<Real>;
  constexpr int K0 = D::k0, K1 = D::k1, NN = D::nrm ? 3 : 0;
  constexpr int E = K0 - 1 + NN;           // planes beyond (x, y, z, f_0)
  constexpr int W = V::W, R0 = 4 / W;      // records of (x, y, z, f_0)
  __shared__ typename V::T win[kTile * R0];
  __shared__ Real ext[E > 0 ? E : 1][kTile];
  const long box = blockIdx.x;             // (x n + y) n + z
  const int x = (int)(box / ((long)n * n)), y = (int)(box / n % n),
            z = (int)(box % n);
  const int sub = threadIdx.x % S;         // this lane's share of a tile
  const int blk_t0 = blockIdx.y * (blockDim.x / S) * R;
  const int t0 = blk_t0 + (int)(threadIdx.x / S) * R;
  const int nt = cnt_t ? max(0, min(cnt_t[box], cap_t)) : cap_t;
  const bool live = t0 < nt;
  const Real* xb = xt + box * 3 * cap_t;
  Real px[R], py[R], pz[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int t = min(t0 + r, cap_t - 1);
    px[r] = xb[t];
    py[r] = xb[cap_t + t];
    pz[r] = xb[2 * cap_t + t];
  }
  Real acc[R][K1];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < K1; ++j) acc[r][j] = Real(0);

  const long L = (long)(n + 2) * cap;      // slots of a column
  // blocks without a real target only write zeros (uniform branch)
  for (int c9 = blk_t0 < nt ? 0 : 9; c9 < 9; ++c9) {
    const int cx = x + c9 / 3 - 1, cy = y + c9 % 3 - 1;
    if (cx < 0 || cx >= n || cy < 0 || cy >= n) continue;
    const long col = (long)cx * n + cy;
    // the real slots of boxes z-1 .. z+1 that exist, as one run of
    // three segments at halo positions (z'+1) cap
    int beg[3], len[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int zz = z - 1 + j;
      const bool in = zz >= 0 && zz < n;
      beg[j] = (zz + 1) * cap;
      len[j] = !in ? 0 : cnt_s ? max(0, min(cnt_s[col * n + zz], cap))
                               : cap;
    }
    const int m_all = len[0] + len[1] + len[2];
    const Real* xc = xs + col * 3 * L;
    const Real* fc = f + col * K0 * L;
    const Real* nc = NN ? ns + col * 3 * L : nullptr;
    for (int s0 = 0; s0 < m_all; s0 += kTile) {
      const int m = min(kTile, m_all - s0);
      __syncthreads();                     // the last tile is consumed
      for (int i = threadIdx.x; i < m; i += blockDim.x) {
        const int v = s0 + i;
        const long g = v < len[0] ? beg[0] + v
                       : v < len[0] + len[1] ? beg[1] + (v - len[0])
                                             : beg[2] + (v - len[0] - len[1]);
        const Real rec[4] = {xc[g], xc[L + g], xc[2 * L + g], fc[g]};
#pragma unroll
        for (int r = 0; r < R0; ++r) win[i * R0 + r] = V::pack(rec + W * r);
#pragma unroll
        for (int c = 1; c < K0; ++c) ext[c - 1][i] = fc[c * L + g];
#pragma unroll
        for (int c = 0; c < NN; ++c) ext[K0 - 1 + c][i] = nc[c * L + g];
      }
      __syncthreads();
      if (!live) continue;
      Real part[R][K1];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < K1; ++j) part[r][j] = Real(0);
#pragma unroll (8 / R)
      for (int i = sub; i < m; i += S) {
        Real q[4];
#pragma unroll
        for (int r = 0; r < R0; ++r) V::unpack(win[i * R0 + r], q + W * r);
        Real fv[K0], nv[3];
        fv[0] = q[3];
#pragma unroll
        for (int c = 1; c < K0; ++c) fv[c] = ext[c - 1][i];
#pragma unroll
        for (int c = 0; c < NN; ++c) nv[c] = ext[K0 - 1 + c][i];
#pragma unroll
        for (int r = 0; r < R; ++r)
          sctl::uker_acc<KER, true>(px[r] - q[0], py[r] - q[1], pz[r] - q[2],
                                    fv, nv, part[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < K1; ++j) acc[r][j] += part[r][j];
    }
  }
  // the S lanes of a target group: a butterfly over neighbouring lanes
#pragma unroll
  for (int o = 1; o < S; o <<= 1)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < K1; ++j)
        acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], o);
  if (sub) return;
  Real* o = out + box * cap_t * K1;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int t = t0 + r;
    if (t >= cap_t) break;
#pragma unroll
    for (int j = 0; j < K1; ++j) o[t * K1 + j] = t < nt ? acc[r][j] : Real(0);
  }
}

template <typename Real>
struct Launch {
  template <int KER>
  struct Of {
    static int run(const Real* xt, const Real* xs, const Real* ns,
                   const Real* f, const int* cnt_s, const int* cnt_t,
                   Real* out, int n, int cap, int cap_t,
                   cudaStream_t stream) {
      // ceil(cap_t / R) S threads rounded to a warp, at most kMaxThreads
      const int up = ((cap_t + R - 1) / R * S + 31) / 32 * 32;
      const int threads = up < kMaxThreads ? up : kMaxThreads;
      const int per_block = threads / S * R;
      dim3 grid(n * n * n, (cap_t + per_block - 1) / per_block);
      p2p_stencil_kernel<Real, KER><<<grid, threads, 0, stream>>>(
          xt, xs, ns, f, cnt_s, cnt_t, out, n, cap, cap_t);
      return (int)cudaGetLastError();
    }
  };
};

template <typename Real>
int p2p_stencil(const Real* xt, const Real* xs, const Real* ns,
                const Real* f, const int* cnt_s, const int* cnt_t,
                Real* out, int ker, int n, int cap, int cap_t,
                cudaStream_t stream) {
  using namespace sctl;
  return dispatch_formula<Launch<Real>::template Of, kLapFxU, kLapDxU,
                          kLapFxdU, kStkFxU, kStkDxU, kStkFSxU>(
      ker, xt, xs, ns, f, cnt_s, cnt_t, out, n, cap, cap_t, stream);
}

}  // namespace

// xt (n, n, n, 3, cap_t), xs (n, n, 3, (n+2) cap), ns (n, n, 3,
// (n+2) cap) (double layers only, else null), f (n, n, k0, (n+2) cap),
// cnt_s, cnt_t (n, n, n) int32 real slots a box (null: all), out (n, n,
// n, cap_t, k1); float32 (sctl_p2p_stencil) or float64
// (sctl_p2p_stencil_f64).  ker: the formula index of ukernels.cuh, one
// of the six kernels with a tree path.
SCTL_API int sctl_p2p_stencil(const float* xt, const float* xs,
                              const float* ns, const float* f,
                              const int* cnt_s, const int* cnt_t,
                              float* out, int ker, int n, int cap, int cap_t,
                              cudaStream_t stream) {
  return p2p_stencil<float>(xt, xs, ns, f, cnt_s, cnt_t, out, ker, n, cap,
                            cap_t, stream);
}

SCTL_API int sctl_p2p_stencil_f64(const double* xt, const double* xs,
                                  const double* ns, const double* f,
                                  const int* cnt_s, const int* cnt_t,
                                  double* out, int ker, int n, int cap,
                                  int cap_t, cudaStream_t stream) {
  return p2p_stencil<double>(xt, xs, ns, f, cnt_s, cnt_t, out, ker, n, cap,
                             cap_t, stream);
}
