// Dense direct sum, every kernel formula, float and double.
//
// Replaces: sctl_tpu/ops/pallas_p2p.py `p2p` (pl.pallas_call at :555,
// body `_p2p_kernel_body`).  For target t < Nt:
//   out[t, :] = sum_{s < Ns} K(xt[t] - xs[s]) f[s, :]
// with r2 = 0 masked to a zero contribution; unscaled (the wrapper,
// ops/p2p.py `p2p`, multiplies by the kernel's scale factor once).
//
// Bound on the H100: the operations of the pairs.  The oracle of the
// 1e7-point Stokes run (1,000 targets x 1e7 sources, float64) is 1e10
// pairs of 23 operations (Stokes3D-FxU, the JAX package's count):
// 2.3e11, 6.8 ms at the 34 TFLOP/s of f64 on the CUDA cores, against
// 0.5 GB of sources (0.14 ms); the 39,000-point float32 runs of
// ParticleFMM's direct path are 1.5e9 pairs against 1 MB.  That count
// prices the rsqrt as one operation.  What the card can reach is set by
// the instructions: in float64 the DP pipe (64 lanes a clock per SM)
// runs every DP instruction of a pair, about 25 for Stokes3D-FxU in the
// lean form (the rsqrt alone seven), so the float64 floor is about 2.5x
// the bound; in float32 the issue rate (128 lane-instructions a clock
// per SM).  chip_smoke.py reads both floors from the SASS.
//
// Design: R = 1 target a thread, 128 threads a block, the k1 sums in
// registers.  A block walks a range of sources in tiles of kTile, staged
// in shared memory as one record a source (coordinates, densities, the
// normal for the double layers, padded to 16 bytes) that each thread
// reads with 16-byte broadcast loads.  The loop runs 8 pairs a pass,
// independent chains up to their sums, which with 10 resident blocks an
// SM (float64 Stokes3D-FxU) covers the latency of the double rsqrt's
// Newton steps.  Per-pair differences, never moment expansions, in the
// lean formula form (ukernels.cuh: fused sums; float's flush-to-zero
// rsqrt, double's seed and two Newton steps).  Each tile sums into its
// own registers before it joins the running sum: one running sum over
// 19,500 float32 terms drifted to 5.0e-6 of the maximum against the
// float64 kernel on the same inputs (Stokes3D-DxU, 39,000 points); the
// two-level sum adds about one rounding per tile.  The last tile is
// padded with zero records, which add exactly zero, so every tile runs
// kTile pairs unrolled.  The grid is (target blocks) x (source splits),
// sized by the wrapper to the card's resident blocks (the occupancy
// API, `sctl_p2p_direct_occupancy`) so that one wave of equal blocks
// fills it when there are few targets, as in the oracles: split k
// writes its partial sums to out[k], and the wrapper adds the splits,
// so a launch repeats bit for bit.  One, two and four targets a thread
// (register blocking: one shared load for R pairs) read within 5% of
// each other, one the fastest in float64 (sctl_tpu_torch/p2p_sweep.py;
// PERF.md section 6).
#include <type_traits>

#include "common.cuh"
#include "ukernels.cuh"

namespace {

constexpr int kThreads = 128;   // threads per block
constexpr int R = 1;            // targets per thread
constexpr int kTile = 128;      // sources per shared tile

// one source's record: x, y, z, the k0 densities, the normal (double
// layers), padded to whole 16-byte vectors
template <typename T, int KER>
struct Rec {
  using D = sctl::Dims<KER>;
  static constexpr int nf = 3 + D::k0 + (D::nrm ? 3 : 0);
  static constexpr int per_vec = 16 / sizeof(T);
  static constexpr int vecs = (nf + per_vec - 1) / per_vec;
  static constexpr int width = vecs * per_vec;
};

template <typename T, int KER>
__global__ void __launch_bounds__(kThreads)
p2p_direct_kernel(const T* __restrict__ xt, const T* __restrict__ xs,
                  const T* __restrict__ ns, const T* __restrict__ f,
                  T* __restrict__ out, int Nt, int Ns, int chunk) {
  using D = sctl::Dims<KER>;
  using RC = Rec<T, KER>;
  using V = typename std::conditional<sizeof(T) == 4, float4,
                                      double2>::type;
  constexpr int K0 = D::k0, K1 = D::k1, W = RC::width;
  __shared__ V tile[kTile * RC::vecs];
  T* rec = reinterpret_cast<T*>(tile);
  const int tb = blockIdx.x * kThreads * R + threadIdx.x;
  T px[R], py[R], pz[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int t = min(tb + r * kThreads, Nt - 1);
    px[r] = xt[3 * t];
    py[r] = xt[3 * t + 1];
    pz[r] = xt[3 * t + 2];
  }
  T acc[R][K1];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < K1; ++j) acc[r][j] = T(0);
  const int s_begin = blockIdx.y * chunk;
  const int s_end = min(Ns, s_begin + chunk);
  for (int s0 = s_begin; s0 < s_end; s0 += kTile) {
    __syncthreads();                       // the last tile is consumed
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const long s = s0 + i;
      const bool real = s < s_end;
      T* o = rec + i * W;
#pragma unroll
      for (int c = 0; c < 3; ++c) o[c] = real ? xs[3 * s + c] : T(0);
#pragma unroll
      for (int c = 0; c < K0; ++c) o[3 + c] = real ? f[K0 * s + c] : T(0);
      if constexpr (D::nrm) {
#pragma unroll
        for (int c = 0; c < 3; ++c)
          o[3 + K0 + c] = real ? ns[3 * s + c] : T(0);
      }
#pragma unroll
      for (int c = RC::nf; c < W; ++c) o[c] = T(0);
    }
    __syncthreads();
    T part[R][K1];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < K1; ++j) part[r][j] = T(0);
#pragma unroll (8 / R)
    for (int i = 0; i < kTile; ++i) {
      V vv[RC::vecs];
#pragma unroll
      for (int k = 0; k < RC::vecs; ++k) vv[k] = tile[i * RC::vecs + k];
      const T* v = reinterpret_cast<const T*>(vv);
#pragma unroll
      for (int r = 0; r < R; ++r)
        sctl::uker_acc<KER, true>(px[r] - v[0], py[r] - v[1], pz[r] - v[2],
                                  v + 3, v + 3 + K0, part[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < K1; ++j) acc[r][j] += part[r][j];
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int t = tb + r * kThreads;
    if (t < Nt) {
      T* o = out + ((long)blockIdx.y * Nt + t) * K1;
#pragma unroll
      for (int j = 0; j < K1; ++j) o[j] = acc[r][j];
    }
  }
}

template <typename T>
struct Launch {
  template <int KER>
  struct Of {
    static int run(const T* xt, const T* xs, const T* ns, const T* f, T* out,
                   int Nt, int Ns, int nsplit, int chunk,
                   cudaStream_t stream) {
      dim3 grid((Nt + kThreads * R - 1) / (kThreads * R), nsplit);
      p2p_direct_kernel<T, KER><<<grid, kThreads, 0, stream>>>(
          xt, xs, ns, f, out, Nt, Ns, chunk);
      return (int)cudaGetLastError();
    }
  };
  template <int KER>
  struct Occupancy {
    static int run(int* blocks) {
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, p2p_direct_kernel<T, KER>, kThreads, 0);
    }
  };
};

template <typename T>
int p2p_direct(const T* xt, const T* xs, const T* ns, const T* f, T* out,
               int ker, int Nt, int Ns, int nsplit, int chunk,
               cudaStream_t stream) {
  if (Nt == 0) return 0;
  if (chunk % kTile || (long)nsplit * chunk < Ns)
    return (int)cudaErrorInvalidValue;
  return dispatch_formula<Launch<T>::template Of, 0, 1, 2, 3, 4, 5, 6, 7>(
      ker, xt, xs, ns, f, out, Nt, Ns, nsplit, chunk, stream);
}

}  // namespace

// xt (Nt, 3), xs (Ns, 3), ns (Ns, 3) (double layers only, else null),
// f (Ns, k0), out (nsplit, Nt, k1): split k sums sources
// [k chunk, (k+1) chunk); chunk a multiple of 128.  ker: the formula
// index of ukernels.cuh.
SCTL_API int sctl_p2p_direct_f32(const float* xt, const float* xs,
                                 const float* ns, const float* f, float* out,
                                 int ker, int Nt, int Ns, int nsplit,
                                 int chunk, cudaStream_t stream) {
  return p2p_direct<float>(xt, xs, ns, f, out, ker, Nt, Ns, nsplit, chunk,
                           stream);
}

SCTL_API int sctl_p2p_direct_f64(const double* xt, const double* xs,
                                 const double* ns, const double* f,
                                 double* out, int ker, int Nt, int Ns,
                                 int nsplit, int chunk, cudaStream_t stream) {
  return p2p_direct<double>(xt, xs, ns, f, out, ker, Nt, Ns, nsplit, chunk,
                            stream);
}

// The block's layout, [threads, targets a thread, sources a tile], into
// layout[0..2], and the resident blocks an SM of formula ker in float64
// (f64 != 0) or float32 into *blocks (the occupancy API).
SCTL_API int sctl_p2p_direct_occupancy(int ker, int f64, int* layout,
                                       int* blocks) {
  layout[0] = kThreads;
  layout[1] = R;
  layout[2] = kTile;
  return f64 ? dispatch_formula<Launch<double>::template Occupancy, 0, 1, 2,
                                3, 4, 5, 6, 7>(ker, blocks)
             : dispatch_formula<Launch<float>::template Occupancy, 0, 1, 2,
                                3, 4, 5, 6, 7>(ker, blocks);
}
