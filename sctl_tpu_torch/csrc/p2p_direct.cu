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
// ParticleFMM's direct path are 1.5e9 pairs against 1 MB.
//
// Design: one thread per target, its k1 sums in registers.  A block of
// kThreads targets walks a range of sources in tiles of kTile, staged
// in shared memory (coordinates, normals only for the double layers,
// densities); every thread of a warp reads the same slot, a broadcast.
// Per-pair differences, never moment expansions.  Each tile sums into
// its own registers before it joins the running sum: one running sum
// over 19,500 float32 terms drifted to 5.0e-6 of the maximum against
// the float64 kernel on the same inputs (Stokes3D-DxU, 39,000 points);
// the two-level sum adds about one rounding per tile.  A grid of
// (target blocks) x (source splits) fills the card when there are few
// targets, as in the oracles: split k writes its partial sums to
// out[k], and the wrapper adds the splits.
#include "common.cuh"
#include "ukernels.cuh"

namespace {

constexpr int kThreads = 128;   // targets per block
constexpr int kTile = 128;      // sources per shared tile

template <typename T, int KER>
__global__ void __launch_bounds__(kThreads)
p2p_direct_kernel(const T* __restrict__ xt, const T* __restrict__ xs,
                  const T* __restrict__ ns, const T* __restrict__ f,
                  T* __restrict__ out, int Nt, int Ns, int chunk) {
  using D = sctl::Dims<KER>;
  constexpr int K0 = D::k0, K1 = D::k1;
  __shared__ T sx[3][kTile];
  __shared__ T sn[D::nrm ? 3 : 1][kTile];
  __shared__ T sf[K0][kTile];
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const bool live = t < Nt;
  const T x = live ? xt[3 * t] : T(0);
  const T y = live ? xt[3 * t + 1] : T(0);
  const T z = live ? xt[3 * t + 2] : T(0);
  T acc[K1];
#pragma unroll
  for (int j = 0; j < K1; ++j) acc[j] = T(0);
  const int s_begin = blockIdx.y * chunk;
  const int s_end = min(Ns, s_begin + chunk);
  for (int s0 = s_begin; s0 < s_end; s0 += kTile) {
    const int n_tile = min(kTile, s_end - s0);
    __syncthreads();
    for (int i = threadIdx.x; i < n_tile; i += kThreads) {
      const long s = s0 + i;
#pragma unroll
      for (int c = 0; c < 3; ++c) sx[c][i] = xs[3 * s + c];
      if constexpr (D::nrm) {
#pragma unroll
        for (int c = 0; c < 3; ++c) sn[c][i] = ns[3 * s + c];
      }
#pragma unroll
      for (int c = 0; c < K0; ++c) sf[c][i] = f[K0 * s + c];
    }
    __syncthreads();
    T part[K1];
#pragma unroll
    for (int j = 0; j < K1; ++j) part[j] = T(0);
#pragma unroll 4
    for (int i = 0; i < n_tile; ++i) {
      T fv[K0], nv[3];
#pragma unroll
      for (int c = 0; c < K0; ++c) fv[c] = sf[c][i];
      if constexpr (D::nrm) {
#pragma unroll
        for (int c = 0; c < 3; ++c) nv[c] = sn[c][i];
      }
      sctl::uker_acc<KER>(x - sx[0][i], y - sx[1][i], z - sx[2][i], fv, nv,
                          part);
    }
#pragma unroll
    for (int j = 0; j < K1; ++j) acc[j] += part[j];
  }
  if (live) {
    T* o = out + ((long)blockIdx.y * Nt + t) * K1;
#pragma unroll
    for (int j = 0; j < K1; ++j) o[j] = acc[j];
  }
}

template <typename T>
struct Launch {
  template <int KER>
  struct Of {
    static int run(const T* xt, const T* xs, const T* ns, const T* f, T* out,
                   int Nt, int Ns, int nsplit, int chunk,
                   cudaStream_t stream) {
      dim3 grid((Nt + kThreads - 1) / kThreads, nsplit);
      p2p_direct_kernel<T, KER><<<grid, kThreads, 0, stream>>>(
          xt, xs, ns, f, out, Nt, Ns, chunk);
      return (int)cudaGetLastError();
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
